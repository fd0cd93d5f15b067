from .base import BaseDataset, DeviceSeqSampler, DeviceTDSampler
from .block_push import BlockPushDataset
from .d4rl_antmaze import (
    D4RLAntmazeDataset,
    D4RLAntmazeTDDataset,
    DV_D4RLAntmazeSeqDataset,
    MultiHorizonD4RLAntmazeDataset,
)
from .d4rl_kitchen import (
    D4RLKitchenDataset,
    D4RLKitchenTDDataset,
    DV_D4RLKitchenSeqDataset,
    MultiHorizonD4RLKitchenDataset,
)
from .d4rl_maze2d import D4RLMaze2DTDDataset, DV_D4RLMaze2DSeqDataset
from .d4rl_mujoco import (
    D4RLMuJoCoDataset,
    D4RLMuJoCoTDDataset,
    DV_D4RLMuJoCoSeqDataset,
    MultiHorizonD4RLMuJoCoDataset,
)
from .dataset_utils import RotationTransformer, SequenceSampler, create_indices
from .fake import (
    FAKE_ENV_SPECS,
    fake_d4rl_dataset,
    fake_d4rl_qlearning_dataset,
    fake_robomimic_buffer,
)
from .hermetic import goal2d_qlearning_dataset, goal2d_sequence_dataset
from .kitchen import KitchenDataset, KitchenDatasetV2, KitchenMjlDataset
from .pusht import (
    PushTImageDataset,
    PushTKeypointDataset,
    PushTStateDataset,
    generate_pusht_demos,
)
from .replay_buffer import ReplayBuffer
from .robomimic import (
    RobomimicDataset,
    RobomimicImageDataset,
    RobomimicTDDataset,
    abs_action_transform,
    undo_transform_action,
)

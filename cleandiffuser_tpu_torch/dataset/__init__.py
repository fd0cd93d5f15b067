from .base import BaseDataset, DeviceSeqSampler, DeviceTDSampler
from .d4rl_mujoco import (
    D4RLMuJoCoDataset,
    D4RLMuJoCoTDDataset,
    DV_D4RLMuJoCoSeqDataset,
    MultiHorizonD4RLMuJoCoDataset,
)
from .dataset_utils import SequenceSampler, create_indices
from .fake import FAKE_ENV_SPECS, fake_d4rl_dataset, fake_d4rl_qlearning_dataset
from .hermetic import goal2d_qlearning_dataset, goal2d_sequence_dataset

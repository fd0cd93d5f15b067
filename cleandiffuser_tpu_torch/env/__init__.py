from .async_vector import make_async_vector_env
from .block_pushing import (
    BlockPushEnv,
    BlockPushMultimodalEnv,
    BlockPushState,
    generate_blockpush_demos,
    generate_blockpush_discontinuous_demos,
    generate_blockpush_reach_demos,
)
from .d4rl_eval import (
    ANTMAZE_EVAL_CELLS,
    ANTMAZE_GYM_IDS,
    MAZE2D_GYM_IDS,
    AntMazeD4RLWrapper,
    PointMazeD4RLWrapper,
    make_antmaze_env,
    make_maze2d_env,
)
from .goal2d import Goal2DEnv, evaluate_policy, normalized_score_fn, optimal_return
from .maze2d_expert import WaypointController, generate_maze2d_dataset
from .kitchen import ALL_KITCHEN_TASKS, KitchenLowdimWrapper, make_kitchen_env
from .pusht import PushTEnv, PushTImageEnv, PushTKeypointEnv, PushTState, render_state
from .pusht_expert import PushTExpertMPC, generate_pusht_expert_trajectories
from .robomimic import RobomimicImageWrapper, RobomimicLowdimWrapper, create_robomimic_env
from .wrapper import (
    DuckSyncVectorEnv,
    MultiStepWrapper,
    VideoRecorder,
    VideoRecordingWrapper,
    VideoWrapper,
    make_sync_vector_env,
    repeated_space,
    stack_last_n_obs,
)

from .blocks import DVHorizonCritic, DVTransformerBlock, IDQLVNet, dense, xavier_uniform_init
from .embeddings import (
    SUPPORTED_TIMESTEP_EMBEDDING,
    FourierEmbedding,
    PositionalEmbedding,
    mish,
    positional_features,
    sinusoidal_features,
)
from .schedules import (
    SUPPORTED_DISCRETIZATIONS,
    SUPPORTED_NOISE_SCHEDULES,
    SUPPORTED_SAMPLING_STEP_SCHEDULE,
    linear_noise_schedule,
)
from .tensors import at_least_ndim

# Decision Diffuser return-normalization scales
# (same table as cleandiffuser_tpu/utils/__init__.py)
DD_RETURN_SCALE = {
    "halfcheetah-medium-expert-v2": 3600,
    "halfcheetah-medium-replay-v2": 1600,
    "halfcheetah-medium-v2": 1700,
    "hopper-medium-expert-v2": 1200,
    "hopper-medium-replay-v2": 1000,
    "hopper-medium-v2": 1000,
    "walker2d-medium-expert-v2": 1600,
    "walker2d-medium-replay-v2": 1300,
    "walker2d-medium-v2": 1300,
    "kitchen-partial-v0": 470,
    "kitchen-mixed-v0": 400,
    "antmaze-medium-play-v2": 100,
    "antmaze-medium-diverse-v2": 100,
    "antmaze-large-play-v2": 100,
    "antmaze-large-diverse-v2": 100,
}

from .blocks import (
    V,
    DQLCritic,
    DVHorizonCritic,
    DVTransformerBlock,
    FeedForward,
    IDQLQNet,
    IDQLVNet,
    Mlp,
    MultiHeadAttention,
    SoftLowerBound,
    SoftUpperBound,
    Transformer,
    TwinQ,
    dense,
    dropout,
    generate_causal_mask,
    xavier_uniform_init,
)
from .embeddings import (
    SUPPORTED_TIMESTEP_EMBEDDING,
    FourierEmbedding,
    PositionalEmbedding,
    SinusoidalEmbedding,
    UntrainableFourierEmbedding,
    UntrainablePositionalEmbedding,
    get_timestep_embedding,
    mish,
    positional_features,
    sinusoidal_features,
)
from .iql import IQL, IQLState
from .normalizers import (
    CDFNormalizer,
    CDFNormalizer1d,
    DatasetGaussianNormalizer,
    DatasetMinMaxNormalizer,
    EmptyNormalizer,
    GaussianNormalizer,
    ImageNormalizer,
    MinMaxNormalizer,
)
from .schedules import (
    SUPPORTED_DISCRETIZATIONS,
    SUPPORTED_NOISE_SCHEDULES,
    SUPPORTED_SAMPLING_STEP_SCHEDULE,
    cosine_beta_schedule,
    cosine_noise_schedule,
    inverse_cosine_noise_schedule,
    inverse_linear_noise_schedule,
    karras_sigma_schedule,
    linear_beta_schedule,
    linear_noise_schedule,
    uniform_discretization,
)
from .tensors import (
    at_least_ndim,
    count_parameters,
    dict_apply,
    loop_dataloader,
    report_parameters,
    set_seed,
)
from .train_state import ema_update, load_state, make_optimizer, save_state

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

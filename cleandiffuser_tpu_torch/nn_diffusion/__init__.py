from .base import timestep_embedding_module
from .dit import DiT1d, DiTBlock, FinalLayer1d, modulate
from .mlps import DQLMlp, DVInvMlp, IDQLMlp, NewIDQLMlp
from .jannerunet import (
    Downsample1d,
    JannerUNet1d,
    LinearAttention,
    ResidualBlock1d,
    Upsample1d,
    get_norm,
)

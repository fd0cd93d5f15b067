from .base import BaseNNDiffusion, timestep_embedding_module
from .chitransformer import ChiTransformer
from .chiunet import ChiResidualBlock, ChiUNet1d
from .dit import DiT1d, DiT1Ref, DiTBlock, FinalLayer1d, modulate
from .mlps import DQLMlp, DVInvMlp, IDQLMlp, MlpNNDiffusion, NewIDQLMlp
from .pearce import PearceMlp, PearceTransformer
from .sfbc_unet import SfBCUNet
from .jannerunet import (
    Downsample1d,
    JannerUNet1d,
    LinearAttention,
    ResidualBlock1d,
    Upsample1d,
    get_norm,
)

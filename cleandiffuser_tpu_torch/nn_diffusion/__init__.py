from .base import timestep_embedding_module
from .dit import DiT1d, DiTBlock, FinalLayer1d, modulate

"""Timestep embeddings (counterpart of cleandiffuser_tpu/utils/embeddings.py).

All embeddings accept a (b,) or (...,) timestep tensor and return (..., dim)
features. Ported so far: the positional embedding (DiT1d's default), the
Fourier embedding DD's DiT1d uses, and the sinusoidal features of DiT1d's
token positions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import dense

__all__ = [
    "PositionalEmbedding",
    "FourierEmbedding",
    "SUPPORTED_TIMESTEP_EMBEDDING",
    "mish",
    "positional_features",
    "sinusoidal_features",
]


def positional_features(x, dim: int, max_positions: int = 10000, endpoint: bool = False):
    """DDPM++/ADM positional features: [cos | sin] over geometric freqs."""
    freqs = torch.arange(dim // 2, dtype=torch.float32, device=x.device)
    freqs = freqs / (dim // 2 - (1 if endpoint else 0))
    freqs = (1 / max_positions) ** freqs
    ang = x[..., None].to(torch.float32) * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def sinusoidal_features(x, dim: int):
    """Transformer sinusoidal features: [sin | cos]."""
    half_dim = dim // 2
    scale = math.log(10000) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=x.device) * -scale)
    ang = x[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mish(x):
    """Mish activation: x * tanh(softplus(x)), one fused op."""
    return F.mish(x)


class PositionalEmbedding(nn.Module):
    """Untrained positional embedding (parameter-free module)."""

    def __init__(self, dim: int, max_positions: int = 10000, endpoint: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.max_positions, self.endpoint = dim, max_positions, endpoint

    def forward(self, x):
        return positional_features(x, self.dim, self.max_positions, self.endpoint)


class FourierEmbedding(nn.Module):
    """Random-Fourier embedding followed by a 2-layer Mish MLP: frozen freqs
    ~ N(0, scale^2) of size dim//8, [cos | sin] features of size dim//4,
    then MLP dim//4 -> dim -> dim."""

    JAX_NAMES = {"dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, dim: int, scale: float = 16.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # frozen: a buffer, so it follows .to() and the EMA copy but is
        # never trained
        self.register_buffer(
            "freqs", torch.randn(dim // 8, generator=generator) * scale)
        self.dense1 = dense(2 * (dim // 8), dim, generator=generator)
        self.dense2 = dense(dim, dim, generator=generator)

    def forward(self, x):
        ang = x[..., None].to(torch.float32) * (2 * math.pi * self.freqs)
        emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
        return self.dense2(mish(self.dense1(emb)))


SUPPORTED_TIMESTEP_EMBEDDING = {
    "positional": PositionalEmbedding,
    "fourier": FourierEmbedding,
}

"""Timestep embeddings (counterpart of cleandiffuser_tpu/utils/embeddings.py).

All embeddings accept a (b,) or (...,) timestep tensor and return (..., dim)
features. Ported so far: the positional embedding (DiT1d's default), the
Fourier embedding DD's DiT1d uses, the untrainable Fourier features of
SfBC's U-Net and QGPO's energy net, the sinusoidal features of DiT1d's
token positions and `SinusoidalEmbedding`, their module (no pipeline uses
it).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import below_f32, dense

__all__ = [
    "PositionalEmbedding",
    "FourierEmbedding",
    "UntrainableFourierEmbedding",
    "SinusoidalEmbedding",
    "UntrainablePositionalEmbedding",
    "SUPPORTED_TIMESTEP_EMBEDDING",
    "get_timestep_embedding",
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
    """Mish activation: x * tanh(softplus(x)), one fused op. Below f32, the
    reference's op sequence, each step rounded to x's type as jnp's are:
    softplus as `jnp.logaddexp(x, 0)` = max(x, 0) + log1p(exp(-|x|))."""
    if below_f32(x.dtype):
        softplus = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
        return x * torch.tanh(softplus)
    return F.mish(x)


def _two_pi_times(freqs):
    """The reference's `2 * jnp.pi * freqs`: below f32 the weakly typed 2 pi
    is rounded to the freqs' type before the product (a torch scalar would
    multiply in f32 and round once)."""
    if below_f32(freqs.dtype):
        return torch.tensor(2 * math.pi, dtype=freqs.dtype, device=freqs.device) * freqs
    return 2 * math.pi * freqs


class PositionalEmbedding(nn.Module):
    """Untrained positional embedding (parameter-free module)."""

    def __init__(self, dim: int, max_positions: int = 10000, endpoint: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.max_positions, self.endpoint = dim, max_positions, endpoint

    def forward(self, x):
        return positional_features(x, self.dim, self.max_positions, self.endpoint)


# the reference's "untrainable_positional" is the same parameter-free math
UntrainablePositionalEmbedding = PositionalEmbedding


class SinusoidalEmbedding(nn.Module):
    """Transformer sinusoidal features [sin | cos] (parameter-free module)."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return sinusoidal_features(x, self.dim)


class FourierEmbedding(nn.Module):
    """Random-Fourier embedding followed by a 2-layer Mish MLP: freqs ~
    N(0, scale^2) of size dim//8, [cos | sin] features of size dim//4, then
    MLP dim//4 -> dim -> dim.

    `freqs` is a parameter read through `.detach()`, as the reference reads
    its flax param through `stop_gradient`: no gradient reaches it, but it
    is a parameter like the others, so the optimizer sees it (with a zero
    gradient, AdamW's decoupled decay shrinks it by lr * wd per step), the
    EMA blends it, a bf16 cast casts it, and checkpoints carry it under its
    flax name."""

    JAX_NAMES = {"dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, dim: int, scale: float = 16.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.freqs = nn.Parameter(torch.randn(dim // 8, generator=generator) * scale)
        self.dense1 = dense(2 * (dim // 8), dim, generator=generator)
        self.dense2 = dense(dim, dim, generator=generator)

    def forward(self, x):
        ang = x[..., None].to(torch.float32) * _two_pi_times(self.freqs.detach())
        emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
        return self.dense2(mish(self.dense1(emb)))


class UntrainableFourierEmbedding(nn.Module):
    """Random-Fourier features with no MLP: freqs ~ N(0, scale^2) of size
    dim//2, [cos | sin] of 2 pi freqs x. `freqs` is a parameter read
    through `.detach()`, as `FourierEmbedding`'s: the optimizer's decay and
    the EMA move it as they move the reference's."""

    def __init__(self, dim: int, scale: float = 16.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.freqs = nn.Parameter(torch.randn(dim // 2, generator=generator) * scale)

    def forward(self, x):
        ang = x[..., None].to(torch.float32) * _two_pi_times(self.freqs.detach())
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


SUPPORTED_TIMESTEP_EMBEDDING = {
    "positional": PositionalEmbedding,
    "fourier": FourierEmbedding,
    "untrainable_fourier": UntrainableFourierEmbedding,
}


def get_timestep_embedding(kind: str, dim: int, params: Optional[dict] = None,
                           generator: Optional[torch.Generator] = None) -> nn.Module:
    return SUPPORTED_TIMESTEP_EMBEDDING[kind](dim=dim, generator=generator, **(params or {}))

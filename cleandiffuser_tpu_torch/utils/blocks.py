"""Parameter initialisers and channels-last layers (counterpart of the
init helpers in cleandiffuser_tpu/utils/blocks.py and of the flax layers
the U-Nets use).

flax keeps a Dense kernel as (in, out); torch's `nn.Linear.weight` is
(out, in). Both give the same fan-in and fan-out, so each initialiser draws
from the distribution its flax namesake draws from. Every initialiser takes
an explicit `torch.Generator`; nothing here touches the global seed.

`Conv1d`, `GroupNorm` and `LayerNorm` work on channels-last (b, length, C)
tensors, as flax's do, and keep flax's parameter names and layouts: a conv
kernel is (K, Cin, Cout), a norm has `scale` and `bias`. So the JAX
parameters copy into them unchanged (utils/jax_params.py), and a Hopper
kernel reads the conv weights as they are stored.

Type promotion. PyTorch does not promote inside a product (`f32 @ bf16`
raises), while `jnp` and flax's `Dense` cast the operands to their common
type first (`jnp.result_type`: f32 with bf16 is f32, bf16 with bf16 is
bf16). `promote` does that for the port's layers, so a net whose params
were cast to bf16 runs as the reference's does under a bf16 cast; on f32
operands it returns them unchanged.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = [
    "xavier_uniform_init",
    "lecun_normal_init",
    "normal_init",
    "orthogonal_init",
    "zeros_init",
    "promote",
    "Dense",
    "dense",
    "conv1d",
    "group_norm",
    "Conv1d",
    "GroupNorm",
    "LayerNorm",
]

Init = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def xavier_uniform_init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    return nn.init.xavier_uniform_(w, generator=generator)


def lecun_normal_init(w: torch.Tensor, generator: Optional[torch.Generator] = None,
                      fan_in: Optional[int] = None):
    """flax's default Dense and Conv kernel init: truncated normal (±2 std)
    scaled so the variance is 1/fan_in (default: an nn.Linear weight's)."""
    if fan_in is None:
        fan_in = w.shape[1] if w.ndim == 2 else w.shape[0]
    # 0.8796... is the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def normal_init(stddev: float) -> Init:
    def init(w, generator=None):
        return nn.init.normal_(w, 0.0, stddev, generator=generator)

    return init


def orthogonal_init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    return nn.init.orthogonal_(w, generator=generator)


def zeros_init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    return nn.init.zeros_(w)


def promote(*tensors):
    """The tensors cast to their common type (`jnp.result_type`'s rule for
    floating types); no-ops where a tensor has it already."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in tensors)


class Dense(nn.Linear):
    """`nn.Linear` that promotes input, weight and bias to their common type
    before the product, as flax's `Dense` does. Below f32, flax rounds the
    product to that type and then adds the bias (two roundings), where one
    fused `linear` would round once; the f32 path keeps the fused call."""

    def forward(self, x):
        x, w, b = promote(x, self.weight, self.bias)
        if x.dtype == torch.float32:
            return F.linear(x, w, b)
        return F.linear(x, w) + b


@torch.no_grad()
def dense(in_dim: int, out_dim: int, kernel_init: Init = lecun_normal_init,
          bias_init: Init = zeros_init,
          generator: Optional[torch.Generator] = None) -> Dense:
    """`Dense` initialised as flax's `nn.Dense(out_dim, kernel_init=...)`."""
    # skip_init: no throw-away draw from the global generator
    layer = nn.utils.skip_init(Dense, in_dim, out_dim)
    kernel_init(layer.weight, generator)
    bias_init(layer.bias, generator)
    return layer


# ---------------------------------------------------------------------------
# Channels-last layers with flax's parameter layouts
def conv1d(x, kernel, bias, stride: int = 1, padding: Tuple[int, int] = (0, 0)):
    """flax `nn.Conv` on (b, L, Cin) with kernel (K, Cin, Cout): (b, L', Cout)."""
    lo, hi = padding
    xc = x.transpose(1, 2)
    if lo != hi:
        xc, lo = F.pad(xc, (lo, hi)), 0
    return F.conv1d(xc, kernel.permute(2, 1, 0), bias, stride=stride, padding=lo).transpose(1, 2)


def group_norm(x, groups: int, scale, bias, eps: float):
    """GroupNorm of (b, L, C) per sample over (L, C/groups), then the
    per-channel affine."""
    return F.group_norm(x.transpose(1, 2), groups, scale, bias, eps).transpose(1, 2)


class Conv1d(nn.Module):
    """flax `nn.Conv(out_dim, (kernel_size,), strides, padding)` on (b, L,
    Cin). `padding` is "SAME" (stride 1) or a (lo, hi) pair."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, stride: int = 1,
                 padding: Union[str, Tuple[int, int]] = "SAME",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding == "SAME":
            if stride != 1:
                raise ValueError("SAME padding is ported for stride 1 only")
            padding = ((kernel_size - 1) // 2, kernel_size // 2)
        self.stride, self.padding = stride, tuple(padding)
        w = torch.empty(kernel_size, in_dim, out_dim)
        self.kernel = nn.Parameter(lecun_normal_init(w, generator, fan_in=kernel_size * in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        return conv1d(x, self.kernel, self.bias, self.stride, self.padding)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups)` on (b, L, C); flax's eps is 1e-6."""

    def __init__(self, dim: int, groups: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return group_norm(x, self.groups, self.scale, self.bias, self.eps)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm()` over the last axis; flax's eps is 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, self.eps)

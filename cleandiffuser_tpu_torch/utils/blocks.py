"""Parameter initialisers (counterpart of the init helpers in
cleandiffuser_tpu/utils/blocks.py).

flax keeps a Dense kernel as (in, out); torch's `nn.Linear.weight` is
(out, in). Both give the same fan-in and fan-out, so each initialiser draws
from the distribution its flax namesake draws from. Every initialiser takes
an explicit `torch.Generator`; nothing here touches the global seed.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn

__all__ = [
    "xavier_uniform_init",
    "lecun_normal_init",
    "normal_init",
    "orthogonal_init",
    "zeros_init",
    "dense",
]

Init = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def xavier_uniform_init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    return nn.init.xavier_uniform_(w, generator=generator)


def lecun_normal_init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax's default Dense kernel init: truncated normal (±2 std) scaled so
    the variance is 1/fan_in."""
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


@torch.no_grad()
def dense(in_dim: int, out_dim: int, kernel_init: Init = lecun_normal_init,
          bias_init: Init = zeros_init,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """`nn.Linear` initialised as flax's `nn.Dense(out_dim, kernel_init=...)`."""
    # skip_init: no throw-away draw from the global generator
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    kernel_init(layer.weight, generator)
    bias_init(layer.bias, generator)
    return layer

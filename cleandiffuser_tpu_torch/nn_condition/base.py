"""Condition encoders (counterpart of cleandiffuser_tpu/nn_condition/base.py).

    emb = module(condition, mask=None, train=False, generator=None)

- In training, each batch element's embedding is zeroed with probability
  `dropout` (Bernoulli keep-mask drawn from `generator`): the
  classifier-free-guidance mechanism.
- At sampling time (train=False) the mask defaults to all-ones, or the
  caller-passed `mask`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.blocks import dense
from ..utils.tensors import at_least_ndim

__all__ = ["BaseNNCondition", "IdentityCondition", "MLPCondition"]


class BaseNNCondition(nn.Module):
    """Subclasses implement forward(condition, mask=None, train=False,
    generator=None)."""

    dropout: float = 0.25

    def get_mask(self, condition, mask, train: bool,
                 generator: Optional[torch.Generator] = None):
        if train:
            u = torch.rand(condition.shape[0], generator=generator, device=condition.device)
            return (u > self.dropout).to(torch.float32)
        return 1.0 if mask is None else mask

    @staticmethod
    def _apply_mask(h, m):
        return h * at_least_ndim(torch.as_tensor(m, dtype=h.dtype, device=h.device), h.ndim)


class IdentityCondition(BaseNNCondition):
    """Pass-through with condition dropout."""

    def __init__(self, dropout: float = 0.25):
        super().__init__()
        self.dropout = dropout

    def forward(self, condition, mask=None, train: bool = False, generator=None):
        return self._apply_mask(condition, self.get_mask(condition, mask, train, generator))


class MLPCondition(BaseNNCondition):
    """MLP projection with condition dropout."""

    JAX_NAMES = {"layers": "Dense_{}"}

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dims: Union[int, Sequence[int]] = (256,),
                 act: Callable = F.leaky_relu, dropout: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = (hidden_dims,) if isinstance(hidden_dims, int) else tuple(hidden_dims)
        dims = (in_dim,) + hidden + (out_dim,)
        self.layers = nn.ModuleList(
            dense(i, o, generator=generator) for i, o in zip(dims[:-1], dims[1:]))
        self.act, self.dropout = act, dropout

    def forward(self, condition, mask=None, train: bool = False, generator=None):
        m = self.get_mask(condition, mask, train, generator)
        h = condition
        for layer in self.layers[:-1]:
            h = self.act(layer(h))
        return self._apply_mask(self.layers[-1](h), m)

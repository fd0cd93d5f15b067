"""Condition encoders (counterpart of cleandiffuser_tpu/nn_condition/base.py).

    emb = module(condition, mask=None, train=False, generator=None)

- In training, each batch element's embedding is zeroed with probability
  `dropout` (Bernoulli keep-mask drawn from `generator`, which must lie on
  the condition's device): the classifier-free-guidance mechanism. With
  `dropout` 0 nothing is drawn and every element is kept. A
  caller-passed `mask` is taken as the keep-mask instead, which is how the
  tests replay the reference's draws.
- At sampling time (train=False) the mask defaults to all-ones, or the
  caller-passed `mask`.

Under `bf16_sampling` the SDE sampler casts the condition's params too (the
other samplers leave them f32, as the reference's do): its f32 input then
runs f32 math on the bf16-rounded weights (utils/blocks.py promotion).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.blocks import dense, leaky_relu
from ..utils.embeddings import _two_pi_times, mish, positional_features
from ..utils.ranks import batch_draw
from ..utils.tensors import at_least_ndim

__all__ = ["BaseNNCondition", "IdentityCondition", "LinearCondition", "MLPCondition",
           "MLPSieveObsCondition", "FourierCondition", "PositionalCondition",
           "PearceObsCondition"]


class BaseNNCondition(nn.Module):
    """Subclasses implement forward(condition, mask=None, train=False,
    generator=None)."""

    dropout: float = 0.25

    def get_mask(self, condition, mask, train: bool,
                 generator: Optional[torch.Generator] = None):
        if train and mask is None and self.dropout > 0:
            u = batch_draw(lambda s: torch.rand(s, generator=generator, device=condition.device),
                           (condition.shape[0],))
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


class LinearCondition(BaseNNCondition):
    """Affine projection with condition dropout."""

    JAX_NAMES = {"dense": "Dense_0"}

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = dense(in_dim, out_dim, generator=generator)
        self.dropout = dropout

    def forward(self, condition, mask=None, train: bool = False, generator=None):
        m = self.get_mask(condition, mask, train, generator)
        return self._apply_mask(self.dense(condition), m)


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


class PearceObsCondition(BaseNNCondition):
    """Per-frame observation MLP (Dense, leaky ReLU, Dense) of (b, To,
    obs_dim) -> (b, To, emb_dim), or (b, To * emb_dim) with `flatten`, with
    condition dropout."""

    JAX_NAMES = {"dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, obs_dim: int, emb_dim: int = 128, flatten: bool = False,
                 dropout: float = 0.25, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense1 = dense(obs_dim, emb_dim, generator=generator)
        self.dense2 = dense(emb_dim, emb_dim, generator=generator)
        self.flatten, self.dropout = flatten, dropout

    def forward(self, obs, mask=None, train: bool = False, generator=None):
        m = self.get_mask(obs, mask, train, generator)
        h = self.dense2(leaky_relu(self.dense1(obs), 0.01))
        if self.flatten:
            h = h.reshape(h.shape[0], -1)
        return self._apply_mask(h, m)


class MLPSieveObsCondition(BaseNNCondition):
    """Per-frame MLP (Dense, leaky ReLU, Dense) then flatten: (b, To, o_dim)
    -> (b, To * emb_dim), with condition dropout."""

    JAX_NAMES = {"dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, o_dim: int, emb_dim: int = 128, hidden_dim: int = 512,
                 dropout: float = 0.25, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense1 = dense(o_dim, hidden_dim, generator=generator)
        self.dense2 = dense(hidden_dim, emb_dim, generator=generator)
        self.dropout = dropout

    def forward(self, obs, mask=None, train: bool = False, generator=None):
        m = self.get_mask(obs, mask, train, generator)
        h = self.dense2(leaky_relu(self.dense1(obs), 0.01))
        return self._apply_mask(h.reshape(h.shape[0], -1), m)


class FourierCondition(BaseNNCondition):
    """Scalar condition (b, 1) -> [cos | sin] of 2 pi freqs c (freqs ~
    N(0, scale^2), hidden_dim // 2 of them) -> Dense(hidden_dim), Mish,
    Dense(out_dim), with condition dropout. `freqs` is a parameter read
    through `.detach()`, as the reference reads its flax param through
    `stop_gradient` (utils/embeddings.py `FourierEmbedding`): no gradient
    reaches it, and AdamW's decoupled decay shrinks it as it shrinks the
    reference's."""

    JAX_NAMES = {"dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, out_dim: int, hidden_dim: int, scale: float = 16.0,
                 dropout: float = 0.25, generator: Optional[torch.Generator] = None):
        super().__init__()
        half = hidden_dim // 2
        self.freqs = nn.Parameter(torch.randn(half, generator=generator) * scale)
        self.dense1 = dense(2 * half, hidden_dim, generator=generator)
        self.dense2 = dense(hidden_dim, out_dim, generator=generator)
        self.dropout = dropout

    def forward(self, condition, mask=None, train: bool = False, generator=None):
        ang = condition.squeeze(-1)[..., None] * _two_pi_times(self.freqs.detach())
        emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
        m = self.get_mask(condition, mask, train, generator)
        return self._apply_mask(self.dense2(mish(self.dense1(emb))), m)


class PositionalCondition(BaseNNCondition):
    """Scalar condition (b, 1) -> positional features of width out_dim ->
    Dense(hidden_dim), Mish, Dense(out_dim), with condition dropout."""

    JAX_NAMES = {"dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, out_dim: int, hidden_dim: int, dropout: float = 0.25,
                 max_positions: int = 10000, endpoint: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim, self.max_positions, self.endpoint = out_dim, max_positions, endpoint
        self.dense1 = dense(2 * (out_dim // 2), hidden_dim, generator=generator)
        self.dense2 = dense(hidden_dim, out_dim, generator=generator)
        self.dropout = dropout

    def forward(self, condition, mask=None, train: bool = False, generator=None):
        feats = positional_features(condition.squeeze(-1), self.out_dim, self.max_positions,
                                    self.endpoint)
        m = self.get_mask(condition, mask, train, generator)
        return self._apply_mask(self.dense2(mish(self.dense1(feats))), m)

"""MLP diffusion backbones of the diffusion policies (counterpart of
cleandiffuser_tpu/nn_diffusion/mlps.py): `DQLMlp` (DQL and EDP),
`IDQLMlp` / `NewIDQLMlp` (IDQL) and `DVInvMlp` (Diffusion Veteran's
inverse-dynamics policy, conditioned on (s, s')).

    pred = net(x, t, emb=None)                      # (b, act_dim)
    pred = net(x, t, emb, train=True, generator=g)  # IDQLMlp: dropout on

`x` is the noisy action (b, act_dim), `t` the integer noise level (b,), fed
to the timestep embedding, `emb` the observation (b, obs_dim) or None
(zeros). Children are named as flax names them (`_TimeMlp_0`, `Dense_i`,
`_LNResBlock_i`, `LayerNorm_0`), so utils/jax_params.py maps the JAX param
trees onto them. `IDQLMlp`'s dropout runs only with `train=True`, its keep
mask drawn from the explicit generator (flax's `Dropout`: keep with
probability 1 - p, kept entries scaled by 1 / (1 - p)).

`IDQLMlp` is also SynthER's backbone, over flat transitions with
`obs_dim=0`. `MlpNNDiffusion` belongs to ROADMAP queue 1, item 9 (modules no
pipeline uses).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..utils.blocks import LayerNorm, dense
from ..utils.embeddings import mish
from .base import timestep_embedding_module

__all__ = ["DQLMlp", "IDQLMlp", "NewIDQLMlp", "DVInvMlp"]


def _time_emb_names(module: nn.Module) -> dict:
    """The flax names of a backbone's time embedding and its MLP."""
    return {"time_emb": f"{type(module.time_emb).__name__}_0", "time_mlp": "_TimeMlp_0"}


class _TimeMlp(nn.Module):
    """emb -> Dense(2 emb) -> Mish -> Dense(emb)."""

    JAX_NAMES = {"dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, emb_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense1 = dense(emb_dim, 2 * emb_dim, generator=generator)
        self.dense2 = dense(2 * emb_dim, emb_dim, generator=generator)

    def forward(self, e):
        return self.dense2(mish(self.dense1(e)))


class DQLMlp(nn.Module):
    """(b, act) x (b, obs) -> (b, act): [x, time, obs] through a 3 x 256
    Mish trunk (the width is fixed, as in the reference)."""

    def __init__(self, obs_dim: int, act_dim: int, emb_dim: int = 16,
                 timestep_emb_type: str = "positional", timestep_emb_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim = obs_dim
        self.time_emb = timestep_embedding_module(emb_dim, timestep_emb_type, timestep_emb_params,
                                                  generator)
        self.time_mlp = _TimeMlp(emb_dim, generator)
        dims = (act_dim + emb_dim + obs_dim, 256, 256, 256, act_dim)
        self.layers = nn.ModuleList(
            dense(i, o, generator=generator) for i, o in zip(dims[:-1], dims[1:]))
        self.JAX_NAMES = {**_time_emb_names(self), "layers": "Dense_{}"}

    def forward(self, x, t, emb=None):
        if emb is None:
            emb = torch.zeros((x.shape[0], self.obs_dim), dtype=x.dtype, device=x.device)
        h = torch.cat([x, self.time_mlp(self.time_emb(t)), emb], dim=-1)
        for layer in self.layers[:-1]:
            h = mish(layer(h))
        return self.layers[-1](h)


class _LNResBlock(nn.Module):
    """dropout -> LayerNorm -> Dense(4h) -> Mish -> Dense(h), plus x."""

    JAX_NAMES = {"norm": "LayerNorm_0", "dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, hidden_dim: int, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.norm = LayerNorm(hidden_dim)
        self.dense1 = dense(hidden_dim, 4 * hidden_dim, generator=generator)
        self.dense2 = dense(4 * hidden_dim, hidden_dim, generator=generator)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        h = x
        if train and self.dropout > 0:
            keep_prob = 1.0 - self.dropout
            keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
            h = torch.where(keep, x / keep_prob, torch.zeros_like(x))
        return x + self.dense2(mish(self.dense1(self.norm(h))))


class IDQLMlp(nn.Module):
    """[x, time, obs] -> Dense(h) -> `n_blocks` LayerNorm residual blocks
    (with dropout in training) -> (Mish, for `final_mish`) -> Dense(act)."""

    def __init__(self, obs_dim: int, act_dim: int, emb_dim: int = 64, hidden_dim: int = 256,
                 n_blocks: int = 3, dropout: float = 0.1, timestep_emb_type: str = "positional",
                 timestep_emb_params: Optional[dict] = None, final_mish: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim, self.dropout, self.final_mish = obs_dim, dropout, final_mish
        self.time_emb = timestep_embedding_module(emb_dim, timestep_emb_type, timestep_emb_params,
                                                  generator)
        self.time_mlp = _TimeMlp(emb_dim, generator)
        self.proj = dense(act_dim + emb_dim + obs_dim, hidden_dim, generator=generator)
        self.blocks = nn.ModuleList(
            _LNResBlock(hidden_dim, dropout, generator) for _ in range(n_blocks))
        self.out = dense(hidden_dim, act_dim, generator=generator)
        self.JAX_NAMES = {**_time_emb_names(self), "proj": "Dense_0", "blocks": "_LNResBlock_{}",
                          "out": "Dense_1"}

    def forward(self, x, t, emb=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if emb is None:
            emb = torch.zeros((x.shape[0], self.obs_dim), dtype=x.dtype, device=x.device)
        h = self.proj(torch.cat([x, self.time_mlp(self.time_emb(t)), emb], dim=-1))
        for block in self.blocks:
            h = block(h, train=train, generator=generator)
        if self.final_mish:
            h = mish(h)
        return self.out(h)


def NewIDQLMlp(**kwargs) -> IDQLMlp:
    return IDQLMlp(final_mish=True, **kwargs)


class DVInvMlp(nn.Module):
    """(b, act) x (b, 2 obs) -> (b, act): [x, time, (s, s')] through three
    Mish Dense layers of `hidden_dim`. The condition is required."""

    def __init__(self, obs_dim: int, act_dim: int, emb_dim: int = 16, hidden_dim: int = 256,
                 timestep_emb_type: str = "positional", timestep_emb_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.time_emb = timestep_embedding_module(emb_dim, timestep_emb_type, timestep_emb_params,
                                                  generator)
        self.time_mlp = _TimeMlp(emb_dim, generator)
        dims = (act_dim + emb_dim + 2 * obs_dim, hidden_dim, hidden_dim, hidden_dim, act_dim)
        self.layers = nn.ModuleList(
            dense(i, o, generator=generator) for i, o in zip(dims[:-1], dims[1:]))
        self.JAX_NAMES = {**_time_emb_names(self), "layers": "Dense_{}"}

    def forward(self, x, t, emb=None):
        if emb is None:
            raise ValueError("DVInvMlp requires the (s, s') condition")
        h = torch.cat([x, self.time_mlp(self.time_emb(t)), emb], dim=-1)
        for layer in self.layers[:-1]:
            h = mish(layer(h))
        return self.layers[-1](h)

"""DiffusionBC's Pearce backbones (counterpart of
cleandiffuser_tpu/nn_diffusion/pearce.py): `PearceMlp` and
`PearceTransformer`.

    pred = net(x, t, emb)   # x (b, act_dim), emb (b, To, emb_dim) or None

`PearceMlp`: [x embedding, time embedding, flattened condition] through
three Dense-GroupNorm-GELU blocks with /1.414 residuals, the raw action and
time fed again to each. `PearceTransformer`: tokens [action, time, To
condition frames] with a sin-activated position embedding (`TimeSiren`),
four encoder blocks of multi-head attention with /1.414 residuals and a
BatchNorm over (batch, tokens) per feature, then a Dense over the flattened
tokens.

Under the engines' bf16 flags the action embedding runs bf16 (its leaky
ReLU rounded as flax's, utils/blocks.py `leaky_relu`); the position inputs
and the raw time stay f32, as the reference's (`t` cast to f32), so from the
first concatenation on everything is f32 on bf16-rounded weights.

`_TokenBatchNorm` normalises with the current batch's statistics in
training and in sampling alike: the JAX module keeps no running statistics
(a logged reference quirk, ROADMAP queue 3), and the port reproduces it.
Children carry flax's names (`Dense_i`, `FCBlock_i`, `TimeSiren_0`,
`_PearceEncoderBlock_i`, `_TokenBatchNorm_i`, `GroupNorm_0`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.blocks import dense, leaky_relu, promoted_norm
from ..utils.ranks import current_rows
from .base import timestep_embedding_module

__all__ = ["PearceMlp", "PearceTransformer", "TimeSiren", "FCBlock"]


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu


class TimeSiren(nn.Module):
    """Dense (no bias) -> sin -> Dense."""

    JAX_NAMES = {"dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, emb_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense1 = dense(1, emb_dim, generator=generator)
        self.dense1.bias = None
        self.dense2 = dense(emb_dim, emb_dim, generator=generator)

    def forward(self, x):
        return self.dense2(torch.sin(self.dense1(x)))


class _GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups)` over the features of (b, C)."""

    def __init__(self, dim: int, groups: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return promoted_norm(lambda x, s, b: F.group_norm(x, self.groups, s, b, self.eps),
                             x, self.scale, self.bias)


class FCBlock(nn.Module):
    """Dense -> GroupNorm(min(8, out // 4)) -> GELU."""

    JAX_NAMES = {"dense": "Dense_0", "norm": "GroupNorm_0"}

    def __init__(self, in_feats: int, out_feats: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = dense(in_feats, out_feats, generator=generator)
        self.norm = _GroupNorm(out_feats, min(8, out_feats // 4))

    def forward(self, x):
        return _gelu(self.norm(self.dense(x)))


class PearceMlp(nn.Module):
    """(b, act) x (b, To, emb) -> (b, act); /1.414 residual FC stack."""

    def __init__(self, act_dim: int, To: int = 1, emb_dim: int = 128, hidden_dim: int = 512,
                 timestep_emb_type: str = "positional",
                 timestep_emb_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.To, self.emb_dim = To, emb_dim
        self.x_dense1 = dense(act_dim, emb_dim, generator=g)
        self.x_dense2 = dense(emb_dim, emb_dim, generator=g)
        self.t_emb = timestep_embedding_module(emb_dim, timestep_emb_type, timestep_emb_params,
                                               g)
        self.fc = nn.ModuleList([
            FCBlock(2 * emb_dim + To * emb_dim, hidden_dim, g),
            FCBlock(hidden_dim + act_dim + 1, hidden_dim, g),
            FCBlock(hidden_dim + act_dim + 1, hidden_dim, g)])
        self.out = dense(hidden_dim + act_dim + 1, act_dim, generator=g)
        self.JAX_NAMES = {"x_dense1": "Dense_0", "x_dense2": "Dense_1",
                          "t_emb": f"{type(self.t_emb).__name__}_0", "fc": "FCBlock_{}",
                          "out": "Dense_2"}

    def forward(self, x, t, emb=None):
        x_e = self.x_dense2(leaky_relu(self.x_dense1(x), 0.01))
        t_e = self.t_emb(t)
        t_raw = t[:, None].to(torch.float32)
        if emb is None:
            emb = torch.zeros((x.shape[0], self.To, self.emb_dim), dtype=x.dtype,
                              device=x.device)
        nn1 = self.fc[0](torch.cat([x_e, t_e, emb.reshape(emb.shape[0], -1)], dim=-1))
        nn2 = self.fc[1](torch.cat([nn1 / 1.414, x, t_raw], dim=-1)) + nn1 / 1.414
        nn3 = self.fc[2](torch.cat([nn2 / 1.414, x, t_raw], dim=-1)) + nn2 / 1.414
        return self.out(torch.cat([nn3, x, t_raw], dim=-1))


class _TokenBatchNorm(nn.Module):
    """BatchNorm over (batch, tokens) per feature, batch statistics only."""

    def __init__(self, feats: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(feats))
        self.bias = nn.Parameter(torch.zeros(feats))

    def forward(self, x):
        if current_rows() is not None:
            # the rank's rows alone would give other statistics than the
            # global batch's
            raise NotImplementedError("batch statistics of a batch split over ranks")
        mean = x.mean(dim=(0, 1), keepdim=True)
        var = x.var(dim=(0, 1), keepdim=True, unbiased=False)
        return (x - mean) / torch.sqrt(var + 1e-5) * self.scale + self.bias


class _PearceEncoderBlock(nn.Module):
    """Multi-head attention (one fused qkv Dense), /1.414 residuals, token
    BatchNorm, a 4x GELU MLP."""

    JAX_NAMES = {"qkv": "Dense_0", "attn_out": "Dense_1", "proj": "Dense_2", "bn1":
                 "_TokenBatchNorm_0", "mlp1": "Dense_3", "mlp2": "Dense_4",
                 "bn2": "_TokenBatchNorm_1"}

    def __init__(self, trans_emb_dim: int, transformer_dim: int, nheads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.nheads, self.transformer_dim = nheads, transformer_dim
        self.qkv = dense(trans_emb_dim, 3 * transformer_dim, generator=g)
        self.attn_out = dense(transformer_dim, transformer_dim, generator=g)
        self.proj = dense(transformer_dim, trans_emb_dim, generator=g)
        self.bn1 = _TokenBatchNorm(trans_emb_dim)
        self.mlp1 = dense(trans_emb_dim, 4 * trans_emb_dim, generator=g)
        self.mlp2 = dense(4 * trans_emb_dim, trans_emb_dim, generator=g)
        self.bn2 = _TokenBatchNorm(trans_emb_dim)

    def forward(self, f):
        b, n, _ = f.shape
        d_head = self.transformer_dim // self.nheads
        q, k, v = (z.reshape(b, n, self.nheads, d_head) for z in self.qkv(f).chunk(3, dim=-1))
        scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(d_head)
        out = torch.einsum("bhij,bjhd->bihd", torch.softmax(scores, dim=-1), v)
        out = self.attn_out(out.reshape(b, n, self.transformer_dim))
        h = self.bn1(self.proj(out) / 1.414 + f / 1.414)
        h2 = self.mlp2(_gelu(self.mlp1(h)))
        return self.bn2(h2 / 1.414 + h / 1.414)


class PearceTransformer(nn.Module):
    """(b, act) x (b, To, emb) -> (b, act); tokens = [act, t, cond frames]."""

    def __init__(self, act_dim: int, To: int = 1, emb_dim: int = 128, trans_emb_dim: int = 64,
                 nhead: int = 16, timestep_emb_type: str = "positional",
                 timestep_emb_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.To, self.emb_dim = To, emb_dim
        self.x_dense1 = dense(act_dim, emb_dim, generator=g)
        self.x_dense2 = dense(emb_dim, emb_dim, generator=g)
        self.t_emb = timestep_embedding_module(emb_dim, timestep_emb_type, timestep_emb_params,
                                               g)
        self.x_in = dense(emb_dim, trans_emb_dim, generator=g)
        self.t_in = dense(emb_dim, trans_emb_dim, generator=g)
        self.c_in = dense(emb_dim, trans_emb_dim, generator=g)
        self.pos = TimeSiren(trans_emb_dim, g)
        self.blocks = nn.ModuleList(
            _PearceEncoderBlock(trans_emb_dim, trans_emb_dim * nhead, nhead, g)
            for _ in range(4))
        self.out = dense((2 + To) * trans_emb_dim, act_dim, generator=g)
        self.JAX_NAMES = {"x_dense1": "Dense_0", "x_dense2": "Dense_1",
                          "t_emb": f"{type(self.t_emb).__name__}_0", "x_in": "Dense_2",
                          "t_in": "Dense_3", "c_in": "Dense_4", "pos": "TimeSiren_0",
                          "blocks": "_PearceEncoderBlock_{}", "out": "Dense_5"}

    def forward(self, x, t, emb=None):
        if emb is None:
            emb = torch.zeros((x.shape[0], self.To, self.emb_dim), dtype=x.dtype,
                              device=x.device)
        x_e = self.x_dense2(leaky_relu(self.x_dense1(x), 0.01))
        t_e = self.t_emb(t)
        # the reference's position inputs are float32 (float64 where x is):
        # under a bf16 cast the positions stay f32 on bf16-rounded weights
        pos_dtype = torch.promote_types(x.dtype, torch.float32)
        one = torch.ones((1, 1), dtype=pos_dtype, device=x.device)
        x_in = self.x_in(x_e) + self.pos(one)
        t_in = self.t_in(t_e) + self.pos(one * 2.0)
        frames = torch.arange(3, 3 + self.To, dtype=pos_dtype, device=x.device)
        c_in = self.c_in(emb) + self.pos(frames[None, :, None])
        f = torch.cat([x_in[:, None], t_in[:, None], c_in], dim=1)
        for block in self.blocks:
            f = block(f)
        return self.out(f.reshape(f.shape[0], -1))

"""Chi U-Net 1d, Diffusion Policy's convolutional backbone (counterpart of
cleandiffuser_tpu/nn_diffusion/chiunet.py), channels-last.

    pred = net(x, t, emb)   # x (b, Ta, act_dim), emb (b, To, obs_dim) or None

FiLM conditioning with an optional predicted scale (`cond_predict_scale`);
the observation window is either a global condition (flattened, projected
to `emb_dim` and concatenated with the time embedding) or a local one
added at the first down and the last up stage. The residual block is the
module's own (GroupNorm with min(8, C // 4) groups at flax's eps 1e-6, FiLM
scale and bias): it is not the Janner block, so no kernel runs here.

Under the engines' bf16 flags (bf16 params, x and the condition cast to
bf16, t f32) the layers promote as flax's do (utils/blocks.py): the first
block's conv, norm and Mish run bf16, its FiLM term (from the f32 time
embedding) makes the rest f32 on bf16-rounded weights, as in the reference.

Children carry flax's names (`ChiResidualBlock_i` in the order the JAX
module creates them, `Downsample1d_i`, `Upsample1d_i`, `Dense_i`, `Conv_i`,
`GroupNorm_0`), so utils/jax_params.py maps the JAX param tree onto them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..utils.blocks import Conv1d, GroupNorm, dense
from ..utils.embeddings import mish
from .base import timestep_embedding_module
from .jannerunet import Downsample1d, Upsample1d

__all__ = ["ChiResidualBlock", "ChiUNet1d"]


def _groups(dim: int) -> int:
    return min(8, dim // 4)


class ChiResidualBlock(nn.Module):
    """Conv-GN-Mish, FiLM (scale * h + bias, or h + bias), Conv-GN-Mish,
    plus the input (through a 1-wide conv when the widths differ)."""

    def __init__(self, in_dim: int, out_dim: int, cond_dim: int, kernel_size: int = 3,
                 cond_predict_scale: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cond_predict_scale = cond_predict_scale
        self.conv1 = Conv1d(in_dim, out_dim, kernel_size, generator=generator)
        self.norm1 = GroupNorm(out_dim, _groups(out_dim))
        self.film = dense(cond_dim, 2 * out_dim if cond_predict_scale else out_dim,
                          generator=generator)
        self.conv2 = Conv1d(out_dim, out_dim, kernel_size, generator=generator)
        self.norm2 = GroupNorm(out_dim, _groups(out_dim))
        self.skip = Conv1d(in_dim, out_dim, 1, generator=generator) if in_dim != out_dim else None
        self.JAX_NAMES = {"conv1": "Conv_0", "norm1": "GroupNorm_0", "film": "Dense_0",
                          "conv2": "Conv_1", "norm2": "GroupNorm_1", "skip": "Conv_2"}

    def forward(self, x, emb):
        h = mish(self.norm1(self.conv1(x)))
        e = self.film(mish(emb))
        if self.cond_predict_scale:
            scale, bias = e.chunk(2, dim=-1)
            h = scale[:, None, :] * h + bias[:, None, :]
        else:
            h = h + e[:, None, :]
        h = mish(self.norm2(self.conv2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class ChiUNet1d(nn.Module):
    """(b, Ta, act_dim) x (b, To, obs_dim) -> (b, Ta, act_dim); Ta a power of 2."""

    def __init__(self, act_dim: int, obs_dim: int, To: int, model_dim: int = 256,
                 emb_dim: int = 256, kernel_size: int = 5, cond_predict_scale: bool = True,
                 obs_as_global_cond: bool = True, dim_mult: Sequence[int] = (1, 2, 2),
                 timestep_emb_type: str = "positional",
                 timestep_emb_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act_dim, self.obs_dim, self.To = act_dim, obs_dim, To
        self.obs_as_global_cond = obs_as_global_cond
        g = generator
        self.t_emb = timestep_embedding_module(emb_dim, timestep_emb_type, timestep_emb_params,
                                               g)
        self.t_dense1 = dense(emb_dim, 4 * emb_dim, generator=g)
        self.t_dense2 = dense(4 * emb_dim, emb_dim, generator=g)
        names = {"t_emb": f"{type(self.t_emb).__name__}_0", "t_dense1": "Dense_0",
                 "t_dense2": "Dense_1", "blocks": "ChiResidualBlock_{}",
                 "downs": "Downsample1d_{}", "ups": "Upsample1d_{}", "final_conv": "Conv_0",
                 "final_norm": "GroupNorm_0", "out": "Conv_1"}
        if obs_as_global_cond:
            self.cond_proj = dense(To * obs_dim, emb_dim, generator=g)
            names["cond_proj"] = "Dense_2"
            cond_dim = 2 * emb_dim
        else:
            cond_dim = emb_dim

        block = lambda i, o: ChiResidualBlock(i, o, cond_dim, kernel_size, cond_predict_scale, g)
        # every residual block in the order the JAX module creates them, so
        # list index i is flax's ChiResidualBlock_i
        blocks, downs, ups = [], [], []
        if not obs_as_global_cond:
            blocks += [block(obs_dim, model_dim), block(obs_dim, model_dim)]
            downs.append(Downsample1d(model_dim, g))
        dims = [act_dim] + [model_dim * int(m) for m in np.cumprod(dim_mult)]
        in_out = list(zip(dims[:-1], dims[1:]))
        for ind, (d_in, d_out) in enumerate(in_out):
            blocks += [block(d_in, d_out), block(d_out, d_out)]
            if ind < len(in_out) - 1:
                downs.append(Downsample1d(d_out, g))
        blocks += [block(dims[-1], dims[-1]), block(dims[-1], dims[-1])]
        for d_in, d_out in reversed(in_out[1:]):
            blocks += [block(2 * d_out, d_in), block(d_in, d_in)]
            ups.append(Upsample1d(d_in, g))
        self.n_levels = len(in_out)
        self.blocks = nn.ModuleList(blocks)
        self.downs, self.ups = nn.ModuleList(downs), nn.ModuleList(ups)
        self.final_conv = Conv1d(model_dim, model_dim, kernel_size, generator=g)
        self.final_norm = GroupNorm(model_dim, _groups(model_dim))
        self.out = Conv1d(model_dim, act_dim, 1, generator=g)
        self.JAX_NAMES = names

    def forward(self, x, t, emb=None):
        if x.shape[1] & (x.shape[1] - 1):
            raise ValueError(f"Ta dimension must be 2^n, got {x.shape[1]}")
        te = self.t_dense2(mish(self.t_dense1(self.t_emb(t))))
        blocks, downs = iter(self.blocks), iter(self.downs)
        h_local = None
        if self.obs_as_global_cond:
            if emb is None:
                emb = torch.zeros((x.shape[0], self.To, self.obs_dim), dtype=x.dtype,
                                  device=x.device)
            te = torch.cat([te, self.cond_proj(emb.reshape(emb.shape[0], -1))], dim=-1)
        else:
            if emb is None:
                emb = torch.zeros((x.shape[0], x.shape[1], self.obs_dim), dtype=x.dtype,
                                  device=x.device)
            if emb.shape[1] != x.shape[1]:
                raise ValueError("local cond must align with Ta")
            first = next(blocks)(emb, te)
            h_local = [first, next(downs)(next(blocks)(emb, te))]

        h_stack = []
        for ind in range(self.n_levels):
            x = next(blocks)(x, te)
            if ind == 0 and h_local is not None:
                x = x + h_local[0]
            x = next(blocks)(x, te)
            h_stack.append(x)
            if ind < self.n_levels - 1:
                x = next(downs)(x)
        x = next(blocks)(x, te)
        x = next(blocks)(x, te)
        for ind, up in enumerate(self.ups):
            x = next(blocks)(torch.cat([x, h_stack.pop()], dim=-1), te)
            if ind == len(self.ups) - 1 and h_local is not None:
                x = x + h_local[1]
            x = up(next(blocks)(x, te))
        x = mish(self.final_norm(self.final_conv(x)))
        return self.out(x)

"""SfBC's dense U-Net (counterpart of cleandiffuser_tpu/nn_diffusion/sfbc_unet.py).

    pred = net(x, t, emb=None)   # x (b, act_dim) or (b, H, act_dim)

The timestep's untrainable Fourier features go through Dense -> SiLU ->
Dense to a condition c (plus the condition embedding `emb`, if any). Dense
residual blocks (Dense -> SiLU, + Dense(c), Dense -> SiLU, plus the input,
through a Dense when the widths differ) go down `hidden_dims`, one more
block stays at the last width, and the up path concatenates the down
path's outputs before each block. Children carry the flax names
(`Dense_i`, `_DenseResBlock_i`), so utils/jax_params.py maps the JAX
params onto them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.blocks import dense
from .base import timestep_embedding_module

__all__ = ["SfBCUNet"]


class _DenseResBlock(nn.Module):
    JAX_NAMES = {"dense1": "Dense_0", "cond": "Dense_1", "dense2": "Dense_2", "skip": "Dense_3"}

    def __init__(self, in_dim: int, out_dim: int, cond_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense1 = dense(in_dim, out_dim, generator=generator)
        self.cond = dense(cond_dim, out_dim, generator=generator)
        self.dense2 = dense(out_dim, out_dim, generator=generator)
        self.skip = dense(in_dim, out_dim, generator=generator) if in_dim != out_dim else None

    def forward(self, x, c):
        h = F.silu(self.dense1(x)) + self.cond(c)
        h = F.silu(self.dense2(h))
        return h + (self.skip(x) if self.skip is not None else x)


class SfBCUNet(nn.Module):
    def __init__(self, act_dim: int, emb_dim: int = 64,
                 hidden_dims: Sequence[int] = (512, 256, 128),
                 timestep_emb_type: str = "untrainable_fourier",
                 timestep_emb_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = list(hidden_dims)
        self.n_down = len(hidden)
        self.time_emb = timestep_embedding_module(emb_dim, timestep_emb_type, timestep_emb_params,
                                                  generator)
        self.cond1 = dense(emb_dim, emb_dim, generator=generator)
        self.cond2 = dense(emb_dim, emb_dim, generator=generator)
        widths = [(act_dim, hidden[0])] + list(zip(hidden[:-1], hidden[1:]))
        widths.append((hidden[-1], hidden[-1]))
        w = hidden[-1]
        for i in range(len(hidden) - 1):
            widths.append((w + hidden[-1 - i], hidden[-2 - i]))
            w = hidden[-2 - i]
        self.blocks = nn.ModuleList(_DenseResBlock(i, o, emb_dim, generator) for i, o in widths)
        self.out = dense(w, act_dim, generator=generator)
        self.JAX_NAMES = {"time_emb": f"{type(self.time_emb).__name__}_0", "cond1": "Dense_0",
                          "cond2": "Dense_1", "blocks": "_DenseResBlock_{}", "out": "Dense_2"}

    def forward(self, x, t, emb=None):
        c = self.cond2(F.silu(self.cond1(self.time_emb(t))))
        if emb is not None:
            c = c + emb
        c = c[:, None, :] if x.ndim == 3 else c
        buffer, h = [], x
        for block in self.blocks[:self.n_down]:
            h = block(h, c)
            buffer.append(h)
        h = self.blocks[self.n_down](h, c)
        for block in self.blocks[self.n_down + 1:]:
            h = block(torch.cat([h, buffer.pop()], dim=-1), c)
        return self.out(h)

"""Trajectory classifier heads (counterpart of
cleandiffuser_tpu/nn_classifier/half_nets.py): `HalfJannerUNet1d`, the
down half of the Janner U-Net and an MLP, and `HalfDiT1d` (no pipeline
uses it), a DiT trunk, mean-pooled, through a LayerNorm / SiLU / Dense
head. Each maps (b, H, in_dim) x (b,) [x cond] -> (b, out_dim), e.g. a
trajectory-return prediction for classifier guidance.

The classifier is differentiated with respect to its input at every
sampler step. With `use_pallas_block=True` the ten residual blocks of
`HalfJannerUNet1d` run through `film_resblock_vjp_op`
(ops/film_resblock_vjp.py): where only x needs a gradient, a forward
kernel that keeps residuals and an input-gradient kernel on a CUDA tensor
(their plain versions on a CPU tensor); under no_grad the forward kernel
alone; and where a parameter needs a gradient (the classifier's training)
the plain block, as without the flag. The U-Net's K3 takes no part: it
has no backward kernel. `HalfDiT1d`'s blocks always take the plain path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn_diffusion.base import timestep_embedding_module
from ..nn_diffusion.dit import DiTBlock, FinalLayer1d
from ..nn_diffusion.jannerunet import Downsample1d, ResidualBlock1d
from ..utils.blocks import LayerNorm, dense, normal_init, xavier_uniform_init
from ..utils.embeddings import mish, sinusoidal_features
from .mlp import BaseNNClassifier

__all__ = ["HalfJannerUNet1d", "HalfDiT1d"]


class HalfJannerUNet1d(BaseNNClassifier):
    """Down-half of JannerUNet + MLP head -> (b, out_dim)."""

    def __init__(
        self,
        horizon: int,
        in_dim: int,
        out_dim: int = 1,
        kernel_size: int = 3,
        model_dim: int = 32,
        emb_dim: int = 32,
        dim_mult: Sequence[int] = (1, 2, 2, 2),
        timestep_emb_type: str = "positional",
        norm_type: str = "groupnorm",
        use_pallas_block: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = generator
        self.t_emb = timestep_embedding_module(emb_dim, timestep_emb_type, None, g)
        self.t_dense1 = dense(emb_dim, model_dim * 4, generator=g)
        self.t_dense2 = dense(model_dim * 4, model_dim, generator=g)

        dims = [in_dim] + [model_dim * int(m) for m in np.cumprod(dim_mult)]
        in_out = list(zip(dims[:-1], dims[1:]))
        block = lambda i, o, ks=kernel_size: ResidualBlock1d(
            i, o, model_dim, ks, norm_type, generator=g, vjp_kernel=use_pallas_block)
        blocks, downs = [], []
        for ind, (dim_in, dim_out) in enumerate(in_out):
            blocks += [block(dim_in, dim_out), block(dim_out, dim_out)]
            if ind < len(in_out) - 1:
                downs.append(Downsample1d(dim_out, g))
                horizon //= 2
        mid = dims[-1]
        mid_2, mid_3 = mid // 2, mid // 4
        blocks.append(block(mid, mid_2, 5))
        downs.append(Downsample1d(mid_2, g))
        blocks.append(block(mid_2, mid_3, 5))
        downs.append(Downsample1d(mid_3, g))
        horizon //= 4
        self.n_levels = len(in_out)
        self.blocks = nn.ModuleList(blocks)
        self.downs = nn.ModuleList(downs)
        fc_dim = mid_3 * max(horizon, 1)
        self.head1 = dense(fc_dim + model_dim, fc_dim // 2, generator=g)
        self.head2 = dense(fc_dim // 2, out_dim, generator=g)
        self.JAX_NAMES = {
            "t_emb": f"{type(self.t_emb).__name__}_0", "t_dense1": "Dense_0",
            "t_dense2": "Dense_1", "blocks": "ResidualBlock1d_{}",
            "downs": "Downsample1d_{}", "head1": "Dense_2", "head2": "Dense_3",
        }

    def forward(self, x, t, y=None):
        te = self.t_emb(t)
        if y is not None:
            te = te + y
        te = self.t_dense2(mish(self.t_dense1(te)))
        blocks, downs = iter(self.blocks), iter(self.downs)
        for ind in range(self.n_levels):
            x = next(blocks)(x, te)
            x = next(blocks)(x, te)
            if ind < self.n_levels - 1:
                x = next(downs)(x)
        for _ in range(2):
            x = next(downs)(next(blocks)(x, te))
        # channels-last flatten, as the JAX head's Dense expects
        h = torch.cat([x.reshape(x.shape[0], -1), te], dim=-1)
        return self.head2(mish(self.head1(h)))


class HalfDiT1d(BaseNNClassifier):
    """DiT trunk (plain `DiTBlock`s) -> FinalLayer1d to d_model // 2 ->
    mean over the horizon -> LayerNorm, SiLU, Dense(d_model // 4),
    LayerNorm, SiLU, Dense(out_dim)."""

    def __init__(self, in_dim: int, out_dim: int, emb_dim: int, d_model: int = 384,
                 n_heads: int = 6, depth: int = 12, timestep_emb_type: str = "positional",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.d_model = d_model
        self.x_proj = dense(in_dim, d_model, xavier_uniform_init, generator=g)
        self.t_emb = timestep_embedding_module(emb_dim, timestep_emb_type, None, g)
        self.t_dense1 = dense(emb_dim, d_model, normal_init(0.02), generator=g)
        self.t_dense2 = dense(d_model, d_model, normal_init(0.02), generator=g)
        self.blocks = nn.ModuleList(DiTBlock(d_model, n_heads, False, g) for _ in range(depth))
        self.final = FinalLayer1d(d_model, d_model // 2, g)
        self.norm1 = LayerNorm(d_model // 2)
        self.head1 = dense(d_model // 2, d_model // 4, generator=g)
        self.norm2 = LayerNorm(d_model // 4)
        self.head2 = dense(d_model // 4, out_dim, generator=g)
        self.JAX_NAMES = {
            "x_proj": "Dense_0", "t_emb": f"{type(self.t_emb).__name__}_0",
            "t_dense1": "Dense_1", "t_dense2": "Dense_2", "blocks": "PallasDiTBlock_{}",
            "final": "FinalLayer1d_0", "norm1": "LayerNorm_0", "head1": "Dense_3",
            "norm2": "LayerNorm_1", "head2": "Dense_4",
        }

    def forward(self, x, t, y=None):
        pos = sinusoidal_features(torch.arange(x.shape[1], device=x.device), self.d_model)
        x = self.x_proj(x) + pos[None]
        te = self.t_emb(t)
        if y is not None:
            te = te + y
        te = mish(self.t_dense2(mish(self.t_dense1(te))))
        for block in self.blocks:
            x = block(x, te)
        h = F.silu(self.norm1(self.final(x, te).mean(dim=1)))
        return self.head2(F.silu(self.norm2(self.head1(h))))

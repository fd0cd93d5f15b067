"""DiT1d — adaLN-Zero diffusion transformer (counterpart of
cleandiffuser_tpu/nn_diffusion/dit.py).

The block keeps the flat parameter layout of the reference's
`PallasDiTBlock` (wmod, bmod, wqkv, bqkv, wo, bo, w1, b1, w2, b2), in the
JAX `(in, out)` orientation, so the fused kernel (ops/dit_block.py) reads
the weights as they are stored. The adaLN modulation and the final layer
are zero-initialised: a freshly built net outputs exactly 0 and every block
is the identity.

`DiT1Ref` (no pipeline uses it) splits its input's channels into a
reference trajectory and the trajectory to denoise, projects both with one
`x_proj`, and in each block runs cross-attention from the trajectory to the
reference (`_MultiHeadAttention`, flax's `MultiHeadDotProductAttention`
with xavier kernels) before a plain `DiTBlock`; the output carries the
reference half through unchanged. No config turns a fused block on there,
as in the reference, so it launches no kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dit_block import dit_block_op, dit_block_reference
from ..utils.blocks import (
    _MultiHeadAttention,
    dense,
    normal_init,
    promote,
    xavier_uniform_init,
    zeros_init,
)
from ..utils.embeddings import mish, sinusoidal_features
from .base import timestep_embedding_module

__all__ = ["DiT1d", "DiT1Ref", "DiTBlock", "FinalLayer1d", "modulate"]


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


class DiTBlock(nn.Module):
    """adaLN-Zero block. With `use_kernel` it runs through `dit_block_op`
    (the Hopper kernel for a CUDA tensor, which raises on a shape it does
    not take; the plain version for a CPU tensor); without, through the
    plain version. The modulation
    `mod = silu(t) @ wmod + bmod` is computed here, outside the kernel."""

    def __init__(self, hidden_size: int, n_heads: int, use_kernel: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D = hidden_size
        self.n_heads, self.use_kernel = n_heads, use_kernel

        def param(init, *shape):
            return nn.Parameter(init(torch.empty(shape), generator))

        self.wmod = param(zeros_init, D, 6 * D)
        self.bmod = param(zeros_init, 6 * D)
        self.wqkv = param(xavier_uniform_init, D, 3 * D)
        self.bqkv = param(zeros_init, 3 * D)
        self.wo = param(xavier_uniform_init, D, D)
        self.bo = param(zeros_init, D)
        self.w1 = param(xavier_uniform_init, D, 4 * D)
        self.b1 = param(zeros_init, 4 * D)
        self.w2 = param(xavier_uniform_init, 4 * D, D)
        self.b2 = param(zeros_init, D)

    def forward(self, x, t):
        st, wmod, bmod = promote(F.silu(t), self.wmod, self.bmod)
        mod = st @ wmod + bmod
        args = (x, mod, self.wqkv, self.bqkv, self.wo, self.bo,
                self.w1, self.b1, self.w2, self.b2)
        if self.use_kernel:
            return dit_block_op(*args, n_heads=self.n_heads)
        return dit_block_reference(*args, n_heads=self.n_heads)


class FinalLayer1d(nn.Module):
    """Zero-init adaLN final projection."""

    JAX_NAMES = {"mod": "Dense_0", "out": "Dense_1"}

    def __init__(self, hidden_size: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mod = dense(hidden_size, 2 * hidden_size, zeros_init, zeros_init, generator)
        self.out = dense(hidden_size, out_dim, zeros_init, zeros_init, generator)

    def forward(self, x, t):
        shift, scale = self.mod(F.silu(t)).chunk(2, dim=-1)
        x = modulate(F.layer_norm(x, x.shape[-1:], eps=1e-6), shift, scale)
        return self.out(x)


class DiT1d(nn.Module):
    """(b, H, in_dim) -> (b, H, in_dim)."""

    def __init__(
        self,
        in_dim: int,
        emb_dim: int,
        d_model: int = 384,
        n_heads: int = 6,
        depth: int = 12,
        timestep_emb_type: str = "positional",
        timestep_emb_params: Optional[dict] = None,
        use_pallas_block: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.d_model = d_model
        self.x_proj = dense(in_dim, d_model, xavier_uniform_init, generator=generator)
        self.t_emb = timestep_embedding_module(emb_dim, timestep_emb_type,
                                               timestep_emb_params, generator)
        self.t_dense1 = dense(emb_dim, d_model, normal_init(0.02), generator=generator)
        self.t_dense2 = dense(d_model, d_model, normal_init(0.02), generator=generator)
        self.blocks = nn.ModuleList(
            DiTBlock(d_model, n_heads, use_pallas_block, generator) for _ in range(depth))
        self.final = FinalLayer1d(d_model, in_dim, generator)
        # flax names (utils/jax_params.py); blocks load from either layout
        self.JAX_NAMES = {
            "x_proj": "Dense_0", "t_emb": f"{type(self.t_emb).__name__}_0",
            "t_dense1": "Dense_1", "t_dense2": "Dense_2",
            "blocks": "PallasDiTBlock_{}", "final": "FinalLayer1d_0",
        }

    def map_t(self, t, emb):
        te = self.t_emb(t)
        if emb is not None:
            te = te + emb
        return mish(self.t_dense2(mish(self.t_dense1(te))))

    def forward(self, x, t, emb=None):
        pos = sinusoidal_features(torch.arange(x.shape[1], device=x.device), self.d_model)
        x = self.x_proj(x) + pos[None]
        te = self.map_t(t, emb)
        for block in self.blocks:
            x = block(x, te)
        return self.final(x, te)


class DiT1Ref(nn.Module):
    """(b, H, 2 in_dim) -> (b, H, 2 in_dim): the first in_dim channels are
    the reference trajectory, passed through; the rest are denoised with
    cross-attention to the reference in every block (module note)."""

    def __init__(
        self,
        in_dim: int,
        emb_dim: int,
        d_model: int = 384,
        n_heads: int = 6,
        depth: int = 12,
        timestep_emb_type: str = "positional",
        timestep_emb_params: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = generator
        self.d_model = d_model
        self.x_proj = dense(in_dim, d_model, xavier_uniform_init, generator=g)
        self.t_emb = timestep_embedding_module(emb_dim, timestep_emb_type,
                                               timestep_emb_params, g)
        self.t_dense1 = dense(emb_dim, d_model, normal_init(0.02), generator=g)
        self.t_dense2 = dense(d_model, d_model, normal_init(0.02), generator=g)
        self.attns = nn.ModuleList(
            _MultiHeadAttention(d_model, n_heads, g, kernel_init=xavier_uniform_init)
            for _ in range(depth))
        self.blocks = nn.ModuleList(DiTBlock(d_model, n_heads, False, g) for _ in range(depth))
        self.final = FinalLayer1d(d_model, in_dim, g)
        # flax names: x_proj is named there, so the time MLP is Dense_0, Dense_1
        self.JAX_NAMES = {
            "t_emb": f"{type(self.t_emb).__name__}_0", "t_dense1": "Dense_0",
            "t_dense2": "Dense_1", "attns": "MultiHeadDotProductAttention_{}",
            "blocks": "PallasDiTBlock_{}", "final": "FinalLayer1d_0",
        }

    def forward(self, x, t, emb=None):
        pos = sinusoidal_features(torch.arange(x.shape[1], device=x.device), self.d_model)
        x_ref, x_main = x.chunk(2, dim=-1)
        ref = self.x_proj(x_ref) + pos[None]
        h = self.x_proj(x_main) + pos[None]
        te = self.t_emb(t)
        if emb is not None:
            te = te + emb
        te = mish(self.t_dense2(mish(self.t_dense1(te))))
        for attn, block in zip(self.attns, self.blocks):
            h = block(attn(h, kv=ref), te)
        return torch.cat([x_ref, self.final(h, te)], dim=-1)

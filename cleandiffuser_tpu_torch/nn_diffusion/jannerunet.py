"""Janner U-Net 1d, channels-last (counterpart of
cleandiffuser_tpu/nn_diffusion/jannerunet.py).

Everything stays (b, horizon, dim), as in the JAX module: the classifier's
half U-Net flattens (b, H', C) into a Dense, and a channels-first tensor
would permute that Dense's inputs without any error. Convs and norms are
the channels-last layers of utils/blocks.py, which keep flax's parameter
layouts; the transposed conv of `Upsample1d` is a torch `ConvTranspose1d`,
whose kernel the converter flips (utils/jax_params.py).

With `use_pallas_block=True` (the name DiT1d uses for the same switch)
every `ResidualBlock1d` runs through `film_resblock_op`: the fused Hopper
kernel for a CUDA tensor, the plain version for a CPU tensor. The FiLM
projection `Dense(mish(emb))` stays a torch op in front of it.

bf16 (the engines' `bf16_sampling` / `bf16_training`: x and the condition
embedding cast to bf16, t f32, the params a bf16 copy): every layer
promotes as flax's does (utils/blocks.py). So the time embedding and its
MLP stay f32 on bf16-rounded weights; the first block runs its first conv,
norm and Mish and its skip in bf16, and its FiLM add (f32 + bf16) returns
f32; from there on every activation is f32 on bf16-rounded weights, as in
the reference. A fused block with bf16 weights runs the kernel's BF16 route
(`ops/film_resblock.py`), never the f32 one and never the plain block.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.film_resblock import film_resblock_op
from ..ops.film_resblock_vjp import film_resblock_vjp_op
from ..utils.blocks import (Conv1d, Dense, GroupNorm, LayerNorm, below_f32, dense,
                            lecun_normal_init, promote)
from ..utils.embeddings import mish
from .base import timestep_embedding_module

__all__ = ["get_norm", "JannerUNet1d", "ResidualBlock1d", "LinearAttention", "Downsample1d",
           "Upsample1d"]


def get_norm(dim: int, norm_type: str) -> nn.Module:
    if norm_type == "groupnorm":
        return GroupNorm(dim, min(8, dim // 4))
    if norm_type == "layernorm":
        return LayerNorm(dim)
    return nn.Identity()


def _flax_names(**children) -> dict:
    """JAX_NAMES for children numbered by type, as flax numbers them:
    children given in flax's creation order, attribute -> module."""
    names, seen = {}, {}
    for attr, module in children.items():
        kind = {Conv1d: "Conv", nn.Linear: "Dense"}.get(type(module), type(module).__name__)
        names[attr] = f"{kind}_{seen.get(kind, 0)}"
        seen[kind] = seen.get(kind, 0) + 1
    return names


class Downsample1d(nn.Module):
    """Stride-2 conv halving the horizon: flax `Conv(dim, (3,), strides=2,
    padding=((1, 1),))`."""

    JAX_NAMES = {"conv": "Conv_0"}

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv1d(dim, dim, 3, stride=2, padding=(1, 1), generator=generator)

    def forward(self, x):
        return self.conv(x)


class Upsample1d(nn.Module):
    """Transposed conv doubling the horizon: flax `ConvTranspose(dim, (4,),
    strides=2, padding="SAME")`, i.e. torch `ConvTranspose1d(dim, dim, 4, 2,
    1)` on the K-flipped kernel."""

    JAX_NAMES = {"conv": "ConvTranspose_0"}

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.utils.skip_init(nn.ConvTranspose1d, dim, dim, 4, stride=2, padding=1)
        with torch.no_grad():
            lecun_normal_init(self.conv.weight, generator, fan_in=4 * dim)
            self.conv.bias.zero_()

    def forward(self, x):
        x, w, b = promote(x, self.conv.weight, self.conv.bias)
        if below_f32(x.dtype):  # flax's order: the product rounded, then the bias
            return F.conv_transpose1d(x.transpose(1, 2), w, None, 2, 1).transpose(1, 2) + b
        return F.conv_transpose1d(x.transpose(1, 2), w, b, 2, 1).transpose(1, 2)


class ResidualBlock1d(nn.Module):
    """Conv-GN-Mish x2 with FiLM-add of the time/cond embedding. With
    `use_kernel` (groupnorm only) the block runs through `film_resblock_op`
    (K3, a forward kernel: the U-Net's path); with `vjp_kernel` through
    `film_resblock_vjp_op` (a forward kernel that keeps residuals and an
    input-gradient kernel: the classifier's path, differentiated with
    respect to x); without either, through the flax-style layers, which
    `film_resblock_vjp_op` also takes when a parameter needs a gradient."""

    def __init__(self, in_dim: int, out_dim: int, emb_dim: int, kernel_size: int = 3,
                 norm_type: str = "groupnorm", use_kernel: bool = False,
                 generator: Optional[torch.Generator] = None, vjp_kernel: bool = False):
        super().__init__()
        if (use_kernel or vjp_kernel) and norm_type != "groupnorm":
            raise ValueError("the fused block computes GroupNorm: use_pallas_block needs "
                             "norm_type='groupnorm'")
        if use_kernel and vjp_kernel:
            raise ValueError("a block takes K3 (use_kernel) or the VJP kernels (vjp_kernel)")
        self.kernel_size, self.use_kernel, self.vjp_kernel = kernel_size, use_kernel, vjp_kernel
        self.conv1 = Conv1d(in_dim, out_dim, kernel_size, generator=generator)
        self.norm1 = get_norm(out_dim, norm_type)
        self.film = dense(emb_dim, out_dim, generator=generator)
        self.conv2 = Conv1d(out_dim, out_dim, kernel_size, generator=generator)
        self.norm2 = get_norm(out_dim, norm_type)
        self.skip = Conv1d(in_dim, out_dim, 1, generator=generator) if in_dim != out_dim else None
        children = dict(conv1=self.conv1, norm1=self.norm1, film=self.film, conv2=self.conv2,
                        norm2=self.norm2)
        if self.skip is not None:
            children["skip"] = self.skip
        self.JAX_NAMES = _flax_names(**children)

    def forward(self, x, emb):
        e = self.film(mish(emb))
        if self.use_kernel or self.vjp_kernel:
            skip = (None, None) if self.skip is None else (self.skip.kernel[0], self.skip.bias)
            # the down/up-sampling convs return transposed views; the kernel
            # reads x row-major
            args = (x.contiguous(), e, self.conv1.kernel, self.conv1.bias, self.norm1.scale,
                    self.norm1.bias, self.conv2.kernel, self.conv2.bias, self.norm2.scale,
                    self.norm2.bias, *skip)
            config = dict(K=self.kernel_size, groups=self.norm1.groups, eps=self.norm1.eps)
            if self.use_kernel:
                return film_resblock_op(*args, **config)
            return film_resblock_vjp_op(*args, **config, plain=lambda: self._plain(x, e))
        return self._plain(x, e)

    def _plain(self, x, e):
        h = mish(self.norm1(self.conv1(x)))
        h = h + e[:, None, :]
        h = mish(self.norm2(self.conv2(h)))
        return h + (x if self.skip is None else self.skip(x))


class LinearAttention(nn.Module):
    """Linear attention over the horizon axis, with a residual."""

    JAX_NAMES = {"norm": "LayerNorm_0", "qkv": "Dense_0", "out": "Dense_1"}

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm = LayerNorm(dim)
        self.qkv = nn.utils.skip_init(Dense, dim, 3 * heads * dim_head, bias=False)
        with torch.no_grad():
            lecun_normal_init(self.qkv.weight, generator)
        self.out = dense(heads * dim_head, dim, generator=generator)

    def forward(self, x):
        b, l, _ = x.shape
        q, k, v = self.qkv(self.norm(x)).chunk(3, dim=-1)
        q = q.reshape(b, l, self.heads, self.dim_head) * (self.dim_head ** -0.5)
        k = torch.softmax(k.reshape(b, l, self.heads, self.dim_head), dim=1)  # over horizon
        v = v.reshape(b, l, self.heads, self.dim_head)
        context = torch.einsum("blhd,blhe->bhde", k, v)
        out = torch.einsum("bhde,blhd->blhe", context, q).reshape(b, l, -1)
        return self.out(out) + x


class JannerUNet1d(nn.Module):
    """(b, H, in_dim) -> (b, H, in_dim); H must be a power of 2."""

    def __init__(
        self,
        in_dim: int,
        model_dim: int = 32,
        emb_dim: int = 32,
        kernel_size: int = 3,
        dim_mult: Sequence[int] = (1, 2, 2, 2),
        norm_type: str = "groupnorm",
        attention: bool = False,
        timestep_emb_type: str = "positional",
        timestep_emb_params: Optional[dict] = None,
        use_pallas_block: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = generator
        self.attention = attention
        self.t_emb = timestep_embedding_module(emb_dim, timestep_emb_type, timestep_emb_params, g)
        self.t_dense1 = dense(emb_dim, model_dim * 4, generator=g)
        self.t_dense2 = dense(model_dim * 4, model_dim, generator=g)

        dims = [in_dim] + [model_dim * int(m) for m in np.cumprod(dim_mult)]
        in_out = list(zip(dims[:-1], dims[1:]))
        block = lambda i, o, ks=kernel_size: ResidualBlock1d(
            i, o, model_dim, ks, norm_type, use_pallas_block, g)
        # modules in flax's creation order, so that list index = flax number
        blocks, attns, downs, ups = [], [], [], []
        for ind, (dim_in, dim_out) in enumerate(in_out):
            blocks += [block(dim_in, dim_out), block(dim_out, dim_out)]
            if attention:
                attns.append(LinearAttention(dim_out, generator=g))
            if ind < len(in_out) - 1:
                downs.append(Downsample1d(dim_out, g))
        mid = dims[-1]
        blocks.append(block(mid, mid))
        if attention:
            attns.append(LinearAttention(mid, generator=g))
        blocks.append(block(mid, mid))
        for dim_in, dim_out in reversed(in_out[1:]):
            blocks += [block(2 * dim_out, dim_in), block(dim_in, dim_in)]
            if attention:
                attns.append(LinearAttention(dim_in, generator=g))
            ups.append(Upsample1d(dim_in, g))
        self.n_levels = len(in_out)
        self.blocks = nn.ModuleList(blocks)
        self.attns = nn.ModuleList(attns)
        self.downs = nn.ModuleList(downs)
        self.ups = nn.ModuleList(ups)
        self.final_conv = Conv1d(model_dim, model_dim, 5, generator=g)
        self.final_norm = get_norm(model_dim, norm_type)
        self.out_conv = Conv1d(model_dim, in_dim, 1, generator=g)
        # flax names (utils/jax_params.py)
        self.JAX_NAMES = {
            "t_emb": f"{type(self.t_emb).__name__}_0", "t_dense1": "Dense_0",
            "t_dense2": "Dense_1", "blocks": "ResidualBlock1d_{}",
            "attns": "LinearAttention_{}", "downs": "Downsample1d_{}", "ups": "Upsample1d_{}",
            "final_conv": "Conv_0", "out_conv": "Conv_1",
            "final_norm": _flax_names(final_norm=self.final_norm)["final_norm"],
        }

    def forward(self, x, t, emb=None):
        if x.shape[1] & (x.shape[1] - 1):
            raise ValueError(f"horizon {x.shape[1]} must be a power of 2")
        te = self.t_emb(t)
        if emb is not None:
            te = te + emb
        te = self.t_dense2(mish(self.t_dense1(te)))

        blocks, attns = iter(self.blocks), iter(self.attns)
        h_stack = []
        for ind in range(self.n_levels):
            x = next(blocks)(x, te)
            x = next(blocks)(x, te)
            if self.attention:
                x = next(attns)(x)
            h_stack.append(x)
            if ind < self.n_levels - 1:
                x = self.downs[ind](x)
        x = next(blocks)(x, te)
        if self.attention:
            x = next(attns)(x)
        x = next(blocks)(x, te)
        for up in self.ups:
            x = torch.cat([x, h_stack.pop()], dim=-1)
            x = next(blocks)(x, te)
            x = next(blocks)(x, te)
            if self.attention:
                x = next(attns)(x)
            x = up(x)
        return self.out_conv(mish(self.final_norm(self.final_conv(x))))

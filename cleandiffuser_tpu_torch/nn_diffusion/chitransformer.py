"""Chi Transformer, Diffusion Policy's transformer backbone (counterpart of
cleandiffuser_tpu/nn_diffusion/chitransformer.py).

    pred = net(x, t, emb)                              # sampling
    pred = net(x, t, emb, train=True, generator=g)     # training: dropout on

A pre-norm decoder over the action tokens with a causal target mask and
the memory mask t >= s - 1 over [time token; obs tokens]; the memory is an
MLP of the condition tokens (`n_cond_layers=0`, the pipelines' choice) or
a pre-norm encoder. In training, `p_drop_attn` drops attention weights (one
(Ta, S) mask per attention call for the whole batch and every head, as
flax's `broadcast_dropout`) and the MLP's hidden units, kept entries
scaled by 1 / (1 - p); `p_drop_emb` drops the embeddings. Each mask is a
Bernoulli keep-draw from the explicit generator through `dropout_keep`, in
the order the JAX module draws them: per layer the self-attention, the
cross-attention, then the MLP.

The attention is flax's `MultiHeadDotProductAttention` (utils/blocks.py:
q, k, v kernels (D, heads, head_dim), normal(0.02) init), and children
carry flax's names, so utils/jax_params.py maps the JAX param tree on.

Under the engines' bf16 flags the action tokens are bf16 until the first
cross-attention, whose f32 memory (the f32 time token promotes it) makes
them f32: the first decoder layer's norm and self-attention (its softmax in
bf16, rounded as flax's) run bf16, the rest f32 on bf16-rounded weights.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.blocks import LayerNorm, _MultiHeadAttention, dense, normal_init
from ..utils.embeddings import mish
from ..utils.ranks import batch_draw
from .base import timestep_embedding_module

__all__ = ["ChiTransformer", "dropout_keep"]

normal02 = normal_init(0.02)


def dropout_keep(shape, rate: float, generator: Optional[torch.Generator], device):
    """A Bernoulli keep-mask (probability 1 - rate) of `shape`."""
    return batch_draw(lambda s: torch.rand(s, generator=generator, device=device),
                      shape) < 1.0 - rate


def _dropout(x, rate: float, train: bool, generator):
    if not train or rate == 0.0:
        return x
    keep = dropout_keep(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class _Attention(_MultiHeadAttention):
    def __init__(self, d_model: int, nhead: int, generator=None):
        super().__init__(d_model, nhead, generator, kernel_init=normal02)

    def attend(self, x, kv, mask, rate: float, train: bool, generator):
        keep = None
        if train and rate > 0.0:
            keep = dropout_keep((x.shape[1], kv.shape[1]), rate, generator, x.device)
        return self(x, kv, mask, keep, rate)


def _mlp(layer, h, rate, train, generator):
    h = F.gelu(layer.dense1(h), approximate="tanh")
    return layer.dense2(_dropout(h, rate, train, generator))


class _PreNormEncoderLayer(nn.Module):
    JAX_NAMES = {"norm1": "LayerNorm_0", "attn": "MultiHeadDotProductAttention_0",
                 "norm2": "LayerNorm_1", "dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0, generator=None):
        super().__init__()
        self.dropout = dropout
        self.norm1 = LayerNorm(d_model)
        self.attn = _Attention(d_model, nhead, generator)
        self.norm2 = LayerNorm(d_model)
        self.dense1 = dense(d_model, 4 * d_model, normal02, generator=generator)
        self.dense2 = dense(4 * d_model, d_model, normal02, generator=generator)

    def forward(self, x, train: bool = False, generator=None):
        h = self.norm1(x)
        x = x + self.attn.attend(h, h, None, self.dropout, train, generator)
        return x + _mlp(self, self.norm2(x), self.dropout, train, generator)


class _PreNormDecoderLayer(nn.Module):
    JAX_NAMES = {"norm1": "LayerNorm_0", "self_attn": "MultiHeadDotProductAttention_0",
                 "norm2": "LayerNorm_1", "cross_attn": "MultiHeadDotProductAttention_1",
                 "norm3": "LayerNorm_2", "dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0, generator=None):
        super().__init__()
        self.dropout = dropout
        self.norm1 = LayerNorm(d_model)
        self.self_attn = _Attention(d_model, nhead, generator)
        self.norm2 = LayerNorm(d_model)
        self.cross_attn = _Attention(d_model, nhead, generator)
        self.norm3 = LayerNorm(d_model)
        self.dense1 = dense(d_model, 4 * d_model, normal02, generator=generator)
        self.dense2 = dense(4 * d_model, d_model, normal02, generator=generator)

    def forward(self, x, memory, tgt_mask, memory_mask, train: bool = False, generator=None):
        h = self.norm1(x)
        x = x + self.self_attn.attend(h, h, tgt_mask, self.dropout, train, generator)
        h = self.norm2(x)
        x = x + self.cross_attn.attend(h, memory, memory_mask, self.dropout, train, generator)
        return x + _mlp(self, self.norm3(x), self.dropout, train, generator)


class ChiTransformer(nn.Module):
    """(b, Ta, act_dim) x (b, To, obs_dim) -> (b, Ta, act_dim)."""

    def __init__(self, act_dim: int, obs_dim: int, Ta: int, To: int, d_model: int = 256,
                 nhead: int = 4, num_layers: int = 8, p_drop_emb: float = 0.0,
                 p_drop_attn: float = 0.3, n_cond_layers: int = 0,
                 timestep_emb_type: str = "positional",
                 timestep_emb_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.obs_dim, self.To = obs_dim, To
        self.p_drop_emb, self.p_drop_attn = p_drop_emb, p_drop_attn
        # the engine passes `train` and the generator to a backbone with dropout
        self.dropout = max(p_drop_emb, p_drop_attn)
        self.t_emb = timestep_embedding_module(d_model, timestep_emb_type, timestep_emb_params,
                                               g)
        self.act_proj = dense(act_dim, d_model, normal02, generator=g)
        self.obs_proj = dense(obs_dim, d_model, normal02, generator=g)
        self.pos_emb = nn.Parameter(normal02(torch.empty(1, Ta, d_model), g))
        self.cond_pos_emb = nn.Parameter(normal02(torch.empty(1, 1 + To, d_model), g))
        names = {"t_emb": f"{type(self.t_emb).__name__}_0", "act_proj": "Dense_0",
                 "obs_proj": "Dense_1", "encoder": "_PreNormEncoderLayer_{}",
                 "decoder": "_PreNormDecoderLayer_{}", "norm": "LayerNorm_0"}
        self.encoder = nn.ModuleList(_PreNormEncoderLayer(d_model, nhead, p_drop_attn, g)
                                     for _ in range(n_cond_layers))
        n_dense = 2
        if n_cond_layers == 0:
            self.cond_dense1 = dense(d_model, 4 * d_model, normal02, generator=g)
            self.cond_dense2 = dense(4 * d_model, d_model, normal02, generator=g)
            names.update(cond_dense1="Dense_2", cond_dense2="Dense_3")
            n_dense = 4
        self.decoder = nn.ModuleList(_PreNormDecoderLayer(d_model, nhead, p_drop_attn, g)
                                     for _ in range(num_layers))
        self.norm = LayerNorm(d_model)
        self.head = dense(d_model, act_dim, normal02, generator=g)
        names["head"] = f"Dense_{n_dense}"
        self.JAX_NAMES = names

    def forward(self, x, t, emb=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if emb is None:
            emb = torch.zeros((x.shape[0], self.To, self.obs_dim), dtype=x.dtype,
                              device=x.device)
        te = self.t_emb(t)[:, None, :]
        cond = torch.cat([te, self.obs_proj(emb)], dim=1)
        memory = _dropout(cond + self.cond_pos_emb[:, :cond.shape[1]], self.p_drop_emb, train,
                          generator)
        if len(self.encoder):
            for layer in self.encoder:
                memory = layer(memory, train, generator)
        else:
            memory = self.cond_dense2(mish(self.cond_dense1(memory)))
        h = _dropout(self.act_proj(x) + self.pos_emb[:, :x.shape[1]], self.p_drop_emb, train,
                     generator)
        Ta = x.shape[1]
        ti = torch.arange(Ta, device=x.device)[:, None]
        tgt_mask = ti >= ti.T
        memory_mask = ti >= torch.arange(self.To + 1, device=x.device)[None, :] - 1
        for layer in self.decoder:
            h = layer(h, memory, tgt_mask, memory_mask, train, generator)
        return self.head(self.norm(h))

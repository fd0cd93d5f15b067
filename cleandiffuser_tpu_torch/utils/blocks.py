"""Parameter initialisers and channels-last layers (counterpart of the
init helpers in cleandiffuser_tpu/utils/blocks.py and of the flax layers
the U-Nets use).

flax keeps a Dense kernel as (in, out); torch's `nn.Linear.weight` is
(out, in). Both give the same fan-in and fan-out, so each initialiser draws
from the distribution its flax namesake draws from. Every initialiser takes
an explicit `torch.Generator`; nothing here touches the global seed.

`Conv1d`, `GroupNorm` and `LayerNorm` work on channels-last (b, length, C)
tensors, as flax's do, and keep flax's parameter names and layouts: a conv
kernel is (K, Cin, Cout), a norm has `scale` and `bias`. So the JAX
parameters copy into them unchanged (utils/jax_params.py), and a Hopper
kernel reads the conv weights as they are stored.

The MLPs and critics of the RL pipelines (`Mlp`, `DQLCritic`, `TwinQ`,
`V`) name their children as flax does (`q1_model` / `q2_model`, `Q1` /
`Q2`, `Dense_i`, `LayerNorm_i`), so the converter maps them onto the JAX
param trees. So do Diffusion Veteran's critic transformer
(`DVHorizonCritic` of `DVTransformerBlock`s) and its attention, whose
`DenseGeneral` projections load flax's `MultiHeadDotProductAttention`
kernels, (D, heads, head_dim) and (heads, head_dim, D); the Chi
transformer's attention is the same module with keys and values from a
memory, a mask and an attention-weight dropout mask. The early-conv ViT's
pre-norm `Transformer` (`LayerNorm_i`, `MultiHeadAttention_i` with
`q_layer` / `k_layer` / `v_layer` and no output projection, `FeedForward_i`)
is a separate module, as in the reference; with `SoftLowerBound`,
`SoftUpperBound` and `generate_causal_mask` it has no pipeline caller.

Type promotion. PyTorch does not promote inside a product (`f32 @ bf16`
raises), while `jnp` and flax's `Dense` cast the operands to their common
type first (`jnp.result_type`: f32 with bf16 is f32, bf16 with bf16 is
bf16). `promote` does that for the port's layers, so a net whose params
were cast to bf16 runs as the reference's does under a bf16 cast; on f32
operands it returns them unchanged. Below f32, flax's Dense and Conv round
the product to the common type and then add the bias (two roundings), and
flax's norms take their statistics and the affine in f32 and round once to
the promoted type of x, scale and bias; the port's layers do the same. On
f32 (or f64) operands every layer computes exactly what it computed before
promotion was added.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
from .ranks import batch_draw
import torch.nn as nn
import torch.nn.functional as F

__all__ = [
    "xavier_uniform_init",
    "lecun_normal_init",
    "normal_init",
    "orthogonal_init",
    "zeros_init",
    "promote",
    "Dense",
    "dense",
    "below_f32",
    "silu",
    "leaky_relu",
    "conv1d",
    "group_norm",
    "layer_norm",
    "promoted_norm",
    "Conv1d",
    "GroupNorm",
    "LayerNorm",
    "Mlp",
    "DQLCritic",
    "TwinQ",
    "V",
    "IDQLQNet",
    "IDQLVNet",
    "DenseGeneral",
    "DVTransformerBlock",
    "DVHorizonCritic",
    "SoftLowerBound",
    "SoftUpperBound",
    "FeedForward",
    "MultiHeadAttention",
    "Transformer",
    "generate_causal_mask",
    "dropout",
]

Init = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def xavier_uniform_init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    return nn.init.xavier_uniform_(w, generator=generator)


def lecun_normal_init(w: torch.Tensor, generator: Optional[torch.Generator] = None,
                      fan_in: Optional[int] = None):
    """flax's default Dense and Conv kernel init: truncated normal (±2 std)
    scaled so the variance is 1/fan_in (default: an nn.Linear weight's)."""
    if fan_in is None:
        fan_in = w.shape[1] if w.ndim == 2 else w.shape[0]
    # 0.8796... is the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def normal_init(stddev: float) -> Init:
    def init(w, generator=None):
        return nn.init.normal_(w, 0.0, stddev, generator=generator)

    return init


def orthogonal_init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    return nn.init.orthogonal_(w, generator=generator)


def zeros_init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    return nn.init.zeros_(w)


def promote(*tensors):
    """The tensors cast to their common type (`jnp.result_type`'s rule for
    floating types); no-ops where a tensor has it already."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in tensors)


def below_f32(dtype) -> bool:
    """A floating type narrower than f32 (bf16, f16): where flax rounds
    each step's result."""
    return dtype.is_floating_point and torch.finfo(dtype).bits < 32


def silu(x):
    """flax's `nn.silu`, x * sigmoid(x): below f32 as XLA computes it on the
    CPU, x * (1 / (1 + exp(-x))) with each step rounded to x's type; one
    fused op otherwise."""
    return x * (1 / (1 + torch.exp(-x))) if below_f32(x.dtype) else F.silu(x)


def leaky_relu(x, negative_slope: float = 0.01):
    """flax's `nn.leaky_relu`: below f32 the slope is rounded to x's type
    before the product, as jnp's weakly typed scalar is."""
    if below_f32(x.dtype):
        return torch.where(x >= 0, x, x * torch.tensor(negative_slope, dtype=x.dtype))
    return F.leaky_relu(x, negative_slope)


class Dense(nn.Linear):
    """`nn.Linear` that promotes input, weight and bias to their common type
    before the product, as flax's `Dense` does. Below f32, flax rounds the
    product to that type and then adds the bias (two roundings), where one
    fused `linear` would round once; the f32 path keeps the fused call."""

    def forward(self, x):
        if self.bias is None:
            return F.linear(*promote(x, self.weight))
        x, w, b = promote(x, self.weight, self.bias)
        if x.dtype == torch.float32:
            return F.linear(x, w, b)
        return F.linear(x, w) + b


@torch.no_grad()
def dense(in_dim: int, out_dim: int, kernel_init: Init = lecun_normal_init,
          bias_init: Init = zeros_init,
          generator: Optional[torch.Generator] = None) -> Dense:
    """`Dense` initialised as flax's `nn.Dense(out_dim, kernel_init=...)`."""
    # skip_init: no throw-away draw from the global generator
    layer = nn.utils.skip_init(Dense, in_dim, out_dim)
    kernel_init(layer.weight, generator)
    bias_init(layer.bias, generator)
    return layer


# ---------------------------------------------------------------------------
# Channels-last layers with flax's parameter layouts
def conv1d(x, kernel, bias, stride: int = 1, padding: Tuple[int, int] = (0, 0)):
    """flax `nn.Conv` on (b, L, Cin) with kernel (K, Cin, Cout): (b, L', Cout),
    in the operands' common type."""
    x, kernel, bias = promote(x, kernel, bias)
    lo, hi = padding
    xc = x.transpose(1, 2)
    if lo != hi:
        xc, lo = F.pad(xc, (lo, hi)), 0
    if below_f32(x.dtype):  # the product rounded, then the bias added
        out = F.conv1d(xc, kernel.permute(2, 1, 0), None, stride=stride, padding=lo)
        return out.transpose(1, 2) + bias
    return F.conv1d(xc, kernel.permute(2, 1, 0), bias, stride=stride, padding=lo).transpose(1, 2)


def promoted_norm(norm, x, scale, bias):
    """`norm(x, scale, bias)` as flax's norms compute it: in at least f32,
    the result in the promoted type of x, scale and bias (either may be
    None)."""
    params = [t for t in (scale, bias) if t is not None]
    if all(t.dtype == x.dtype for t in params) and not below_f32(x.dtype):
        return norm(x, scale, bias)
    out_dt = promote(x, *params)[0].dtype
    wide = torch.promote_types(out_dt, torch.float32)
    up = lambda t: None if t is None else t.to(wide)
    return norm(x.to(wide), up(scale), up(bias)).to(out_dt)


def group_norm(x, groups: int, scale, bias, eps: float):
    """GroupNorm of (b, L, C) per sample over (L, C/groups), then the
    per-channel affine; promoted as flax's (module note)."""
    return promoted_norm(
        lambda x, s, b: F.group_norm(x.transpose(1, 2), groups, s, b, eps).transpose(1, 2),
        x, scale, bias)


def layer_norm(x, scale, bias, eps: float):
    """LayerNorm over the last axis with an optional affine; promoted as
    flax's (module note)."""
    return promoted_norm(lambda x, s, b: F.layer_norm(x, x.shape[-1:], s, b, eps),
                          x, scale, bias)


class Conv1d(nn.Module):
    """flax `nn.Conv(out_dim, (kernel_size,), strides, padding)` on (b, L,
    Cin). `padding` is "SAME" (stride 1) or a (lo, hi) pair."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, stride: int = 1,
                 padding: Union[str, Tuple[int, int]] = "SAME",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding == "SAME":
            if stride != 1:
                raise ValueError("SAME padding is ported for stride 1 only")
            padding = ((kernel_size - 1) // 2, kernel_size // 2)
        self.stride, self.padding = stride, tuple(padding)
        w = torch.empty(kernel_size, in_dim, out_dim)
        self.kernel = nn.Parameter(lecun_normal_init(w, generator, fan_in=kernel_size * in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        return conv1d(x, self.kernel, self.bias, self.stride, self.padding)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups)` on (b, L, C); flax's eps is 1e-6."""

    def __init__(self, dim: int, groups: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return group_norm(x, self.groups, self.scale, self.bias, self.eps)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm()` over the last axis; flax's eps is 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


# ---------------------------------------------------------------------------
# MLPs and the RL critics
class Mlp(nn.Module):
    """Plain MLP: `activation` after every hidden Dense, `out_activation`
    (if any) after the last."""

    JAX_NAMES = {"layers": "Dense_{}"}

    def __init__(self, in_dim: int, hidden_dims, out_dim: int, activation: Callable = F.relu,
                 out_activation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = (in_dim, *hidden_dims, out_dim)
        self.layers = nn.ModuleList(
            dense(i, o, generator=generator) for i, o in zip(dims[:-1], dims[1:]))
        self.activation, self.out_activation = activation, out_activation

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self.activation(layer(x))
        x = self.layers[-1](x)
        return x if self.out_activation is None else self.out_activation(x)


class _QHead(nn.Module):
    """(Dense -> LayerNorm -> activation) per activation, then Dense(1)."""

    JAX_NAMES = {"dense": "Dense_{}", "norm": "LayerNorm_{}"}

    def __init__(self, in_dim: int, hidden_dim: int, activations,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activations = tuple(activations)
        dims = [in_dim] + [hidden_dim] * len(self.activations)
        self.dense = nn.ModuleList([dense(i, hidden_dim, generator=generator) for i in dims[:-1]]
                                   + [dense(hidden_dim, 1, generator=generator)])
        self.norm = nn.ModuleList(LayerNorm(hidden_dim) for _ in self.activations)

    def forward(self, x):
        for layer, norm, act in zip(self.dense, self.norm, self.activations):
            x = act(norm(layer(x)))
        return self.dense[-1](x)


class DQLCritic(nn.Module):
    """Twin Q over [obs, act] with a tanh, mish, mish stack."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        acts = (torch.tanh, F.mish, F.mish)
        self.q1_model = _QHead(obs_dim + act_dim, hidden_dim, acts, generator)
        self.q2_model = _QHead(obs_dim + act_dim, hidden_dim, acts, generator)

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.q1_model(x), self.q2_model(x)

    def q1(self, obs, act):
        return self.q1_model(torch.cat([obs, act], dim=-1))

    def q_min(self, obs, act):
        return torch.minimum(*self(obs, act))


class TwinQ(nn.Module):
    """IQL's twin Q (mish, mish); calling it gives the min of the heads."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        acts = (F.mish, F.mish)
        self.Q1 = _QHead(obs_dim + act_dim, hidden_dim, acts, generator)
        self.Q2 = _QHead(obs_dim + act_dim, hidden_dim, acts, generator)

    def both(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.Q1(x), self.Q2(x)

    def forward(self, obs, act):
        return torch.minimum(*self.both(obs, act))


class V(_QHead):
    """IQL's value net over obs (mish, mish)."""

    def __init__(self, obs_dim: int, hidden_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__(obs_dim, hidden_dim, (F.mish, F.mish), generator)


IDQLQNet = TwinQ
IDQLVNet = V


# ---------------------------------------------------------------------------
# Diffusion Veteran's critic transformer
class DenseGeneral(Dense):
    """flax `nn.DenseGeneral` over flattened features: a `Dense` whose flax
    kernel and bias have the shapes `jax_shapes` gives ("weight": the
    kernel's, "bias": the bias'), e.g. (D, heads, head_dim) for an
    attention query. utils/jax_params.py reshapes between the two."""

    def __init__(self, in_features: int, out_features: int, kernel_shape, bias_shape,
                 device=None, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.jax_shapes = {"weight": tuple(kernel_shape), "bias": tuple(bias_shape)}


@torch.no_grad()
def _dense_general(in_dim: int, out_dim: int, kernel_shape, bias_shape,
                   generator: Optional[torch.Generator] = None,
                   kernel_init: Optional[Init] = None, bias: bool = True) -> DenseGeneral:
    """flax's default init of a DenseGeneral (lecun normal on the kernel's
    fan-in, `in_dim`), or `kernel_init`; zero bias (none without `bias`)."""
    layer = nn.utils.skip_init(DenseGeneral, in_dim, out_dim, kernel_shape, bias_shape,
                               bias=bias)
    if kernel_init is None:
        lecun_normal_init(layer.weight, generator, fan_in=in_dim)
    else:
        kernel_init(layer.weight, generator)
    if bias:
        zeros_init(layer.bias)
    return layer


def _softmax_rounded(x):
    """`jax.nn.softmax` over the last axis below f32, each step rounded to
    x's type as jnp's are: exp(x - max), over its sum (taken in f32 and
    rounded)."""
    u = torch.exp(x - x.amax(-1, keepdim=True))
    return u / u.sum(-1, keepdim=True)


class _MultiHeadAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention(num_heads, qkv_features=D)` on
    (b, L, D): softmax(q k^T / sqrt(head_dim)) v per head, heads
    concatenated, then the output projection. Keys and values come from
    `kv` (b, S, D) when given, else from x. `mask` (L, S) bool keeps the
    True entries (flax fills the others with the dtype's minimum before the
    softmax); `keep` (L, S) bool is the attention-weight dropout mask, one
    for the whole batch and every head as flax's `broadcast_dropout` draws
    it, applied with `rate` (kept weights scaled by 1 / (1 - rate)).
    `kernel_init` draws the four kernels (flax's default: lecun normal)."""

    def __init__(self, d_model: int, n_heads: int, generator: Optional[torch.Generator] = None,
                 kernel_init: Optional[Init] = None):
        super().__init__()
        hd = d_model // n_heads
        self.n_heads = n_heads
        for name in ("query", "key", "value"):
            setattr(self, name, _dense_general(d_model, d_model, (d_model, n_heads, hd),
                                               (n_heads, hd), generator, kernel_init))
        self.out = _dense_general(d_model, d_model, (n_heads, hd, d_model), (d_model,),
                                  generator, kernel_init)

    def forward(self, x, kv=None, mask=None, keep=None, rate: float = 0.0):
        b, L, D = x.shape
        kv = x if kv is None else kv
        heads = lambda h: h.view(b, h.shape[1], self.n_heads, D // self.n_heads)
        # flax promotes q, k and v to their common type (a bf16 query on an
        # f32 memory runs f32)
        q, k, v = promote(heads(self.query(x)), heads(self.key(kv)), heads(self.value(kv)))
        low = below_f32(q.dtype)
        if low:  # flax divides by sqrt(depth) rounded to the type, then rounds
            q = q / torch.tensor(math.sqrt(D // self.n_heads), dtype=q.dtype)
        else:
            q = q / math.sqrt(D // self.n_heads)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        attn = _softmax_rounded(logits) if low else torch.softmax(logits, dim=-1)
        if keep is not None:
            attn = attn * (keep.to(attn.dtype) / (torch.tensor(1.0 - rate, dtype=attn.dtype)
                                                  if low else (1.0 - rate)))
        return self.out(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, L, D))


def _plain_layer_norm(x):
    """flax `nn.LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6)`."""
    return layer_norm(x, None, None, 1e-6)


class DVTransformerBlock(nn.Module):
    """Diffusion Veteran's critic block. "post": x = LN(x + attn(x)),
    x = LN(x + mlp(x)); "pre": x = LN(x), x = x + attn(x), x = x +
    mlp(LN(x)) (the residual is the normed x, as in the reference). The MLP
    is Dense(4D), tanh-GELU, Dense(D); the norms have no scale or bias."""

    JAX_NAMES = {"attn": "MultiHeadDotProductAttention_0", "mlp1": "Dense_0",
                 "mlp2": "Dense_1"}

    def __init__(self, hidden_size: int, n_heads: int, norm_type: str = "post",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm_type not in ("post", "pre"):
            raise NotImplementedError(norm_type)
        self.norm_type = norm_type
        self.attn = _MultiHeadAttention(hidden_size, n_heads, generator)
        self.mlp1 = dense(hidden_size, 4 * hidden_size, generator=generator)
        self.mlp2 = dense(4 * hidden_size, hidden_size, generator=generator)

    def mlp(self, x):
        return self.mlp2(F.gelu(self.mlp1(x), approximate="tanh"))

    def forward(self, x):
        if self.norm_type == "post":
            x = _plain_layer_norm(x + self.attn(x))
            return _plain_layer_norm(x + self.mlp(x))
        x = _plain_layer_norm(x)
        x = x + self.attn(x)
        return x + self.mlp(_plain_layer_norm(x))


class DVHorizonCritic(nn.Module):
    """(b, H, in_dim) trajectory -> (b, 1) value: Dense(d_model) plus the
    sinusoidal position, `depth` DVTransformerBlocks, Dense(1), token 0."""

    JAX_NAMES = {"proj": "Dense_0", "blocks": "DVTransformerBlock_{}", "head": "Dense_1"}

    def __init__(self, in_dim: int, emb_dim: int, d_model: int = 384, n_heads: int = 6,
                 depth: int = 12, norm_type: str = "post",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del emb_dim  # the reference's signature; unused there too
        self.d_model = d_model
        self.proj = dense(in_dim, d_model, xavier_uniform_init, generator=generator)
        self.blocks = nn.ModuleList(
            DVTransformerBlock(d_model, n_heads, norm_type, generator) for _ in range(depth))
        self.head = dense(d_model, 1, xavier_uniform_init, generator=generator)

    def forward(self, x):
        from .embeddings import sinusoidal_features

        pos = sinusoidal_features(torch.arange(x.shape[1], device=x.device), self.d_model)
        x = self.proj(x) + pos[None]
        for block in self.blocks:
            x = block(x)
        return self.head(x)[:, 0, :]


# ---------------------------------------------------------------------------
# Bounds and the pre-norm transformer encoder (the early-conv ViT's)
class SoftLowerBound(nn.Module):
    """lb + softplus(x - lb)."""

    def __init__(self, lower_bound: float):
        super().__init__()
        self.lower_bound = lower_bound

    def forward(self, x):
        return self.lower_bound + F.softplus(x - self.lower_bound)


class SoftUpperBound(nn.Module):
    """ub - softplus(ub - x)."""

    def __init__(self, upper_bound: float):
        super().__init__()
        self.upper_bound = upper_bound

    def forward(self, x):
        return self.upper_bound - F.softplus(self.upper_bound - x)


def dropout(x, rate: float, train: bool, generator: Optional[torch.Generator] = None):
    """flax's `nn.Dropout(rate)`: in training each entry kept with
    probability 1 - rate (its keep-mask drawn from `generator`) and scaled
    by 1 / (1 - rate); the identity otherwise."""
    if not train or rate == 0.0:
        return x
    keep = batch_draw(lambda s: torch.rand(s, generator=generator, device=x.device),
                      x.shape) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class FeedForward(nn.Module):
    """Dense(hidden_scale * d_model), tanh-GELU (flax's `nn.gelu`), dropout,
    Dense(d_model), dropout."""

    JAX_NAMES = {"dense1": "Dense_0", "dense2": "Dense_1"}

    def __init__(self, d_model: int, hidden_scale: int = 4, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = int(d_model * hidden_scale)
        self.dense1 = dense(d_model, hidden, generator=generator)
        self.dense2 = dense(hidden, d_model, generator=generator)
        self.rate = dropout

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        h = dropout(F.gelu(self.dense1(x), approximate="tanh"), self.rate, train, generator)
        return dropout(self.dense2(h), self.rate, train, generator)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate q, k and v inputs and no output
    projection: q and k projected without bias (with one under `bias`), v
    with one, each to (heads, d_model / heads); softmax(q k^T / sqrt(d_k))
    per head; heads concatenated. `mask` (i, j) or (b, i, j): entries equal
    to 0 are masked out (-inf before the softmax). Returns the output and
    the attention map (b, heads, i, j), detached. Distinct from
    `_MultiHeadAttention`, the counterpart of flax's
    `MultiHeadDotProductAttention`."""

    JAX_NAMES = {"q": "q_layer", "k": "k_layer", "v": "v_layer"}

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0, bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not a multiple of nhead {nhead}")
        d_k = d_model // nhead
        self.nhead, self.d_k, self.rate = nhead, d_k, dropout
        shapes = ((d_model, nhead, d_k), (nhead, d_k))
        self.q = _dense_general(d_model, d_model, *shapes, generator, bias=bias)
        self.k = _dense_general(d_model, d_model, *shapes, generator, bias=bias)
        self.v = _dense_general(d_model, d_model, *shapes, generator)

    def forward(self, q, k, v, mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        heads = lambda h: h.view(*h.shape[:2], self.nhead, self.d_k)
        qh, kh, vh = promote(heads(self.q(q)), heads(self.k(k)), heads(self.v(v)))
        scores = torch.einsum("bihd,bjhd->bhij", qh, kh) * self.d_k**-0.5
        if mask is not None:
            mask = mask[None, None] if mask.ndim == 2 else mask[:, None]
            scores = scores.masked_fill(mask == 0, float("-inf"))
        attn = dropout(torch.softmax(scores, dim=-1), self.rate, train, generator)
        out = torch.einsum("bhij,bjhd->bihd", attn, vh)
        return out.reshape(*out.shape[:2], -1), attn.detach()


class Transformer(nn.Module):
    """Pre-norm transformer encoder: per layer x = MHA(LN(x)) + x, x =
    FFN(LN(x)) + x. Returns the output and each layer's attention map."""

    JAX_NAMES = {"norms": "LayerNorm_{}", "attns": "MultiHeadAttention_{}",
                 "ffns": "FeedForward_{}"}

    def __init__(self, d_model: int, nhead: int, num_layers: int, hidden_scale: int = 4,
                 attn_dropout: float = 0.0, ffn_dropout: float = 0.0, bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        # LayerNorm_{2i} before layer i's attention, LayerNorm_{2i+1} before its FFN
        self.norms = nn.ModuleList(LayerNorm(d_model) for _ in range(2 * num_layers))
        self.attns = nn.ModuleList(MultiHeadAttention(d_model, nhead, attn_dropout, bias, g)
                                   for _ in range(num_layers))
        self.ffns = nn.ModuleList(FeedForward(d_model, hidden_scale, ffn_dropout, g)
                                  for _ in range(num_layers))

    def forward(self, x, mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        attn_maps = []
        for i, (attn, ffn) in enumerate(zip(self.attns, self.ffns)):
            h = self.norms[2 * i](x)
            h, attn_map = attn(h, h, h, mask, train, generator)
            attn_maps.append(attn_map)
            x = h + x
            x = ffn(self.norms[2 * i + 1](x), train, generator) + x
        return x, attn_maps


def generate_causal_mask(length: int, device=None):
    """Lower-triangular 1/0 mask (length, length)."""
    return torch.tril(torch.ones((length, length), device=device))

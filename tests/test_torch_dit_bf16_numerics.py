"""The rounding of the fused DiT block's BF16 route
(cleandiffuser_tpu_torch/csrc/dit_block_bf16.cu), emulated on the CPU.

The route runs its four weight products on `wgmma` with BF16 operands and
f32 accumulators over the whole K. Its rounding points: LN1's output h,
then q (scaled), k and v, the attention output, LN2's output h2 and each
MLP chunk's GELU'd hidden units are stored as BF16; attention runs on TF32
MMAs over the BF16 q, k and v (exact products) with the probabilities P
rounded to TF32 and divided by their f32 row sum afterwards; LN statistics,
softmax, GELU, the gated residual and every sum stay f32; x and mod are
read in their own type and the output is rounded to x's. (GELU's tanh runs
on the SFU, relative error below 2^-10.98, under the BF16 rounding of the
hidden units that follows it; the emulation takes the exact tanh.)

These tests hold that emulation at the DD configs' width (D = 320, 10
heads, H = 32) within the route's limit of 5e-2 abs + 5e-2 rel of both
plain versions on the same BF16 weights: the port's `dit_block_reference`
and the JAX package's `dit_block_reference`
(cleandiffuser_tpu/ops/dit_block.py), with f32 x and mod (the bf16
sampler's call), all-BF16 (the `bf16_training` forward), and both with x
+ 10, where LN's sums run long and one-signed and it subtracts a large
common offset. So the tolerance the kernel is held to on the card
(tests/test_torch_kernels.py, chip_smoke.py) covers what its arithmetic
does, not only what one run measured. (The limit holds at a trained
block's scales, as the kernel tests' inputs are: with weights of mean 0.05
the outputs reach ~100 and the plain BF16 version itself misses float64 by
more than it.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.ops.dit_block import dit_block_reference as jax_dit_reference
from cleandiffuser_tpu_torch.ops.dit_block import dit_block_reference

torch.set_num_threads(1)

TOL = 5e-2  # the BF16 route's limit against its plain version, abs and rel
B, H, D, NH = 4, 32, 320, 10


def bf16(v: torch.Tensor) -> torch.Tensor:
    """v rounded to BF16 (to nearest even), as f32."""
    return v.to(torch.bfloat16).float()


def tf32(v: torch.Tensor) -> torch.Tensor:
    """v rounded to TF32, to nearest, ties away from zero (cvt.rna.tf32)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def layernorm(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def route(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, out_bf16: bool):
    """The route's arithmetic (module note), in f32 on BF16 values; x and
    mod as the kernel reads them (f32, or BF16 values widened)."""
    hd = D // NH
    shift1, scale1, gate1, shift2, scale2, gate2 = (m[:, None] for m in mod.chunk(6, dim=-1))
    h = bf16(layernorm(x) * (1 + scale1) + shift1)
    q = bf16((h @ wqkv[:, :D] + bqkv[:D]) * hd ** -0.5)
    k = bf16(h @ wqkv[:, D:2 * D] + bqkv[D:2 * D])
    v = bf16(h @ wqkv[:, 2 * D:] + bqkv[2 * D:])
    heads = lambda t: t.reshape(B, H, NH, hd).transpose(1, 2)
    s = heads(q) @ heads(k).transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (tf32(p) @ heads(v)) / p.sum(-1, keepdim=True)
    o = bf16(o.transpose(1, 2).reshape(B, H, D))
    x = x + gate1 * (o @ wo + bo)
    h2 = bf16(layernorm(x) * (1 + scale2) + shift2)
    for c in range(4):
        cols = slice(c * D, (c + 1) * D)
        hid = bf16(torch.nn.functional.gelu(h2 @ w1[:, cols] + b1[cols], approximate="tanh"))
        x = x + gate2 * (hid @ w2[cols] + (b2 if c == 0 else 0.0))
    return bf16(x) if out_bf16 else x


def operands(x_offset=0.0, seed=0):
    """Seeded numpy operands at a trained block's scales: x of unit std (+
    x_offset), mod of 0.5, weights of std fan_in^-1/2, biases of 0.1; the
    weights and biases rounded to BF16 (as float32 arrays)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std: (rng.standard_normal(s) * std).astype(np.float32)
    r = lambda a: np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())
    x, mod = f(B, H, D, std=1.0) + np.float32(x_offset), f(B, 6 * D, std=0.5)
    ws = [f(D, 3 * D, std=D ** -0.5), f(3 * D, std=0.1), f(D, D, std=D ** -0.5), f(D, std=0.1),
          f(D, 4 * D, std=D ** -0.5), f(4 * D, std=0.1), f(4 * D, D, std=(4 * D) ** -0.5),
          f(D, std=0.1)]
    return x, mod, [r(w) for w in ws]


def used(got, want):
    """The share of the limit used: |d| / (TOL + TOL |want|), at its max."""
    return float((np.abs(got - want) / (TOL + TOL * np.abs(want))).max())


CASES = {"mixed": (False, {}), "all-bf16": (True, {}),
         "mixed-x+10": (False, {"x_offset": 10.0}), "all-bf16-x+10": (True, {"x_offset": 10.0})}


def emulate(all_bf16, kw):
    x, mod, ws = operands(**kw)
    t = lambda a: torch.from_numpy(a)
    xe, me = (bf16(t(x)), bf16(t(mod))) if all_bf16 else (t(x), t(mod))
    return x, mod, ws, route(xe, me, *map(t, ws), out_bf16=all_bf16).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_route_rounding_within_the_limit_of_the_port_reference(case):
    all_bf16, kw = CASES[case]
    x, mod, ws, got = emulate(all_bf16, kw)
    dt = torch.bfloat16 if all_bf16 else torch.float32
    wb = [torch.from_numpy(w).to(torch.bfloat16) for w in ws]
    ref = dit_block_reference(torch.from_numpy(x).to(dt), torch.from_numpy(mod).to(dt), *wb,
                              n_heads=NH)
    assert ref.dtype == dt
    share = used(got, ref.float().numpy())
    assert share < 1.0, share


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_route_rounding_within_the_limit_of_the_jax_reference(case):
    """The JAX reference on the same operands, its weights BF16 arrays (and
    x and mod too in the all-BF16 case): jnp promotes as the port's plain
    version does."""
    all_bf16, kw = CASES[case]
    x, mod, ws, got = emulate(all_bf16, kw)
    dt = jnp.bfloat16 if all_bf16 else jnp.float32
    jw = [jnp.asarray(w, jnp.bfloat16) for w in ws]
    want = jax.jit(lambda *a: jax_dit_reference(*a, n_heads=NH))(
        jnp.asarray(x, dt), jnp.asarray(mod, dt), *jw)
    assert want.dtype == dt
    share = used(got, np.asarray(want, np.float32))
    assert share < 1.0, share

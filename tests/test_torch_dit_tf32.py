"""The 3xTF32 arithmetic of the fused DiT block's kernel
(cleandiffuser_tpu_torch/csrc/dit_block.cu), emulated on the CPU.

The kernel runs its four weight products and attention's two (q k^T and
P V) on the tensor cores in TF32 (10 stored mantissa bits). It splits every
operand v into hi, v rounded to TF32 to nearest with ties away from zero,
and lo = v - hi, of which the tensor core reads the TF32 part (the low 13
bits of an f32 register are ignored, i.e. lo is truncated), and sums
a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32. These tests run the whole block
with its six products computed that way and hold it to the plain version in
float64: within the kernel's 1e-4 at the DD plan's width, where one TF32
product misses; and, in a precision case (x + 10, weights of mean 0.05, so
that the products are long same-sign sums), within 1e-4 of the output's
scale, as close as plain float32 comes, where one TF32 product misses.
The same precision case holds the kernel on the card
(tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cleandiffuser_tpu_torch.ops.dit_block import _layernorm, dit_block_reference

torch.set_num_threads(1)

TOL = 1e-4  # the kernel's tolerance against its plain version, per block


def tf32(v: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32, to nearest with ties away from zero (cvt.rna):
    IEEE floats are sign-magnitude, so adding half an ulp of bit 13 to the
    bit pattern and clearing the low 13 bits rounds the magnitude."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(v: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor core reads from an f32 register."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, truncate(v - hi)


def matmul(a, b, mode: str):
    """a @ b in f32 as the kernel's tensor cores compute it: "3x" sums the
    three leading cross products of the split operands, "1x" is one TF32
    product, "f32" plain f32."""
    if mode == "f32":
        return a @ b
    (ah, al), (bh, bl) = split(a), split(b)
    if mode == "1x":
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def block(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, *, n_heads, mode):
    """dit_block_reference with its six products in `mode`."""
    B, H, D = x.shape
    hd = D // n_heads
    shift1, scale1, gate1, shift2, scale2, gate2 = mod.chunk(6, dim=-1)
    h = _layernorm(x) * (1 + scale1[:, None]) + shift1[:, None]
    q, k, v = (matmul(h, wqkv, mode) + bqkv).chunk(3, dim=-1)
    heads = lambda t: t.reshape(B, H, n_heads, hd).transpose(1, 2)  # (B, heads, H, hd)
    q, k, v = heads(q * hd ** -0.5), heads(k), heads(v)
    p = torch.softmax(matmul(q, k.transpose(-1, -2), mode), dim=-1)
    o = matmul(p, v, mode).transpose(1, 2).reshape(B, H, D)
    x = x + gate1[:, None] * (matmul(o, wo, mode) + bo)
    h2 = _layernorm(x) * (1 + scale2[:, None]) + shift2[:, None]
    h2 = F.gelu(matmul(h2, w1, mode) + b1, approximate="tanh")
    return x + gate2[:, None] * (matmul(h2, w2, mode) + b2)


def _inputs(B, H, D, x_offset=0.0, w_mean=0.0, seed=0):
    """Weights at std fan_in^-0.5 plus w_mean, biases at std 0.1, mod at
    0.5, x at 1 plus x_offset (as the card's precision case)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std, mean=0.0: torch.from_numpy(
        (mean + rng.standard_normal(s) * std).astype(np.float32))
    x = f(B, H, D, std=1.0) + x_offset
    mod = f(B, 6 * D, std=0.5)
    ws = [f(D, 3 * D, std=D ** -0.5, mean=w_mean), f(3 * D, std=0.1),
          f(D, D, std=D ** -0.5, mean=w_mean), f(D, std=0.1),
          f(D, 4 * D, std=D ** -0.5, mean=w_mean), f(4 * D, std=0.1),
          f(4 * D, D, std=(4 * D) ** -0.5, mean=w_mean), f(D, std=0.1)]
    return x, mod, ws


def _emulate(shape, **kw):
    B, H, D, NH = shape
    x, mod, ws = _inputs(B, H, D, **kw)
    ref = dit_block_reference(x.double(), mod.double(), *(w.double() for w in ws), n_heads=NH)
    out = {m: block(x, mod, *ws, n_heads=NH, mode=m).double() for m in ("3x", "1x", "f32")}
    return out, ref


def test_block_in_3xtf32_holds_the_kernel_tolerance():
    """At the DD plan's width (D = 320, 10 heads, H = 32), the block with
    its products in 3xTF32 stays within 1e-4 of the plain version in float64
    (measured ~3e-6), as plain f32 does; one TF32 product misses it (~2e-3)."""
    out, ref = _emulate((4, 32, 320, 10))
    torch.testing.assert_close(out["3x"], ref, atol=TOL, rtol=TOL)
    torch.testing.assert_close(out["f32"], ref, atol=TOL, rtol=TOL)
    miss = ((out["1x"] - ref).abs() / (TOL + TOL * ref.abs())).max().item()
    assert miss > 1.0, "one TF32 product should miss the block tolerance"


def test_block_in_3xtf32_precision_case():
    """x + 10 and weights of mean 0.05: LN subtracts a large common offset
    and every product is a long same-sign sum (|out| up to ~100). Neither
    3xTF32 nor plain f32 holds 1e-4 element by element here (both miss
    float64 by ~4e-3); held to 1e-4 of max |ref|, both do (~4e-5 of it), and
    one TF32 product misses by more than 5x the bound (~9e-4)."""
    out, ref = _emulate((4, 32, 320, 10), x_offset=10.0, w_mean=0.05)
    scale = ref.abs().max().item()
    err = {m: (o - ref).abs().max().item() / scale for m, o in out.items()}
    assert err["3x"] < TOL and err["f32"] < TOL, err
    assert err["1x"] > 5 * TOL, err


@pytest.mark.parametrize("shape", [(3, 20, 96, 3), (2, 40, 64, 2)], ids=["ragged-H", "H-over-32"])
def test_block_in_3xtf32_at_the_kernel_test_shapes(shape):
    """The GPU tests' shapes with H not a multiple of 8 and above 32."""
    out, ref = _emulate(shape)
    torch.testing.assert_close(out["3x"], ref, atol=TOL, rtol=TOL)

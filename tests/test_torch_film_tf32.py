"""The 3xTF32 arithmetic of the fused FiLM block's kernel
(cleandiffuser_tpu_torch/csrc/film_resblock.cu), emulated on the CPU.

The kernel runs its convs on the tensor cores in TF32 (10 stored mantissa
bits). It splits every operand v into hi, v rounded to TF32 to nearest
with ties away from zero (as `cvt.rna.tf32.f32` rounds), and lo = v - hi,
of which the tensor core reads the TF32 part (the low 13 bits of an f32
register are ignored, i.e. lo is truncated), and sums a_lo*b_hi +
a_hi*b_lo + a_hi*b_hi in f32. These tests hold that
argument where it can be checked without a card: the split is exact where
it must be, the three products keep f32-class accuracy at the depth of the
U-Net's widest conv, and one TF32 product does not. So the block tolerance
of 1e-4 that the kernel is held to on the card (tests/test_torch_kernels.py,
chip_smoke.py) tells 3xTF32 from 1xTF32, the GPU tests' precision case (a
large common offset, which GroupNorm subtracts) included.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cleandiffuser_tpu_torch.ops.film_resblock import film_resblock_reference
from cleandiffuser_tpu_torch.utils.embeddings import mish

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


def conv(x, w, mode: str):
    """SAME conv of (B, H, Cin) with a (K, Cin, Cout) kernel as one GEMM
    over (tap, channel): the kernel's implicit GEMM, written out."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K // 2, K // 2))
    cols = torch.cat([xp[:, k:k + x.shape[1]] for k in range(K)], dim=-1)
    return matmul(cols.flatten(0, 1), w.flatten(0, 1), mode).unflatten(0, x.shape[:2])


def block(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip, *, groups, eps, mode):
    """film_resblock_reference (add FiLM) with its products in `mode`."""
    gn = lambda h, s, b: F.group_norm(h.transpose(1, 2), groups, s, b, eps).transpose(1, 2)
    h = mish(gn(conv(x, w1, mode) + b1, g1s, g1b)) + emb[:, None, :]
    h = mish(gn(conv(h, w2, mode) + b2, g2s, g2b))
    if wskip is None:
        return h + x
    return h + matmul(x.flatten(0, 1), wskip, mode).unflatten(0, x.shape[:2]) + bskip


def test_tf32_hi_is_exact_tf32():
    """hi and lo (as the tensor core reads it) keep 10 stored mantissa
    bits, the low 13 zero; hi is v rounded to nearest: within half a TF32
    ulp, 2^-11 relative."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.uniform(-4, 4, 100_000))
                         .astype(np.float32))
    hi, lo = split(v)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((v - hi).abs() <= v.abs() * 2.0 ** -11).all())
    # a tie rounds away from zero, as cvt.rna.tf32.f32 does
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], dtype=torch.float32)
    assert tf32(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def test_tf32_split_reconstructs_f32():
    """hi + lo gives v back to 2^-21 relative: |v - hi| <= 2^-11 |v|, and
    truncating it to TF32 loses less than 2^-10 of that."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((5, 512, 128)).astype(np.float32) * 0.02)
    hi, lo = split(w)
    rel = ((hi.double() + lo.double() - w.double()).abs() / w.double().abs()).max().item()
    assert rel <= 2.0 ** -21


def test_three_products_keep_f32_accuracy_at_the_widest_depth():
    """A 256 x 2560 @ 2560 x 256 product: 2560 = 5 taps x 512 channels, the
    depth of the U-Net's widest conv. Against float64, the 3-product sum
    misses by less than 1e-6 of max |ref| (~5e-7, as plain f32 does),
    one TF32 product by more than 1e-4 (~3e-4)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((256, 2560)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((2560, 256)) / np.sqrt(2560)).astype(np.float32))
    ref = a.double() @ b.double()
    scale = ref.abs().max().item()
    err = {m: (matmul(a, b, m).double() - ref).abs().max().item() / scale
           for m in ("3x", "1x", "f32")}
    assert err["3x"] < 1e-6 and err["f32"] < 1e-6
    assert err["1x"] > 1e-4


def _block_inputs(B, H, Cin, Cout, K, x_offset, w_mean, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0, mean=0.0: torch.from_numpy(
        (mean + rng.standard_normal(s) * std).astype(np.float32))
    x = f(B, H, Cin) + x_offset
    emb = f(B, Cout, std=0.5)
    ws = [f(K, Cin, Cout, std=(K * Cin) ** -0.5, mean=w_mean), f(Cout, std=0.1),
          1 + f(Cout, std=0.1), f(Cout, std=0.1),
          f(K, Cout, Cout, std=(K * Cout) ** -0.5, mean=w_mean), f(Cout, std=0.1),
          1 + f(Cout, std=0.1), f(Cout, std=0.1)]
    skip = [f(Cin, Cout, std=Cin ** -0.5), f(Cout, std=0.1)] if Cin != Cout else [None, None]
    return x, emb, ws, skip


@pytest.mark.parametrize("shape", [
    (7, 32, 23, 32, 5, 0.0, 0.0), (5, 4, 512, 128, 5, 0.0, 0.0), (9, 4, 256, 256, 5, 0.0, 0.0),
    (5, 4, 512, 128, 5, 10.0, 0.05), (7, 32, 23, 32, 5, 10.0, 0.05)],
    ids=["cin23", "cin512", "c256", "offset-cin512", "offset-cin23"])
def test_block_in_3xtf32_holds_the_kernel_tolerance(shape):
    """The whole block with its products in 3xTF32 stays within the
    kernel's 1e-4 of the plain version in float64 (measured up to ~1e-5
    where x carries an offset of 10, ~2e-6 without); with one TF32 product
    it misses by more than 1e-4 at every one of these shapes."""
    *dims, x_offset, w_mean = shape
    x, emb, ws, skip = _block_inputs(*dims, x_offset, w_mean)
    kw = dict(groups=8, eps=1e-6)
    ref = film_resblock_reference(
        *(None if t is None else t.double() for t in (x, emb, *ws, *skip)), K=dims[4], **kw)
    emulated = {m: block(x, emb, *ws, *skip, mode=m, **kw).double() for m in ("3x", "1x")}
    torch.testing.assert_close(emulated["3x"], ref, atol=TOL, rtol=TOL)
    miss = ((emulated["1x"] - ref).abs() / (TOL + TOL * ref.abs())).max().item()
    assert miss > 1.0, "one TF32 product should miss the block tolerance"

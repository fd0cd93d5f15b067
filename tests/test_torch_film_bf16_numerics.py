"""The rounding of the fused FiLM block's BF16 route
(cleandiffuser_tpu_torch/csrc/film_resblock_bf16.cu), emulated on the CPU.

The route runs its convs on `wgmma` with BF16 operands and f32
accumulators. Its rounding points: x is rounded to BF16 as it is staged
into shared memory (an f32 x; a BF16 x is already BF16); the products sum
in f32; GroupNorm takes its statistics (two-pass) from the f32
accumulators; the affine, Mish and FiLM run in f32; the hidden tile
between conv1 and conv2 is rounded to BF16; the residual adds x in its own
type (or the skip conv on the BF16 x, in f32). These tests hold that
emulation, at the widest depths of the shipped U-Nets (MuJoCo's
(4, 512->128) block and antmaze's (8, 1024->256)), within the route's
limit of 5e-2 abs + 5e-2 rel of both plain versions on the same BF16
operands: the port's `film_resblock_reference` and the JAX package's
`film_resblock_reference` (cleandiffuser_tpu/ops/film_resblock.py). So the
tolerance the kernel is held to on the card (tests/test_torch_kernels.py,
chip_smoke.py) covers what its arithmetic does, not only what one run
measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cleandiffuser_tpu.ops.film_resblock import film_resblock_reference as jax_film_reference
from cleandiffuser_tpu_torch.ops.film_resblock import film_resblock_reference
from cleandiffuser_tpu_torch.utils.embeddings import mish

torch.set_num_threads(1)

TOL = 5e-2  # the BF16 route's limit against its plain version, abs and rel
K, GROUPS, EPS = 5, 8, 1e-5  # eps: the JAX reference's
# (B, H, Cin, Cout): the deepest conv1 and skip of the MuJoCo and antmaze
# U-Nets (UNET_BLOCKS and ANTMAZE_UNET_BLOCKS in chip_smoke.py)
SHAPES = {"mujoco-512-128": (4, 4, 512, 128), "antmaze-1024-256": (3, 8, 1024, 256)}


def bf16(v: torch.Tensor) -> torch.Tensor:
    """v rounded to BF16 (to nearest even), as f32."""
    return v.to(torch.bfloat16).float()


def conv(x, w):
    """SAME conv of (B, H, Cin) with a (K, Cin, Cout) kernel, summed in f32:
    one GEMM over (tap, channel), the route's implicit GEMM written out."""
    xp = F.pad(x, (0, 0, K // 2, K // 2))
    cols = torch.cat([xp[:, k:k + x.shape[1]] for k in range(K)], dim=-1)
    return (cols.flatten(0, 1) @ w.flatten(0, 1)).unflatten(0, x.shape[:2])


def group_norm(h, scale, bias):
    """Two-pass statistics per (sample, group) over (H, C / groups), f32."""
    B, H, C = h.shape
    g = h.reshape(B, H, GROUPS, C // GROUPS)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    return ((g - mean) * torch.rsqrt(var + EPS)).reshape(B, H, C) * scale + bias


def route(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip):
    """The route's arithmetic (module note); weights as BF16 values in f32."""
    h = mish(group_norm(conv(bf16(x), w1) + b1, g1s, g1b)) + emb[:, None, :]
    h = mish(group_norm(conv(bf16(h), w2) + b2, g2s, g2b))
    if wskip is None:
        return h + x
    return h + (bf16(x).flatten(0, 1) @ wskip).unflatten(0, x.shape[:2]) + bskip


def operands(B, H, Cin, Cout, seed=0):
    """Seeded numpy operands of one block: f32 x and emb, BF16-rounded
    weights, biases and affine (as float32 arrays), the skip conv when
    Cin != Cout."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0, mean=0.0: (mean + rng.standard_normal(s) * std).astype(np.float32)
    r = lambda a: np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())
    x, emb = f(B, H, Cin), f(B, Cout, std=0.5)
    ws = [f(K, Cin, Cout, std=(K * Cin) ** -0.5), f(Cout, std=0.1), f(Cout, std=0.1, mean=1.0),
          f(Cout, std=0.1), f(K, Cout, Cout, std=(K * Cout) ** -0.5), f(Cout, std=0.1),
          f(Cout, std=0.1, mean=1.0), f(Cout, std=0.1)]
    skip = [f(Cin, Cout, std=Cin ** -0.5), f(Cout, std=0.1)] if Cin != Cout else []
    return x, emb, [r(w) for w in ws + skip]


def used(got, want):
    """The share of the limit used: |d| / (TOL + TOL |want|), at its max."""
    return float((np.abs(got - want) / (TOL + TOL * np.abs(want))).max())


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_bf16_route_rounding_within_the_limit_of_the_port_reference(shape):
    x, emb, ws = operands(*shape)
    t = lambda a: torch.from_numpy(a)
    skip = ws[8:] or [None, None]
    emulated = route(t(x), t(emb), *map(t, ws[:8]), *(None if w is None else t(w) for w in skip))
    wb = [t(w).to(torch.bfloat16) for w in ws]
    ref = film_resblock_reference(t(x), t(emb), *wb, K=K, groups=GROUPS, eps=EPS)
    assert ref.dtype == torch.float32
    share = used(emulated.numpy(), ref.numpy())
    assert share < 1.0, share


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_bf16_route_rounding_within_the_limit_of_the_jax_reference(shape):
    """The JAX reference on the same operands, its weights BF16 arrays:
    f32 math on the BF16 weights, as on a CPU."""
    x, emb, ws = operands(*shape)
    t = lambda a: torch.from_numpy(a)
    skip = ws[8:] or [None, None]
    emulated = route(t(x), t(emb), *map(t, ws[:8]), *(None if w is None else t(w) for w in skip))
    jw = [jnp.asarray(w, jnp.bfloat16) for w in ws]
    want = np.asarray(jax.jit(lambda *a: jax_film_reference(*a, K=K, groups=GROUPS))(
        jnp.asarray(x), jnp.asarray(emb), *jw), np.float32)
    share = used(emulated.numpy(), want)
    assert share < 1.0, share

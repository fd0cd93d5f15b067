"""Fused solver update: the Triton kernel, its wrapper and its plain PyTorch
version.

Counterpart of cleandiffuser_tpu/ops/solver_update.py, whose Pallas TPU
kernel `fused_solver_update` is replaced by the Triton kernel below. One
VP-SDE solver step of the form

    x = c_xt * xt + c_eps * eps + c_noise * z,    z ~ N(0, 1)

with z drawn inside the kernel (Philox, `tl.randn(seed, offset)`), so the
noise never goes through device memory: one read of xt and eps and one
write of x, 12 bytes per element. That traffic is all that bounds it on the
card (no reuse, no products), so it is one elementwise pass in Triton; a
CUDA C++ version would gain nothing from shared memory or tensor cores.
With c_noise == 0 no noise is drawn and the result is the plain version's.
The TPU kernel drew z from the TPU's own bits; neither stream equals
`torch.randn`, so the two versions agree in distribution, not in numbers.

The ddpm step folds exactly into this form (`diffusion/vp_solvers.py`
`ddpm_coefficients`); the sampler routes it here with `fused_update=True`.

Dispatch (`solver_update_op`): a CPU tensor takes `solver_update_reference`
with a generator seeded from `seed`; a CUDA tensor launches the kernel or
raises. Triton is imported, and the kernel compiled, at the first launch,
into `cleandiffuser_tpu_torch/_build/triton` unless TRITON_CACHE_DIR is set.
"""

from __future__ import annotations

import functools
import os

import torch

from .build import BUILD_DIR

__all__ = ["fused_solver_update", "solver_update_op", "solver_update_reference"]

_BLOCK = 1024


def solver_update_reference(xt, eps, coefs, generator=None):
    """Plain PyTorch version: coefs = (c_xt, c_eps, c_noise) floats; the
    noise is `torch.randn` from `generator` (none is drawn if c_noise == 0)."""
    c_xt, c_eps, c_noise = coefs
    x = c_xt * xt + c_eps * eps
    if c_noise == 0.0:
        return x
    return x + c_noise * torch.randn(xt.shape, generator=generator, device=xt.device,
                                     dtype=xt.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """Import Triton and define the kernel (compiled at its first launch)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def solver_update_kernel(xt_ptr, eps_ptr, out_ptr, n, c_xt, c_eps, c_noise, seed,
                             NOISE: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = c_xt * tl.load(xt_ptr + offs, mask=mask) + c_eps * tl.load(eps_ptr + offs, mask=mask)
        if NOISE:
            # Philox on (seed, element index): the stream does not depend on
            # the block size or the grid
            x += c_noise * tl.randn(seed, offs)
        tl.store(out_ptr + offs, x, mask=mask)

    return triton, solver_update_kernel


def fused_solver_update(xt, eps, coefs, seed: int):
    """Launch the Triton kernel on the current stream: a new tensor
    c_xt*xt + c_eps*eps + c_noise*z, z drawn from (seed, element index).
    Raises on any input the kernel does not take."""
    if xt.device.type != "cuda":
        raise ValueError(f"fused_solver_update runs on CUDA tensors, got {xt.device}")
    if eps.shape != xt.shape or eps.device != xt.device:
        raise ValueError(f"eps {tuple(eps.shape)} on {eps.device} must match xt "
                         f"{tuple(xt.shape)} on {xt.device}")
    for name, t in (("xt", xt), ("eps", eps)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_solver_update takes float32 only; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} must be in [0, 2**31)")
    triton, kernel = _kernel()
    c_xt, c_eps, c_noise = (float(c) for c in coefs)
    out = torch.empty_like(xt)
    n = xt.numel()
    with torch.cuda.device(xt.device):
        kernel[(triton.cdiv(n, _BLOCK),)](xt, eps, out, n, c_xt, c_eps, c_noise, seed,
                                          NOISE=c_noise != 0.0, BLOCK=_BLOCK)
    fused_solver_update.launches += 1
    return out


fused_solver_update.launches = 0


def solver_update_op(xt, eps, coefs, seed: int):
    """The step as the sampler calls it: a CPU tensor takes the plain version
    (noise from a generator seeded with `seed`); any other device goes to
    the kernel, which launches or raises."""
    if xt.device.type == "cpu":
        return solver_update_reference(xt, eps, coefs, torch.Generator().manual_seed(seed))
    return fused_solver_update(xt, eps, coefs, seed)

"""The port's fused solver update (ops/solver_update.py) and the ddpm fold
that routes the sampler through it (diffusion/vp_solvers.py
`ddpm_coefficients`), against the JAX package.

On the CPU the update runs its plain PyTorch version; the Triton kernel is
held against that plain version in tests/test_torch_kernels.py, on a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.diffusion.vp_solvers import solver_step as jax_solver_step
from cleandiffuser_tpu.ops.solver_update import solver_update_reference as jax_reference
from cleandiffuser_tpu_torch.diffusion import DiscreteDiffusionSDE
from cleandiffuser_tpu_torch.diffusion.vp_solvers import ddpm_coefficients, solver_step
from cleandiffuser_tpu_torch.ops import solver_update as ops

torch.set_num_threads(1)


def _inputs(shape=(64, 32, 23), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_plain_version_without_noise_equals_jax_reference():
    """c_noise = 0: c_xt*xt + c_eps*eps on both sides, the same float32
    operations in the same order: equal to the bit."""
    xt, eps, _ = _inputs()
    coefs = (0.987, -0.123, 0.0)
    want = jax_reference(jnp.asarray(xt), jnp.asarray(eps), jnp.asarray(coefs, jnp.float32),
                         jax.random.PRNGKey(0))
    got = ops.solver_update_reference(torch.from_numpy(xt), torch.from_numpy(eps),
                                      [float(np.float32(c)) for c in coefs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tables(steps=20):
    engine = DiscreteDiffusionSDE(torch.nn.Identity(), diffusion_steps=20, device="cpu")
    ts, alphas, sigmas = engine._sample_tables("uniform", steps)
    stds = torch.cat([torch.zeros(1), sigmas[:-1] / sigmas[1:]
                      * torch.sqrt(1 - (alphas[1:] / alphas[:-1]) ** 2)])
    hs = torch.zeros_like(alphas)  # ddpm reads no h
    return alphas, sigmas, hs, stds


@pytest.mark.parametrize("i", [20, 11, 2, 1])
def test_ddpm_fold_matches_solver_step(i):
    """c_xt*xt + c_eps*eps + c_noise*z with the folded coefficients equals
    the ddpm step of the port and of the JAX package on the same z, at a
    noisy level, the last noisy one, and the final one (c_noise = 0).
    The fold rounds (a_p/a_i)*(xt - s_i*eps) + c*eps in another order; at
    the noisiest level a_p/a_i is ~65 and the terms cancel, so the bound is
    a few float32 ulps of the terms' size, element by element."""
    alphas, sigmas, hs, stds = _tables()
    xt, eps, z = _inputs(seed=i)
    coefs = ddpm_coefficients(i, alphas, sigmas, stds)
    assert (coefs[2] == 0.0) == (i == 1)
    t = torch.from_numpy
    fused = coefs[0] * t(xt) + coefs[1] * t(eps) + coefs[2] * t(z)
    port = solver_step("ddpm", t(xt), t(eps), None, None, False, i, alphas, sigmas, hs, stds,
                       t(z) if i > 1 else None)
    want = jax_solver_step("ddpm", jnp.asarray(xt), jnp.asarray(eps), None, None, False, i,
                           *(jnp.asarray(a.numpy()) for a in (alphas, sigmas, hs, stds)),
                           jnp.asarray(z))
    # the size of the unfolded terms: c_xt*xt, c_xt*s_i*eps, c*eps, c_noise*z
    c_xt_s = abs(coefs[0] * float(sigmas[i]))
    size = (coefs[0] * abs(xt) + (2 * c_xt_s + abs(coefs[1])) * abs(eps)
            + coefs[2] * abs(z)).astype(np.float64)
    bound = 8 * np.finfo(np.float32).eps * size
    for other in (port.numpy(), np.asarray(want)):
        assert (np.abs(fused.numpy().astype(np.float64) - other) <= bound).all()


def test_op_on_the_cpu_is_seeded_and_standard_normal():
    """solver_update_op on a CPU tensor: the plain version with noise from
    a generator seeded with `seed`. Same seed, same output; another seed,
    another; z = (out - c_xt*xt - c_eps*eps) / c_noise is standard normal."""
    xt, eps, _ = (torch.from_numpy(a) for a in _inputs((256, 32, 23)))
    coefs = (0.9, -0.2, 0.3)
    a = ops.solver_update_op(xt, eps, coefs, 5)
    torch.testing.assert_close(a, ops.solver_update_op(xt, eps, coefs, 5), atol=0, rtol=0)
    assert not torch.equal(a, ops.solver_update_op(xt, eps, coefs, 6))
    z = ((a - 0.9 * xt + 0.2 * eps) / 0.3).double()
    assert abs(z.mean().item()) < 0.01 and abs(z.std().item() - 1) < 0.01


def test_kernel_wrapper_has_no_cpu_path():
    """The kernel launcher raises on a CPU tensor and counts nothing (and
    does not import Triton to find that out)."""
    xt, eps, _ = (torch.from_numpy(a) for a in _inputs((4, 8, 3)))
    before = ops.fused_solver_update.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_solver_update(xt, eps, (1.0, 0.0, 0.0), 0)
    assert ops.fused_solver_update.launches == before

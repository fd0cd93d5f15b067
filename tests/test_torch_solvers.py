"""The port's schedules and solver steps (cleandiffuser_tpu_torch/utils/
schedules.py, diffusion/vp_solvers.py) against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.diffusion import vp_solvers as jax_solvers
from cleandiffuser_tpu.utils import schedules as jax_sched
from cleandiffuser_tpu_torch.diffusion import vp_solvers as solvers
from cleandiffuser_tpu_torch.utils import schedules as sched

torch.set_num_threads(1)

# Schedules: float32 on both sides; linspace, exp and cos may round their
# last bit differently in the two libraries, so a few float32 ulps.
SCHED_TOL = 1e-6


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_noise_schedule_matches_jax(name):
    t = np.linspace(1e-3, 1.0, 37, dtype=np.float32)
    fwd_j = jax_sched.SUPPORTED_NOISE_SCHEDULES[name]["forward"]
    fwd_t = sched.SUPPORTED_NOISE_SCHEDULES[name]["forward"]
    (aj, sj), (at, st) = fwd_j(jnp.asarray(t)), fwd_t(torch.from_numpy(t))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=SCHED_TOL, atol=SCHED_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=SCHED_TOL, atol=SCHED_TOL)
    # and the inverse: logSNR -> t
    inv_j = jax_sched.SUPPORTED_NOISE_SCHEDULES[name]["reverse"]
    inv_t = sched.SUPPORTED_NOISE_SCHEDULES[name]["reverse"]
    np.testing.assert_allclose(inv_t(at, st).numpy(), np.asarray(inv_j(aj, sj)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(jax_sched.SUPPORTED_SAMPLING_STEP_SCHEDULE))
def test_sampling_step_schedule_matches_jax(name):
    arg = 1000 if not name.endswith("_continuous") else [1e-3, 1.0]
    want = np.asarray(jax_sched.SUPPORTED_SAMPLING_STEP_SCHEDULE[name](arg, 20))
    got = sched.SUPPORTED_SAMPLING_STEP_SCHEDULE[name](arg, 20).numpy()
    assert got.dtype == want.dtype
    if name.endswith("_continuous"):
        np.testing.assert_allclose(got, want, rtol=SCHED_TOL, atol=SCHED_TOL)
    else:  # integer grids: a float32 ulp can move a truncation by one step
        assert np.abs(got.astype(np.int64) - want).max() <= 1


def test_other_schedules_match_jax():
    pairs = [
        (sched.linear_beta_schedule(), jax_sched.linear_beta_schedule()),
        (sched.cosine_beta_schedule(), jax_sched.cosine_beta_schedule()),
        (sched.uniform_discretization(), jax_sched.uniform_discretization()),
        (sched.karras_sigma_schedule(0.002, 80.0, 7.0, 18),
         jax_sched.karras_sigma_schedule(0.002, 80.0, 7.0, 18)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _tables(steps=6):
    """The engine's sampling tables (ContinuousDiffusionSDE, linear)."""
    ts = jax_sched.uniform_sampling_step_schedule_continuous([1e-3, 1.0], steps)
    alphas, sigmas = jax_sched.linear_noise_schedule(ts)
    logsnr = jnp.log(alphas / sigmas)
    hs = jnp.concatenate([jnp.zeros((1,)), logsnr[:-1] - logsnr[1:]])
    stds = jnp.concatenate([jnp.zeros((1,)), sigmas[:-1] / sigmas[1:]
                            * jnp.sqrt(1 - (alphas[1:] / alphas[:-1]) ** 2)])
    return [np.array(a, np.float32) for a in (alphas, sigmas, hs, stds)]


@pytest.mark.parametrize("solver", solvers.SUPPORTED_SOLVERS)
def test_solver_step_matches_jax(solver):
    """One step of every solver from every level, given the same explicit
    noise. 1e-5: float32 on both sides; the port computes each coefficient
    in float32 on the host, as the reference does inside its scan."""
    assert solvers.SUPPORTED_SOLVERS == jax_solvers.SUPPORTED_SOLVERS
    tables = _tables()
    rng = np.random.default_rng(0)
    xt, eps, x_theta, prev, noise = (
        rng.standard_normal((3, 8, 5)).astype(np.float32) for _ in range(5))
    for i in range(len(tables[0]) - 1, 0, -1):
        for is_first in (True, False):
            want = jax_solvers.solver_step(
                solver, *map(jnp.asarray, (xt, eps, x_theta, prev)), is_first, i,
                *map(jnp.asarray, tables), jnp.asarray(noise))
            uses = solvers.solver_uses_noise(solver, i)
            got = solvers.solver_step(
                solver, *map(torch.from_numpy, (xt, eps, x_theta, prev)), is_first, i,
                *map(torch.from_numpy, tables), torch.from_numpy(noise) if uses else None)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{solver} i={i} first={is_first}")


def test_prediction_conversions_match_jax():
    rng = np.random.default_rng(1)
    x, p = (rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2))
    for f_t, f_j in ((solvers.epstheta_to_xtheta, jax_solvers.epstheta_to_xtheta),
                     (solvers.xtheta_to_epstheta, jax_solvers.xtheta_to_epstheta)):
        got = f_t(torch.from_numpy(x), 0.8, 0.6, torch.from_numpy(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(f_j(x, 0.8, 0.6, p)), rtol=1e-6)

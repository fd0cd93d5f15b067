"""Golden tests of the port's sampler (cleandiffuser_tpu_torch/diffusion/
diffusionsde.py) against the numpy references of tests/test_solver_golden.py:
an independent numpy replica of the reference denoising loop for a
deterministic oracle network, for every ODE solver, exact to the JAX
package's tolerance; the sampling tables against the published formulas;
and, with the exact score of N(mu, S^2), every stochastic solver's samples
against that distribution. The port's engine runs on the CPU; the initial
noise is passed explicitly, as the reference sampler's first draw."""

import numpy as np
import pytest
import torch
import torch.nn as nn

from cleandiffuser_tpu_torch.diffusion import DiscreteDiffusionSDE
from test_solver_golden import ACT, STEPS, T, numpy_reference_sampler


class OracleEps(nn.Module):
    """Deterministic eps-predictor: eps = tanh(x) * 0.5 (ignores t)."""

    def forward(self, x, t, emb=None):
        return torch.tanh(x) * 0.5


class GaussianOracle(nn.Module):
    """Exact eps-predictor for data ~ N(mu, S^2) under the VP forward
    process: eps*(x, t) = sigma_t (x - alpha_t mu) / (alpha_t^2 S^2 + sigma_t^2)."""

    def __init__(self, mu, S, alpha, sigma):
        super().__init__()
        self.mu, self.S, self.alpha, self.sigma = mu, S, alpha, sigma

    def forward(self, x, t, emb=None):
        a, s = self.alpha[t.long()][:, None], self.sigma[t.long()][:, None]
        return s * (x - a * self.mu) / (a**2 * self.S**2 + s**2)


@pytest.mark.parametrize(
    "solver", ["ddim", "ode_dpmsolver_1", "ode_dpmsolver++_1", "ode_dpmsolver++_2M"])
def test_sampler_matches_numpy_reference(solver):
    engine = DiscreteDiffusionSDE(OracleEps(), diffusion_steps=T, noise_schedule="linear",
                                  device="cpu")
    sample_fn = engine.build_sample_fn(solver=solver, sample_steps=STEPS, cfg_mode="uncond",
                                       final_logp=False)
    x_init = np.random.default_rng(42).standard_normal((4, ACT)).astype(np.float32)
    noise = (torch.from_numpy(x_init), torch.zeros((STEPS, 4, ACT)))
    out, _ = sample_fn(engine.ema_params, None, torch.zeros((4, ACT)), noise=noise)
    expected = numpy_reference_sampler(x_init, solver, engine.alpha.numpy(),
                                       engine.sigma.numpy(), STEPS)
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-4, rtol=1e-4)


def test_table_construction_matches_reference_formulas():
    engine = DiscreteDiffusionSDE(OracleEps(), diffusion_steps=T, noise_schedule="linear",
                                  device="cpu")
    ts, alphas, sigmas = engine._sample_tables("uniform", STEPS)
    sched = np.linspace(0, T - 1, STEPS + 1).astype(np.int64)
    np.testing.assert_array_equal(ts.numpy(), sched)
    t_cont = np.linspace(1e-3, 1.0, T)[sched]
    la = -(20.0 - 0.1) / 4 * t_cont**2 - 0.1 / 2 * t_cont
    np.testing.assert_allclose(alphas.numpy(), np.exp(la), rtol=1e-5)
    np.testing.assert_allclose(sigmas.numpy(), np.sqrt(1 - np.exp(2 * la)), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("solver", ["ddpm", "sde_dpmsolver++_1", "ddim"])
def test_stochastic_solvers_match_analytic_gaussian(solver):
    """With the exact score of N(mu, S^2), every solver's samples have that
    mean and std (the SDE solvers' noise terms included)."""
    mu, S = 1.5, 0.7
    tmp = DiscreteDiffusionSDE(OracleEps(), diffusion_steps=128, noise_schedule="linear",
                               device="cpu")
    oracle = GaussianOracle(mu, S, tmp.alpha, tmp.sigma)
    engine = DiscreteDiffusionSDE(oracle, diffusion_steps=128, noise_schedule="linear",
                                  device="cpu")
    sample_fn = engine.build_sample_fn(solver=solver, sample_steps=64, cfg_mode="uncond",
                                       final_logp=False)
    gen = torch.Generator().manual_seed(0)
    out, _ = sample_fn(engine.ema_params, gen, torch.zeros((4096, 1)))
    samples = out.numpy()[:, 0]
    assert abs(samples.mean() - mu) < 0.08, f"mean {samples.mean()} != {mu}"
    assert abs(samples.std() - S) < 0.08, f"std {samples.std()} != {S}"

"""One-step VP-SDE solver updates (counterpart of
cleandiffuser_tpu/diffusion/vp_solvers.py): ddpm, ddim, dpm-solver-1 (ODE),
dpm-solver++-1 / ++-2M (ODE), and their SDE variants.

The per-step scalars come from float32 (steps+1,) tables on the host,
indexed by the Python int `i`; `i-1` indexes the next (less noisy) level.
Each coefficient is computed in float32 on the host, as the reference
computes it inside its scan, and enters the update as a Python float (the
exact float32 value), so the loop over steps needs no device
synchronisation. `noise` is a standard normal of x's shape (None where the
solver adds none), `is_first` marks the first step (used by the 2M
multistep correction), `prev_x_theta` is the previous step's data
prediction.
"""

from __future__ import annotations

import torch

SUPPORTED_SOLVERS = [
    "ddpm",
    "ddim",
    "ode_dpmsolver_1",
    "ode_dpmsolver++_1",
    "ode_dpmsolver++_2M",
    "sde_dpmsolver_1",
    "sde_dpmsolver++_1",
    "sde_dpmsolver++_2M",
]

__all__ = ["SUPPORTED_SOLVERS", "solver_step", "solver_uses_noise", "ddpm_coefficients",
           "epstheta_to_xtheta", "xtheta_to_epstheta"]


def epstheta_to_xtheta(x, alpha, sigma, eps_theta):
    """x_theta = (x - sigma * eps_theta) / alpha."""
    return (x - sigma * eps_theta) / alpha


def xtheta_to_epstheta(x, alpha, sigma, x_theta):
    """eps_theta = (x - alpha * x_theta) / sigma."""
    return (x - alpha * x_theta) / sigma


def solver_uses_noise(solver: str, i: int) -> bool:
    """Whether `solver_step` at level i reads `noise` (ddpm adds none when
    stepping onto the final level)."""
    return solver.startswith("sde_") or (solver == "ddpm" and i > 1)


def ddpm_coefficients(i: int, alphas, sigmas, stds):
    """The ddpm step as (c_xt, c_eps, c_noise), float32 on the host, for
    x = c_xt * xt + c_eps * eps_theta + c_noise * noise
    (ops/solver_update.py): the same update as `solver_step("ddpm", ...)`,
    with its two eps_theta terms folded into one coefficient."""
    a_i, a_p, s_i, s_p, std_i = alphas[i], alphas[i - 1], sigmas[i], sigmas[i - 1], stds[i]
    c_xt = a_p / a_i
    c = torch.sqrt(torch.clamp(s_p**2 - std_i**2, min=0.0) + 1e-8)
    return float(c_xt), float(-c_xt * s_i + c), float(std_i) if i > 1 else 0.0


def solver_step(solver: str, xt, eps_theta, x_theta, prev_x_theta, is_first: bool,
                i: int, alphas, sigmas, hs, stds, noise):
    """Advance x from noise level i to level i-1. Returns new x."""
    a_i, a_p = alphas[i], alphas[i - 1]
    s_i, s_p = sigmas[i], sigmas[i - 1]
    h_i = hs[i]
    std_i = stds[i]
    f = float  # a float32 0-d host tensor -> its exact value

    if solver == "ddpm":
        c = torch.sqrt(torch.clamp(s_p**2 - std_i**2, min=0.0) + 1e-8)
        x = f(a_p / a_i) * (xt - f(s_i) * eps_theta) + f(c) * eps_theta
        # noise only added when not stepping onto the final level (i > 1)
        if i > 1:
            x = x + f(std_i) * noise

    elif solver == "ddim":
        x = f(a_p) * ((xt - f(s_i) * eps_theta) / f(a_i)) + f(s_p) * eps_theta

    elif solver == "ode_dpmsolver_1":
        x = f(a_p / a_i) * xt - f(s_p * torch.expm1(h_i)) * eps_theta

    elif solver == "ode_dpmsolver++_1":
        x = f(s_p / s_i) * xt - f(a_p * torch.expm1(-h_i)) * x_theta

    elif solver in ("ode_dpmsolver++_2M", "sde_dpmsolver++_2M"):
        # multistep correction uses the previous data prediction
        if is_first:
            D = x_theta
        else:
            r = hs[min(i + 1, hs.shape[0] - 1)] / h_i
            D = f(1 + 0.5 / r) * x_theta - f(0.5 / r) * prev_x_theta
        if solver == "ode_dpmsolver++_2M":
            x = f(s_p / s_i) * xt - f(a_p * torch.expm1(-h_i)) * D
        else:
            x = (
                f((s_p / s_i) * torch.exp(-h_i)) * xt
                - f(a_p * torch.expm1(-2 * h_i)) * D
                + f(s_p * torch.sqrt(torch.clamp(-torch.expm1(-2 * h_i), min=0.0))) * noise
            )

    elif solver == "sde_dpmsolver_1":
        x = (
            f(a_p / a_i) * xt
            - f(2 * s_p * torch.expm1(h_i)) * eps_theta
            + f(s_p * torch.sqrt(torch.clamp(torch.expm1(2 * h_i), min=0.0))) * noise
        )

    elif solver == "sde_dpmsolver++_1":
        x = (
            f((s_p / s_i) * torch.exp(-h_i)) * xt
            - f(a_p * torch.expm1(-2 * h_i)) * x_theta
            + f(s_p * torch.sqrt(torch.clamp(-torch.expm1(-2 * h_i), min=0.0))) * noise
        )

    else:
        raise ValueError(f"Solver {solver} is not supported.")

    return x

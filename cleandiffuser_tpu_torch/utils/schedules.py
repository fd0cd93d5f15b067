"""Noise / discretization / sampling-step schedules for VP-SDE diffusion.

Counterpart of cleandiffuser_tpu/utils/schedules.py. All functions are pure
float32 torch so tables built here match the reference's float32 tables.

Conventions (VP-SDE):
    x_t = alpha(t) * x_0 + sigma(t) * eps,   alpha^2 + sigma^2 = 1
    logSNR(t) = log(alpha / sigma)
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

__all__ = [
    "linear_beta_schedule",
    "cosine_beta_schedule",
    "uniform_discretization",
    "linear_noise_schedule",
    "inverse_linear_noise_schedule",
    "cosine_noise_schedule",
    "inverse_cosine_noise_schedule",
    "SUPPORTED_DISCRETIZATIONS",
    "SUPPORTED_NOISE_SCHEDULES",
    "SUPPORTED_SAMPLING_STEP_SCHEDULE",
    "karras_sigma_schedule",
]

_F32 = torch.float32


def _t(x):
    return torch.as_tensor(x, dtype=_F32)


# ------------------------------------------------------------------
# Beta schedules (legacy DDPM-style discrete engines)
# ------------------------------------------------------------------
def linear_beta_schedule(beta_min: float = 1e-4, beta_max: float = 0.02, T: int = 1000):
    return torch.linspace(beta_min, beta_max, T, dtype=_F32)


def cosine_beta_schedule(s: float = 0.008, T: int = 1000):
    f = torch.cos((torch.arange(T + 1, dtype=_F32) / T + s) / (1 + s) * math.pi / 2.0) ** 2
    alpha_bar = f / f[0]
    beta = 1 - alpha_bar[1:] / alpha_bar[:-1]
    return torch.clamp(beta, max=0.999)


# ------------------------------------------------------------------
# Discretization: map [eps, 1] onto T grid points
# ------------------------------------------------------------------
def uniform_discretization(T: int = 1000, eps: float = 1e-3):
    return torch.linspace(eps, 1.0, T, dtype=_F32)


SUPPORTED_DISCRETIZATIONS: Dict[str, Callable] = {
    "uniform": uniform_discretization,
}


# ------------------------------------------------------------------
# Noise schedules: t -> (alpha, sigma) and inverse
# ------------------------------------------------------------------
def linear_noise_schedule(t, beta0: float = 0.1, beta1: float = 20.0):
    t = _t(t)
    log_alpha = -(beta1 - beta0) / 4.0 * (t**2) - beta0 / 2.0 * t
    alpha = torch.exp(log_alpha)
    sigma = torch.sqrt(1.0 - alpha**2)
    return alpha, sigma


def inverse_linear_noise_schedule(
    alpha=None, sigma=None, logSNR=None, beta0: float = 0.1, beta1: float = 20.0
):
    lmbda = torch.log(_t(alpha) / _t(sigma)) if logSNR is None else _t(logSNR)
    v = torch.log(1 + torch.exp(-2 * lmbda))
    return 2 * v / (beta0 + torch.sqrt(beta0**2 + 2 * (beta1 - beta0) * v))


def cosine_noise_schedule(t, s: float = 0.008):
    t = _t(t)
    alpha = torch.cos(math.pi / 2.0 * (torch.clamp(t, 0.0, 0.9946) + s) / (1 + s)) / math.cos(
        math.pi / 2.0 * s / (1 + s)
    )
    sigma = torch.sqrt(1.0 - alpha**2)
    return alpha, sigma


def inverse_cosine_noise_schedule(alpha=None, sigma=None, logSNR=None, s: float = 0.008):
    lmbda = torch.log(_t(alpha) / _t(sigma)) if logSNR is None else _t(logSNR)
    inner = torch.exp(
        -0.5 * torch.log(1 + torch.exp(-2 * lmbda)) + math.log(math.cos(math.pi * s / 2 / (s + 1)))
    )
    return 2 * (1 + s) / math.pi * torch.arccos(inner) - s


SUPPORTED_NOISE_SCHEDULES: Dict[str, Dict[str, Callable]] = {
    "linear": {"forward": linear_noise_schedule, "reverse": inverse_linear_noise_schedule},
    "cosine": {"forward": cosine_noise_schedule, "reverse": inverse_cosine_noise_schedule},
}


# ------------------------------------------------------------------
# Sampling-step schedules
#   Discrete variants: (T, sampling_steps) -> int32 (steps+1,) in [0, T-1]
#   Continuous variants: (trange, sampling_steps) -> float32 (steps+1,)
# ------------------------------------------------------------------
def uniform_sampling_step_schedule(T: int = 1000, sampling_steps: int = 10):
    return torch.linspace(0, T - 1, sampling_steps + 1, dtype=_F32).to(torch.int32)


def uniform_sampling_step_schedule_continuous(trange=None, sampling_steps: int = 10):
    if trange is None:
        trange = [1e-3, 1.0]
    return torch.linspace(trange[0], trange[1], sampling_steps + 1, dtype=_F32)


def quad_sampling_step_schedule(T: int = 1000, sampling_steps: int = 10, n: float = 1.5):
    sched = (T - 1) * (torch.linspace(0, 1, sampling_steps + 1, dtype=_F32) ** n)
    return sched.to(torch.int32)


def quad_sampling_step_schedule_continuous(trange=None, sampling_steps: int = 10, n: float = 1.5):
    if trange is None:
        trange = [1e-3, 1.0]
    return (trange[1] - trange[0]) * (
        torch.linspace(0, 1, sampling_steps + 1, dtype=_F32) ** n
    ) + trange[0]


def _cat_cos_idx(sampling_steps: int, n: float):
    idx = torch.linspace(0, 1, sampling_steps + 1, dtype=_F32)
    return (
        0.5 * (2 * (idx > 0.5).to(_F32) - 1)
        * torch.sin(math.pi * torch.abs(idx - 0.5)) ** (1 / n) + 0.5
    )


def cat_cos_sampling_step_schedule(T: int = 1000, sampling_steps: int = 10, n: float = 2.0):
    return ((T - 1) * _cat_cos_idx(sampling_steps, n)).to(torch.int32)


def cat_cos_sampling_step_schedule_continuous(trange=None, sampling_steps: int = 10, n: float = 2.0):
    if trange is None:
        trange = [1e-3, 1.0]
    return (trange[1] - trange[0]) * _cat_cos_idx(sampling_steps, n) + trange[0]


def _quad_cos_idx(sampling_steps: int, n: float):
    idx = torch.linspace(0, 1, sampling_steps + 1, dtype=_F32)
    return ((torch.sin(math.pi * (idx - 0.5)) + 1) / 2) ** n


def quad_cos_sampling_step_schedule(T: int = 1000, sampling_steps: int = 10, n: float = 2.0):
    return ((T - 1) * _quad_cos_idx(sampling_steps, n)).to(torch.int32)


def quad_cos_sampling_step_schedule_continuous(trange=None, sampling_steps: int = 10, n: float = 2.0):
    if trange is None:
        trange = [1e-3, 1.0]
    return (trange[1] - trange[0]) * _quad_cos_idx(sampling_steps, n) + trange[0]


SUPPORTED_SAMPLING_STEP_SCHEDULE: Dict[str, Callable] = {
    "uniform": uniform_sampling_step_schedule,
    "uniform_continuous": uniform_sampling_step_schedule_continuous,
    "quad": quad_sampling_step_schedule,
    "quad_continuous": quad_sampling_step_schedule_continuous,
    "cat_cos": cat_cos_sampling_step_schedule,
    "cat_cos_continuous": cat_cos_sampling_step_schedule_continuous,
    "quad_cos": quad_cos_sampling_step_schedule,
    "quad_cos_continuous": quad_cos_sampling_step_schedule_continuous,
}


# ------------------------------------------------------------------
# Karras (EDM) rho-schedule
# ------------------------------------------------------------------
def karras_sigma_schedule(sigma_min: float, sigma_max: float, rho: float, steps: int):
    """sigma_i for i=0..steps, increasing from sigma_min to sigma_max."""
    i = torch.arange(steps + 1, dtype=_F32)
    return (
        sigma_min ** (1 / rho) + i / steps * (sigma_max ** (1 / rho) - sigma_min ** (1 / rho))
    ) ** rho

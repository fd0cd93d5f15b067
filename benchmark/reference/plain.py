"""Plain PyTorch pieces shared by the references: layers on channels-last
tensors, the VP-SDE schedules and the ddpm step, written from the published
descriptions (Diffuser, arXiv:2205.09991; Decision Diffuser,
arXiv:2211.15657; CleanDiffuser, arXiv:2406.09509).

Nothing here imports the program under test. Weights arrive as a dict of
tensors keyed by name (the benchmark makes them from the seed); every
function reads the entries it needs by name. The
tables are computed in float32 on the host, as the published code computes
them, and enter the update as float32 scalars.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def mish(x):
    return x * torch.tanh(F.softplus(x))


def linear(w: dict, name: str, x):
    """x @ W.T + b for a weight stored (out, in)."""
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def layer_norm(x, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def conv(w: dict, name: str, x, stride: int = 1, padding=None):
    """Channels-last conv: x (b, L, Cin), kernel (K, Cin, Cout) -> (b, L', Cout);
    `padding` (lo, hi), "same" ((K - 1) // 2 each side) by default."""
    kernel = w[f"{name}.kernel"]
    k = kernel.shape[0]
    lo, hi = padding if padding is not None else ((k - 1) // 2, k // 2)
    xc = F.pad(x.transpose(1, 2), (lo, hi))
    out = F.conv1d(xc, kernel.permute(2, 1, 0), w[f"{name}.bias"], stride=stride)
    return out.transpose(1, 2)


def conv_transpose(w: dict, name: str, x):
    """Channels-last stride-2 transposed conv doubling L: weight (Cin, Cout, 4)."""
    out = F.conv_transpose1d(x.transpose(1, 2), w[f"{name}.weight"], w[f"{name}.bias"],
                             stride=2, padding=1)
    return out.transpose(1, 2)


def group_norm(w: dict, name: str, x, groups: int, eps: float = 1e-6):
    """GroupNorm over (L, C / groups) per sample, channels-last."""
    b, length, c = x.shape
    xg = x.reshape(b, length, groups, c // groups)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mu) / torch.sqrt(var + eps)).reshape(b, length, c)
    return xn * w[f"{name}.scale"] + w[f"{name}.bias"]


def positional_features(t, dim: int, max_positions: int = 10000):
    """[cos | sin] of t over dim // 2 geometric frequencies."""
    freqs = (1.0 / max_positions) ** (torch.arange(dim // 2, dtype=torch.float32,
                                                   device=t.device) / (dim // 2))
    ang = t.to(torch.float32)[:, None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def sinusoidal_features(pos, dim: int):
    """Transformer token-position features [sin | cos]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=pos.device)
                      * -(math.log(10000) / (half - 1)))
    ang = pos.to(torch.float32)[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# VP-SDE schedules
def linear_vp(t, beta0: float = 0.1, beta1: float = 20.0):
    """(alpha, sigma) of the continuous linear VP-SDE at t."""
    log_alpha = -(beta1 - beta0) / 4.0 * t ** 2 - beta0 / 2.0 * t
    alpha = torch.exp(log_alpha)
    return alpha, torch.sqrt(1.0 - alpha ** 2)


def cosine_vp(t, s: float = 0.008):
    """(alpha, sigma) of the cosine schedule at t (alpha reaches 0 at 0.9946)."""
    alpha = (torch.cos(math.pi / 2.0 * (torch.clamp(t, 0.0, 0.9946) + s) / (1 + s))
             / math.cos(math.pi / 2.0 * s / (1 + s)))
    return alpha, torch.sqrt(1.0 - alpha ** 2)


def continuous_tables(steps: int, eps: float = 1e-3):
    """A uniform grid on [eps, 1] of the linear VP-SDE: (t, alpha, sigma),
    each (steps + 1,) float32."""
    t = torch.linspace(eps, 1.0, steps + 1, dtype=torch.float32)
    return (t, *linear_vp(t))


def discrete_tables(diffusion_steps: int, steps: int, eps: float = 1e-3):
    """The discrete engine's uniform subsequence of its cosine levels: (level,
    alpha, sigma), each (steps + 1,); levels int32."""
    grid = torch.linspace(eps, 1.0, diffusion_steps, dtype=torch.float32)
    alpha, sigma = cosine_vp(grid)
    levels = torch.linspace(0, diffusion_steps - 1, steps + 1, dtype=torch.float32).to(torch.int32)
    idx = levels.long()
    return levels, alpha[idx], sigma[idx]


def ddpm_stds(alphas, sigmas):
    """The ddpm step's noise std at each level (0 at level 0)."""
    return torch.cat([torch.zeros(1), sigmas[:-1] / sigmas[1:]
                      * torch.sqrt(1 - (alphas[1:] / alphas[:-1]) ** 2)])


def ddpm_step(x, eps_theta, i: int, alphas, sigmas, stds, z):
    """x at level i -> level i - 1; z, a standard normal, is added for i > 1."""
    a_i, a_p, s_i, s_p, std = alphas[i], alphas[i - 1], sigmas[i], sigmas[i - 1], stds[i]
    c = torch.sqrt(torch.clamp(s_p ** 2 - std ** 2, min=0.0) + 1e-8)
    out = float(a_p / a_i) * (x - float(s_i) * eps_theta) + float(c) * eps_theta
    if i > 1:
        out = out + float(std) * z
    return out


def x0_to_eps(x, alpha: float, sigma: float, x0):
    return (x - alpha * x0) / sigma


def check_sampler(cfg: dict, schedule: str):
    """Raises unless the configuration asks for what the references
    compute: the ddpm sampler on x0 predictions over `schedule`."""
    asked = (cfg["solver"], cfg["predict_noise"], cfg["noise_schedule"])
    if asked != ("ddpm", False, schedule):
        raise ValueError(f"the reference samples ddpm on x0 predictions over the {schedule} "
                         f"schedule; the configuration asks (solver, predict_noise, "
                         f"noise_schedule) = {asked}")

"""Generalized Karras probability-flow ODE engines: VE, VP and iDDPM-DDIM
(counterpart of cleandiffuser_tpu/diffusion/karras_ode.py).

Each parameterization is the Karras et al. 2022 (Table 1) ODE

    dx/dt = [s'(t)/s(t) + sigma'(t)/sigma(t)] x
            - [sigma'(t)/sigma(t) * s(t)] D(x / s(t); sigma(t))

integrated over its own (t_i, sigma_i, scale_i) grid of N + 1 points,
descending in sigma, with its own preconditioning (c_skip, c_out, c_in,
c_noise), loss weighting and training-noise distribution. The grids and the
ODE weights are closed forms in float64 numpy, cast to float32 host tables,
as the reference computes them.

Training: x_t = x0 + sigma * eps (unscaled), the loss weighted by
`loss_weighting(sigma)`; `noise=(sigma, eps, keep_mask)` gives the draws
explicitly, as for the EDM (diffusion/edm.py). `update_classifier` trains
the classifier at the time c_noise(sigma).

Sampling: Euler steps over the table, or Heun's correction where the next
sigma is above 0.005 and the step is not the last; then
`diffusion_x_sampling_steps` more steps over the last interval. CFG,
classifier guidance (+ w_cg scale_i sigma_i^2 d logp / dx at the unscaled
x), clipping and fix_mask as in the EDM. The one draw, the initial noise
(scaled by sigma_0 scale_0 temperature), comes from the generator or as
`noise`. No warm start, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .edm import ContinuousEDM

__all__ = ["KarrasODE", "VEODE", "VPODE", "EDMDDIM"]


class KarrasODE(ContinuousEDM):
    """Base: subclasses define the parameterization through `ode_tables`,
    `ode_weights`, the `c_*` preconditioners, `loss_weighting` and
    `sample_noise_level`."""

    def ode_tables(self, sample_steps: int):
        """(t_s, sigma_s, scale_s) numpy arrays of length sample_steps + 1,
        index 0 the highest noise."""
        raise NotImplementedError

    def ode_weights(self, t_s, sigma_s, scale_s):
        """(x_weight_i, D_weight_i) numpy arrays from the parameterization's
        closed-form d sigma / dt and d scale / dt."""
        raise NotImplementedError

    def loss_weighting(self, sigma):
        return 1.0 / (sigma**2)

    def classifier_time(self, sigma):
        return self.c_noise(sigma)

    def build_sample_fn(
        self,
        solver: str = "euler",
        sample_steps: int = 5,
        cfg_mode: str = "uncond",
        use_cg: bool = False,
        diffusion_x_sampling_steps: int = 0,
        warm_start: bool = False,
        warm_start_forward_level: float = 0.3,
        preserve_history: bool = False,
        final_logp: Optional[bool] = None,
    ):
        """Build the table sampler; `fn` as ContinuousEDM.build_sample_fn's
        (`warm_reference` is ignored)."""
        if solver not in ("euler", "heun"):
            raise ValueError(f"Solver {solver} is not supported.")
        if warm_start:
            raise ValueError("warm start is a DiffusionSDE / EDM feature")
        if cfg_mode not in ("mix", "cond", "uncond"):
            raise ValueError(f"unknown cfg_mode {cfg_mode!r}")
        if use_cg and self.classifier is None:
            raise ValueError("classifier guidance needs a classifier")
        if final_logp is None:
            final_logp = self.classifier is not None
        N = sample_steps
        t_np, sigma_np, scale_np = self.ode_tables(N)
        if len(t_np) != N + 1 or not np.all(np.diff(sigma_np) < 0):
            raise ValueError("tables must be descending in sigma with N + 1 points")
        f32 = lambda a: np.asarray(a, np.float32)
        t_s, sigma_s, scale_s = f32(t_np), f32(sigma_np), f32(scale_np)
        x_w, D_w = map(f32, self.ode_weights(t_np, sigma_np, scale_np))
        heun_ok = (np.arange(N) != N - 1) & (sigma_np[1:] > 0.005)
        idxs = list(range(N)) + [N - 1] * diffusion_x_sampling_steps

        def dot_x(params, cls_params, x, i, emb, condition_cg, w_cfg, w_cg):
            B = x.shape[0]
            sigma = torch.full((B,), float(sigma_s[i]), dtype=torch.float32, device=x.device)
            unscale = float(np.float32(1.0) / scale_s[i])
            xin = x * unscale if self.fix_mask is None else (
                x * (unscale * (1.0 - self.fix_mask) + self.fix_mask))
            D = self.cfg_pred(params, xin, sigma, emb, w_cfg, cfg_mode, net=self.D)
            if use_cg:
                _, grad = self.classifier.gradients(cls_params, xin, self.c_noise(sigma),
                                                    condition_cg)
                coef = np.float32(w_cg) * scale_s[i] * sigma_s[i] ** 2
                D = D + float(coef) * grad
            D = self.clip(D)
            d = float(x_w[i]) * x - float(D_w[i]) * D
            return d if self.fix_mask is None else d * (1.0 - self.fix_mask)

        def fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg: float = 0.0, temperature: float = 1.0, noise=None, cls_params=None,
               condition_cg=None, w_cg: float = 0.0, warm_reference=None):
            del warm_reference
            if self.bf16_sampling:
                params = self.bf16_params(params)
            draw = noise if noise is not None else torch.randn(
                prior.shape, generator=generator, device=prior.device)
            xt = self.pin(draw * float(sigma_s[0]) * float(scale_s[0]) * temperature, prior)
            emb = self.apply_condition(params, condition_cfg, mask=mask_cfg)
            history = []
            for i in idxs:
                d1 = dot_x(params, cls_params, xt, i, emb, condition_cg, w_cfg, w_cg)
                delta_t = float(t_s[i] - t_s[i + 1])
                x_next = self.pin(xt - d1 * delta_t, prior)
                if solver == "heun" and heun_ok[i]:
                    d2 = dot_x(params, cls_params, x_next, i + 1, emb, condition_cg, w_cfg, w_cg)
                    x_next = self.pin(xt - (d1 + d2) / 2.0 * delta_t, prior)
                xt = x_next
                if preserve_history:
                    history.append(xt)
            log = {}
            if preserve_history:
                log["sample_history"] = torch.stack(history, 1)
            if final_logp and self.classifier is not None:
                t0 = torch.full((prior.shape[0],), float(sigma_s[-1]), dtype=torch.float32,
                                device=prior.device)
                log["log_p"] = self.classifier.logp(cls_params, xt, self.c_noise(t0),
                                                    condition_cg)
            return self.clip(xt), log

        return fn


# ---------------------------------------------------------------------------
class VEODE(KarrasODE):
    """Variance-exploding ODE: geometric sigma grid over t = sigma^2,
    identity scale, F-prediction with c_out = sigma."""

    def __init__(self, *args, sigma_min: float = 0.02, sigma_max: float = 100.0, **kwargs):
        super().__init__(*args, sigma_min=sigma_min, sigma_max=sigma_max, **kwargs)

    def c_skip(self, sigma):
        return torch.ones_like(sigma)

    def c_out(self, sigma):
        return sigma

    def c_in(self, sigma):
        return torch.ones_like(sigma)

    def c_noise(self, sigma):
        return torch.log(0.5 * sigma)

    def sample_noise_level(self, n: int, generator, device):
        u = torch.rand(n, generator=generator, device=device)
        return torch.exp(u * float(np.log(self.sigma_max / self.sigma_min))
                         + float(np.log(self.sigma_min)))

    def ode_tables(self, N: int):
        i = np.arange(N + 1)
        sigma = self.sigma_max * (self.sigma_min / self.sigma_max) ** (i / N)
        return sigma**2, sigma, np.ones_like(sigma)

    def ode_weights(self, t_s, sigma_s, scale_s):
        dot_sigma = 1.0 / (2.0 * sigma_s)  # t = sigma^2
        w = dot_sigma / sigma_s
        return w, w


class VPODE(KarrasODE):
    """Variance-preserving ODE: the linear-beta VP schedule over t in
    [eps_s, 1], scale 1 / sqrt(1 + sigma^2)."""

    def __init__(self, *args, beta_min: float = 0.1, beta_max: float = 20.0,
                 eps_s: float = 1e-3, eps_t: float = 1e-5, diffusion_steps: int = 1000,
                 **kwargs):
        self.beta_min, self.beta_d = beta_min, beta_max - beta_min
        self.eps_s, self.eps_t = eps_s, eps_t
        super().__init__(*args, **kwargs)
        self.diffusion_steps = diffusion_steps
        self.t_diffusion = [eps_t, 1.0]

    def _sigma_of_t(self, t):
        return torch.sqrt(torch.exp(0.5 * self.beta_d * t**2 + self.beta_min * t) - 1.0)

    def c_skip(self, sigma):
        return torch.ones_like(sigma)

    def c_out(self, sigma):
        return -sigma

    def c_in(self, sigma):
        return 1.0 / torch.sqrt(1.0 + sigma**2)

    def c_noise(self, sigma):
        # sigma -> t, scaled to the discrete timestep range
        log_scale = -0.5 * torch.log(1.0 + sigma**2)
        t = (torch.sqrt(self.beta_min**2 - 4.0 * self.beta_d * log_scale)
             - self.beta_min) / self.beta_d
        return (self.diffusion_steps - 1) * t

    def sample_noise_level(self, n: int, generator, device):
        t = torch.rand(n, generator=generator, device=device) * (1.0 - self.eps_t) + self.eps_t
        return self._sigma_of_t(t)

    def ode_tables(self, N: int):
        t = 1.0 + np.arange(N + 1) / N * (self.eps_s - 1.0)  # 1 -> eps_s
        sigma = np.sqrt(np.exp(0.5 * self.beta_d * t**2 + self.beta_min * t) - 1.0)
        return t, sigma, 1.0 / np.sqrt(1.0 + sigma**2)

    def ode_weights(self, t_s, sigma_s, scale_s):
        dot_sigma = 0.5 * (sigma_s**2 + 1.0) * (self.beta_d * t_s + self.beta_min) / sigma_s
        dot_scale = -sigma_s / (1.0 + sigma_s**2) ** 1.5 * dot_sigma
        return (dot_sigma / sigma_s + dot_scale / scale_s, dot_sigma / sigma_s * scale_s)


class EDMDDIM(KarrasODE):
    """The iDDPM / DDIM grid ODE (Karras's "DDIM" column): a sigma grid from
    the iDDPM u-recursion over a cosine bar-alpha schedule, identity scale,
    d sigma / dt = 1."""

    def __init__(self, *args, C1: float = 0.001, C2: float = 0.008, j0: int = 8,
                 diffusion_steps: int = 1000, **kwargs):
        self.C1, self.C2, self.j0 = C1, C2, j0
        M = diffusion_steps
        j = np.arange(M + 1)
        bar_alpha = np.sin(j / (M * (C2 + 1)) * np.pi / 2.0) ** 2
        tmp = np.maximum(bar_alpha[:-1] / bar_alpha[1:], C1)
        u = np.zeros(M)
        u[M - 1] = np.sqrt(1.0 / tmp[M - 1] - 1.0)
        for i in range(1, M):
            u[M - 1 - i] = np.sqrt((u[M - i] ** 2 + 1.0) / tmp[M - 1 - i] - 1.0)
        self._u = u
        super().__init__(*args, **kwargs)
        self._u_dev = torch.as_tensor(u, dtype=torch.float32, device=self.device)
        self.diffusion_steps = M
        self.t_diffusion = [float(u[-1]), float(u[j0])]  # u decreases in j

    def c_skip(self, sigma):
        return torch.ones_like(sigma)

    def c_out(self, sigma):
        return -sigma

    def c_in(self, sigma):
        return 1.0 / torch.sqrt(1.0 + sigma**2)

    def c_noise(self, sigma):
        return sigma

    def sample_noise_level(self, n: int, generator, device):
        j = torch.randint(self.j0, self.diffusion_steps, (n,), generator=generator,
                          device=device)
        return self._u_dev[j]

    def ode_tables(self, N: int):
        M, j0 = self.diffusion_steps, self.j0
        idx = np.floor(j0 + (M - 1 - j0) / N * np.arange(N + 1) + 0.5).astype(int)
        # u decreases in j, so ascending j gives a descending sigma grid
        sigma = self._u[idx].copy()
        return sigma, sigma, np.ones_like(sigma)

    def ode_weights(self, t_s, sigma_s, scale_s):
        w = 1.0 / sigma_s  # t = sigma, d sigma / dt = 1
        return w, w

"""Karras EDM engine with Euler and Heun samplers (counterpart of
cleandiffuser_tpu/diffusion/edm.py).

The network runs inside the preconditioned denoiser
D(x; sigma) = c_skip(sigma) x + c_out(sigma) F(c_in(sigma) x, c_noise(sigma)),
with c_noise = log(sigma) / 4. Training draws sigma log-normal
(`P_mean`, `P_std`) and weights the x0 loss by
(sigma^2 + sigma_data^2) / (sigma sigma_data)^2.

Training (`update` on diffusion/basic.py's step): the draws come from the
engine's generator, or explicitly as `noise=(sigma, eps, keep_mask)`, the
roles of the reference's `k_noise, k_cond, k_drop = split(rng, 3)` with
`k_t, k_eps = split(k_noise)`. `update_classifier` trains a classifier on
x0 noised the same way, at the classifier time log(sigma) / 4.

Sampling (`build_sample_fn` or `sample`): the Karras rho-schedule from
sigma_max down to sigma_min, first-order Euler steps, or Heun's
second-order correction on every step but the last, then
`diffusion_x_sampling_steps` more steps at the last interval. Each step's
prediction takes CFG ("mix", "cond", "uncond"), classifier guidance
(+ w_cg sigma^2 d logp / dx) and clipping; fix_mask re-pins the pinned
entries. The one draw, the initial noise, comes from the generator or as
`noise` (of the prior's shape): the reference draws it from
`k_init, _ = split(rng)`. The per-step sigmas are float32 host tables, so
the loop never waits on the device; the sampler follows the caller's grad
mode, as the SDE engines' does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.schedules import karras_sigma_schedule
from ..utils.ranks import batch_draw
from ..utils.tensors import at_least_ndim
from .basic import DiffusionModel, pick_cfg_mode

__all__ = ["ContinuousEDM"]


class ContinuousEDM(DiffusionModel):
    def __init__(
        self,
        nn_diffusion,
        nn_condition=None,
        fix_mask=None,
        loss_weight=None,
        classifier=None,
        grad_clip_norm: Optional[float] = None,
        ema_rate: float = 0.995,
        optim_params: Optional[dict] = None,
        sigma_data: float = 0.5,
        sigma_min: float = 0.002,
        sigma_max: float = 80.0,
        rho: float = 7.0,
        P_mean: float = -1.2,
        P_std: float = 1.2,
        x_max=None,
        x_min=None,
        rng: int = 0,
        device=None,
    ):
        super().__init__(nn_diffusion, nn_condition, fix_mask, loss_weight, classifier,
                         grad_clip_norm, ema_rate, optim_params, rng, device)
        self.sigma_data, self.sigma_min, self.sigma_max = sigma_data, sigma_min, sigma_max
        self.rho, self.P_mean, self.P_std = rho, P_mean, P_std
        as_t = lambda v: None if v is None else torch.as_tensor(
            v, dtype=torch.float32, device=self.device)
        self.x_max, self.x_min = as_t(x_max), as_t(x_min)
        self.t_diffusion = [sigma_min, sigma_max]
        self._sample_fns = {}

    @property
    def supported_solvers(self):
        return ["euler", "heun"]

    @property
    def clip_pred(self):
        return (self.x_max is not None) or (self.x_min is not None)

    def clip(self, x):
        return torch.clamp(x, self.x_min, self.x_max) if self.clip_pred else x

    def pin(self, x, prior):
        """x with the fix_mask entries taken from `prior`."""
        return x if self.fix_mask is None else x * (1.0 - self.fix_mask) + prior * self.fix_mask

    # ---------------- EDM preconditioning ----------------
    def c_skip(self, sigma):
        return self.sigma_data**2 / (self.sigma_data**2 + sigma**2)

    def c_out(self, sigma):
        return sigma * self.sigma_data / torch.sqrt(self.sigma_data**2 + sigma**2)

    def c_in(self, sigma):
        return 1.0 / torch.sqrt(self.sigma_data**2 + sigma**2)

    def c_noise(self, sigma):
        return 0.25 * torch.log(sigma)

    def D(self, params, x, sigma, emb=None, train: bool = False,
          generator: Optional[torch.Generator] = None):
        """The preconditioned denoiser D(x; sigma), sigma (B,)."""
        cs = at_least_ndim(self.c_skip(sigma), x.ndim)
        co = at_least_ndim(self.c_out(sigma), x.ndim)
        ci = at_least_ndim(self.c_in(sigma), x.ndim)
        return cs * x + co * self.apply_diffusion(params, ci * x, self.c_noise(sigma), emb,
                                                  train=train, generator=generator)

    # ---------------- Training ----------------
    def sample_noise_level(self, n: int, generator, device):
        """Training sigmas: log-normal, exp(N(P_mean, P_std^2))."""
        return torch.exp(batch_draw(lambda s: torch.randn(s, generator=generator, device=device),
                                    (n,)) * self.P_std
                         + self.P_mean)

    def add_noise(self, x0, t=None, eps=None, generator=None):
        """(xt, sigma, eps): x0 + sigma * eps (each drawn from `generator`
        when None); pinned entries keep x0."""
        if t is None:
            t = self.sample_noise_level(x0.shape[0], generator, x0.device)
        if eps is None:
            eps = batch_draw(lambda s: torch.randn(s, generator=generator, device=x0.device),
                             x0.shape)
        xt = x0 + at_least_ndim(t, x0.ndim) * eps
        if self.fix_mask is not None:
            xt = (1.0 - self.fix_mask) * xt + self.fix_mask * x0
        return xt, t, eps

    def loss_weighting(self, sigma):
        return (sigma**2 + self.sigma_data**2) / ((sigma * self.sigma_data) ** 2)

    def loss_fn(self, params, x0, condition=None, noise=None, generator=None,
                weighted_regression=None):
        """mean((D(xt; sigma) - x0)^2 * loss_weight * (1 - fix_mask) *
        weighting(sigma)). `noise=(sigma, eps, keep_mask)` gives the draws
        explicitly; a None entry is drawn from `generator`."""
        t, eps, keep = noise if noise is not None else (None, None, None)
        xt, t, _ = self.add_noise(x0, t, eps, generator)
        emb = self.apply_condition(params, condition, mask=keep, train=True,
                                   generator=generator)
        pred = self.D(params, xt, t, emb, train=True, generator=generator)
        loss = (pred - x0) ** 2
        if self.loss_weight is not None:
            loss = loss * self.loss_weight
        if self.fix_mask is not None:
            loss = loss * (1.0 - self.fix_mask)
        loss = loss * at_least_ndim(self.loss_weighting(t), x0.ndim)
        if weighted_regression is not None:
            loss = loss * weighted_regression[..., None]
        return loss.mean()

    def classifier_time(self, sigma):
        """The time the classifier reads at noise level sigma."""
        return torch.log(sigma) / 4.0

    def update_classifier(self, x0, condition, noise=None):
        """One classifier step on x0 noised as in training, at the
        classifier time of its sigma. `noise=(sigma, eps)` gives the draws
        (the reference's `add_noise(next_sample_rng(), x0)`); otherwise
        they come from the engine's generator."""
        t, eps = noise if noise is not None else (None, None)
        xt, t, _ = self.add_noise(x0, t, eps, self.generator)
        return self.classifier.update(xt, self.classifier_time(t), condition)

    # ---------------- Guided prediction ----------------
    def _guided_pred(self, params, cls_params, xt, t, emb, condition_cg, w_cfg: float,
                     w_cg: float, sigma: float, cfg_mode: str, use_cg: bool):
        pred = self.cfg_pred(params, xt, t, emb, w_cfg, cfg_mode, net=self.D)
        if use_cg:
            _, grad = self.classifier.gradients(cls_params, xt, self.classifier_time(t),
                                                condition_cg)
            pred = pred + float(np.float32(w_cg) * np.float32(sigma) ** 2) * grad
        return self.clip(pred)

    # ---------------- Sampling ----------------
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
        """Build the Euler / Heun sampler.

            fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg=0.0, temperature=1.0, noise=None, cls_params=None,
               condition_cg=None, w_cg=0.0, warm_reference=None)
               -> (x0, log dict)

        The initial state is `draw * sigma_max * temperature`, or with
        `warm_start` and a reference `warm_reference + sigma_w * draw`
        (sigma_w the level `warm_start_forward_level` of the way up); `draw`
        is `noise` or a draw from `generator`. With a classifier and
        `final_logp` (default: whether there is one) the log holds "log_p"
        of the final sample at sigma_min; with `preserve_history`,
        "sample_history" (B, steps, *x)."""
        if solver not in ("euler", "heun"):
            raise ValueError(f"Solver {solver} is not supported.")
        if cfg_mode not in ("mix", "cond", "uncond"):
            raise ValueError(f"unknown cfg_mode {cfg_mode!r}")
        if use_cg and self.classifier is None:
            raise ValueError("classifier guidance needs a classifier")
        if final_logp is None:
            final_logp = self.classifier is not None
        fwd_sigma = (self.sigma_min + (self.sigma_max - self.sigma_min) * warm_start_forward_level
                     if warm_start else self.sigma_max)
        sigmas = karras_sigma_schedule(self.sigma_min, fwd_sigma, self.rho, sample_steps)
        idxs = list(range(sample_steps, 0, -1)) + [1] * diffusion_x_sampling_steps

        def fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg: float = 0.0, temperature: float = 1.0, noise=None, cls_params=None,
               condition_cg=None, w_cg: float = 0.0, warm_reference=None):
            if self.bf16_sampling:
                params = self.bf16_params(params, condition=False)
            draw = noise if noise is not None else batch_draw(
                lambda s: torch.randn(s, generator=generator, device=prior.device), prior.shape)
            if warm_start and warm_reference is not None:
                xt = warm_reference + fwd_sigma * draw
            else:
                xt = draw * self.sigma_max * temperature
            xt = self.pin(xt, prior)
            emb = self.apply_condition(params, condition_cfg, mask=mask_cfg)
            B = prior.shape[0]
            full = lambda v: torch.full((B,), v, dtype=torch.float32, device=prior.device)
            history = []
            for i in idxs:
                s_i, s_prev = float(sigmas[i]), float(sigmas[i - 1])
                delta_t = float(sigmas[i] - sigmas[i - 1])
                pred = self._guided_pred(params, cls_params, xt, full(s_i), emb, condition_cg,
                                         w_cfg, w_cg, s_i, cfg_mode, use_cg)
                dot_x = (xt - pred) / s_i
                x_next = self.pin(xt - dot_x * delta_t, prior)
                if solver == "heun" and i > 1:
                    pred2 = self._guided_pred(params, cls_params, x_next, full(s_prev), emb,
                                              condition_cg, w_cfg, w_cg, s_prev, cfg_mode,
                                              use_cg)
                    dot_x2 = (x_next - pred2) / s_prev
                    x_next = self.pin(xt - (dot_x + dot_x2) / 2.0 * delta_t, prior)
                xt = x_next
                if preserve_history:
                    history.append(xt)
            log = {}
            if preserve_history:
                log["sample_history"] = torch.stack(history, 1)
            if final_logp and self.classifier is not None:
                t0 = full(self.sigma_min)
                log["log_p"] = self.classifier.logp(cls_params, xt, self.classifier_time(t0),
                                                    condition_cg)
            return self.clip(xt), log

        return fn

    def sample(
        self,
        prior,
        solver: str = "euler",
        sample_steps: int = 5,
        use_ema: bool = True,
        temperature: float = 1.0,
        condition_cfg=None,
        mask_cfg=None,
        w_cfg: float = 0.0,
        condition_cg=None,
        w_cg: float = 0.0,
        diffusion_x_sampling_steps: int = 0,
        warm_start_reference=None,
        warm_start_forward_level: float = 0.3,
        preserve_history: bool = False,
        generator: Optional[torch.Generator] = None,
        noise=None,
    ):
        """One sample with the CFG mode picked as the reference picks it
        (`pick_cfg_mode`) and classifier guidance when there is a
        classifier, a weight and a condition. Samplers are cached per
        setting. Returns (x0, log) with "sample_history" and "log_p" (each
        None when not made)."""
        cfg_mode = pick_cfg_mode(w_cfg, condition_cfg)
        use_cg = self.classifier is not None and w_cg != 0.0 and condition_cg is not None
        warm = warm_start_reference is not None
        key = ("sample", solver, sample_steps, cfg_mode, use_cg, diffusion_x_sampling_steps,
               warm, warm_start_forward_level if warm else None, preserve_history)
        if key not in self._sample_fns:
            self._sample_fns[key] = self.build_sample_fn(
                solver=solver, sample_steps=sample_steps, cfg_mode=cfg_mode, use_cg=use_cg,
                diffusion_x_sampling_steps=diffusion_x_sampling_steps, warm_start=warm,
                warm_start_forward_level=warm_start_forward_level,
                preserve_history=preserve_history)
        params = self.ema_params if use_ema else self.params
        cls_params = self.classifier.inference_params if self.classifier is not None else None
        x0, log = self._sample_fns[key](
            params, generator or self.generator, prior, condition_cfg, mask_cfg, w_cfg,
            temperature, noise, cls_params, condition_cg, w_cg, warm_start_reference)
        log.setdefault("sample_history", None)
        log.setdefault("log_p", None)
        return x0, log

"""Continuous VP-SDE diffusion engine with a k-step sampler (counterpart of
cleandiffuser_tpu/diffusion/diffusionsde.py).

The reference traces its whole denoising loop into one `lax.scan`; here it
is a Python loop over the steps, whose per-step scalars come from float32
host tables (vp_solvers.py), so the loop never waits on the device. Each
step: guided prediction (CFG doubled-batch forward), prediction clipping,
solver update with noise injection, fix_mask re-pinning.

Randomness comes from an explicit `torch.Generator`, or from explicit
noise: `noise=(initial, per_step)` with `initial` of the prior's shape and
`per_step` of shape (sample_steps, *prior.shape), row n used at the n-th
step. The reference draws the same roles from its key splits
(`k_init, k_scan = split(rng)`, then `rng, k_noise = split(rng)` per step),
which is how the tests hand both samplers the same numbers.

Ported so far: the solvers, CFG in mix / cond / uncond modes, clipping and
inpainting. Classifier guidance, warm start, diffusion-x steps, history and
the parallel-in-time sampler come later.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.schedules import SUPPORTED_NOISE_SCHEDULES, SUPPORTED_SAMPLING_STEP_SCHEDULE
from .basic import DiffusionModel
from .vp_solvers import (
    SUPPORTED_SOLVERS,
    epstheta_to_xtheta,
    solver_step,
    solver_uses_noise,
    xtheta_to_epstheta,
)

__all__ = ["BaseDiffusionSDE", "ContinuousDiffusionSDE"]


def _cat_zeros(emb):
    """Stack [emb; zeros] along batch for the CFG doubled forward: the
    unconditional half gets a zero embedding."""
    return None if emb is None else torch.cat([emb, torch.zeros_like(emb)], dim=0)


class BaseDiffusionSDE(DiffusionModel):
    def __init__(
        self,
        nn_diffusion,
        nn_condition=None,
        fix_mask=None,
        loss_weight=None,
        epsilon: float = 1e-3,
        x_max=None,
        x_min=None,
        predict_noise: bool = True,
        device="cpu",
    ):
        super().__init__(nn_diffusion, nn_condition, fix_mask, loss_weight, device)
        self.predict_noise = predict_noise
        self.epsilon = epsilon
        as_t = lambda v: None if v is None else torch.as_tensor(
            v, dtype=torch.float32, device=self.device)
        self.x_max, self.x_min = as_t(x_max), as_t(x_min)

    @property
    def clip_pred(self):
        return (self.x_max is not None) or (self.x_min is not None)

    def clip_prediction(self, pred, xt, alpha, sigma):
        """Clip x0 (or the eps bounds it implies) to [x_min, x_max]."""
        if not self.clip_pred:
            return pred
        if self.predict_noise:
            upper = (xt - alpha * self.x_min) / sigma if self.x_min is not None else None
            lower = (xt - alpha * self.x_max) / sigma if self.x_max is not None else None
            return torch.clamp(pred, lower, upper)
        return torch.clamp(pred, self.x_min, self.x_max)

    def _guided_pred(self, params, xt, t, emb, w_cfg: float, cfg_mode: str):
        """Classifier-free guidance: [cond; uncond] in one doubled forward,
        combined as w*cond + (1-w)*uncond."""
        if cfg_mode == "mix":
            b = xt.shape[0]
            pred_all = self.apply_diffusion(
                params, torch.cat([xt, xt], 0), torch.cat([t, t], 0), _cat_zeros(emb))
            pred, pred_uncond = pred_all[:b], pred_all[b:]
            # both weights rounded to float32 first, as the reference's are
            w = np.float32(w_cfg)
            return float(w) * pred + float(np.float32(1) - w) * pred_uncond
        if cfg_mode == "cond":
            return self.apply_diffusion(params, xt, t, emb)
        if cfg_mode == "uncond":
            return self.apply_diffusion(params, xt, t, None)
        raise ValueError(f"unknown cfg_mode {cfg_mode!r}")

    def _sample_tables(self, sample_step_schedule: str, sample_steps: int):
        """(ts, alphas, sigmas), each a float32 (steps+1,) host tensor."""
        raise NotImplementedError

    def build_sample_fn(
        self,
        solver: str = "ddpm",
        sample_steps: int = 5,
        sample_step_schedule: str = "uniform",
        cfg_mode: str = "uncond",
    ):
        """Build the k-step sampler.

            fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg=0.0, temperature=1.0, noise=None) -> (x0, log dict)

        `params` is `self.params` or `self.ema_params`.
        """
        if solver not in SUPPORTED_SOLVERS:
            raise ValueError(f"Solver {solver} is not supported.")
        fix_mask = self.fix_mask
        ts, alphas, sigmas = self._sample_tables(sample_step_schedule, sample_steps)
        logSNRs = torch.log(alphas / sigmas)
        zero = torch.zeros(1)
        hs = torch.cat([zero, logSNRs[:-1] - logSNRs[1:]])
        stds = torch.cat([
            zero, sigmas[:-1] / sigmas[1:] * torch.sqrt(1 - (alphas[1:] / alphas[:-1]) ** 2)])

        @torch.no_grad()
        def fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg: float = 0.0, temperature: float = 1.0, noise=None):
            def draw(n):
                if noise is not None:
                    return noise[0] if n < 0 else noise[1][n]
                return torch.randn(prior.shape, generator=generator, device=prior.device)

            xt = draw(-1) * temperature
            if fix_mask is not None:
                xt = xt * (1.0 - fix_mask) + prior * fix_mask
            emb = self.apply_condition(params, condition_cfg, mask=mask_cfg)
            prev_x_theta = torch.zeros_like(xt)
            for n, i in enumerate(range(sample_steps, 0, -1)):
                t = torch.full((prior.shape[0],), float(ts[i]), device=prior.device)
                a_i, s_i = float(alphas[i]), float(sigmas[i])
                pred = self._guided_pred(params, xt, t, emb, w_cfg, cfg_mode)
                pred = self.clip_prediction(pred, xt, a_i, s_i)
                if self.predict_noise:
                    eps_theta, x_theta = pred, epstheta_to_xtheta(xt, a_i, s_i, pred)
                else:
                    eps_theta, x_theta = xtheta_to_epstheta(xt, a_i, s_i, pred), pred
                z = draw(n) if solver_uses_noise(solver, i) else None
                x_next = solver_step(solver, xt, eps_theta, x_theta, prev_x_theta, n == 0,
                                     i, alphas, sigmas, hs, stds, z)
                if fix_mask is not None:
                    x_next = x_next * (1.0 - fix_mask) + prior * fix_mask
                xt, prev_x_theta = x_next, x_theta
            if self.clip_pred:
                xt = torch.clamp(xt, self.x_min, self.x_max)
            return xt, {}

        return fn


class ContinuousDiffusionSDE(BaseDiffusionSDE):
    """Continuous-time VP-SDE."""

    def __init__(
        self,
        nn_diffusion,
        nn_condition=None,
        fix_mask=None,
        loss_weight=None,
        epsilon: float = 1e-3,
        noise_schedule: str = "cosine",
        x_max=None,
        x_min=None,
        predict_noise: bool = True,
        device="cpu",
    ):
        super().__init__(nn_diffusion, nn_condition, fix_mask, loss_weight, epsilon,
                         x_max, x_min, predict_noise, device)
        # cosine alpha hits 0 at t=0.9946
        self.t_diffusion = [epsilon, 0.9946] if noise_schedule == "cosine" else [epsilon, 1.0]
        if noise_schedule not in SUPPORTED_NOISE_SCHEDULES:
            raise ValueError(f"Noise schedule {noise_schedule} is not supported.")
        self.noise_schedule_funcs = SUPPORTED_NOISE_SCHEDULES[noise_schedule]

    def _sample_tables(self, sample_step_schedule, sample_steps):
        if not sample_step_schedule.endswith("_continuous"):
            sample_step_schedule = sample_step_schedule + "_continuous"
        sched = SUPPORTED_SAMPLING_STEP_SCHEDULE[sample_step_schedule](
            self.t_diffusion, sample_steps)
        alphas, sigmas = self.noise_schedule_funcs["forward"](sched)
        return sched, alphas, sigmas

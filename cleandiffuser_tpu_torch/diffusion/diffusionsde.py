"""Discrete and continuous VP-SDE diffusion engines with a k-step sampler
(counterpart of cleandiffuser_tpu/diffusion/diffusionsde.py).

The reference traces its whole denoising loop into one `lax.scan`; here it
is a Python loop over the steps, whose per-step scalars come from float32
host tables (vp_solvers.py), so the loop never waits on the device. Each
step: guided prediction (CFG doubled-batch forward, then the classifier's
gradient), prediction clipping, solver update with noise injection,
fix_mask re-pinning. With a classifier, the sampler can score the final
sample with its log p at t = 0 (`final_logp`).

Randomness comes from an explicit `torch.Generator`, or from explicit
noise: `noise=(initial, per_step)` with `initial` of the prior's shape and
`per_step` of shape (sample_steps, *prior.shape), row n used at the n-th
step. The reference draws the same roles from its key splits
(`k_init, k_scan = split(rng)`, then `rng, k_noise = split(rng)` per step),
which is how the tests hand both samplers the same numbers.

`fused_update=True` (ddpm only, off by default as in the reference) takes
each step through the fused solver-update kernel (ops/solver_update.py),
which draws its own noise from a per-step seed; the seeds come from the
generator, all at the start of a sample.

Training: `add_noise` and `loss_fn` (diffusion/basic.py runs the update);
the draws come from a generator on the engine's device, or explicitly as
`noise=(t, eps, keep_mask)`.

Ported so far: the solvers, CFG in mix / cond / uncond modes, classifier
guidance, final log p, clipping, inpainting and the training loss. Warm
start, diffusion-x steps, history and the parallel-in-time sampler come
later.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.solver_update import solver_update_op
from ..utils.schedules import (
    SUPPORTED_NOISE_SCHEDULES,
    SUPPORTED_SAMPLING_STEP_SCHEDULE,
    uniform_discretization,
)
from ..utils.tensors import at_least_ndim
from .basic import DiffusionModel
from .vp_solvers import (
    SUPPORTED_SOLVERS,
    ddpm_coefficients,
    epstheta_to_xtheta,
    solver_step,
    solver_uses_noise,
    xtheta_to_epstheta,
)

__all__ = ["BaseDiffusionSDE", "DiscreteDiffusionSDE", "ContinuousDiffusionSDE"]


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
        classifier=None,
        grad_clip_norm=None,
        ema_rate: float = 0.995,
        optim_params=None,
        epsilon: float = 1e-3,
        x_max=None,
        x_min=None,
        predict_noise: bool = True,
        rng: int = 0,
        device=None,
    ):
        super().__init__(nn_diffusion, nn_condition, fix_mask, loss_weight, classifier,
                         grad_clip_norm, ema_rate, optim_params, rng, device)
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

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def add_noise(self, x0, t=None, eps=None, generator=None):
        """(xt, t, eps): x0 taken to noise level t (drawn from `generator`
        when None) with noise eps (likewise); pinned entries keep x0."""
        raise NotImplementedError

    def _noised(self, x0, alpha, sigma, eps):
        xt = at_least_ndim(alpha, x0.ndim) * x0 + at_least_ndim(sigma, x0.ndim) * eps
        if self.fix_mask is not None:
            xt = (1.0 - self.fix_mask) * xt + self.fix_mask * x0
        return xt

    def loss_fn(self, params, x0, condition=None, noise=None, generator=None,
                weighted_regression=None):
        """mean((pred - target)^2 * loss_weight * (1 - fix_mask)), target eps
        or x0. `noise=(t, eps, keep_mask)` gives the draws explicitly: the
        levels (B,), the noise (x0's shape) and the condition's dropout
        keep-mask (B,) (None without a condition); a None entry is drawn
        from `generator`. The reference draws the same roles from
        `k_noise, k_cond, k_drop = split(rng, 3)`."""
        t, eps, keep = noise if noise is not None else (None, None, None)
        xt, t, eps = self.add_noise(x0, t, eps, generator)
        emb = self.apply_condition(params, condition, mask=keep, train=True,
                                   generator=generator)
        pred = self.apply_diffusion(params, xt, t, emb, train=True)
        loss = (pred - (eps if self.predict_noise else x0)) ** 2
        if self.loss_weight is not None:
            loss = loss * self.loss_weight
        if self.fix_mask is not None:
            loss = loss * (1.0 - self.fix_mask)
        if weighted_regression is not None:
            loss = loss * weighted_regression[..., None]
        return loss.mean()

    def _guided_pred(self, params, xt, t, emb, w_cfg: float, cfg_mode: str,
                     cls_params=None, condition_cg=None, cg_coef: float = 0.0):
        """Classifier-free guidance: [cond; uncond] in one doubled forward,
        combined as w*cond + (1-w)*uncond; then, with `cg_coef` != 0,
        classifier guidance: pred + cg_coef * d logp / dx. With
        `bf16_sampling`, `apply_diffusion` casts the network's xt and emb to
        bf16 and brings its prediction back f32; the guidance reads the f32
        xt."""
        if cfg_mode == "mix":
            b = xt.shape[0]
            pred_all = self.apply_diffusion(
                params, torch.cat([xt, xt], 0), torch.cat([t, t], 0), _cat_zeros(emb))
            pred, pred_uncond = pred_all[:b], pred_all[b:]
            # both weights rounded to float32 first, as the reference's are
            w = np.float32(w_cfg)
            pred = float(w) * pred + float(np.float32(1) - w) * pred_uncond
        elif cfg_mode == "cond":
            pred = self.apply_diffusion(params, xt, t, emb)
        elif cfg_mode == "uncond":
            pred = self.apply_diffusion(params, xt, t, None)
        else:
            raise ValueError(f"unknown cfg_mode {cfg_mode!r}")
        if cg_coef != 0.0:
            _, grad = self.classifier.gradients(cls_params, xt, t, condition_cg)
            pred = pred + cg_coef * grad
        return pred

    def _cg_coef(self, w_cg: float, a_i, s_i) -> float:
        """The guidance gradient's weight at level (alpha_i, sigma_i), in
        float32 as the reference's: -w*sigma (eps prediction) or
        w*sigma^2/alpha (x0 prediction)."""
        w = torch.tensor(w_cg, dtype=torch.float32)
        return float(-(w * s_i) if self.predict_noise else w * (s_i**2 / a_i))

    def _sample_tables(self, sample_step_schedule: str, sample_steps: int):
        """(ts, alphas, sigmas), each a (steps+1,) host tensor; alphas and
        sigmas float32, ts of the dtype the network takes as t."""
        raise NotImplementedError

    def build_sample_fn(
        self,
        solver: str = "ddpm",
        sample_steps: int = 5,
        sample_step_schedule: str = "uniform",
        cfg_mode: str = "uncond",
        use_cg: bool = False,
        final_logp=None,
        fused_update: bool = False,
    ):
        """Build the k-step sampler.

            fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg=0.0, temperature=1.0, noise=None, cls_params=None,
               condition_cg=None, w_cg=0.0) -> (x0, log dict)

        `params` is `self.params` or `self.ema_params`, `cls_params` the
        classifier's. With `bf16_sampling` the sampler casts all of `params`
        (backbone and condition) to bf16 once per call (`bf16_params`), not
        once per step; its solver math stays f32. With `final_logp` (default: whether there is a
        classifier) the log holds "log_p" of the final sample at t = 0.
        """
        if solver not in SUPPORTED_SOLVERS:
            raise ValueError(f"Solver {solver} is not supported.")
        if fused_update and solver != "ddpm":
            raise ValueError(f"fused_update takes the ddpm step only, not {solver}")
        if (use_cg or final_logp) and self.classifier is None:
            raise ValueError("classifier guidance and final_logp need a classifier")
        if final_logp is None:
            final_logp = self.classifier is not None
        fix_mask = self.fix_mask
        ts, alphas, sigmas = self._sample_tables(sample_step_schedule, sample_steps)
        logSNRs = torch.log(alphas / sigmas)
        zero = torch.zeros(1)
        hs = torch.cat([zero, logSNRs[:-1] - logSNRs[1:]])
        stds = torch.cat([
            zero, sigmas[:-1] / sigmas[1:] * torch.sqrt(1 - (alphas[1:] / alphas[:-1]) ** 2)])

        @torch.no_grad()
        def fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg: float = 0.0, temperature: float = 1.0, noise=None, cls_params=None,
               condition_cg=None, w_cg: float = 0.0):
            def draw(n):
                if noise is not None:
                    return noise[0] if n < 0 else noise[1][n]
                return torch.randn(prior.shape, generator=generator, device=prior.device)

            if fused_update:
                if noise is not None:
                    raise ValueError("fused_update draws its noise in the kernel: it takes "
                                     "no explicit noise")
                # one seed per step, drawn at once: a single device-to-host copy
                seeds = torch.randint(2**31 - 1, (sample_steps,), generator=generator,
                                      device=generator.device).tolist()
            if self.bf16_sampling:
                params = self.bf16_params(params)
            xt = draw(-1) * temperature
            if fix_mask is not None:
                xt = xt * (1.0 - fix_mask) + prior * fix_mask
            emb = self.apply_condition(params, condition_cfg, mask=mask_cfg)
            prev_x_theta = torch.zeros_like(xt)
            B = prior.shape[0]
            for n, i in enumerate(range(sample_steps, 0, -1)):
                t = torch.full((B,), ts[i].item(), dtype=ts.dtype, device=prior.device)
                a_i, s_i = float(alphas[i]), float(sigmas[i])
                cg_coef = self._cg_coef(w_cg, alphas[i], sigmas[i]) if use_cg else 0.0
                pred = self._guided_pred(params, xt, t, emb, w_cfg, cfg_mode,
                                         cls_params, condition_cg, cg_coef)
                pred = self.clip_prediction(pred, xt, a_i, s_i)
                if self.predict_noise:
                    eps_theta, x_theta = pred, epstheta_to_xtheta(xt, a_i, s_i, pred)
                else:
                    eps_theta, x_theta = xtheta_to_epstheta(xt, a_i, s_i, pred), pred
                if fused_update:
                    x_next = solver_update_op(xt, eps_theta,
                                              ddpm_coefficients(i, alphas, sigmas, stds), seeds[n])
                else:
                    z = draw(n) if solver_uses_noise(solver, i) else None
                    x_next = solver_step(solver, xt, eps_theta, x_theta, prev_x_theta, n == 0,
                                         i, alphas, sigmas, hs, stds, z)
                if fix_mask is not None:
                    x_next = x_next * (1.0 - fix_mask) + prior * fix_mask
                xt, prev_x_theta = x_next, x_theta
            log = {}
            if final_logp:
                t0 = torch.zeros((B,), dtype=ts.dtype, device=prior.device)
                log["log_p"] = self.classifier.logp(cls_params, xt, t0, condition_cg)
            if self.clip_pred:
                xt = torch.clamp(xt, self.x_min, self.x_max)
            return xt, log

        return fn


class DiscreteDiffusionSDE(BaseDiffusionSDE):
    """Discrete-time VP-SDE: time lives on a uniform T-point grid mapping
    [epsilon, 1] -> [0, T-1]; alpha and sigma are (T,) float32 tables and
    the network takes the integer level as t."""

    def __init__(
        self,
        nn_diffusion,
        nn_condition=None,
        fix_mask=None,
        loss_weight=None,
        classifier=None,
        grad_clip_norm=None,
        ema_rate: float = 0.995,
        optim_params=None,
        epsilon: float = 1e-3,
        diffusion_steps: int = 1000,
        noise_schedule: str = "cosine",
        x_max=None,
        x_min=None,
        predict_noise: bool = True,
        rng: int = 0,
        device=None,
    ):
        super().__init__(nn_diffusion, nn_condition, fix_mask, loss_weight, classifier,
                         grad_clip_norm, ema_rate, optim_params, epsilon, x_max, x_min,
                         predict_noise, rng, device)
        if 1.0 / diffusion_steps < epsilon:
            raise ValueError("epsilon is too large for the number of diffusion steps")
        if noise_schedule not in SUPPORTED_NOISE_SCHEDULES:
            raise ValueError(f"Noise schedule {noise_schedule} is not supported.")
        self.diffusion_steps = diffusion_steps
        self.t_diffusion = uniform_discretization(diffusion_steps, epsilon)
        self.alpha, self.sigma = SUPPORTED_NOISE_SCHEDULES[noise_schedule]["forward"](
            self.t_diffusion)
        # the sampler reads the host tables; training indexes these per batch
        self._alpha_dev, self._sigma_dev = self.alpha.to(self.device), self.sigma.to(self.device)

    def add_noise(self, x0, t=None, eps=None, generator=None):
        """t: integer levels uniform on [0, diffusion_steps)."""
        if t is None:
            t = torch.randint(self.diffusion_steps, (x0.shape[0],), generator=generator,
                              device=x0.device)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, device=x0.device)
        return self._noised(x0, self._alpha_dev[t], self._sigma_dev[t], eps), t, eps

    def _sample_tables(self, sample_step_schedule, sample_steps):
        sched = SUPPORTED_SAMPLING_STEP_SCHEDULE[sample_step_schedule](
            self.diffusion_steps, sample_steps).long()
        return sched.to(torch.int32), self.alpha[sched], self.sigma[sched]


class ContinuousDiffusionSDE(BaseDiffusionSDE):
    """Continuous-time VP-SDE."""

    def __init__(
        self,
        nn_diffusion,
        nn_condition=None,
        fix_mask=None,
        loss_weight=None,
        classifier=None,
        grad_clip_norm=None,
        ema_rate: float = 0.995,
        optim_params=None,
        epsilon: float = 1e-3,
        noise_schedule: str = "cosine",
        x_max=None,
        x_min=None,
        predict_noise: bool = True,
        rng: int = 0,
        device=None,
    ):
        super().__init__(nn_diffusion, nn_condition, fix_mask, loss_weight, classifier,
                         grad_clip_norm, ema_rate, optim_params, epsilon, x_max, x_min,
                         predict_noise, rng, device)
        # cosine alpha hits 0 at t=0.9946
        self.t_diffusion = [epsilon, 0.9946] if noise_schedule == "cosine" else [epsilon, 1.0]
        if noise_schedule not in SUPPORTED_NOISE_SCHEDULES:
            raise ValueError(f"Noise schedule {noise_schedule} is not supported.")
        self.noise_schedule_funcs = SUPPORTED_NOISE_SCHEDULES[noise_schedule]

    def add_noise(self, x0, t=None, eps=None, generator=None):
        """t: uniform on `t_diffusion`."""
        if t is None:
            lo, hi = self.t_diffusion
            t = torch.rand(x0.shape[0], generator=generator, device=x0.device) * (hi - lo) + lo
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, device=x0.device)
        alpha, sigma = self.noise_schedule_funcs["forward"](t)
        return self._noised(x0, alpha, sigma, eps), t, eps

    def _sample_tables(self, sample_step_schedule, sample_steps):
        if not sample_step_schedule.endswith("_continuous"):
            sample_step_schedule = sample_step_schedule + "_continuous"
        sched = SUPPORTED_SAMPLING_STEP_SCHEDULE[sample_step_schedule](
            self.t_diffusion, sample_steps)
        alphas, sigmas = self.noise_schedule_funcs["forward"](sched)
        return sched, alphas, sigmas

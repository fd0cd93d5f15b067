"""Discrete and continuous VP-SDE diffusion engines with a k-step sampler
(counterpart of cleandiffuser_tpu/diffusion/diffusionsde.py).

The reference traces its whole denoising loop into one `lax.scan`; here it
is a Python loop over the steps, whose per-step scalars come from float32
host tables (vp_solvers.py), so the loop never waits on the device. Each
step: guided prediction (CFG doubled-batch forward, then the classifier's
gradient), prediction clipping, solver update with noise injection,
fix_mask re-pinning. With a classifier, the sampler can score the final
sample with its log p at t = 0 (`final_logp`). Each step opens the spans
`sampler.denoise` (the CFG forward), `sampler.guide` (the classifier's
gradient, where it guides) and `sampler.update` (from the clipping to the
re-pinned next state), which record while a profiler does
(utils/profiling.py `annotate`).

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

`diffusion_x_sampling_steps` adds that many steps at the last noise level
after the schedule's (Diffusion-X, DiffusionBC's option): each one is the
solver's step from level 1, and each takes its row of `per_step` noise, so
`per_step` then has sample_steps + diffusion_x_sampling_steps rows.

Warm start (`warm_start`, `warm_start_forward_level` = w): the sampler
starts from a reference sample taken part of the way up, x = ref * alpha_w
+ sigma_w * draw (the initial row of `noise`, or a draw from the
generator; no temperature), and runs its steps on the level grid below w:
the discrete engine's schedule over the first int(w * diffusion_steps)
levels, the continuous engine's `*_continuous` schedule over [epsilon,
epsilon + w (1 - epsilon)]. The mask then pins the prior. With
`fused_update`, K2 takes these warm tables' coefficients.
`preserve_history` logs "sample_history", every step's state before the
final clipping: (B, sample_steps + diffusion_x_sampling_steps, ...).
Neither has a pipeline caller; `sample` serves them, as the reference's.

Parallel-in-time sampling (`build_parallel_sample_fn`, `sample_parallel`;
opt-in, nothing dispatches to it, as in the reference): Picard iteration
over the whole DDIM grid (ParaDiGMS, arXiv:2305.16317). The sweep state
holds an estimate at each of the N + 1 grid points; each sweep runs the
network once over all N * B rows (the condition embedding tiled
grid-major, row i * B + b), turns the predictions into eps, and propagates
the DDIM recurrence x_{i-1} = c1_i x_i + c2_i eps_i from x_N down the grid,
re-pinned by the fix mask at every point. K sweeps give sequential DDIM
exactly at K = N (the system is triangular). The propagation is a Python
loop over the N grid points on (B, F) slices; the residual max |X_new - X|
of each sweep stays on the device, and the log holds the last one.

Ported: the solvers, CFG in mix / cond / uncond modes, classifier
guidance, final log p, clipping, inpainting, the diffusion-x steps, warm
start, history, the parallel-in-time sampler and the training loss.
"""

from __future__ import annotations

import torch

from ..ops.solver_update import solver_update_op
from ..utils.schedules import (
    SUPPORTED_NOISE_SCHEDULES,
    SUPPORTED_SAMPLING_STEP_SCHEDULE,
    uniform_discretization,
)
from ..utils.tensors import at_least_ndim
from ..utils.profiling import annotate
from ..utils.ranks import batch_draw, current_rows
from .basic import DiffusionModel, pick_cfg_mode
from .vp_solvers import (
    SUPPORTED_SOLVERS,
    ddpm_coefficients,
    epstheta_to_xtheta,
    solver_step,
    solver_uses_noise,
    xtheta_to_epstheta,
)

__all__ = ["BaseDiffusionSDE", "DiscreteDiffusionSDE", "ContinuousDiffusionSDE"]


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
        self._sample_fns = {}  # `sample`'s samplers, one per setting

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
        pred = self.apply_diffusion(params, xt, t, emb, train=True, generator=generator)
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
        with annotate("sampler.denoise"):
            pred = self.cfg_pred(params, xt, t, emb, w_cfg, cfg_mode)
        if cg_coef != 0.0:
            with annotate("sampler.guide"):
                _, grad = self.classifier.gradients(cls_params, xt, t, condition_cg)
            pred = pred + cg_coef * grad
        return pred

    def _cg_coef(self, w_cg: float, a_i, s_i) -> float:
        """The guidance gradient's weight at level (alpha_i, sigma_i), in
        float32 as the reference's: -w*sigma (eps prediction) or
        w*sigma^2/alpha (x0 prediction)."""
        w = torch.tensor(w_cg, dtype=torch.float32)
        return float(-(w * s_i) if self.predict_noise else w * (s_i**2 / a_i))

    def _sample_tables(self, sample_step_schedule: str, sample_steps: int, warm_level=None):
        """(ts, alphas, sigmas), each a (steps+1,) host tensor; alphas and
        sigmas float32, ts of the dtype the network takes as t. With
        `warm_level`, the grid below the warm start's level (module note)."""
        raise NotImplementedError

    def _forward_level(self, warm_level: float):
        """(alpha, sigma) at the warm start's forward level, as floats."""
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
        fix_mask=None,
        diffusion_x_sampling_steps: int = 0,
        warm_start: bool = False,
        warm_start_forward_level: float = 0.3,
        preserve_history: bool = False,
    ):
        """Build the k-step sampler.

            fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg=0.0, temperature=1.0, noise=None, cls_params=None,
               condition_cg=None, w_cg=0.0, warm_reference=None)
               -> (x0, log dict)

        `params` is `self.params` or `self.ema_params`, `cls_params` the
        classifier's. `fix_mask` (one point's shape) overrides the engine's
        training mask for this sampler only: inference-time inpainting,
        such as Veteran's goal pin. With `bf16_sampling` the sampler casts
        all of `params` (backbone and condition) to bf16 once per call
        (`bf16_params`), not
        once per step; its solver math stays f32. With `final_logp` (default: whether there is a
        classifier) the log holds "log_p" of the final sample at t = 0.

        `diffusion_x_sampling_steps` extra steps run at the last level;
        with `warm_start` and a `warm_reference` (the prior's shape) the
        sampler starts from it on the warm tables; with `preserve_history`
        the log holds "sample_history" (module note).

        `fn` follows the caller's grad mode, as the reference's sampler is a
        plain differentiable function: DQL's policy loss backpropagates
        through it into `params`. Callers that only sample run it under
        `torch.no_grad()`; with `fused_update`, grad mode on raises.
        """
        if solver not in SUPPORTED_SOLVERS:
            raise ValueError(f"Solver {solver} is not supported.")
        if fused_update and solver != "ddpm":
            raise ValueError(f"fused_update takes the ddpm step only, not {solver}")
        if (use_cg or final_logp) and self.classifier is None:
            raise ValueError("classifier guidance and final_logp need a classifier")
        if final_logp is None:
            final_logp = self.classifier is not None
        fix_mask = (self.fix_mask if fix_mask is None else
                    torch.as_tensor(fix_mask, dtype=torch.float32, device=self.device)[None])
        warm_level = warm_start_forward_level if warm_start else None
        ts, alphas, sigmas = self._sample_tables(sample_step_schedule, sample_steps, warm_level)
        if warm_start:
            fwd_alpha, fwd_sigma = self._forward_level(warm_start_forward_level)
        logSNRs = torch.log(alphas / sigmas)
        zero = torch.zeros(1)
        hs = torch.cat([zero, logSNRs[:-1] - logSNRs[1:]])
        stds = torch.cat([
            zero, sigmas[:-1] / sigmas[1:] * torch.sqrt(1 - (alphas[1:] / alphas[:-1]) ** 2)])
        # the levels stepped from: steps, ..., 1, then the diffusion-x steps at 1
        idxs = list(range(sample_steps, 0, -1)) + [1] * diffusion_x_sampling_steps

        def fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg: float = 0.0, temperature: float = 1.0, noise=None, cls_params=None,
               condition_cg=None, w_cg: float = 0.0, warm_reference=None):
            if fused_update and torch.is_grad_enabled():
                # K2 has no backward; a quiet switch to the plain step would
                # be a fallback
                raise RuntimeError("fused_update has no backward: sample under torch.no_grad()")

            def draw(n):
                if noise is not None:
                    return noise[0] if n < 0 else noise[1][n]
                return batch_draw(lambda s: torch.randn(s, generator=generator,
                                                        device=prior.device), prior.shape)

            if fused_update:
                if current_rows() is not None:
                    # K2 draws each element's noise from its index in the
                    # rank's rows: not the number one process draws there
                    raise ValueError("fused_update draws its noise in the kernel: it does not "
                                     "run on a batch split over ranks")
                if noise is not None:
                    raise ValueError("fused_update draws its noise in the kernel: it takes "
                                     "no explicit noise")
                # one seed per step, drawn at once: a single device-to-host copy
                seeds = torch.randint(2**31 - 1, (len(idxs),), generator=generator,
                                      device=generator.device).tolist()
            if self.bf16_sampling:
                params = self.bf16_params(params)
            if warm_start and warm_reference is not None:
                xt = warm_reference * fwd_alpha + fwd_sigma * draw(-1)
            else:
                xt = draw(-1) * temperature
            if fix_mask is not None:
                xt = xt * (1.0 - fix_mask) + prior * fix_mask
            emb = self.apply_condition(params, condition_cfg, mask=mask_cfg)
            prev_x_theta = torch.zeros_like(xt)
            B = prior.shape[0]
            history = []
            for n, i in enumerate(idxs):
                t = torch.full((B,), ts[i].item(), dtype=ts.dtype, device=prior.device)
                a_i, s_i = float(alphas[i]), float(sigmas[i])
                cg_coef = self._cg_coef(w_cg, alphas[i], sigmas[i]) if use_cg else 0.0
                pred = self._guided_pred(params, xt, t, emb, w_cfg, cfg_mode,
                                         cls_params, condition_cg, cg_coef)
                with annotate("sampler.update"):
                    pred = self.clip_prediction(pred, xt, a_i, s_i)
                    if self.predict_noise:
                        eps_theta, x_theta = pred, epstheta_to_xtheta(xt, a_i, s_i, pred)
                    else:
                        eps_theta, x_theta = xtheta_to_epstheta(xt, a_i, s_i, pred), pred
                    if fused_update:
                        x_next = solver_update_op(
                            xt, eps_theta, ddpm_coefficients(i, alphas, sigmas, stds), seeds[n])
                    else:
                        z = draw(n) if solver_uses_noise(solver, i) else None
                        x_next = solver_step(solver, xt, eps_theta, x_theta, prev_x_theta,
                                             n == 0, i, alphas, sigmas, hs, stds, z)
                    if fix_mask is not None:
                        x_next = x_next * (1.0 - fix_mask) + prior * fix_mask
                xt, prev_x_theta = x_next, x_theta
                if preserve_history:
                    history.append(xt)
            log = {}
            if preserve_history:
                log["sample_history"] = torch.stack(history, 1)
            if final_logp:
                t0 = torch.zeros((B,), dtype=ts.dtype, device=prior.device)
                log["log_p"] = self.classifier.logp(cls_params, xt, t0, condition_cg)
            if self.clip_pred:
                xt = torch.clamp(xt, self.x_min, self.x_max)
            return xt, log

        return fn

    def build_parallel_sample_fn(
        self,
        sample_steps: int = 20,
        picard_iters: int = 8,
        sample_step_schedule: str = "uniform",
        cfg_mode: str = "uncond",
    ):
        """Build the parallel-in-time DDIM sampler (module note).

            fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg=0.0, temperature=1.0, noise=None)
               -> (x0, {"picard_residual": r})

        `noise`, when given, is the initial draw (the prior's shape; the
        reference's `k_init` of `split(rng)`), else it comes from
        `generator`. `r` is the last sweep's max |X_new - X|, a device
        scalar. With `bf16_sampling` the network runs on `bf16_params`, as
        in `build_sample_fn`. No classifier guidance. Follows the caller's
        grad mode."""
        ts, alphas, sigmas = self._sample_tables(sample_step_schedule, sample_steps)
        N = sample_steps
        idx = torch.arange(N, 0, -1)  # the grid points stepped from: N..1
        # the DDIM map at grid point i, in float32 as the reference's tables:
        # x_{i-1} = c1 x_i + c2 eps_i
        c1 = alphas[idx - 1] / alphas[idx]
        c2 = sigmas[idx - 1] - c1 * sigmas[idx]
        c1, c2 = c1.tolist(), c2.tolist()
        t_rows, a_rows, s_rows = ts[idx], alphas[idx], sigmas[idx]

        def fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg: float = 0.0, temperature: float = 1.0, noise=None):
            if self.bf16_sampling:
                params = self.bf16_params(params)
            B, feat, dev = prior.shape[0], prior.shape[1:], prior.device
            bc = (N * B,) + (1,) * len(feat)
            if noise is None:
                noise = batch_draw(lambda s: torch.randn(s, generator=generator, device=dev),
                                   prior.shape)
            xT = noise * temperature
            fix = self.fix_mask
            if fix is not None:
                xT = xT * (1.0 - fix) + prior * fix
            emb = self.apply_condition(params, condition_cfg, mask=mask_cfg)
            # the embedding tiled over the N grid points: row i * B + b
            emb_rows = None if emb is None else emb.repeat((N,) + (1,) * (emb.ndim - 1))
            t_all = t_rows.repeat_interleave(B).to(dev)
            a_all = a_rows.repeat_interleave(B).reshape(bc).to(dev)
            s_all = s_rows.repeat_interleave(B).reshape(bc).to(dev)
            prior_flat = prior.reshape(B, -1)
            fixm = None if fix is None else (fix * torch.ones_like(prior)).reshape(B, -1)

            # X[i]: the estimate at grid point N - i, X[0] = xT throughout
            X = xT.reshape(1, B, -1).expand(N + 1, -1, -1)
            resid = None
            for _ in range(picard_iters):
                xs = X[:-1].reshape((N * B,) + feat)
                pred = self.cfg_pred(params, xs, t_all, emb_rows, w_cfg, cfg_mode)
                pred = self.clip_prediction(pred, xs, a_all, s_all)
                eps = pred if self.predict_noise else xtheta_to_epstheta(xs, a_all, s_all, pred)
                eps = eps.reshape(N, B, -1)
                rows = [X[0]]
                for i in range(N):
                    x = c1[i] * rows[-1] + c2[i] * eps[i]
                    if fixm is not None:
                        x = x * (1.0 - fixm) + prior_flat * fixm
                    rows.append(x)
                X_new = torch.stack(rows)
                resid = (X_new - X).abs().max()
                X = X_new
            x0 = X[-1].reshape(prior.shape)
            if self.clip_pred:
                x0 = torch.clamp(x0, self.x_min, self.x_max)
            return x0, {"picard_residual": resid}

        return fn

    def sample_parallel(
        self,
        prior,
        sample_steps: int = 20,
        picard_iters: int = 8,
        sample_step_schedule: str = "uniform",
        use_ema: bool = True,
        temperature: float = 1.0,
        condition_cfg=None,
        mask_cfg=None,
        w_cfg: float = 0.0,
        generator=None,
        noise=None,
    ):
        """Parallel-in-time DDIM sampling (`build_parallel_sample_fn`), the
        CFG mode picked as `sample` picks it; samplers cached per setting.
        Returns (x0, {"picard_residual": r})."""
        cfg_mode = pick_cfg_mode(w_cfg, condition_cfg)
        key = ("sample_parallel", sample_steps, picard_iters, sample_step_schedule, cfg_mode)
        if key not in self._sample_fns:
            self._sample_fns[key] = self.build_parallel_sample_fn(
                sample_steps=sample_steps, picard_iters=picard_iters,
                sample_step_schedule=sample_step_schedule, cfg_mode=cfg_mode)
        params = self.ema_params if use_ema else self.params
        return self._sample_fns[key](params, generator or self.generator, prior, condition_cfg,
                                     mask_cfg, w_cfg, temperature, noise)

    def sample(
        self,
        prior,
        solver: str = "ddpm",
        sample_steps: int = 5,
        sample_step_schedule: str = "uniform",
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
        fused_update: bool = False,
        generator=None,
        noise=None,
    ):
        """One sample with the CFG mode picked as the reference picks it
        (`pick_cfg_mode`) and classifier guidance when there is a
        classifier, a weight and a condition; a warm start when a
        `warm_start_reference` is given. Samplers are cached per setting.
        Returns (x0, log) with "sample_history" and "log_p" (each None when
        not made). Follows the caller's grad mode, as `build_sample_fn`'s
        sampler does."""
        cfg_mode = pick_cfg_mode(w_cfg, condition_cfg)
        use_cg = self.classifier is not None and w_cg != 0.0 and condition_cg is not None
        warm = warm_start_reference is not None
        key = ("sample", solver, sample_steps, sample_step_schedule, cfg_mode, use_cg,
               diffusion_x_sampling_steps, warm, warm_start_forward_level if warm else None,
               preserve_history, fused_update)
        if key not in self._sample_fns:
            self._sample_fns[key] = self.build_sample_fn(
                solver=solver, sample_steps=sample_steps,
                sample_step_schedule=sample_step_schedule, cfg_mode=cfg_mode, use_cg=use_cg,
                fused_update=fused_update, diffusion_x_sampling_steps=diffusion_x_sampling_steps,
                warm_start=warm, warm_start_forward_level=warm_start_forward_level,
                preserve_history=preserve_history)
        params = self.ema_params if use_ema else self.params
        cls_params = self.classifier.inference_params if self.classifier is not None else None
        x0, log = self._sample_fns[key](
            params, generator or self.generator, prior, condition_cfg, mask_cfg, w_cfg,
            temperature, noise, cls_params, condition_cg, w_cg, warm_start_reference)
        log.setdefault("sample_history", None)
        log.setdefault("log_p", None)
        return x0, log


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
            t = batch_draw(lambda s: torch.randint(self.diffusion_steps, s, generator=generator,
                                                   device=x0.device), (x0.shape[0],))
        if eps is None:
            eps = batch_draw(lambda s: torch.randn(s, generator=generator, device=x0.device),
                             x0.shape)
        return self._noised(x0, self._alpha_dev[t], self._sigma_dev[t], eps), t, eps

    def _sample_tables(self, sample_step_schedule, sample_steps, warm_level=None):
        T_eff = (self.diffusion_steps if warm_level is None
                 else int(warm_level * self.diffusion_steps))
        sched = SUPPORTED_SAMPLING_STEP_SCHEDULE[sample_step_schedule](
            T_eff, sample_steps).long()
        return sched.to(torch.int32), self.alpha[sched], self.sigma[sched]

    def _forward_level(self, warm_level):
        i = int(warm_level * self.diffusion_steps)
        return float(self.alpha[i]), float(self.sigma[i])


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
            t = batch_draw(lambda s: torch.rand(s, generator=generator, device=x0.device),
                           (x0.shape[0],)) * (hi - lo) + lo
        if eps is None:
            eps = batch_draw(lambda s: torch.randn(s, generator=generator, device=x0.device),
                             x0.shape)
        alpha, sigma = self.noise_schedule_funcs["forward"](t)
        return self._noised(x0, alpha, sigma, eps), t, eps

    def _warm_t(self, warm_level):
        """The continuous time of the warm start's level."""
        return self.epsilon + warm_level * (1.0 - self.epsilon)

    def _sample_tables(self, sample_step_schedule, sample_steps, warm_level=None):
        trange = (self.t_diffusion if warm_level is None
                  else [self.t_diffusion[0], self._warm_t(warm_level)])
        if not sample_step_schedule.endswith("_continuous"):
            sample_step_schedule = sample_step_schedule + "_continuous"
        sched = SUPPORTED_SAMPLING_STEP_SCHEDULE[sample_step_schedule](trange, sample_steps)
        alphas, sigmas = self.noise_schedule_funcs["forward"](sched)
        return sched, alphas, sigmas

    def _forward_level(self, warm_level):
        alpha, sigma = self.noise_schedule_funcs["forward"](
            torch.tensor([self._warm_t(warm_level)], dtype=torch.float32))
        return float(alpha[0]), float(sigma[0])

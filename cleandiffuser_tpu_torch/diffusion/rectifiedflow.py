"""Rectified-flow engines with an Euler sampler (counterpart of
cleandiffuser_tpu/diffusion/rectifiedflow.py).

Straight flow matching between a source x1 (a Gaussian draw unless the
caller gives one: reflow's self-generated pairs) and the data x0:
xt = t*x1 + (1-t)*x0, and the network predicts the velocity x0 - x1.
`DiscreteRectifiedFlow` puts t on a grid of `diffusion_steps` points of
[0, 1] (the network takes the integer index); `ContinuousRectifiedFlow`
draws t uniform on [0, 1] (the network takes t itself). No classifier
guidance, as in the reference.

Training (`update(x0, condition, x1=None)` on diffusion/basic.py's step):
the draws come from the engine's generator, or explicitly as
`noise=(t, x1, keep_mask)`, the roles of the reference's
`k_t, k_x1, k_cond, k_drop = split(rng, 4)`; a reflow `x1` takes the
place of the drawn one.

Sampling (`build_sample_fn` or `sample`): Euler steps from t = 1 down the
`uniform` or `quad` schedule (the continuous engine appends `_continuous`
to a schedule's name), then `diffusion_x_sampling_steps` more steps at the
last level, with CFG in "mix", "cond" or "uncond" mode, fix_mask
inpainting, `temperature` on the initial x1, an optional given x1, and
warm start from a reference sample noised to `warm_start_forward_level`.
The one draw, the initial x1, comes from the generator or as `noise` (of
the prior's shape); the reference draws it from `k_init, _ = split(rng)`.
The per-step times are float32 host tables, so the loop never waits on
the device. The sampler follows the caller's grad mode, as the SDE
engines' does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.schedules import SUPPORTED_DISCRETIZATIONS, SUPPORTED_SAMPLING_STEP_SCHEDULE
from ..utils.ranks import batch_draw
from ..utils.tensors import at_least_ndim
from .basic import DiffusionModel, pick_cfg_mode

__all__ = ["DiscreteRectifiedFlow", "ContinuousRectifiedFlow"]


class _BaseRectifiedFlow(DiffusionModel):
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
        x_max=None,
        x_min=None,
        rng: int = 0,
        device=None,
    ):
        if classifier is not None:
            raise ValueError("Rectified Flow does not support classifier-guidance.")
        super().__init__(nn_diffusion, nn_condition, fix_mask, loss_weight, None,
                         grad_clip_norm, ema_rate, optim_params, rng, device)
        as_t = lambda v: None if v is None else torch.as_tensor(
            v, dtype=torch.float32, device=self.device)
        self.x_max, self.x_min = as_t(x_max), as_t(x_min)
        self._sample_fns = {}

    @property
    def clip_pred(self):
        return (self.x_max is not None) or (self.x_min is not None)

    def _pin(self, x, prior):
        return x if self.fix_mask is None else x * (1.0 - self.fix_mask) + prior * self.fix_mask

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _sample_t(self, batch: int, generator, device):
        """(t_net, t_cont) for training: the network's time and the
        continuous one."""
        raise NotImplementedError

    def _t_cont(self, t_net):
        raise NotImplementedError

    def loss_fn(self, params, x0, condition=None, noise=None, generator=None,
                weighted_regression=None, x1=None):
        """mean((pred - (x0 - x1))^2 * loss_weight * (1 - fix_mask)).
        `noise=(t, x1, keep_mask)` gives the draws explicitly (a None entry
        is drawn from `generator`); a given `x1` (reflow) wins over both."""
        t, x1_draw, keep = noise if noise is not None else (None, None, None)
        if x1 is None:
            x1 = x1_draw if x1_draw is not None else batch_draw(
                lambda s: torch.randn(s, generator=generator, device=x0.device), x0.shape)
        if t is None:
            t, t_c = self._sample_t(x0.shape[0], generator, x0.device)
        else:
            t_c = self._t_cont(t)
        t_c = at_least_ndim(t_c, x0.ndim)
        xt = self._pin(t_c * x1 + (1 - t_c) * x0, x0)
        emb = self.apply_condition(params, condition, mask=keep, train=True,
                                   generator=generator)
        pred = self.apply_diffusion(params, xt, t, emb, train=True, generator=generator)
        loss = (pred - (x0 - x1)) ** 2
        if self.loss_weight is not None:
            loss = loss * self.loss_weight
        if self.fix_mask is not None:
            loss = loss * (1.0 - self.fix_mask)
        if weighted_regression is not None:
            loss = loss * weighted_regression[..., None]
        return loss.mean()

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------
    def _sample_times(self, sample_step_schedule: str, sample_steps: int, warm_level):
        """(ts_net, ts_cont): (steps+1,) host tensors, the network's times
        and the continuous ones (float32)."""
        raise NotImplementedError

    def _warm_level(self, warm_level: float) -> float:
        """The continuous time a warm start's reference is noised to."""
        raise NotImplementedError

    def build_sample_fn(
        self,
        sample_steps: int = 5,
        sample_step_schedule: str = "uniform",
        cfg_mode: str = "uncond",
        diffusion_x_sampling_steps: int = 0,
        warm_start: bool = False,
        warm_start_forward_level: float = 0.3,
        preserve_history: bool = False,
    ):
        """Build the Euler sampler.

            fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg=0.0, temperature=1.0, noise=None, warm_reference=None,
               x1=None) -> (x0, log dict)

        The initial state is, in this order of precedence: the warm start's
        `draw * t_w + warm_reference * (1 - t_w)` (with `warm_start` and a
        reference), the given `x1`, or `draw * temperature`; `draw` is
        `noise` or a draw from `generator`. With `preserve_history` the log
        holds "sample_history" (B, steps, *x)."""
        if cfg_mode not in ("mix", "cond", "uncond"):
            raise ValueError(f"unknown cfg_mode {cfg_mode!r}")
        ts_net, ts_c = self._sample_times(
            sample_step_schedule, sample_steps, warm_start_forward_level if warm_start else None)
        idxs = list(range(sample_steps, 0, -1)) + [1] * diffusion_x_sampling_steps
        warm_t = self._warm_level(warm_start_forward_level) if warm_start else None

        def fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg: float = 0.0, temperature: float = 1.0, noise=None, warm_reference=None,
               x1=None):
            if self.bf16_sampling:
                params = self.bf16_params(params, condition=False)
            draw = lambda: noise if noise is not None else batch_draw(
                lambda s: torch.randn(s, generator=generator, device=prior.device), prior.shape)
            if warm_start and warm_reference is not None:
                xt = draw() * warm_t + warm_reference * (1 - warm_t)
            elif x1 is not None:
                xt = x1
            else:
                xt = draw() * temperature
            xt = self._pin(xt, prior)
            emb = self.apply_condition(params, condition_cfg, mask=mask_cfg)
            B = prior.shape[0]
            history = []
            for i in idxs:
                t = torch.full((B,), ts_net[i].item(), dtype=ts_net.dtype, device=prior.device)
                delta_t = float(ts_c[i] - ts_c[i - 1])
                vel = self.cfg_pred(params, xt, t, emb, w_cfg, cfg_mode)
                xt = self._pin(xt + delta_t * vel, prior)
                if preserve_history:
                    history.append(xt)
            log = {}
            if preserve_history:
                log["sample_history"] = torch.stack(history, 1)
            if self.clip_pred:
                xt = torch.clamp(xt, self.x_min, self.x_max)
            return xt, log

        return fn

    def sample(
        self,
        prior,
        x1=None,
        solver: str = "euler",
        sample_steps: int = 5,
        sample_step_schedule: str = "uniform",
        use_ema: bool = True,
        temperature: float = 1.0,
        condition_cfg=None,
        mask_cfg=None,
        w_cfg: float = 0.0,
        diffusion_x_sampling_steps: int = 0,
        warm_start_reference=None,
        warm_start_forward_level: float = 0.3,
        preserve_history: bool = False,
        generator: Optional[torch.Generator] = None,
        noise=None,
    ):
        """One sample: the CFG mode from `w_cfg` and the condition, as the
        reference picks it (`pick_cfg_mode`); `solver` is dropped (Euler
        only). Samplers are cached per setting. Returns (x0, log) with
        "sample_history" (or None) and "log_p" None."""
        del solver
        cfg_mode = pick_cfg_mode(w_cfg, condition_cfg)
        warm = warm_start_reference is not None
        key = ("sample", sample_steps, sample_step_schedule, cfg_mode,
               diffusion_x_sampling_steps, warm, warm_start_forward_level if warm else None,
               preserve_history)
        if key not in self._sample_fns:
            self._sample_fns[key] = self.build_sample_fn(
                sample_steps, sample_step_schedule, cfg_mode, diffusion_x_sampling_steps,
                warm, warm_start_forward_level, preserve_history)
        params = self.ema_params if use_ema else self.params
        x0, log = self._sample_fns[key](params, generator or self.generator, prior, condition_cfg,
                             mask_cfg, w_cfg, temperature, noise, warm_start_reference, x1)
        log.setdefault("sample_history", None)
        log.setdefault("log_p", None)
        return x0, log


class DiscreteRectifiedFlow(_BaseRectifiedFlow):
    """Discrete-time rectified flow: t on a `diffusion_steps`-point grid of
    [0, 1] (`discretization`, uniform by default); the network takes the
    integer index."""

    def __init__(self, *args, diffusion_steps: int = 1000, discretization="uniform", **kwargs):
        super().__init__(*args, **kwargs)
        self.diffusion_steps = diffusion_steps
        if isinstance(discretization, str):
            disc_fn = SUPPORTED_DISCRETIZATIONS.get(discretization,
                                                    SUPPORTED_DISCRETIZATIONS["uniform"])
        else:
            disc_fn = discretization
        self.t_diffusion = torch.as_tensor(disc_fn(diffusion_steps, 0.0), dtype=torch.float32)
        self._t_dev = self.t_diffusion.to(self.device)

    def _sample_t(self, batch, generator, device):
        t = batch_draw(lambda s: torch.randint(self.diffusion_steps, s, generator=generator,
                                               device=device), (batch,))
        return t, self._t_dev[t]

    def _t_cont(self, t_net):
        return self._t_dev[t_net.to(self.device).long()]

    def _sample_times(self, sample_step_schedule, sample_steps, warm_level):
        T_eff = (int(warm_level * self.diffusion_steps) if warm_level is not None
                 else self.diffusion_steps)
        sched_fn = (SUPPORTED_SAMPLING_STEP_SCHEDULE[sample_step_schedule]
                    if isinstance(sample_step_schedule, str) else sample_step_schedule)
        sched = torch.as_tensor(sched_fn(T_eff, sample_steps)).long()
        return sched.to(torch.int32), self.t_diffusion[sched]

    def _warm_level(self, warm_level):
        return float(self.t_diffusion[int(warm_level * self.diffusion_steps)])


class ContinuousRectifiedFlow(_BaseRectifiedFlow):
    """Continuous-time rectified flow: t uniform on [0, 1]."""

    def _sample_t(self, batch, generator, device):
        t = batch_draw(lambda s: torch.rand(s, generator=generator, device=device), (batch,))
        return t, t

    def _t_cont(self, t_net):
        return t_net

    def _sample_times(self, sample_step_schedule, sample_steps, warm_level):
        final_t = warm_level if warm_level is not None else 1.0
        if isinstance(sample_step_schedule, str):
            if not sample_step_schedule.endswith("_continuous"):
                sample_step_schedule = sample_step_schedule + "_continuous"
            sched_fn = SUPPORTED_SAMPLING_STEP_SCHEDULE[sample_step_schedule]
        else:
            sched_fn = sample_step_schedule
        sched = torch.as_tensor(sched_fn([0.0, final_t], sample_steps), dtype=torch.float32)
        return sched, sched

    def _warm_level(self, warm_level):
        return warm_level

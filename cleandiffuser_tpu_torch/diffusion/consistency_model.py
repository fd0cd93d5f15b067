"""Continuous-time consistency model: training, distillation and the
multistep sampler (counterpart of cleandiffuser_tpu/diffusion/consistency_model.py).

- The iCT discretization curriculum (`CMCurriculumLogger`) is host state:
  N(k) doubles from s0 up to s1 over the curriculum cycle, and each stage's
  sigma grid and its erf-based pmf over adjacent-level pairs are numpy
  tables padded to the fixed size s1 (the pmf is zero beyond N(k)), as the
  reference pads them. A stage's tables reach the device once.
- Consistency training: the pseudo-Huber distance between the model at
  adjacent noise levels sharing one eps, the lower level's side without
  gradient (and without dropout), weighted 1 / (sigma_m - sigma_n).
  `noise=(idx, eps, keep_mask)` gives the draws explicitly: the pair index
  (B,) drawn from the pmf, the noise and the condition's keep-mask, the
  roles of the reference's `k_idx, k_eps, k_cond, k_drop = split(rng, 4)`.
- Consistency distillation (`prepare_distillation(edm)` first, which
  raises when the teacher's sigma_data, sigma range, rho or clipping
  differ): the teacher EDM's EMA takes one Euler step m -> n, and the
  student at m is matched to its EMA at n, weighted 1 / (t_m - t_n).
  `noise=(idx, eps)`: the reference's `k_t, k_eps, _ = split(rng, 3)`, the
  teacher's `add_noise` drawing eps from `split(k_eps)[1]`.
- Sampling: one evaluation at sigma_max, then (steps - 1) rounds of noise
  re-injection to the Karras grid's levels and one evaluation each;
  `noise=(initial, per_step)` as the SDE engines take it.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..utils.schedules import karras_sigma_schedule
from ..utils.ranks import batch_draw
from ..utils.tensors import at_least_ndim
from .basic import DiffusionModel
from .edm import ContinuousEDM

__all__ = ["ContinuousConsistencyModel", "CMCurriculumLogger", "pseudo_huber_loss",
           "compare_properties"]


def compare_properties(obj1, obj2, properties: List[str]) -> List[str]:
    """The names in `properties` whose values differ between the two objects
    (arrays and tensors compared by allclose, None against a value
    differs)."""

    def differs(a, b):
        arrays = (np.ndarray, torch.Tensor)
        if isinstance(a, arrays) or isinstance(b, arrays):
            if a is None or b is None:
                return True
            as_np = lambda v: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            return not np.allclose(as_np(a), as_np(b))
        return a != b

    return [p for p in properties if differs(getattr(obj1, p), getattr(obj2, p))]


def pseudo_huber_loss(source, target, c: float = 0.0):
    """sqrt(err^2 + c^2) - c, the iCT loss; c = 0 is |err|."""
    return torch.sqrt((source - target) ** 2 + c**2) - c


class CMCurriculumLogger:
    """The iCT curriculum N(k) and its noise-level pmf, host state with
    tables padded to s1."""

    def __init__(self, s0: int = 10, s1: int = 1280, curriculum_cycle: int = 100_000,
                 sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0,
                 P_mean: float = -1.1, P_std: float = 2.0):
        self.Kprime = np.ceil(curriculum_cycle / (np.log2(np.ceil(s1 / s0)) + 1))
        self.Nk = s0
        self.s0, self.s1 = s0, s1
        self.curriculum_cycle = curriculum_cycle
        self.sigma_min, self.sigma_max, self.rho = sigma_min, sigma_max, rho
        self.P_mean, self.P_std = P_mean, P_std
        self.ceil_k_div_Kprime, self.k = None, None
        self._device_tables = {}
        self.update_k(0)

    def update_k(self, k: int):
        self.k = k
        if np.ceil(k / self.Kprime) != self.ceil_k_div_Kprime:
            self.ceil_k_div_Kprime = np.ceil(k / self.Kprime)
            self.Nk = int(min(self.s0 * (2**self.ceil_k_div_Kprime), self.s1))
            sig = (
                self.sigma_min ** (1 / self.rho)
                + np.arange(self.Nk + 1, dtype=np.float32) / self.Nk
                * (self.sigma_max ** (1 / self.rho) - self.sigma_min ** (1 / self.rho))
            ) ** self.rho
            z = (np.log(sig) - self.P_mean) / (self.P_std * math.sqrt(2.0))
            erfv = np.vectorize(math.erf)(z)
            p = erfv[1:] - erfv[:-1]
            p = p / p.sum()
            sig_pad = np.full((self.s1 + 1,), sig[-1], np.float32)
            sig_pad[: self.Nk + 1] = sig
            p_pad = np.zeros((self.s1,), np.float32)
            p_pad[: self.Nk] = p
            self.sigmas_padded, self.p_padded = sig_pad, p_pad
            self._device_tables = {}

    def incremental_update_k(self):
        self.update_k(self.k + 1)

    def tables(self, device) -> tuple:
        """(sigmas_padded, p_padded) of the current stage on `device`,
        copied there once per stage."""
        key = str(device)
        if key not in self._device_tables:
            self._device_tables[key] = (torch.as_tensor(self.sigmas_padded, device=device),
                                        torch.as_tensor(self.p_padded, device=device))
        return self._device_tables[key]

    @property
    def curriculum_process(self):
        return (self.k % self.curriculum_cycle) / self.curriculum_cycle


class ContinuousConsistencyModel(DiffusionModel):
    def __init__(
        self,
        nn_diffusion,
        nn_condition=None,
        fix_mask=None,
        loss_weight=None,
        classifier=None,
        grad_clip_norm: Optional[float] = None,
        ema_rate: float = 0.9999,
        optim_params: Optional[dict] = None,
        s0: int = 10,
        s1: int = 1280,
        data_dim: Optional[int] = None,
        P_mean: float = -1.1,
        P_std: float = 2.0,
        sigma_min: float = 0.002,
        sigma_max: float = 80.0,
        sigma_data: float = 0.5,
        rho: float = 7.0,
        curriculum_cycle: int = 100_000,
        x_max=None,
        x_min=None,
        rng: int = 0,
        device=None,
    ):
        if classifier is not None:
            raise ValueError("Consistency Model does not support classifier guidance.")
        super().__init__(nn_diffusion, nn_condition, fix_mask, loss_weight, None,
                         grad_clip_norm, ema_rate, optim_params, rng, device)
        self.cur_logger = CMCurriculumLogger(s0, s1, curriculum_cycle, sigma_min, sigma_max,
                                             rho, P_mean, P_std)
        self.pseudo_huber_constant = 0.01 if data_dim is None else 0.00054 * math.sqrt(data_dim)
        self.rho = rho
        self.sigma_data, self.sigma_max, self.sigma_min = sigma_data, sigma_max, sigma_min
        as_t = lambda v: None if v is None else torch.as_tensor(
            v, dtype=torch.float32, device=self.device)
        self.x_max, self.x_min = as_t(x_max), as_t(x_min)
        self.edm: Optional[ContinuousEDM] = None
        self.distillation_sigmas, self.distillation_N = None, None
        self._sample_fns = {}

    @property
    def supported_solvers(self):
        return ["none"]

    @property
    def clip_pred(self):
        return (self.x_max is not None) or (self.x_min is not None)

    def _pin(self, x, ref):
        return x if self.fix_mask is None else x * (1.0 - self.fix_mask) + ref * self.fix_mask

    def training_noise_schedule(self, N: int):
        return karras_sigma_schedule(self.sigma_min, self.sigma_max, self.rho, N)

    def prepare_distillation(self, edm: ContinuousEDM, distillation_N: int = 18):
        """Take a trained EDM as the teacher and its weights (params and
        EMA) as the student's start; raises ValueError when the properties
        the two must share differ."""
        checklist = ["sigma_data", "sigma_max", "sigma_min", "rho", "x_max", "x_min"]
        differences = compare_properties(self, edm, checklist)
        if differences:
            raise ValueError(
                f"Properties {differences} differ between the EDM and the Consistency Model.")
        self.edm = edm
        with torch.no_grad():
            self.params.load_state_dict(edm.params.state_dict())
            self.ema_params.load_state_dict(edm.ema_params.state_dict())
        self.distillation_N = distillation_N
        self.distillation_sigmas = self.training_noise_schedule(distillation_N).to(self.device)

    # ---------------- CM preconditioning ----------------
    def c_skip(self, sigma):
        return self.sigma_data**2 / (self.sigma_data**2 + (sigma - self.sigma_min) ** 2)

    def c_out(self, sigma):
        return (sigma - self.sigma_min) * self.sigma_data / torch.sqrt(
            self.sigma_data**2 + sigma**2)

    def c_in(self, sigma):
        return 1.0 / torch.sqrt(self.sigma_data**2 + sigma**2)

    def c_noise(self, sigma):
        return 0.25 * torch.log(sigma)

    def f(self, params, x, t, emb=None, train: bool = False,
          generator: Optional[torch.Generator] = None):
        """The consistency function at level t (B,), clipped."""
        cs = at_least_ndim(self.c_skip(t), x.ndim)
        co = at_least_ndim(self.c_out(t), x.ndim)
        ci = at_least_ndim(self.c_in(t), x.ndim)
        pred = cs * x + co * self.apply_diffusion(params, ci * x, self.c_noise(t), emb,
                                                  train=train, generator=generator)
        return torch.clamp(pred, self.x_min, self.x_max) if self.clip_pred else pred

    # ---------------- Losses ----------------
    def _weighted(self, loss):
        if self.fix_mask is not None:
            loss = loss * (1.0 - self.fix_mask)
        if self.loss_weight is not None:
            loss = loss * self.loss_weight
        return loss

    def training_loss(self, params, x0, condition=None, noise=None, generator=None):
        """(loss, {"unweighted_loss"}) of consistency training at the
        curriculum's current stage."""
        idx, eps, keep = noise if noise is not None else (None, None, None)
        sigmas, p = self.cur_logger.tables(x0.device)
        b = x0.shape[0]
        if idx is None:
            idx = batch_draw(lambda s: torch.multinomial(p, s[0], replacement=True,
                                                         generator=generator), (b,))
        if eps is None:
            eps = batch_draw(lambda s: torch.randn(s, generator=generator, device=x0.device),
                             x0.shape)
        idx = idx.to(x0.device)
        sigma_n, sigma_m = sigmas[idx], sigmas[idx + 1]
        x_n = x0 + at_least_ndim(sigma_n, x0.ndim) * eps
        x_m = x0 + at_least_ndim(sigma_m, x0.ndim) * eps
        emb = self.apply_condition(params, condition, mask=keep, train=True,
                                   generator=generator)
        pred_x_m = self.f(params, x_m, sigma_m, emb, train=True, generator=generator)
        with torch.no_grad():
            pred_x_n = self.f(params, x_n, sigma_n, None if emb is None else emb.detach())
        unweighted = self._weighted(
            pseudo_huber_loss(pred_x_m, pred_x_n, self.pseudo_huber_constant))
        cm_weight = at_least_ndim(1.0 / (sigma_m - sigma_n), x0.ndim)
        return (unweighted * cm_weight).mean(), {"unweighted_loss": unweighted.mean().detach()}

    def distillation_loss(self, params, x0, condition=None, noise=None, generator=None):
        """(loss, {}) of consistency distillation from the teacher's EMA."""
        idx, eps = noise if noise is not None else (None, None)
        sig = self.distillation_sigmas
        b = x0.shape[0]
        if idx is None:
            idx = batch_draw(lambda s: torch.randint(self.distillation_N, s, generator=generator,
                                                     device=x0.device), (b,))
        idx = idx.to(x0.device)
        t_m, t_n = sig[idx + 1], sig[idx]
        edm, teacher = self.edm, self.edm.ema_params
        with torch.no_grad():
            x_m, t_m, _ = edm.add_noise(x0, t_m, eps, generator)
            pred = edm.D(teacher, x_m, t_m, edm.apply_condition(teacher, condition))
            dot_x = (x_m - pred) / at_least_ndim(t_m, x_m.ndim)
            x_n = x_m - dot_x * at_least_ndim(t_m - t_n, x_m.ndim)
            x_n = self._pin(x_n, x0)
            ema = self.ema_params
            pred_x_n = self.f(ema, x_n, t_n, self.apply_condition(ema, condition))
        pred_x_m = self.f(params, x_m, t_m, self.apply_condition(params, condition))
        loss = self._weighted((pred_x_n - pred_x_m) ** 2)
        loss = loss * at_least_ndim(1.0 / (t_m - t_n), pred_x_n.ndim)
        return loss.mean(), {}

    # ---------------- Update ----------------
    def update(self, x0, condition=None, loss_type: str = "training", noise=None) -> dict:
        """One gradient step and one EMA step on the training or the
        distillation loss; a training step advances the curriculum. Returns
        {"loss", ...} as device scalars."""
        if loss_type not in ("training", "distillation"):
            raise ValueError(f"unknown loss_type {loss_type!r}")
        if loss_type == "distillation" and self.edm is None:
            raise ValueError("Call `prepare_distillation` before distillation.")
        loss_fn = self.training_loss if loss_type == "training" else self.distillation_loss
        loss, aux = loss_fn(self.params, x0, condition, noise, self.generator)
        loss.backward()
        self.optimizer.step()
        self.ema_update()
        self.step += 1
        if loss_type == "training":
            self.cur_logger.incremental_update_k()
        return {"loss": loss.detach(), **aux}

    # ---------------- Sampling ----------------
    def build_sample_fn(self, sample_steps: int = 5, cfg_mode: str = "uncond",
                        diffusion_x_sampling_steps: int = 0):
        """Build the multistep sampler.

            fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg=0.0, temperature=1.0, noise=None) -> (x0, {})

        The condition's embedding is used whenever one is given (`cfg_mode`
        and `w_cfg` are taken for the engines' common signature and not
        read, as in the reference)."""
        del cfg_mode
        sigmas = karras_sigma_schedule(self.sigma_min, self.sigma_max, self.rho, sample_steps)
        idxs = sorted(list(range(1, sample_steps)) + [1] * diffusion_x_sampling_steps,
                      reverse=True)
        f32 = np.float32
        scales = [float(np.sqrt(np.maximum(f32(sigmas[i]) ** 2 - f32(self.sigma_min**2),
                                           f32(0.0)))) for i in idxs]

        def fn(params, generator, prior, condition_cfg=None, mask_cfg=None,
               w_cfg: float = 0.0, temperature: float = 1.0, noise=None):
            del w_cfg
            if self.bf16_sampling:
                params = self.bf16_params(params, condition=False)

            def draw(n):
                if noise is not None:
                    return noise[0] if n < 0 else noise[1][n]
                return batch_draw(lambda s: torch.randn(s, generator=generator,
                                                        device=prior.device), prior.shape)

            B = prior.shape[0]
            full = lambda v: torch.full((B,), v, dtype=torch.float32, device=prior.device)
            xt = self._pin(draw(-1) * self.sigma_max * temperature, prior)
            emb = self.apply_condition(params, condition_cfg, mask=mask_cfg)
            pred_x = self._pin(self.f(params, xt, full(float(sigmas[-1])), emb), prior)
            for n, (i, scale) in enumerate(zip(idxs, scales)):
                xt = pred_x + scale * draw(n)
                pred_x = self._pin(self.f(params, xt, full(float(sigmas[i])), emb), prior)
            return pred_x, {}

        return fn

    def sample(self, prior, solver: str = "none", sample_steps: int = 5, use_ema: bool = True,
               temperature: float = 1.0, condition_cfg=None, mask_cfg=None, w_cfg: float = 0.0,
               condition_cg=None, w_cg: float = 0.0, diffusion_x_sampling_steps: int = 0,
               generator: Optional[torch.Generator] = None, noise=None):
        """One sample (no classifier guidance: a weight or condition for it
        raises). Returns (x0, log) with "sample_history" and "log_p" None."""
        if w_cg != 0.0 or condition_cg is not None:
            raise ValueError("Consistency Distillation does not support classifier guidance.")
        del solver
        key = ("sample", sample_steps, diffusion_x_sampling_steps)
        if key not in self._sample_fns:
            self._sample_fns[key] = self.build_sample_fn(sample_steps, "uncond",
                                                         diffusion_x_sampling_steps)
        params = self.ema_params if use_ema else self.params
        x0, log = self._sample_fns[key](params, generator or self.generator, prior,
                                        condition_cfg, mask_cfg, w_cfg, temperature, noise)
        log.setdefault("sample_history", None)
        log.setdefault("log_p", None)
        return x0, log

"""DiffusionModel holder and training step (counterpart of
cleandiffuser_tpu/diffusion/basic.py).

The reference keeps one immutable pytree of parameters plus an EMA copy;
here both are `nn.ModuleDict({"diffusion": backbone, "condition":
encoder})` on one device (the CUDA device unless the caller names
another), and the pure `apply_*` helpers take either of them as their
`params`. A classifier for guidance (classifier/base.py) holds its own
parameters, optimizer and EMA; the engine keeps it in its `classifier` slot.

Training (`update`): loss (the engine's `loss_fn`), backward, AdamW with
optional global-norm clipping and a schedule (utils/train_state.py), then
the EMA step, all in place on the device. `update` returns the loss and the
gradient's global norm before clipping as device tensors: no host sync per
step. Random draws come from `self.generator` (on the engine's device,
seeded by `rng`) unless the caller passes them explicitly (`noise=`).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn as nn

from ..nn_condition.base import IdentityCondition
from ..utils.jax_params import load_agent_moments, load_agent_params
from ..utils.tensors import default_device
from ..utils.train_state import (
    ema_update,
    load_jax_checkpoint,
    load_state,
    make_optimizer,
    save_state,
)

__all__ = ["DiffusionModel"]


class DiffusionModel:
    def __init__(
        self,
        nn_diffusion: nn.Module,
        nn_condition: Optional[nn.Module] = None,
        fix_mask=None,
        loss_weight=None,
        classifier=None,
        grad_clip_norm: Optional[float] = None,
        ema_rate: float = 0.995,
        optim_params: Optional[dict] = None,
        rng: int = 0,
        device=None,
    ):
        self.device = default_device(device)
        self.classifier = classifier
        self.ema_rate = ema_rate
        cond = nn_condition if nn_condition is not None else IdentityCondition()
        self.params = nn.ModuleDict({"diffusion": nn_diffusion, "condition": cond})
        self.params.to(self.device)
        self.ema_params = copy.deepcopy(self.params).requires_grad_(False)
        self._optim_args = dict(grad_clip_norm=grad_clip_norm,
                                **(optim_params or {"lr": 2e-4, "weight_decay": 1e-5}))
        self._optimizer = None
        self.generator = torch.Generator(device=self.device).manual_seed(rng)
        self.step = 0  # host counter of updates: reading the device's would sync

        def per_point(a):
            if a is None:
                return None
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)[None]

        # (1, *x_shape) or None; None means "no entry pinned" / "weight 1"
        self.fix_mask = per_point(fix_mask)
        self.loss_weight = per_point(loss_weight)

    # ------------------------------------------------------------------
    # Module application helpers (pure in `params`)
    # ------------------------------------------------------------------
    def apply_condition(self, params: nn.ModuleDict, condition, mask=None,
                        train: bool = False, generator: Optional[torch.Generator] = None):
        """Run nn_condition; None passes through (backbone substitutes zeros).
        With `train`, `mask` is the keep-mask (drawn from `generator` when
        None)."""
        if condition is None:
            return None
        return params["condition"](condition, mask=mask, train=train, generator=generator)

    def apply_diffusion(self, params: nn.ModuleDict, x, t, emb):
        return params["diffusion"](x, t, emb)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    @property
    def optimizer(self):
        """Built at first use: an engine whose nets hold no parameters (a
        sampler test's) never trains, and torch.optim refuses none."""
        if self._optimizer is None:
            self._optimizer = make_optimizer(self.params.parameters(), **self._optim_args)
        return self._optimizer

    def loss_fn(self, params, x0, condition=None, noise=None, generator=None,
                weighted_regression=None):
        raise NotImplementedError

    def update(self, x0, condition=None, noise=None, weighted_regression_tensor=None) -> dict:
        """One gradient step + EMA step. Returns {"loss", "grad_norm"} as
        device scalars. `noise` is the loss's optional explicit draws (see
        the engine's `loss_fn`)."""
        loss = self.loss_fn(self.params, x0, condition, noise=noise, generator=self.generator,
                            weighted_regression=weighted_regression_tensor)
        loss.backward()
        grad_norm = self.optimizer.step()
        self.ema_update()
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    def ema_update(self):
        ema_update(self.ema_params, self.params, self.ema_rate)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    def save(self, path):
        save_state(path, self.params, self.ema_params, self.optimizer, self.step, self.generator)

    def load(self, path):
        self.step = load_state(path, self.params, self.ema_params, self.optimizer,
                               self.generator)

    def load_jax_checkpoint(self, path):
        """Resume from a checkpoint the JAX engine's `save` wrote: params,
        EMA, Adam moments, schedule count and step (its PRNG key has no
        counterpart here; the generator keeps its state)."""
        ckpt = load_jax_checkpoint(path)
        load_agent_params(self.params, ckpt["params"])
        load_agent_params(self.ema_params, ckpt["ema_params"])
        load_agent_moments(self.optimizer.optimizer, self.params, ckpt["mu"], ckpt["nu"],
                           ckpt["count"])
        if ckpt["schedule_count"] is not None:
            self.optimizer.set_count(ckpt["schedule_count"])
        self.step = ckpt["step"]

"""Classifier guidance (counterpart of cleandiffuser_tpu/classifier/base.py).

A classifier holds its network's parameters and their EMA copy, as the
diffusion engine does (diffusion/basic.py), and the pure helpers take
either as `params`. `gradients` is d logp / dx at x_t: the sampler runs
under `torch.no_grad()`, so it turns grad mode back on for this one
product.

Training (`update(x, t, y)`): the subclass's `loss`, backward, then the
reference's optimizer, which is coupled L2 (optax
`chain(clip_by_global_norm?, add_decayed_weights(wd)?, adam(lr))`, i.e.
`torch.optim.Adam(weight_decay=wd)`, not AdamW; wd 0 unless
`optim_params` names it), then the EMA step (rate 0.995 by default).

`QGPOClassifier` is QGPO's contrastive energy prediction (CEP): `update(x,
t, y)` takes the noised support actions x (b, K, act_dim), their levels t
(b,) and y = {"soft_label": (b, K, 1), "obs": (b, obs_dim)}; the loss is
the cross-entropy of the soft labels against softmax over K of the energy
f(x_k, t, obs), and it logs f's max, mean and min.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn as nn

from ..utils.jax_params import load_adam_moments, load_jax_params
from ..utils.tensors import default_device
from ..utils.train_state import (
    ema_update,
    load_jax_checkpoint,
    load_state,
    make_optimizer,
    save_state,
)

__all__ = ["BaseClassifier", "MSEClassifier", "CumRewClassifier", "QGPOClassifier"]


class BaseClassifier:
    def __init__(self, nn_classifier: nn.Module, ema_rate: float = 0.995,
                 grad_clip_norm: Optional[float] = None, optim_params: Optional[dict] = None,
                 device=None):
        self.device = default_device(device)
        self.ema_rate = ema_rate
        self.params = nn_classifier.to(self.device)
        self.ema_params = copy.deepcopy(self.params).requires_grad_(False)
        optim_params = dict(optim_params or {"lr": 2e-4, "weight_decay": 1e-4})
        self.optimizer = make_optimizer(
            self.params.parameters(), lr=optim_params.pop("lr", 2e-4),
            weight_decay=optim_params.pop("weight_decay", 0.0), grad_clip_norm=grad_clip_norm,
            decoupled=False, **optim_params)
        self.step = 0

    @property
    def inference_params(self) -> nn.Module:
        return self.ema_params

    def apply_nn(self, params: nn.Module, x, t, y=None):
        return params(x, t, y)

    def logp(self, params: nn.Module, x, t, c=None):
        """logp(c | x_t, t) up to a constant; (b, 1)."""
        raise NotImplementedError

    def gradients(self, params: nn.Module, x, t, c=None):
        """(logp, d logp / dx), both detached."""
        with torch.enable_grad():
            xi = x.detach().requires_grad_(True)
            logp = self.logp(params, xi, t, c)
            (grad,) = torch.autograd.grad(logp.sum(), xi)
        return logp.detach(), grad.detach()

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def loss(self, params: nn.Module, x, t, y):
        raise NotImplementedError

    def update(self, x, t, y) -> dict:
        """One optimizer step and one EMA step on `loss` (a scalar, or
        (scalar, dict of logged scalars)). Returns {"loss", ...} as device
        scalars."""
        out = self.loss(self.params, x, t, y)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        loss.backward()
        self.optimizer.step()
        ema_update(self.ema_params, self.params, self.ema_rate)
        self.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    def save(self, path):
        save_state(path, self.params, self.ema_params, self.optimizer, self.step)

    def load(self, path):
        self.step = load_state(path, self.params, self.ema_params, self.optimizer)

    def load_jax_checkpoint(self, path):
        """Resume from a checkpoint the JAX classifier's `save` wrote."""
        self.load_jax_state(load_jax_checkpoint(path))

    def load_jax_state(self, ckpt: dict):
        """`load_jax_checkpoint` from the fields of a JAX TrainState already
        read (utils/train_state.py `jax_train_state`)."""
        load_jax_params(self.params, ckpt["params"]["params"])
        load_jax_params(self.ema_params, ckpt["ema_params"]["params"])
        load_adam_moments(self.optimizer.optimizer, self.params, ckpt["mu"]["params"],
                          ckpt["nu"]["params"], ckpt["count"])
        if ckpt["schedule_count"] is not None:
            self.optimizer.set_count(ckpt["schedule_count"])
        self.step = ckpt["step"]


class MSEClassifier(BaseClassifier):
    """logp = -temperature * MSE(pred_y, y)."""

    def __init__(self, nn_classifier: nn.Module, temperature: float = 1.0, **kwargs):
        super().__init__(nn_classifier, **kwargs)
        self.temperature = temperature

    def loss(self, params, x, t, y):
        return ((self.apply_nn(params, x, t) - y) ** 2).mean()

    def logp(self, params, x, t, c=None):
        pred_y = self.apply_nn(params, x, t)
        return -self.temperature * ((pred_y - c) ** 2).mean(-1, keepdim=True)


class CumRewClassifier(BaseClassifier):
    """Predicts the trajectory's return; logp is the prediction itself."""

    def loss(self, params, x, t, R):
        return ((self.apply_nn(params, x, t) - R) ** 2).mean()

    def logp(self, params, x, t, c=None):
        return self.apply_nn(params, x, t)


class QGPOClassifier(BaseClassifier):
    """In-support contrastive energy prediction; logp is the energy."""

    def loss(self, params, x, t, y):
        b, k = x.shape[:2]
        soft_label, obs = y["soft_label"], y["obs"]
        t_k = t[:, None].expand(b, k)
        obs_k = obs[:, None, :].expand(b, k, obs.shape[-1])
        f = self.apply_nn(params, x, t_k, obs_k)
        loss = -(soft_label * torch.log_softmax(f, dim=1)).sum(1).mean()
        f_ = f.detach()
        return loss, {"f_max": f_.max(1).values.mean(), "f_mean": f_.mean(),
                      "f_min": f_.min(1).values.mean()}

    def logp(self, params, x, t, c=None):
        return self.apply_nn(params, x, t, c)

"""Classifier guidance, inference half (counterpart of
cleandiffuser_tpu/classifier/base.py).

A classifier holds its network's parameters and their EMA copy, as the
diffusion engine does (diffusion/basic.py), and the pure helpers take
either as `params`. `gradients` is d logp / dx at x_t: the sampler runs
under `torch.no_grad()`, so it turns grad mode back on for this one
product. The optimizer, `update` and checkpoints come with training.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from ..utils.tensors import default_device

__all__ = ["BaseClassifier", "MSEClassifier", "CumRewClassifier"]


class BaseClassifier:
    def __init__(self, nn_classifier: nn.Module, device=None):
        self.device = default_device(device)
        self.params = nn_classifier.to(self.device)
        self.ema_params = copy.deepcopy(self.params).requires_grad_(False)

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


class MSEClassifier(BaseClassifier):
    """logp = -temperature * MSE(pred_y, y)."""

    def __init__(self, nn_classifier: nn.Module, temperature: float = 1.0, device=None):
        super().__init__(nn_classifier, device)
        self.temperature = temperature

    def logp(self, params, x, t, c=None):
        pred_y = self.apply_nn(params, x, t)
        return -self.temperature * ((pred_y - c) ** 2).mean(-1, keepdim=True)


class CumRewClassifier(BaseClassifier):
    """Predicts the trajectory's return; logp is the prediction itself."""

    def logp(self, params, x, t, c=None):
        return self.apply_nn(params, x, t)

"""DiffusionModel holder (counterpart of cleandiffuser_tpu/diffusion/basic.py).

The reference keeps one immutable pytree of parameters plus an EMA copy;
here both are `nn.ModuleDict({"diffusion": backbone, "condition":
encoder})` on one explicit device, and the pure `apply_*` helpers take
either of them as their `params`. The optimizer, `update`, the EMA step and
checkpoints come with the training path.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn as nn

from ..nn_condition.base import IdentityCondition

__all__ = ["DiffusionModel"]


class DiffusionModel:
    def __init__(
        self,
        nn_diffusion: nn.Module,
        nn_condition: Optional[nn.Module] = None,
        fix_mask=None,
        loss_weight=None,
        device="cpu",
    ):
        self.device = torch.device(device)
        cond = nn_condition if nn_condition is not None else IdentityCondition()
        self.params = nn.ModuleDict({"diffusion": nn_diffusion, "condition": cond})
        self.params.to(self.device)
        self.ema_params = copy.deepcopy(self.params).requires_grad_(False)

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
        """Run nn_condition; None passes through (backbone substitutes zeros)."""
        if condition is None:
            return None
        return params["condition"](condition, mask=mask, train=train, generator=generator)

    def apply_diffusion(self, params: nn.ModuleDict, x, t, emb):
        return params["diffusion"](x, t, emb)

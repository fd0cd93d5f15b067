"""Inverse dynamics (counterpart of cleandiffuser_tpu/invdynamic/mlp.py).

`MlpInvDynamic` predicts the action that takes o to o_next:
a = out_activation(MLP([o, o_next])). Forward only; its optimizer comes
with the training path.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from ..utils.blocks import dense, orthogonal_init

__all__ = ["MlpInvDynamic"]


class _InvMlpNet(nn.Module):
    JAX_NAMES = {"l1": "Dense_0", "l2": "Dense_1", "l3": "Dense_2"}

    def __init__(self, in_dim: int, a_dim: int, hidden_dim: int = 512,
                 out_activation: Callable = torch.tanh,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.l1 = dense(in_dim, hidden_dim, orthogonal_init, generator=generator)
        self.l2 = dense(hidden_dim, hidden_dim, orthogonal_init, generator=generator)
        self.l3 = dense(hidden_dim, a_dim, orthogonal_init, generator=generator)
        self.out_activation = out_activation

    def forward(self, oo):
        h = torch.relu(self.l1(oo))
        h = torch.relu(self.l2(h))
        return self.out_activation(self.l3(h))


class MlpInvDynamic:
    def __init__(self, o_dim: int, a_dim: int, hidden_dim: int = 512,
                 out_activation: Callable = torch.tanh,
                 generator: Optional[torch.Generator] = None, device="cpu"):
        self.net = _InvMlpNet(2 * o_dim, a_dim, hidden_dim, out_activation,
                              generator).to(device)

    @torch.no_grad()
    def predict(self, o, o_next):
        return self.net(torch.cat([o, o_next], dim=-1))

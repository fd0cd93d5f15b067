"""Inverse dynamics (counterpart of cleandiffuser_tpu/invdynamic/mlp.py).

`MlpInvDynamic` predicts the action that takes o to o_next:
a = out_activation(MLP([o, o_next])), trained by Adam (optax `adam(lr)`:
no decay, no clipping) on the mean squared action error.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import torch
import torch.nn as nn

from ..utils.blocks import dense, orthogonal_init
from ..utils.jax_params import load_jax_params
from ..utils.tensors import default_device
from ..utils.train_state import make_optimizer, read_jax_pickle

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
                 out_activation: Callable = torch.tanh, optim_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        self.net = _InvMlpNet(2 * o_dim, a_dim, hidden_dim, out_activation,
                              generator).to(default_device(device))
        self.optimizer = make_optimizer(self.net.parameters(),
                                        lr=(optim_params or {}).get("lr", 5e-4),
                                        weight_decay=0.0, decoupled=False)

    @torch.no_grad()
    def predict(self, o, o_next):
        return self.net(torch.cat([o, o_next], dim=-1))

    def update(self, o, a, o_next) -> dict:
        """One Adam step on mean((net([o, o_next]) - a)^2). Returns
        {"loss"} as a device scalar."""
        loss = ((self.net(torch.cat([o, o_next], dim=-1)) - a) ** 2).mean()
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach()}

    def save(self, path):
        """Params and the Adam state (the reference saves the params only)."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"params": self.net.state_dict(), "optimizer": self.optimizer.state_dict()},
                   path)

    def load(self, path):
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.net.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])

    def load_jax_checkpoint(self, path):
        """Load the params a JAX `MlpInvDynamic.save` wrote. That file holds
        no optimizer state: Adam starts afresh, as it does when the JAX
        package loads it."""
        load_jax_params(self.net, read_jax_pickle(path)["params"])
        self.optimizer.optimizer.state.clear()

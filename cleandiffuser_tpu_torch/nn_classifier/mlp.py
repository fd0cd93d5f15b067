"""MLP classifier heads (counterpart of cleandiffuser_tpu/nn_classifier/mlp.py).
Contract: `forward(x, t, y=None) -> (b, out_dim)` where t is (b,).

- `MLPNNClassifier` (no pipeline uses it): [x, timestep embedding]
  through an `Mlp` (`Mlp_0`) to `out_dim`.
- `QGPONNClassifier`: QGPO's energy net f(a, t, s): Dense(s) and Dense(a)
  to `emb_dim` each, beside the timestep embedding, through a SiLU `Mlp`
  to one output, squashed as tanh(out / 10) * 10. Children carry the flax
  names (`Dense_0` for s, `Dense_1` for a, `Mlp_0`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn_diffusion.base import timestep_embedding_module
from ..utils.blocks import Mlp, dense

__all__ = ["BaseNNClassifier", "MLPNNClassifier", "QGPONNClassifier"]


class BaseNNClassifier(nn.Module):
    """(x, t, y) -> logp(y|x,t)+C scalar head base."""

    def forward(self, x, t, y=None):
        raise NotImplementedError


class MLPNNClassifier(BaseNNClassifier):
    def __init__(self, x_dim: int, out_dim: int, emb_dim: int,
                 hidden_dims: Sequence[int] = (256,), activation: Callable = F.relu,
                 out_activation: Optional[Callable] = None,
                 timestep_emb_type: str = "positional",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.time_emb = timestep_embedding_module(emb_dim, timestep_emb_type, None, generator)
        self.mlp = Mlp(x_dim + emb_dim, hidden_dims, out_dim, activation, out_activation,
                       generator=generator)
        self.JAX_NAMES = {"time_emb": f"{type(self.time_emb).__name__}_0", "mlp": "Mlp_0"}

    def forward(self, x, t, y=None):
        return self.mlp(torch.cat([x, self.time_emb(t)], dim=-1))


class QGPONNClassifier(BaseNNClassifier):
    def __init__(self, obs_dim: int, act_dim: int, emb_dim: int,
                 hidden_dims: Sequence[int] = (256, 256), timestep_emb_type: str = "positional",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.time_emb = timestep_embedding_module(emb_dim, timestep_emb_type, None, generator)
        self.obs_proj = dense(obs_dim, emb_dim, generator=generator)
        self.act_proj = dense(act_dim, emb_dim, generator=generator)
        self.mlp = Mlp(3 * emb_dim, hidden_dims, 1, activation=F.silu, generator=generator)
        self.JAX_NAMES = {"time_emb": f"{type(self.time_emb).__name__}_0",
                          "obs_proj": "Dense_0", "act_proj": "Dense_1", "mlp": "Mlp_0"}

    def forward(self, x, t, y=None):
        h = torch.cat([self.obs_proj(y), self.act_proj(x), self.time_emb(t)], dim=-1)
        return torch.tanh(self.mlp(h) / 10.0) * 10.0

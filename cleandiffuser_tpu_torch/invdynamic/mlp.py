"""Inverse dynamics (counterpart of cleandiffuser_tpu/invdynamic/mlp.py).

`MlpInvDynamic` predicts the action that takes o to o_next:
a = out_activation(MLP([o, o_next])), trained by Adam (optax `adam(lr)`:
no decay, no clipping) on the mean squared action error.
`FancyMlpInvDynamic` (DiffuserLite's) is the same harness on a GELU MLP
(flax's `nn.gelu`, the tanh form) with an optional LayerNorm and an
optional dropout of 0.1 after its first layer. The dropout runs only in
`update`, its keep-mask drawn from the agent's own generator (seeded by
`rng`, on the net's device) or passed explicitly (`keep=`), which is how
the tests replay the reference's draws.

`ResInvDynamic` (no pipeline uses it) is the same harness on a residual
MLP: Dense(hidden), `n_blocks` blocks of h + Dense(GELU(Dense(LN(h)))),
Dense(a_dim). `EnsembleMlpInvDynamic` keeps `n_models` `MlpInvDynamic`
nets as one stacked parameter axis (each Dense a (n, in, out) kernel and
an (n, out) bias, the reference's vmapped layout) under one Adam: its
forward is batched matmuls over the heads, `predict` averages the heads,
and `update`'s loss is the mean over heads, batch and action dims.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.blocks import LayerNorm, dense, orthogonal_init
from ..utils.jax_params import load_jax_params
from ..utils.ranks import batch_draw
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from ..utils.train_state import make_optimizer, read_jax_pickle

__all__ = ["MlpInvDynamic", "FancyMlpInvDynamic", "ResInvDynamic", "EnsembleMlpInvDynamic"]


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


class _FancyInvMlpNet(nn.Module):
    JAX_NAMES = {"l1": "Dense_0", "l2": "Dense_1", "l3": "Dense_2", "norm": "LayerNorm_0"}

    def __init__(self, in_dim: int, a_dim: int, hidden_dim: int = 256, add_norm: bool = False,
                 add_dropout: bool = False, out_activation: Callable = torch.tanh,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.l1 = dense(in_dim, hidden_dim, generator=generator)
        self.norm = LayerNorm(hidden_dim) if add_norm else None
        self.add_dropout = add_dropout
        self.l2 = dense(hidden_dim, hidden_dim, generator=generator)
        self.l3 = dense(hidden_dim, a_dim, generator=generator)
        self.out_activation = out_activation

    def forward(self, oo, train: bool = False, keep=None,
                generator: Optional[torch.Generator] = None):
        h = F.gelu(self.l1(oo), approximate="tanh")
        if self.norm is not None:
            h = self.norm(h)
        if train and self.add_dropout:
            if keep is None:
                keep = batch_draw(lambda s: torch.rand(s, generator=generator, device=h.device),
                                  h.shape) < 0.9
            h = torch.where(keep, h / 0.9, torch.zeros_like(h))
        h = F.gelu(self.l2(h), approximate="tanh")
        return self.out_activation(self.l3(h))


class _ResInvNet(nn.Module):
    def __init__(self, in_dim: int, a_dim: int, hidden_dim: int = 256, n_blocks: int = 3,
                 out_activation: Callable = torch.tanh,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        layers = [dense(in_dim, hidden_dim, generator=g)]
        for _ in range(n_blocks):
            layers += [dense(hidden_dim, 4 * hidden_dim, generator=g),
                       dense(4 * hidden_dim, hidden_dim, generator=g)]
        layers.append(dense(hidden_dim, a_dim, generator=g))
        # flax numbers the Dense layers in creation order
        self.layers = nn.ModuleList(layers)
        self.norms = nn.ModuleList(LayerNorm(hidden_dim) for _ in range(n_blocks))
        self.out_activation = out_activation
        self.JAX_NAMES = {"layers": "Dense_{}", "norms": "LayerNorm_{}"}

    def forward(self, oo):
        h = self.layers[0](oo)
        for i, norm in enumerate(self.norms):
            r = F.gelu(self.layers[2 * i + 1](norm(h)), approximate="tanh")
            h = h + self.layers[2 * i + 2](r)
        return self.out_activation(self.layers[-1](h))


class _StackedDense(nn.Module):
    """`n` Dense layers as one (n, in, out) kernel and (n, out) bias (flax's
    orientation, a vmapped init's layout), each kernel drawn orthogonal."""

    def __init__(self, n: int, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kernel = torch.stack([orthogonal_init(torch.empty(out_dim, in_dim), generator).T
                              for _ in range(n)])
        self.kernel = nn.Parameter(kernel.contiguous())
        self.bias = nn.Parameter(torch.zeros(n, out_dim))

    def forward(self, x):
        """(n, B, in) -> (n, B, out)."""
        return torch.baddbmm(self.bias[:, None], x, self.kernel)


class _EnsembleInvMlpNet(nn.Module):
    JAX_NAMES = {"l1": "Dense_0", "l2": "Dense_1", "l3": "Dense_2"}

    def __init__(self, n: int, in_dim: int, a_dim: int, hidden_dim: int = 512,
                 out_activation: Callable = torch.tanh,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n = n
        self.l1 = _StackedDense(n, in_dim, hidden_dim, generator)
        self.l2 = _StackedDense(n, hidden_dim, hidden_dim, generator)
        self.l3 = _StackedDense(n, hidden_dim, a_dim, generator)
        self.out_activation = out_activation

    def forward(self, oo):
        """(B, in) -> (n, B, a_dim): every head's prediction."""
        h = torch.relu(self.l1(oo.expand(self.n, *oo.shape)))
        h = torch.relu(self.l2(h))
        return self.out_activation(self.l3(h))


class MlpInvDynamic:
    def __init__(self, o_dim: int, a_dim: int, hidden_dim: int = 512,
                 out_activation: Callable = torch.tanh, optim_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        self._setup(_InvMlpNet(2 * o_dim, a_dim, hidden_dim, out_activation, generator),
                    (optim_params or {}).get("lr", 5e-4), device)

    def _setup(self, net: nn.Module, lr: float, device):
        self.net = net.to(default_device(device))
        self.optimizer = make_optimizer(self.net.parameters(), lr=lr, weight_decay=0.0,
                                        decoupled=False)

    @torch.no_grad()
    def predict(self, o, o_next):
        return self.net(torch.cat([o, o_next], dim=-1))

    def _forward_train(self, oo, keep):
        return self.net(oo)

    def update(self, o, a, o_next, keep=None) -> dict:
        """One Adam step on mean((net([o, o_next]) - a)^2). Returns
        {"loss"} as a device scalar. `keep` is a net with dropout's
        explicit keep-mask."""
        loss = ((self._forward_train(torch.cat([o, o_next], dim=-1), keep) - a) ** 2).mean()
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach()}

    @writer_only
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


class FancyMlpInvDynamic(MlpInvDynamic):
    def __init__(self, o_dim: int, a_dim: int, hidden_dim: int = 256,
                 out_activation: Callable = torch.tanh, add_norm: bool = False,
                 add_dropout: bool = False, optim_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, device=None, rng: int = 0):
        self._setup(_FancyInvMlpNet(2 * o_dim, a_dim, hidden_dim, add_norm, add_dropout,
                                    out_activation, generator),
                    (optim_params or {}).get("lr", 3e-4), device)
        self.generator = torch.Generator(device=default_device(device)).manual_seed(rng)

    def _forward_train(self, oo, keep):
        return self.net(oo, train=True, keep=keep, generator=self.generator)


class ResInvDynamic(MlpInvDynamic):
    def __init__(self, o_dim: int, a_dim: int, hidden_dim: int = 256, n_blocks: int = 3,
                 out_activation: Callable = torch.tanh, optim_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        self._setup(_ResInvNet(2 * o_dim, a_dim, hidden_dim, n_blocks, out_activation,
                               generator),
                    (optim_params or {}).get("lr", 3e-4), device)


class EnsembleMlpInvDynamic(MlpInvDynamic):
    """`n_models` MlpInvDynamic heads on one stacked parameter axis (module
    note)."""

    def __init__(self, o_dim: int, a_dim: int, n_models: int = 5, hidden_dim: int = 512,
                 out_activation: Callable = torch.tanh, optim_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        self.n_models = n_models
        self._setup(_EnsembleInvMlpNet(n_models, 2 * o_dim, a_dim, hidden_dim, out_activation,
                                       generator),
                    (optim_params or {}).get("lr", 5e-4), device)

    @torch.no_grad()
    def predict(self, o, o_next):
        return self.net(torch.cat([o, o_next], dim=-1)).mean(0)

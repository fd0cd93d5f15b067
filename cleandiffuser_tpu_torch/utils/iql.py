"""Implicit Q-Learning (counterpart of cleandiffuser_tpu/utils/iql.py):
a `TwinQ` critic with its target and a `V` net, trained by expectile
regression of V on the target's min-Q and a TD update of Q on V.

    iql = IQL(obs_dim, act_dim, device="cpu")
    loss_v = iql.update_V(obs, act)
    loss_q = iql.update_Q(obs, act, rew, obs_next, done)

Losses come back as device scalars (no host sync); with `apply=False` an
update only computes its loss and nothing moves. The state is the modules
and their Adam optimizers (`IQLState`, the reference's field names),
updated in place; `lr` is a rate or a schedule. The target follows
`target_mu * target + (1 - target_mu) * online`: IQL's own rule at the
default `target_mu=0.995`; IDQL's pipeline keeps 0.005 of the target
(utils/train_state.py `target_update`). Both are the reference's.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Union

import torch

from .blocks import TwinQ, V
from .jax_params import load_adam_moments, load_jax_params
from .ranks import writer_only
from .tensors import default_device
from .train_state import TrainOptimizer, ema_update, jax_adam_state, make_adam

__all__ = ["IQL", "IQLState"]


@dataclass
class IQLState:
    q_params: TwinQ
    q_target_params: TwinQ
    v_params: V
    q_opt_state: TrainOptimizer
    v_opt_state: TrainOptimizer


def expectile_loss(diff, tau: float):
    """mean(|tau - 1[diff < 0]| * diff^2)."""
    w = torch.abs(tau - (diff < 0).to(diff.dtype))
    return (w * diff ** 2).mean()


class IQL:
    def __init__(self, obs_dim: int, act_dim: int, tau: float = 0.7, discount: float = 0.99,
                 hidden_dim: int = 256, lr: Union[float, Callable] = 3e-4,
                 target_mu: float = 0.995,
                 rng: int = 0, device=None):
        self.iql_tau, self.discount, self.target_mu = tau, discount, target_mu
        self.device = default_device(device)
        init = torch.Generator().manual_seed(rng)
        q = TwinQ(obs_dim, act_dim, hidden_dim, generator=init).to(self.device)
        v = V(obs_dim, hidden_dim, generator=init).to(self.device)
        self.state = IQLState(q, copy.deepcopy(q).requires_grad_(False), v,
                              make_adam(q.parameters(), lr), make_adam(v.parameters(), lr))

    def update_V(self, obs, act, apply: bool = True) -> torch.Tensor:
        st = self.state
        with torch.no_grad():
            q = st.q_target_params(obs, act)
        with torch.set_grad_enabled(apply):
            loss = expectile_loss(q - st.v_params(obs), self.iql_tau)
        if apply:
            loss.backward()
            st.v_opt_state.step()
        return loss.detach()

    def update_Q(self, obs, act, rew, obs_next, done, apply: bool = True) -> torch.Tensor:
        st = self.state
        with torch.no_grad():
            td_target = rew + self.discount * (1.0 - done) * st.v_params(obs_next)
        with torch.set_grad_enabled(apply):
            q1, q2 = st.q_params.both(obs, act)
            loss = ((q1 - td_target) ** 2 + (q2 - td_target) ** 2).mean()
        if apply:
            loss.backward()
            st.q_opt_state.step()
            ema_update(st.q_target_params, st.q_params, self.target_mu)
        return loss.detach()

    @torch.no_grad()
    def q(self, obs, act):
        return self.state.q_params(obs, act)

    @torch.no_grad()
    def q_target(self, obs, act):
        return self.state.q_target_params(obs, act)

    @torch.no_grad()
    def v(self, obs):
        return self.state.v_params(obs)

    def state_dict(self) -> dict:
        return {name: getattr(self.state, name).state_dict() for name in _FIELDS}

    def load_state_dict(self, saved: dict) -> None:
        for name in _FIELDS:
            getattr(self.state, name).load_state_dict(saved[name])

    def load_jax_state(self, state: dict) -> None:
        """Load a JAX `IQLState` (or IDQL's critic state, the same fields)
        as `read_jax_pickle` returns it."""
        st = self.state
        for name in ("q_params", "q_target_params", "v_params"):
            load_jax_params(getattr(st, name), state[name]["params"])
        for opt, net, key in ((st.q_opt_state, st.q_params, "q_opt_state"),
                              (st.v_opt_state, st.v_params, "v_opt_state")):
            adam = jax_adam_state(state[key])
            load_adam_moments(opt.optimizer, net, adam["mu"]["params"], adam["nu"]["params"],
                              adam["count"])
            opt.set_count(adam["schedule_count"])

    @writer_only
    def save(self, path: str):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(self.state_dict(), path)

    def load(self, path: str):
        self.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))


_FIELDS = ("q_params", "q_target_params", "v_params", "q_opt_state", "v_opt_state")

"""Online SAC: the generator of locomotion datasets (counterpart of
cleandiffuser_tpu/utils/sac.py).

d4rl built its locomotion datasets by training SAC online and logging
rollouts of partly trained ("medium") and fully trained ("expert")
policies; cli/make_locomotion_dataset.py re-creates that recipe on
gymnasium's MuJoCo-v5 envs with this module: a twin-Q SAC with an
auto-tuned temperature (Haarnoja et al. 2018).

- `GaussianActor` (obs -> mu, log_std clipped to [LOG_STD_MIN,
  LOG_STD_MAX]) and `TwinQ` ((obs, act) -> (B, 2)), 256 wide, with flax
  `Dense` layouts and names (`Dense_0`, ...), so utils/jax_params.py
  carries the reference's parameters in and out.
- `squash(mu, log_std, eps)`: the tanh-Gaussian action and its log-prob,
  on an explicit standard-normal draw.
- `SAC`: the state (`SACState`: actor, critic, target critic, log alpha
  and their three Adams, optax's `adam(lr)`: eps 1e-8 outside the square
  root), updated in place. `update_step` is one critic, actor and
  temperature update, then `target <- (1 - tau) * target + tau * critic`;
  `update_window` K of them on a (K, B, ...) stack. Each update takes two
  squash draws, from `generator` or given as `noise=(next, pi)` ((B, act)
  each; a window's (K, B, act)), which is how the tests replay the
  reference's keys (`k1, k2 = split(key)`). Logs are device scalars: no
  host sync inside a window.
- `ReplayRing`: the host ring (numpy), as the reference's.
- `NumpyActor`: a host numpy forward of an actor snapshot (the flax tree
  `SAC.snapshot_actor` returns, the reference's snapshot format), for
  evaluation and rollouts that step an env per action.
- `DeviceCollector`: the ring lives on the device as seven tensors at
  capacity; one `step` writes the iteration's valid rows (the mask's;
  masked rows are dropped, as the reference's `mode="drop"` scatter drops
  them), runs K updates on batches gathered at `min(int(u * size), size -
  1)` from one (K, B) uniform draw, and selects the next actions. `export`
  gives the d4rl views of the ring: the sequence view stably sorted by env
  id, and the transition view with the stored successors. Draws come from
  the SAC's generator or as `draws={"act", "u", "squash"}`.

Everything runs on the CUDA device unless the caller names another.
`SAC.load_jax_checkpoint` reads a pickle the reference's `SAC.save` wrote
(params, target, log alpha, the three Adams' counts and moments).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import dense
from .jax_params import jax_params_of, load_adam_moments, load_jax_params
from .ranks import writer_only
from .tensors import default_device
from .train_state import jax_adam_state, read_jax_pickle

__all__ = ["SAC", "SACState", "ReplayRing", "DeviceCollector", "NumpyActor", "GaussianActor",
           "TwinQ", "squash", "LOG_STD_MIN", "LOG_STD_MAX"]

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


class GaussianActor(nn.Module):
    """obs -> (mu, log_std): two ReLU layers, then the mean and log-std heads."""

    JAX_NAMES = {"dense": "Dense_{}"}

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = nn.ModuleList([
            dense(obs_dim, hidden, generator=generator), dense(hidden, hidden, generator=generator),
            dense(hidden, act_dim, generator=generator), dense(hidden, act_dim, generator=generator)])

    def forward(self, obs):
        x = F.relu(self.dense[1](F.relu(self.dense[0](obs))))
        return self.dense[2](x), self.dense[3](x).clamp(LOG_STD_MIN, LOG_STD_MAX)


class TwinQ(nn.Module):
    """(obs, act) -> (B, 2): two Q heads, each two ReLU layers and a scalar."""

    JAX_NAMES = {"dense": "Dense_{}"}

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        for _ in range(2):
            layers += [dense(obs_dim + act_dim, hidden, generator=generator),
                       dense(hidden, hidden, generator=generator),
                       dense(hidden, 1, generator=generator)]
        self.dense = nn.ModuleList(layers)

    def forward(self, obs, act):
        x = torch.cat([obs, act], -1)
        qs = []
        for q in range(2):
            h = F.relu(self.dense[3 * q + 1](F.relu(self.dense[3 * q](x))))
            qs.append(self.dense[3 * q + 2](h))
        return torch.cat(qs, -1)


def squash(mu, log_std, eps):
    """The reparameterised tanh-Gaussian action on the draw `eps` and its
    log-prob."""
    act = torch.tanh(mu + torch.exp(log_std) * eps)
    logp = (-0.5 * eps**2 - log_std - _HALF_LOG_2PI).sum(-1)
    return act, logp - torch.log(1 - act**2 + 1e-6).sum(-1)


@dataclass
class SACState:
    actor: GaussianActor
    critic: TwinQ
    target_critic: TwinQ
    log_alpha: nn.Parameter
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    alpha_opt: torch.optim.Adam


_LOG_KEYS = ("critic_loss", "actor_loss", "alpha", "q_mean")


class ReplayRing:
    """Host ring buffer (numpy). The gather for a K-update window is one
    fancy index on the host."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.act = np.zeros((capacity, act_dim), np.float32)
        self.rew = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.term = np.zeros((capacity,), np.float32)
        self.ptr, self.size = 0, 0

    def add_batch(self, obs, act, rew, next_obs, term):
        n = obs.shape[0]
        idx = (self.ptr + np.arange(n)) % self.capacity
        self.obs[idx], self.act[idx], self.rew[idx] = obs, act, rew
        self.next_obs[idx], self.term[idx] = next_obs, term
        self.ptr = (self.ptr + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def gather_stack(self, rng: np.random.Generator, k: int, batch_size: int):
        """(K, B, ...) batch stacks for one K-update window."""
        idx = rng.integers(0, self.size, size=(k, batch_size))
        return {"obs": self.obs[idx], "act": self.act[idx], "rew": self.rew[idx],
                "next_obs": self.next_obs[idx], "term": self.term[idx]}

    def export(self, timeout_mask: np.ndarray = None):
        """Chronological d4rl-schema view of the ring (the medium-replay
        dataset is exactly this)."""
        order = (np.arange(self.size) + (self.ptr if self.size == self.capacity
                                         else 0)) % self.capacity
        return {
            "observations": self.obs[order].copy(),
            "actions": self.act[order].copy(),
            "rewards": self.rew[order].copy(),
            "terminals": self.term[order].copy(),
            "timeouts": np.zeros((self.size,), np.float32)
            if timeout_mask is None else timeout_mask[order].copy(),
        }


class SAC:
    def __init__(self, obs_dim: int, act_dim: int, lr: float = 3e-4, gamma: float = 0.99,
                 tau: float = 5e-3, rng: int = 0, device=None):
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.gamma, self.tau = gamma, tau
        self.target_entropy = -float(act_dim)
        self.device = default_device(device)
        init = torch.Generator().manual_seed(rng)
        actor = GaussianActor(obs_dim, act_dim, generator=init).to(self.device)
        critic = TwinQ(obs_dim, act_dim, generator=init).to(self.device)
        log_alpha = nn.Parameter(torch.zeros((), device=self.device))
        adam = lambda params: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.state = SACState(actor, critic, copy.deepcopy(critic).requires_grad_(False),
                              log_alpha, adam(actor.parameters()), adam(critic.parameters()),
                              adam([log_alpha]))
        self.generator = torch.Generator(device=self.device).manual_seed(rng + 1)

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _normal(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    # ---------------- acting ----------------
    @torch.no_grad()
    def act(self, obs, deterministic: bool = False, noise=None) -> np.ndarray:
        """Actions for `obs` (B, obs_dim) on the host: tanh(mu), or a squash
        sample on `noise` (B, act_dim; drawn from the generator when None)."""
        mu, log_std = self.state.actor(self._tensor(obs))
        if deterministic:
            return torch.tanh(mu).cpu().numpy()
        eps = self._normal(mu.shape) if noise is None else self._tensor(noise)
        return squash(mu, log_std, eps)[0].cpu().numpy()

    # ---------------- learning ----------------
    @staticmethod
    def _apply(opt: torch.optim.Adam, params, loss):
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step()

    def update_step(self, batch: dict, noise=None) -> dict:
        """One SAC update on `batch` {obs, act, rew, next_obs, term} (B rows),
        in place; `noise=(next, pi)` the two squash draws (drawn when None).
        Returns the logs as device scalars."""
        st = self.state
        obs, act, rew, next_obs, term = (self._tensor(batch[k]) for k in
                                         ("obs", "act", "rew", "next_obs", "term"))
        if noise is None:
            shape = (obs.shape[0], self.act_dim)
            noise = (self._normal(shape), self._normal(shape))
        eps_next, eps_pi = noise
        alpha = st.log_alpha.detach().exp()

        # critic: y = r + gamma (1 - term) [min Q'(s', a') - alpha logp(a')]
        with torch.no_grad():
            a_n, logp_n = squash(*st.actor(next_obs), eps_next)
            q_n = st.target_critic(next_obs, a_n).amin(-1)
            y = rew + self.gamma * (1 - term) * (q_n - alpha * logp_n)
        critic_params = list(st.critic.parameters())
        closs = ((st.critic(obs, act) - y[:, None]) ** 2).mean()
        self._apply(st.critic_opt, critic_params, closs)

        # actor, against the updated critic
        actor_params = list(st.actor.parameters())
        a, logp = squash(*st.actor(obs), eps_pi)
        aloss = (alpha * logp - st.critic(obs, a).amin(-1)).mean()
        logp_mean = logp.mean().detach()
        self._apply(st.actor_opt, actor_params, aloss)

        lloss = -st.log_alpha.exp() * (logp_mean + self.target_entropy)
        self._apply(st.alpha_opt, [st.log_alpha], lloss)

        with torch.no_grad():
            target = list(st.target_critic.parameters())
            torch._foreach_mul_(target, 1 - self.tau)
            torch._foreach_add_(target, torch._foreach_mul(critic_params, self.tau))
        return {"critic_loss": closs.detach(), "actor_loss": aloss.detach(),
                "alpha": st.log_alpha.detach().exp(), "q_mean": y.mean()}

    def update_window(self, batch_stack: dict, noise=None) -> dict:
        """K updates on a (K, B, ...) stack (`ReplayRing.gather_stack`'s);
        `noise=(next, pi)` of shape (K, B, act_dim) each. Returns the window
        means of the logs as device scalars."""
        stack = {k: self._tensor(v) for k, v in batch_stack.items()}
        k = next(iter(stack.values())).shape[0]
        logs = [self.update_step({n: v[i] for n, v in stack.items()},
                                 None if noise is None else (noise[0][i], noise[1][i]))
                for i in range(k)]
        return {n: torch.stack([log[n] for log in logs]).mean() for n in _LOG_KEYS}

    # ---------------- persistence ----------------
    def state_dict(self) -> dict:
        st = self.state
        return {"actor": st.actor.state_dict(), "critic": st.critic.state_dict(),
                "target_critic": st.target_critic.state_dict(),
                "log_alpha": st.log_alpha.detach().clone(),
                "actor_opt": st.actor_opt.state_dict(), "critic_opt": st.critic_opt.state_dict(),
                "alpha_opt": st.alpha_opt.state_dict()}

    def load_state_dict(self, saved: dict) -> None:
        st = self.state
        for name in ("actor", "critic", "target_critic", "actor_opt", "critic_opt",
                     "alpha_opt"):
            getattr(st, name).load_state_dict(saved[name])
        with torch.no_grad():
            st.log_alpha.copy_(saved["log_alpha"])

    @writer_only
    def save(self, path: str):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(self.state_dict(), path)

    def load(self, path: str):
        self.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))

    def load_jax_checkpoint(self, path: str):
        """Load a pickle the reference's `SAC.save` wrote."""
        self.load_jax_state(read_jax_pickle(path))

    def load_jax_state(self, state: dict) -> None:
        """Load a reference `SACState` as `read_jax_pickle` returns it: the
        nets, log alpha and the three Adams (counts and moments)."""
        st = self.state
        for name in ("actor", "critic", "target_critic"):
            load_jax_params(getattr(st, name), state[name]["params"])
        for opt, net, key in ((st.actor_opt, st.actor, "actor_opt"),
                              (st.critic_opt, st.critic, "critic_opt")):
            adam = jax_adam_state(state[key])
            load_adam_moments(opt, net, adam["mu"]["params"], adam["nu"]["params"],
                              adam["count"])
        with torch.no_grad():
            st.log_alpha.copy_(self._tensor(state["log_alpha"]))
        adam = jax_adam_state(state["alpha_opt"])
        st.alpha_opt.state[st.log_alpha] = {
            "step": torch.tensor(float(adam["count"])),
            "exp_avg": self._tensor(adam["mu"]), "exp_avg_sq": self._tensor(adam["nu"])}

    def snapshot_actor(self) -> dict:
        """The actor's parameters as a flax tree of numpy arrays (the
        reference's snapshot format, which `NumpyActor` takes)."""
        return {"params": jax_params_of(self.state.actor)}


class NumpyActor:
    """Host numpy forward of a `GaussianActor` snapshot (a flax tree
    {"params": {"Dense_i": {"kernel", "bias"}}}, from either package)."""

    def __init__(self, actor_params):
        p = actor_params["params"]
        self.layers = [(np.asarray(p[f"Dense_{i}"]["kernel"]), np.asarray(p[f"Dense_{i}"]["bias"]))
                       for i in range(4)]

    def __call__(self, obs, rng: np.random.Generator = None):
        x = obs
        for w, b in self.layers[:2]:
            x = np.maximum(x @ w + b, 0.0)
        mu = x @ self.layers[2][0] + self.layers[2][1]
        if rng is None:
            return np.tanh(mu)
        log_std = np.clip(x @ self.layers[3][0] + self.layers[3][1], LOG_STD_MIN, LOG_STD_MAX)
        return np.tanh(mu + np.exp(log_std) * rng.standard_normal(mu.shape).astype(np.float32))


_RING = ("obs", "act", "rew", "next_obs", "term", "done", "env")
_BATCH = ("obs", "act", "rew", "next_obs", "term")


class DeviceCollector:
    """Device-resident online-RL collector (module note). The ring stores
    `term` (the bootstrap mask: termination only, timeouts bootstrap
    through) apart from `done` (the episode boundary, term | trunc), and
    the source env id, from which `export` rebuilds per-env segments."""

    def __init__(self, sac: SAC, capacity: int, n_envs: int, batch_size: int = 256,
                 updates_per_iter: int = None):
        self.sac = sac
        self.capacity = capacity
        self.n_envs = n_envs
        self.batch_size = batch_size
        self.k = n_envs if updates_per_iter is None else updates_per_iter
        O, A, dev = sac.obs_dim, sac.act_dim, sac.device
        shapes = {"obs": (O,), "act": (A,), "next_obs": (O,)}
        self.ring = {k: torch.zeros((capacity,) + shapes.get(k, ()), device=dev,
                                    dtype=torch.int32 if k == "env" else torch.float32)
                     for k in _RING}
        self.ptr, self.size = 0, 0

    def step(self, obs: np.ndarray, new: dict = None, update: bool = True, draws: dict = None):
        """`new` = {obs, act, rew, next_obs, term, done, env, mask} rows at
        the fixed n_envs width (None on the very first call); `draws` the
        iteration's draws {"act": (n_envs, act), "u": (K, B), "squash":
        ((K, B, act), (K, B, act))}, drawn from the SAC's generator when
        None. Returns (actions on the host, logs as device scalars)."""
        sac, st = self.sac, self.sac.state
        mask = None if new is None else np.asarray(new["mask"]) > 0
        n_valid = 0 if new is None else int(mask.sum())
        if update and self.size == 0 and n_valid == 0:
            # the gather would index -1 and train on the zero row
            raise ValueError("DeviceCollector.step(update=True) on an empty ring: warm up "
                             "with update=False (or pass transitions) first")
        if n_valid:
            # the valid rows in order at ptr, ptr + 1, ...; masked rows dropped
            idx = torch.from_numpy((self.ptr + np.arange(n_valid)) % self.capacity).to(sac.device)
            for k in _RING:
                rows = np.asarray(new[k])[mask]
                self.ring[k][idx] = torch.as_tensor(rows, dtype=self.ring[k].dtype).to(sac.device)
        size = min(self.size + n_valid, self.capacity)
        K, B = self.k, self.batch_size
        if update:
            u = (torch.rand((K, B), generator=sac.generator, device=sac.device)
                 if draws is None else sac._tensor(draws["u"]))
            gidx = torch.clamp((u * size).to(torch.int32), max=size - 1).long()
            batch = {k: self.ring[k][gidx] for k in _BATCH}
            if draws is None:
                noise = (sac._normal((K, B, sac.act_dim)), sac._normal((K, B, sac.act_dim)))
            else:
                noise = tuple(sac._tensor(n) for n in draws["squash"])
            logs = sac.update_window(batch, noise)
        else:
            zero = torch.zeros((), device=sac.device)
            logs = {"critic_loss": zero, "actor_loss": zero,
                    "alpha": st.log_alpha.detach().exp(), "q_mean": zero}
        with torch.no_grad():
            mu, log_std = st.actor(sac._tensor(obs))
            eps = sac._normal(mu.shape) if draws is None else sac._tensor(draws["act"])
            act = squash(mu, log_std, eps)[0]
        self.ptr = (self.ptr + n_valid) % self.capacity
        self.size = size
        return act.cpu().numpy(), logs

    def export(self) -> dict:
        """The d4rl medium-replay views of the ring, fetched once. Rows are
        chronological but interleaved over the n_envs writers: the sequence
        view stably sorts them by env id (each env's time order kept) and
        marks each env segment's end as a timeout (unless it terminated),
        and the transition view pairs each row with its stored next_obs
        (row i + 1 is another env's step, not the successor)."""
        rows = self.size if self.size < self.capacity else self.capacity
        host = {k: v[:rows].cpu().numpy() for k, v in self.ring.items()}
        order = (np.arange(self.size) +
                 (self.ptr if self.size == self.capacity else 0)) % self.capacity
        host = {k: v[order] for k, v in host.items()}
        by_env = np.argsort(host["env"], kind="stable")
        seq = {k: host[k][by_env] for k in host}
        timeouts = np.logical_and(seq["done"] > 0, seq["term"] == 0)
        seg_end = np.ones((self.size,), bool)
        seg_end[:-1] = seq["env"][:-1] != seq["env"][1:]
        timeouts = np.logical_or(timeouts, np.logical_and(seg_end, seq["term"] == 0))
        return {
            "observations": seq["obs"],
            "actions": seq["act"],
            "rewards": seq["rew"],
            "terminals": seq["term"],
            "timeouts": timeouts.astype(np.float32),
            "qlearning": {
                "observations": host["obs"],
                "actions": host["act"],
                "next_observations": host["next_obs"],
                "rewards": host["rew"],
                "terminals": host["term"],
            },
        }

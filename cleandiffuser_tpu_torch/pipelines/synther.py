"""SynthER pipeline and TD3+BC (counterpart of
cleandiffuser_tpu/pipelines/synther.py).

`SynthERPipeline`: an unconditional diffusion model over flat transitions
[obs, act, rew, next_obs, tml] (`IDQLMlp` with `obs_dim=0`, hidden 1024 x 6
blocks, dropout 0.1 in training, on a 128-step `DiscreteDiffusionSDE`; Adam
without decay on a cosine schedule). `train_step(batch, noise)` is one
update (`noise` the loss's explicit (t, eps, keep); the dropout masks come
from the engine's generator); `make_train_scan` is the CLI's window;
`generate_transitions` samples synthetic transitions with the EMA model in
sampler calls of at most `batch_size` rows (clamped to the request), one
sampler cached per (batch, steps).

`TD3BC`: a deterministic tanh actor (Dense 256, SiLU, twice) and a twin
critic (Dense -> LayerNorm -> tanh -> Dense -> SiLU -> Dense, twice), each
with a target copy and an Adam on a cosine decay over `gradient_steps`.
One `update(batch, noise)`:
1. the critic's TD step on rew + (1 - tml) discount min-Q_target(s',
   clip(actor_target(s') + clip(noise * policy_noise, +-noise_clip), +-1));
2. on steps where `step % policy_freq == 0` (a host counter) only: the
   actor's step on -lambda Q(s, pi(s)).mean() + BC MSE, lambda = alpha /
   |Q|.mean() with no gradient through it, and both targets
   `0.995 target + 0.005 online`. Between those steps the actor, its Adam
   state and schedule count, and both targets stay as they are; the
   actor's losses are still logged.
`noise` is the target-policy noise (act's shape) before scaling, the
reference's `normal(k_noise)`; otherwise drawn from the agent's generator.
No kernel runs on this path: the nets are MLPs.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..diffusion import DiscreteDiffusionSDE
from ..nn_diffusion import IDQLMlp
from ..utils.blocks import LayerNorm, dense
from ..utils.jax_params import load_adam_moments, load_jax_params
from ..utils.tensors import default_device
from ..utils.train_state import (
    cosine_decay_schedule,
    ema_update,
    jax_adam_state,
    make_adam,
    read_jax_pickle,
)
from .runner import train_window

__all__ = ["SynthERPipeline", "TD3BC"]


class _TD3Actor(nn.Module):
    JAX_NAMES = {"layers": "Dense_{}"}

    def __init__(self, obs_dim: int, act_dim: int, generator=None):
        super().__init__()
        self.layers = nn.ModuleList([dense(obs_dim, 256, generator=generator),
                                     dense(256, 256, generator=generator),
                                     dense(256, act_dim, generator=generator)])

    def forward(self, obs):
        h = F.silu(self.layers[0](obs))
        h = F.silu(self.layers[1](h))
        return torch.tanh(self.layers[2](h))


class _TD3Critic(nn.Module):
    """Twin Q; the flax `setup` lists name the layers `q1_l_0`..`q1_l_3`."""

    JAX_NAMES = {"q1_l": "q1_l_{}", "q2_l": "q2_l_{}"}

    def __init__(self, obs_dim: int, act_dim: int, generator=None):
        super().__init__()

        def head():
            return nn.ModuleList([dense(obs_dim + act_dim, 256, generator=generator),
                                  LayerNorm(256), dense(256, 256, generator=generator),
                                  dense(256, 1, generator=generator)])

        self.q1_l, self.q2_l = head(), head()

    @staticmethod
    def _q(layers, x):
        h = torch.tanh(layers[1](layers[0](x)))
        return layers[3](F.silu(layers[2](h)))

    def both(self, obs, act):
        x = torch.cat([obs, act], -1)
        return self._q(self.q1_l, x), self._q(self.q2_l, x)

    def forward(self, obs, act):
        return torch.minimum(*self.both(obs, act))


class TD3BC:
    LOG_KEYS = ("critic_loss", "policy_loss", "bc_loss", "policy_q", "mean_target_q")

    def __init__(self, obs_dim: int, act_dim: int, policy_noise: float = 0.2,
                 noise_clip: float = 0.5, policy_freq: int = 2, alpha: float = 2.5,
                 gradient_steps: int = 1_000_000, discount: float = 0.99, rng: int = 0,
                 device=None):
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.policy_noise, self.noise_clip = policy_noise, noise_clip
        self.policy_freq, self.alpha, self.discount = policy_freq, alpha, discount
        self.device = default_device(device)
        init = torch.Generator().manual_seed(rng)
        self.actor = _TD3Actor(obs_dim, act_dim, init).to(self.device)
        self.critic = _TD3Critic(obs_dim, act_dim, init).to(self.device)
        self.actor_target = copy.deepcopy(self.actor).requires_grad_(False)
        self.critic_target = copy.deepcopy(self.critic).requires_grad_(False)
        self.actor_optimizer = make_adam(self.actor.parameters(),
                                         cosine_decay_schedule(3e-4, gradient_steps))
        self.critic_optimizer = make_adam(self.critic.parameters(),
                                          cosine_decay_schedule(3e-4, gradient_steps))
        self.step = 0  # host counters: reading the device's would sync
        self.actor_updates = 0
        self.generator = torch.Generator(device=self.device).manual_seed(rng + 1)

    def _f32(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def update(self, batch, noise=None) -> dict:
        """One TD3+BC step; returns the `LOG_KEYS` as device scalars."""
        obs, act = self._f32(batch["obs"]["state"]), self._f32(batch["act"])
        next_obs = self._f32(batch["next_obs"]["state"])
        rew, tml = self._f32(batch["rew"]), self._f32(batch["tml"])
        if noise is None:
            noise = torch.randn(act.shape, generator=self.generator, device=self.device)
        with torch.no_grad():
            pn = torch.clamp(self._f32(noise) * self.policy_noise, -self.noise_clip,
                             self.noise_clip)
            next_act = torch.clamp(self.actor_target(next_obs) + pn, -1.0, 1.0)
            target_q = rew + (1.0 - tml) * self.discount * self.critic_target(next_obs, next_act)
        q1, q2 = self.critic.both(obs, act)
        critic_loss = ((q1 - target_q) ** 2).mean() + ((q2 - target_q) ** 2).mean()
        critic_loss.backward()
        self.critic_optimizer.step()

        update_actor = self.step % self.policy_freq == 0
        with torch.set_grad_enabled(update_actor):
            pred_act = self.actor(obs)
            q = self.critic(obs, pred_act)
            lmbda = self.alpha / q.abs().mean().detach()
            policy_loss = -lmbda * q.mean()
            bc_loss = ((pred_act - act) ** 2).mean()
        if update_actor:
            # the critic is read, not trained, here
            (policy_loss + bc_loss).backward(inputs=list(self.actor.parameters()))
            self.actor_optimizer.step()
            ema_update(self.actor_target, self.actor, 0.995)
            ema_update(self.critic_target, self.critic, 0.995)
            self.actor_updates += 1
        self.step += 1
        return {"critic_loss": critic_loss.detach(), "policy_loss": policy_loss.detach(),
                "bc_loss": bc_loss.detach(), "policy_q": q.mean().detach(),
                "mean_target_q": target_q.mean()}

    def make_train_scan(self, dataset, batch_size: int, n_steps: int):
        """`run(generator) -> log`: `n_steps` updates on device gathers, the
        logs' window means on the device."""
        return train_window(self.update, dataset, batch_size, n_steps, self.LOG_KEYS,
                            self.device)

    @torch.no_grad()
    def act(self, obs):
        return self.actor(self._f32(obs))

    # ------------------------------------------------------------------
    _NETS = ("actor", "actor_target", "critic", "critic_target")

    def save(self, path: str):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save({**{n: getattr(self, n).state_dict() for n in self._NETS},
                    "actor_optimizer": self.actor_optimizer.state_dict(),
                    "critic_optimizer": self.critic_optimizer.state_dict(),
                    "step": self.step, "actor_updates": self.actor_updates}, path)

    def load(self, path: str):
        state = torch.load(path, map_location="cpu", weights_only=True)
        for n in self._NETS:
            getattr(self, n).load_state_dict(state[n])
        self.actor_optimizer.load_state_dict(state["actor_optimizer"])
        self.critic_optimizer.load_state_dict(state["critic_optimizer"])
        self.step, self.actor_updates = state["step"], state["actor_updates"]

    def load_jax_checkpoint(self, path: str):
        """Read the JAX CLI's `td3bc.pkl` (a pickled `TD3BCState`) without
        JAX: the four nets, both Adams' moments and counts, and the step."""
        state = read_jax_pickle(path)
        if state.get("_class") != "TD3BCState":
            raise ValueError(f"{path} holds no TD3BCState")
        for n in self._NETS:
            load_jax_params(getattr(self, n), state[f"{n}_params"]["params"])
        for opt, net, key in ((self.actor_optimizer, self.actor, "actor_opt_state"),
                              (self.critic_optimizer, self.critic, "critic_opt_state")):
            adam = jax_adam_state(state[key])
            load_adam_moments(opt.optimizer, net, adam["mu"]["params"], adam["nu"]["params"],
                              adam["count"])
            opt.set_count(adam["schedule_count"])
        self.step = int(state["step"])
        self.actor_updates = -(-self.step // self.policy_freq)


class SynthERPipeline:
    LOG_KEYS = ("loss", "grad_norm")

    def __init__(self, obs_dim: int, act_dim: int, diffusion_steps: int = 128,
                 emb_dim: int = 128, hidden_dim: int = 1024, n_blocks: int = 6,
                 lr: float = 3e-4, gradient_steps: int = 100_000, ema_rate: float = 0.999,
                 rng: int = 0, device=None):
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.x_dim = obs_dim * 2 + act_dim + 2
        self.device = default_device(device)
        self.diffusion = DiscreteDiffusionSDE(
            IDQLMlp(obs_dim=0, act_dim=self.x_dim, emb_dim=emb_dim, hidden_dim=hidden_dim,
                    n_blocks=n_blocks, generator=torch.Generator().manual_seed(rng)),
            diffusion_steps=diffusion_steps, ema_rate=ema_rate,
            optim_params={"lr": cosine_decay_schedule(lr, gradient_steps), "weight_decay": 0.0},
            rng=rng, device=self.device,
        )
        self._gen_fns = {}  # (batch_size, sampling_steps) -> sampler
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 1)

    def train_step(self, batch, noise=None) -> dict:
        """One update on the batch as flat rows [obs, act, rew, next_obs,
        tml]; returns device scalars "loss" and "grad_norm"."""
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        x = torch.cat([f32(batch["obs"]["state"]), f32(batch["act"]), f32(batch["rew"]),
                       f32(batch["next_obs"]["state"]), f32(batch["tml"])], dim=-1)
        return self.diffusion.update(x, noise=noise)

    def make_train_scan(self, dataset, batch_size: int, n_steps: int):
        return train_window(self.train_step, dataset, batch_size, n_steps, self.LOG_KEYS,
                            self.device)

    @torch.no_grad()
    def generate_transitions(self, n_transitions: int, batch_size: int = 100_000,
                             sampling_steps: int = 128,
                             generator: Optional[torch.Generator] = None,
                             noise=None) -> np.ndarray:
        """`n_transitions` synthetic rows (numpy) from the EMA model, in
        sampler calls of min(batch_size, n_transitions) rows; `noise`, when
        given, is one sampler draw (initial, per_step) per call."""
        batch_size = min(batch_size, n_transitions)
        key = (batch_size, sampling_steps)
        if key not in self._gen_fns:
            self._gen_fns[key] = self.diffusion.build_sample_fn(
                solver="ddpm", sample_steps=sampling_steps, cfg_mode="uncond", final_logp=False)
        fn, gen = self._gen_fns[key], generator or self._generator
        prior = torch.zeros((batch_size, self.x_dim), device=self.device)
        out, remaining, b = [], n_transitions, 0
        while remaining > 0:
            x, _ = fn(self.diffusion.ema_params, gen, prior,
                      noise=None if noise is None else noise[b])
            out.append(x[: min(remaining, batch_size)].cpu().numpy())
            remaining -= batch_size
            b += 1
            print(f"synthesized: step {n_transitions - max(remaining, 0)}/{n_transitions}",
                  flush=True)
        return np.concatenate(out, axis=0)

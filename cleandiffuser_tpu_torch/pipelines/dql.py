"""Diffusion-QL pipeline (counterpart of cleandiffuser_tpu/pipelines/dql.py).

A diffusion policy over one action per state (`DQLMlp` on a
`DiscreteDiffusionSDE`, the observation as its condition) and a twin-Q
critic (`DQLCritic`) with a target copy.

One `train_step`, in the reference's order:
1. the critic's TD update: the next action sampled by the EMA actor with
   no grad (with `max_q_backup` M > 0: M candidates per state, the max over
   them per head, then the min over the heads), scored by the target
   critic; Adam under a cosine schedule;
2. the actor's update on `bc + eta * q_loss`: the BC loss of the engine,
   and the Q of actions the sampler draws *with grad* through `params`
   (the backward runs through all its steps), scored by the critic as just
   updated, whose parameters get no gradient; a coin picks which head is
   normalised by the other's detached `|q|.mean()`; AdamW without decay
   under a cosine schedule;
3. the actor's EMA every `ema_update_interval` steps from step 1000, and
   the critic target `0.995 * online + 0.005 * target` every
   `ema_update_interval` steps (utils/train_state.py `ema_gate`,
   `target_update`), both gated on the host step before it increments.
Until step 1000 the EMA actor is the initial network; the TD target and
`act(use_ema=True)` use it as the reference does. Logs stay on the device.

`noise` gives a step's draws explicitly, a dict with any of "next" (the TD
target sampler's noise, diffusion/diffusionsde.py), "bc" (the BC loss's
(t, eps)), "new" (the policy sampler's noise) and "coin" (a bool scalar);
a missing one is drawn from the engine's generator.

`act`: E x K candidates per call (`temperature`), scored by the target
critic's min-Q, one per env drawn from softmax(q * weight_temperature) by
the Gumbel-max draw (`categorical_pick`). Nothing is read on the host but
the returned actions.

The CLI's windowed trainer is pipelines/runner.py `make_rl_train_scan`. No
kernel runs on this path: the nets are MLPs.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..diffusion import DiscreteDiffusionSDE
from ..nn_condition import IdentityCondition
from ..nn_diffusion import DQLMlp
from ..utils.blocks import DQLCritic
from ..utils.jax_params import load_adam_moments, load_jax_params
from ..utils.ranks import batch_mean
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from ..utils.train_state import (
    cosine_decay_schedule,
    ema_gate,
    jax_adam_state,
    jax_train_state,
    load_train_state_dict,
    make_adam,
    read_jax_pickle,
    target_update,
    train_state_dict,
)

__all__ = ["DQLPipeline", "categorical_pick", "gumbel_pick", "sample_candidates"]


def gumbel_pick(candidates, logits, generator: Optional[torch.Generator] = None,
                gumbel=None):
    """One of K candidates per row, drawn from softmax(logits) (E, K) by the
    Gumbel-max draw `jax.random.categorical` makes: argmax(logits + g), g
    standard Gumbel noise (E, K) drawn from `generator` unless given.
    candidates: (E, K, d) -> (picked (E, d), picks (E,), the perturbed
    logits (E, K) they are the argmax of)."""
    if gumbel is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    perturbed = logits + gumbel.to(logits.device)
    idx = perturbed.argmax(dim=-1)
    return candidates[torch.arange(candidates.shape[0], device=idx.device), idx], idx, perturbed


def categorical_pick(candidates, logits, generator: Optional[torch.Generator] = None,
                     gumbel=None):
    """`gumbel_pick`'s picked candidates alone: (E, K, d) -> (E, d)."""
    return gumbel_pick(candidates, logits, generator, gumbel)[0]


def sample_candidates(pipe, obs_normed, num_candidates: int, use_ema: bool,
                      temperature: float, generator, sample_noise=None):
    """`num_candidates` actions per observation from a policy pipeline's
    sampler: (obs repeated env-major (E * K, obs_dim), actions (E * K,
    act_dim))."""
    obs = torch.as_tensor(obs_normed, dtype=torch.float32, device=pipe.device)
    obs_rep = obs.repeat_interleave(num_candidates, dim=0)
    params = pipe.actor.ema_params if use_ema else pipe.actor.params
    prior = torch.zeros((obs_rep.shape[0], pipe.act_dim), device=pipe.device)
    act, _ = pipe._sample_fn(params, generator, prior, condition_cfg=obs_rep, w_cfg=1.0,
                             temperature=temperature, noise=sample_noise)
    return obs_rep, act


class DQLPipeline:
    LOG_KEYS = ("bc_loss", "q_loss", "critic_loss", "target_q_mean")

    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        diffusion_steps: int = 5,
        sampling_steps: int = 5,
        solver: str = "ddpm",
        emb_dim: int = 64,
        hidden_dim: int = 256,
        actor_lr: float = 3e-4,
        critic_lr: float = 3e-4,
        gradient_steps: int = 2_000_000,
        discount: float = 0.99,
        eta: float = 1.0,
        ema_rate: float = 0.995,
        ema_update_interval: int = 5,
        predict_noise: bool = True,
        max_q_backup: int = 0,
        rng: int = 0,
        device=None,
    ):
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.discount, self.eta = discount, eta
        self.ema_update_interval = ema_update_interval
        self.sampling_steps, self.solver = sampling_steps, solver
        self.max_q_backup = max_q_backup
        self.device = default_device(device)

        self.actor = DiscreteDiffusionSDE(
            DQLMlp(obs_dim, act_dim, emb_dim=emb_dim, generator=torch.Generator().manual_seed(rng)),
            IdentityCondition(dropout=0.0),
            predict_noise=predict_noise,
            optim_params={"lr": cosine_decay_schedule(actor_lr, gradient_steps),
                          "weight_decay": 0.0},
            x_max=np.ones((act_dim,)), x_min=-np.ones((act_dim,)),
            diffusion_steps=diffusion_steps, ema_rate=ema_rate, rng=rng, device=self.device,
        )
        self.critic = DQLCritic(obs_dim, act_dim, hidden_dim,
                                generator=torch.Generator().manual_seed(rng + 1)).to(self.device)
        self.critic_target = copy.deepcopy(self.critic).requires_grad_(False)
        self.critic_optimizer = make_adam(self.critic.parameters(),
                                          cosine_decay_schedule(critic_lr, gradient_steps))
        self.critic_step = 0
        self._sample_fn = self.actor.build_sample_fn(
            solver=solver, sample_steps=sampling_steps, cfg_mode="cond", final_logp=False)
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 2)

    # ------------------------------------------------------------------
    def _sample(self, params, obs, noise=None):
        """Actions (B, act_dim) the sampler draws for `obs` (B, obs_dim),
        differentiable in `params` when grad mode is on."""
        prior = torch.zeros((obs.shape[0], self.act_dim), device=self.device)
        act, _ = self._sample_fn(params, self.actor.generator, prior, condition_cfg=obs,
                                 w_cfg=1.0, noise=noise)
        return act

    @torch.no_grad()
    def _td_target(self, next_obs, rew, tml, noise=None):
        """rew + (1 - tml) * discount * min-Q of the target critic at the EMA
        actor's next action (with max_q_backup M: the per-head max over M
        candidates first)."""
        M, b = self.max_q_backup, next_obs.shape[0]
        nobs = next_obs.repeat_interleave(M, dim=0) if M > 0 else next_obs
        q1, q2 = self.critic_target(nobs, self._sample(self.actor.ema_params, nobs, noise))
        if M > 0:
            q1 = q1.reshape(b, M, -1).amax(dim=1)
            q2 = q2.reshape(b, M, -1).amax(dim=1)
        return rew + (1.0 - tml) * self.discount * torch.minimum(q1, q2)

    def _policy_actions(self, obs, act, noise: dict):
        """The actions the policy's Q-loss scores: sampled with grad."""
        return self._sample(self.actor.params, obs, noise.get("new"))

    def train_step(self, batch, noise: Optional[dict] = None) -> dict:
        """One critic and one actor update on a TD batch {"obs": {"state"},
        "next_obs": {"state"}, "act", "rew", "tml"}. Returns device scalars
        "bc_loss", "q_loss", "critic_loss" and "target_q_mean"."""
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        obs, next_obs = f32(batch["obs"]["state"]), f32(batch["next_obs"]["state"])
        act, rew, tml = f32(batch["act"]), f32(batch["rew"]), f32(batch["tml"])
        noise = noise or {}
        gen = self.actor.generator

        target_q = self._td_target(next_obs, rew, tml, noise.get("next"))
        q1, q2 = self.critic(obs, act)
        critic_loss = ((q1 - target_q) ** 2).mean() + ((q2 - target_q) ** 2).mean()
        critic_loss.backward()
        self.critic_optimizer.step()

        coin = noise.get("coin")
        if coin is None:
            coin = torch.rand((), generator=gen, device=self.device) > 0.5
        params = self.actor.params
        t_eps = noise.get("bc")
        bc_loss = self.actor.loss_fn(params, act, obs, generator=gen,
                                     noise=None if t_eps is None else (*t_eps, None))
        q1_new, q2_new = self.critic(obs, self._policy_actions(obs, act, noise))
        q_loss = torch.where(torch.as_tensor(coin, device=self.device),
                             -q1_new.mean() / batch_mean(q2_new.abs()),
                             -q2_new.mean() / batch_mean(q1_new.abs()))
        # the critic is read, not trained, here: only the actor's params
        # take gradients
        (bc_loss + self.eta * q_loss).backward(inputs=list(params.parameters()))
        self.actor.optimizer.step()

        step = self.actor.step
        if ema_gate(step, self.ema_update_interval):
            self.actor.ema_update()
        if step % self.ema_update_interval == 0:
            target_update(self.critic_target, self.critic)
        self.actor.step += 1
        self.critic_step += 1
        return {"bc_loss": bc_loss.detach(), "q_loss": q_loss.detach(),
                "critic_loss": critic_loss.detach(), "target_q_mean": target_q.mean()}

    @property
    def trained_steps(self) -> int:
        """Updates taken (the actor's host step; checkpoints restore it)."""
        return self.actor.step

    # ------------------------------------------------------------------
    @torch.no_grad()
    def act(self, obs_normed, num_candidates: int = 50, weight_temperature: float = 10.0,
            use_ema: bool = True, temperature: float = 1.0,
            generator: Optional[torch.Generator] = None, noise=None):
        """Actions (E, act_dim) for normalised observations (E, obs_dim).
        `noise=(sampler_noise, gumbel)` gives the draws explicitly: the
        sampler's noise over the E * K candidates (env-major) and the
        choice's Gumbel noise (E, K); either may be None."""
        sample_noise, gumbel = noise if noise is not None else (None, None)
        gen = generator or self._generator
        obs_rep, act = sample_candidates(self, obs_normed, num_candidates, use_ema, temperature,
                                         gen, sample_noise)
        E = obs_rep.shape[0] // num_candidates
        logits = self.critic_target.q_min(obs_rep, act).reshape(E, -1) * weight_temperature
        return categorical_pick(act.reshape(E, num_candidates, -1), logits, gen, gumbel)

    # ------------------------------------------------------------------
    @writer_only
    def save(self, path: str):
        """Actor (params, EMA, optimizer, step, generator) and critic
        (params, target, optimizer, step) in one file."""
        a = self.actor
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"actor": train_state_dict(a.params, a.ema_params, a.optimizer, a.step,
                                              a.generator),
                    "critic": {"params": self.critic.state_dict(),
                               "target_params": self.critic_target.state_dict(),
                               "optimizer": self.critic_optimizer.state_dict(),
                               "step": self.critic_step}}, path)

    def load(self, path: str):
        a = self.actor
        state = torch.load(path, map_location="cpu", weights_only=True)
        a.step = load_train_state_dict(state["actor"], a.params, a.ema_params, a.optimizer,
                                       a.generator)
        c = state["critic"]
        self.critic.load_state_dict(c["params"])
        self.critic_target.load_state_dict(c["target_params"])
        self.critic_optimizer.load_state_dict(c["optimizer"])
        self.critic_step = c["step"]

    def load_jax_checkpoint(self, path: str):
        """Resume from the pickle the JAX pipeline's `save` wrote
        ({"actor": TrainState, "critic": CriticState}), without JAX."""
        state = read_jax_pickle(path)
        self.actor.load_jax_state(jax_train_state(state["actor"]))
        critic = state["critic"]
        load_jax_params(self.critic, critic["params"]["params"])
        load_jax_params(self.critic_target, critic["target_params"]["params"])
        adam = jax_adam_state(critic["opt_state"])
        load_adam_moments(self.critic_optimizer.optimizer, self.critic, adam["mu"]["params"],
                          adam["nu"]["params"], adam["count"])
        self.critic_optimizer.set_count(adam["schedule_count"])
        self.critic_step = int(critic["step"])

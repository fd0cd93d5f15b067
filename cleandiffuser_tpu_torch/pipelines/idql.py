"""IDQL pipeline (counterpart of cleandiffuser_tpu/pipelines/idql.py): a
behavior-cloned diffusion policy (`IDQLMlp`, dropout in training) and an
IQL critic (utils/iql.py `IQL`: `TwinQ` with its target, `V`).

One `train_step`:
1. the IQL critic, on even critic steps only (a host counter): V by
   expectile regression (`iql_tau`) on the target's min-Q, then Q by TD on
   the *new* V, then the target `0.995 * online + 0.005 * target` (the
   pipeline's rule, `IQL(target_mu=0.005)`). On odd steps nothing moves:
   no parameter, no Adam moment, no Adam or schedule count, as the
   reference's `where`-gated states; `v_loss` and `q_loss` are computed and
   logged on every step. Both optimizers: Adam under a cosine schedule.
2. the BC actor update (the engine's `update`: AdamW without decay under a
   cosine schedule, then an ungated EMA).

`train_step(batch, noise)`: `noise` is the actor loss's explicit (t, eps,
keep) (diffusion/diffusionsde.py `loss_fn`); the dropout masks come from
the engine's generator.

`act`: E x K candidates (256 per env by default, so 50 envs make 12,800
rows), scored by the advantage min-Q(target) - V, one per env drawn from
softmax(adv * weight_temperature) (pipelines/dql.py `categorical_pick`).
No kernel runs on this path: the nets are MLPs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..diffusion import DiscreteDiffusionSDE
from ..nn_condition import IdentityCondition
from ..nn_diffusion import IDQLMlp
from ..utils.iql import IQL
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from ..utils.train_state import (
    cosine_decay_schedule,
    jax_train_state,
    load_train_state_dict,
    read_jax_pickle,
    train_state_dict,
)
from .dql import categorical_pick, sample_candidates

__all__ = ["IDQLPipeline"]


class IDQLPipeline:
    LOG_KEYS = ("bc_loss", "q_loss", "v_loss")

    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        diffusion_steps: int = 5,
        sampling_steps: int = 5,
        solver: str = "ddpm",
        emb_dim: int = 64,
        actor_hidden_dim: int = 256,
        actor_n_blocks: int = 3,
        actor_dropout: float = 0.1,
        critic_hidden_dim: int = 256,
        actor_lr: float = 3e-4,
        critic_lr: float = 3e-4,
        gradient_steps: int = 1_000_000,
        discount: float = 0.99,
        iql_tau: float = 0.7,
        ema_rate: float = 0.995,
        predict_noise: bool = True,
        rng: int = 0,
        device=None,
    ):
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.sampling_steps, self.solver = sampling_steps, solver
        self.device = default_device(device)

        self.actor = DiscreteDiffusionSDE(
            IDQLMlp(obs_dim, act_dim, emb_dim=emb_dim, hidden_dim=actor_hidden_dim,
                    n_blocks=actor_n_blocks, dropout=actor_dropout,
                    generator=torch.Generator().manual_seed(rng)),
            IdentityCondition(dropout=0.0),
            predict_noise=predict_noise,
            optim_params={"lr": cosine_decay_schedule(actor_lr, gradient_steps),
                          "weight_decay": 0.0},
            x_max=np.ones((act_dim,)), x_min=-np.ones((act_dim,)),
            diffusion_steps=diffusion_steps, ema_rate=ema_rate, rng=rng, device=self.device,
        )
        self.iql = IQL(obs_dim, act_dim, tau=iql_tau, discount=discount,
                       hidden_dim=critic_hidden_dim,
                       lr=cosine_decay_schedule(critic_lr, gradient_steps), target_mu=0.005,
                       rng=rng + 1, device=self.device)
        self.critic_step = 0
        self._sample_fn = self.actor.build_sample_fn(
            solver=solver, sample_steps=sampling_steps, cfg_mode="cond", final_logp=False)
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 2)

    # ------------------------------------------------------------------
    def train_step(self, batch, noise=None) -> dict:
        """One IQL critic step (gated to even steps) and one BC actor
        update. Returns device scalars "bc_loss", "q_loss" and "v_loss"."""
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        obs, next_obs = f32(batch["obs"]["state"]), f32(batch["next_obs"]["state"])
        act, rew, tml = f32(batch["act"]), f32(batch["rew"]), f32(batch["tml"])
        do_iql = self.critic_step % 2 == 0
        v_loss = self.iql.update_V(obs, act, apply=do_iql)
        q_loss = self.iql.update_Q(obs, act, rew, next_obs, tml, apply=do_iql)
        self.critic_step += 1

        log = self.actor.update(act, obs, noise=noise)
        return {"bc_loss": log["loss"], "q_loss": q_loss, "v_loss": v_loss}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def act(self, obs_normed, num_candidates: int = 256, weight_temperature: float = 10.0,
            temperature: float = 1.0, use_ema: bool = True,
            generator: Optional[torch.Generator] = None, noise=None):
        """Actions (E, act_dim) for normalised observations (E, obs_dim);
        `noise=(sampler_noise, gumbel)` as in `DQLPipeline.act`."""
        sample_noise, gumbel = noise if noise is not None else (None, None)
        gen = generator or self._generator
        obs_rep, act = sample_candidates(self, obs_normed, num_candidates, use_ema, temperature,
                                         gen, sample_noise)
        E = obs_rep.shape[0] // num_candidates
        adv = (self.iql.q_target(obs_rep, act) - self.iql.v(obs_rep)).reshape(E, -1)
        return categorical_pick(act.reshape(E, num_candidates, -1), adv * weight_temperature,
                                gen, gumbel)

    # ------------------------------------------------------------------
    @writer_only
    def save(self, path: str):
        a = self.actor
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"actor": train_state_dict(a.params, a.ema_params, a.optimizer, a.step,
                                              a.generator),
                    "critic": {**self.iql.state_dict(), "step": self.critic_step}}, path)

    def load(self, path: str):
        a = self.actor
        state = torch.load(path, map_location="cpu", weights_only=True)
        a.step = load_train_state_dict(state["actor"], a.params, a.ema_params, a.optimizer,
                                       a.generator)
        self.iql.load_state_dict(state["critic"])
        self.critic_step = state["critic"]["step"]

    def load_jax_checkpoint(self, path: str):
        """Resume from the pickle the JAX pipeline's `save` wrote
        ({"actor": TrainState, "critic": IQLCriticState}), without JAX."""
        state = read_jax_pickle(path)
        self.actor.load_jax_state(jax_train_state(state["actor"]))
        self.iql.load_jax_state(state["critic"])
        self.critic_step = int(state["critic"]["step"])

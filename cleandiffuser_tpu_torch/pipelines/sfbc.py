"""SfBC pipeline (counterpart of cleandiffuser_tpu/pipelines/sfbc.py): a
behavior actor (`SfBCUNet` on a `ContinuousDiffusionSDE`, the observation
through an `MLPCondition` with label dropout) and an in-sample-planning
value critic (`Mlp` over [obs, act], SiLU).

- `bc_train_step(batch, noise)`: one actor update on the (batch, horizon)
  windows flattened to rows; `noise` is the loss's explicit (t, eps,
  keep) (diffusion/diffusionsde.py). `make_bc_train_scan` is the CLI's
  window of such steps (pipelines/runner.py `train_window`).
- `reset_critic()`: a fresh critic and a fresh Adam, the weights drawn from
  the pipeline's own generator, at each in-sample-planning iteration.
- `critic_train_step(obs, act, val)`: one Adam step on the MSE to `val`.
- `monte_carlo_reevaluate`: M actions per (path, step) sampled by the EMA
  actor (ddpm), scored by the critic, softmax-weighted at temperature
  alpha; the target is rew + discount * max(seq_val, eval) shifted one step,
  the last step the evaluation and the terminal cells their reward; a new
  `GaussianNormalizer` of the target. Paths go `batch_paths` at a time,
  each batch one sampler call of paths x L x M rows.
- `act`: `num_candidates` actions per env from the EMA actor, the
  `top_k_average` best by the critic averaged.

Randomness comes from the engine's generator or the caller's, or
explicitly (`noise=`). No kernel runs on this path: the nets are MLPs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion import ContinuousDiffusionSDE
from ..nn_condition import MLPCondition
from ..nn_diffusion import SfBCUNet
from ..utils.blocks import Mlp
from ..utils.jax_params import load_jax_params
from ..utils.normalizers import GaussianNormalizer
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from ..utils.train_state import make_adam, read_jax_pickle
from .runner import train_window

__all__ = ["SfBCPipeline"]


class SfBCPipeline:
    LOG_KEYS = ("loss", "grad_norm")

    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        emb_dim: int = 64,
        hidden_dim: int = 256,
        actor_lr: float = 3e-4,
        critic_lr: float = 3e-4,
        ema_rate: float = 0.995,
        predict_noise: bool = True,
        discount: float = 0.99,
        monte_carlo_samples: int = 16,
        weight_temperature: float = 10.0,
        rng: int = 0,
        device=None,
    ):
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.discount = discount
        self.M, self.alpha = monte_carlo_samples, weight_temperature
        self.critic_lr, self.hidden_dim = critic_lr, hidden_dim
        self.device = default_device(device)
        init = torch.Generator().manual_seed(rng)
        self.actor = ContinuousDiffusionSDE(
            SfBCUNet(act_dim, emb_dim, generator=init),
            MLPCondition(obs_dim, emb_dim, (emb_dim,), act=F.silu, generator=init),
            ema_rate=ema_rate, predict_noise=predict_noise,
            x_max=np.ones((act_dim,)), x_min=-np.ones((act_dim,)),
            optim_params={"lr": actor_lr, "weight_decay": 0.0}, rng=rng, device=self.device,
        )
        self._critic_init = torch.Generator().manual_seed(rng + 1)
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 2)
        self._sample_fns = {}
        self.reset_critic()

    def reset_critic(self):
        """A fresh critic and Adam (an in-sample-planning iteration's)."""
        self.critic = Mlp(self.obs_dim + self.act_dim, (self.hidden_dim, self.hidden_dim), 1,
                          activation=F.silu, generator=self._critic_init).to(self.device)
        self.critic_optimizer = make_adam(self.critic.parameters(), self.critic_lr)

    def _sample_fn(self, sampling_steps: int):
        if sampling_steps not in self._sample_fns:
            self._sample_fns[sampling_steps] = self.actor.build_sample_fn(
                solver="ddpm", sample_steps=sampling_steps, cfg_mode="cond", final_logp=False)
        return self._sample_fns[sampling_steps]

    def _f32(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    def bc_train_step(self, batch, noise=None) -> dict:
        """One actor update on the windows flattened to rows; returns
        device scalars "loss" and "grad_norm"."""
        obs = self._f32(batch["obs"]["state"]).reshape(-1, self.obs_dim)
        act = self._f32(batch["act"]).reshape(-1, self.act_dim)
        return self.actor.update(act, obs, noise=noise)

    def make_bc_train_scan(self, dataset, batch_size: int, n_steps: int):
        """`run(generator) -> log`: `n_steps` x `bc_train_step` on device
        gathers, the logs' window means on the device."""
        return train_window(self.bc_train_step, dataset, batch_size, n_steps, self.LOG_KEYS,
                            self.device)

    def critic_train_step(self, obs, act, val) -> dict:
        pred = self.critic(torch.cat([self._f32(obs), self._f32(act)], -1))
        loss = ((pred - self._f32(val)) ** 2).mean()
        loss.backward()
        self.critic_optimizer.step()
        return {"critic_loss": loss.detach()}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _mc_eval(self, seq_obs, sampling_steps: int, generator, noise=None):
        """Normalised values (n, L, 1) of paths `seq_obs` (n, L, o): M EMA
        actions per (path, step), their critic values softmax-weighted."""
        n, L, M = seq_obs.shape[0], seq_obs.shape[1], self.M
        obs_rep = self._f32(seq_obs).reshape(n * L, self.obs_dim).repeat_interleave(M, dim=0)
        prior = torch.zeros((n * L * M, self.act_dim), device=self.device)
        act, _ = self._sample_fn(sampling_steps)(self.actor.ema_params, generator, prior,
                                                 condition_cfg=obs_rep, w_cfg=1.0, noise=noise)
        pred_val = self.critic(torch.cat([obs_rep, act], -1)).reshape(n, L, M, 1)
        w = torch.softmax(self.alpha * pred_val, dim=2)
        return (w * pred_val).sum(2)

    def monte_carlo_reevaluate(self, seq_obs, seq_rew, seq_val, tml_and_not_timeout,
                               val_normalizer: GaussianNormalizer, sampling_steps: int = 5,
                               batch_paths: int = 8, generator: Optional[torch.Generator] = None,
                               noise=None):
        """The in-sample-planning targets. Returns (target (n_paths, L, 1)
        numpy, its new GaussianNormalizer). `noise`, when given, is one
        sampler draw (initial, per_step) per batch of paths, its rows
        path-major, then step, then sample."""
        gen = generator or self._generator
        n_paths = seq_obs.shape[0]
        normed_eval = np.empty((n_paths, seq_obs.shape[1], 1), np.float32)
        for b, i in enumerate(range(0, n_paths, batch_paths)):
            sl = slice(i, min(i + batch_paths, n_paths))
            normed_eval[sl] = self._mc_eval(seq_obs[sl], sampling_steps, gen,
                                            None if noise is None else noise[b]).cpu().numpy()
        eval_seq_val = val_normalizer.unnormalize(normed_eval)
        target = np.empty_like(eval_seq_val)
        target[:, :-1] = seq_rew[:, :-1] + self.discount * np.maximum(seq_val[:, 1:],
                                                                       eval_seq_val[:, 1:])
        target[:, -1] = eval_seq_val[:, -1]
        if tml_and_not_timeout is not None and len(tml_and_not_timeout) != 0:
            idx = tuple(np.asarray(tml_and_not_timeout).T)
            target[idx] = seq_rew[idx]
        return target, GaussianNormalizer(target)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def act(self, obs_normed, num_candidates: int = 32, top_k_average: int = 4,
            sampling_steps: int = 5, temperature: float = 1.0,
            generator: Optional[torch.Generator] = None, noise=None, return_info: bool = False):
        """Actions (E, act_dim): the mean of the `top_k_average` of
        `num_candidates` EMA samples per env ranked by the critic. `noise`
        is the sampler's (initial, per_step) over the E * K candidates
        (env-major). With `return_info`, (actions, {"candidates" (E, K, A),
        "scores" (E, K), "idx" (E, top_k)})."""
        obs = self._f32(obs_normed)
        E, K = obs.shape[0], num_candidates
        obs_rep = obs.repeat_interleave(K, dim=0)
        prior = torch.zeros((E * K, self.act_dim), device=self.device)
        act, _ = self._sample_fn(sampling_steps)(
            self.actor.ema_params, generator or self._generator, prior, condition_cfg=obs_rep,
            w_cfg=1.0, temperature=temperature, noise=noise)
        value = self.critic(torch.cat([obs_rep, act], -1)).reshape(E, K)
        act = act.reshape(E, K, -1)
        order = torch.argsort(-value, dim=1, stable=True)[:, :top_k_average]
        out = torch.take_along_dim(act, order[:, :, None], dim=1).mean(1)
        if return_info:
            return out, {"candidates": act, "scores": value, "idx": order}
        return out

    # ------------------------------------------------------------------
    @writer_only
    def save(self, path: str):
        """The actor's train state to `path.actor`, the critic's params to
        `path.critic`."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.actor.save(path + ".actor")
        torch.save({"params": self.critic.state_dict()}, path + ".critic")

    def load(self, path: str):
        self.actor.load(path + ".actor")
        self.load_critic(path)

    def load_critic(self, path: str):
        state = torch.load(path + ".critic", map_location="cpu", weights_only=True)
        self.critic.load_state_dict(state["params"])

    def load_jax_checkpoint(self, path: str):
        """Read the files the JAX pipeline's `save` wrote: `path.actor` (a
        TrainState) and `path.critic` (the critic's flax params), without
        JAX."""
        self.actor.load_jax_checkpoint(path + ".actor")
        load_jax_params(self.critic, read_jax_pickle(path + ".critic")["params"])

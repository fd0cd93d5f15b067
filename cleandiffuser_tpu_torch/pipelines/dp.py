"""Diffusion Policy (counterpart of cleandiffuser_tpu/pipelines/dp.py):
action-chunk diffusion conditioned on the observation window, with a
ChiUNet1d, ChiTransformer or DiT1d backbone on the DDPM
(`DiscreteDiffusionSDE`) or EDM engine, executed receding-horizon: the
chunk `pred[:, To - 1 : To - 1 + Ta]` of a `horizon`-step prediction.

    pipe = DPPipeline(obs_dim=5, action_dim=2, nn="chi_unet", device="cpu")
    log = pipe.train_step(batch)                 # {"loss", "grad_norm"} on the device
    chunk = pipe.act_chunk(nobs)                 # (B, Ta, act), normalised
    rew, success = pipe.evaluate_on_device(env, dataset.normalizer, num_envs=10)

- `train_step(batch, noise=None)`: one engine update on (B, horizon, act)
  actions and the (B, To, obs) observation window (flattened for the DiT's
  MLP condition); `noise` is the loss's explicit draws, (t, eps, keep) or,
  for EDM, (sigma, eps, keep); the ChiTransformer's dropout masks come from
  the engine's generator.
- `make_train_scan(dataset, batch_size, n_steps)`: a window of `n_steps`
  steps on device gathers, the logs kept on the device
  (`runner.train_window`).
- `act_chunk(nobs, generator=None, noise=None)`: the EMA sampler (ddpm, or
  Euler for EDM) with the condition, w_cfg 1; `noise` is the sampler's
  explicit draws ((initial, per_step) for ddpm, the initial draw for EDM).
- `evaluate_on_device(env, normalizer, num_envs, max_episode_steps)`: the
  whole receding-horizon rollout on the device (env/pusht.py): normalise
  the window, sample a chunk, run its Ta env steps, for
  `max_episode_steps // Ta` chunks, with no host sync inside the loop; one
  read at the end. Returns (mean episode return, mean best reward), as the
  JAX pipeline's; `reset_to_state` and `noise` (one sampler draw per chunk)
  give the draws explicitly.
- `save` / `load` (the port's checkpoint) and `load_jax_checkpoint` (the
  file the JAX pipeline's `save` writes).

No kernel runs on this path: the Chi U-Net builds its own residual block,
and the DiT1d is built without the fused block, as the JAX pipeline's.
Entry points run on the CUDA device unless `device` names another.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion import ContinuousEDM, DiscreteDiffusionSDE
from ..nn_condition import IdentityCondition, MLPCondition
from ..nn_diffusion import ChiTransformer, ChiUNet1d, DiT1d
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from ..utils.train_state import cosine_decay_schedule
from .runner import train_window

__all__ = ["DPPipeline", "make_agent", "minmax_consts"]


def make_agent(nn_diffusion, nn_condition, diffusion: str, x_shape, sample_steps: int,
               lr: float, gradient_steps: int, ema_rate: float, rng: int, device):
    """The imitation pipelines' engine: DDPM / DDIM (`DiscreteDiffusionSDE`
    with `sample_steps` diffusion steps and predictions clipped to [-1, 1])
    or EDM, AdamW without decay under a cosine schedule."""
    optim_params = {"lr": cosine_decay_schedule(lr, gradient_steps), "weight_decay": 0.0}
    if diffusion in ("ddpm", "ddim"):
        return DiscreteDiffusionSDE(nn_diffusion, nn_condition, diffusion_steps=sample_steps,
                                    x_max=np.ones(x_shape), x_min=-np.ones(x_shape),
                                    ema_rate=ema_rate, optim_params=optim_params, rng=rng,
                                    device=device)
    if diffusion == "edm":
        return ContinuousEDM(nn_diffusion, nn_condition, ema_rate=ema_rate,
                             optim_params=optim_params, rng=rng, device=device)
    raise NotImplementedError(diffusion)


def minmax_consts(normalizer, device):
    """A min-max normaliser's (min, range) as device tensors: the rollouts
    normalise with them on the device, as the JAX package's
    `as_device_constants`."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return f32(normalizer.min), f32(normalizer.range)


class DPPipeline:
    LOG_KEYS = ("loss", "grad_norm")

    def __init__(self, obs_dim: int, action_dim: int, horizon: int = 16, obs_steps: int = 2,
                 action_steps: int = 8, nn: str = "chi_unet", diffusion: str = "ddpm",
                 sample_steps: int = 5, lr: float = 1e-4, gradient_steps: int = 1_000_000,
                 ema_rate: float = 0.9999, rng: int = 0, device=None):
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.horizon, self.To, self.Ta = horizon, obs_steps, action_steps
        self.diffusion_kind = diffusion
        self.device = default_device(device)
        g = torch.Generator().manual_seed(rng)
        self._flatten_cond = nn == "dit"
        if nn == "dit":
            nn_diffusion = DiT1d(in_dim=action_dim, emb_dim=128, d_model=320, n_heads=10, depth=2,
                                 timestep_emb_type="fourier", generator=g)
            nn_condition = MLPCondition(obs_steps * obs_dim, 128, (256,), act=F.relu,
                                        dropout=0.0, generator=g)
        elif nn == "chi_unet":
            nn_diffusion = ChiUNet1d(act_dim=action_dim, obs_dim=obs_dim, To=obs_steps,
                                     model_dim=256, emb_dim=256, dim_mult=(1, 2, 2),
                                     obs_as_global_cond=True, timestep_emb_type="positional",
                                     generator=g)
            nn_condition = IdentityCondition(dropout=0.0)
        elif nn == "chi_transformer":
            nn_diffusion = ChiTransformer(act_dim=action_dim, obs_dim=obs_dim, Ta=horizon,
                                          To=obs_steps, d_model=256, nhead=4, num_layers=4,
                                          timestep_emb_type="positional", generator=g)
            nn_condition = IdentityCondition(dropout=0.0)
        else:
            raise ValueError(f"Invalid nn type {nn}")
        self.agent = make_agent(nn_diffusion, nn_condition, diffusion, (horizon, action_dim),
                                sample_steps, lr, gradient_steps, ema_rate, rng, self.device)
        self.sample_kw = dict(solver="ddpm" if diffusion == "ddpm" else "euler",
                              sample_steps=sample_steps, cfg_mode="cond", final_logp=False)
        self._sample_fn = self.agent.build_sample_fn(**self.sample_kw)
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 1)

    # ------------------------------------------------------------------
    def _tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def condition_of(self, nobs):
        """(B, >= To, obs) -> the backbone's condition: the first To frames,
        flattened for the DiT's MLP condition."""
        cond = nobs[:, :self.To]
        return cond.reshape(cond.shape[0], -1) if self._flatten_cond else cond

    def prior_shape(self, B: int) -> tuple:
        return (B, self.horizon, self.action_dim)

    def executed(self, x):
        """The executed chunk of a (B, horizon, act) prediction."""
        return x[:, self.To - 1:self.To - 1 + self.Ta]

    def train_step(self, batch, noise=None) -> dict:
        nobs = self._tensor(batch["obs"]["state"])
        return self.agent.update(self._tensor(batch["action"]), self.condition_of(nobs),
                                 noise=noise)

    def make_train_scan(self, dataset, batch_size: int, n_steps: int):
        """`run(generator) -> log`: `n_steps` steps on device gathers, the
        logs' window means as device scalars."""
        return train_window(self.train_step, dataset, batch_size, n_steps, self.LOG_KEYS,
                            self.device)

    # ------------------------------------------------------------------
    def _sample(self, cond, B: int, generator, noise):
        prior = torch.zeros(self.prior_shape(B), device=self.device)
        out, _ = self._sample_fn(self.agent.ema_params, generator, prior, condition_cfg=cond,
                                 w_cfg=1.0, noise=noise)
        return self.executed(out)

    @torch.no_grad()
    def act_chunk(self, nobs, generator: Optional[torch.Generator] = None, noise=None):
        """Normalised actions (B, Ta, act) for the normalised observation
        window (B, To, obs)."""
        nobs = self._tensor(nobs)
        return self._sample(self.condition_of(nobs), nobs.shape[0],
                            generator or self._generator, noise)

    @torch.no_grad()
    def evaluate_on_device(self, env, normalizer, num_envs: int = 8,
                           max_episode_steps: int = 300,
                           generator: Optional[torch.Generator] = None, reset_to_state=None,
                           noise=None):
        """The receding-horizon rollout on the device (module note).
        Returns (mean episode return, mean best reward)."""
        gen = generator or self._generator
        o_min, o_range = minmax_consts(normalizer["obs"]["state"], self.device)
        a_min, a_range = minmax_consts(normalizer["action"], self.device)
        state, obs = env.reset(gen, num_envs, reset_to_state)
        window = obs[:, None].repeat(1, self.To, 1)
        rews = []
        for c in range(max_episode_steps // self.Ta):
            nobs = (window - o_min) / o_range * 2.0 - 1.0
            naction = self._sample(self.condition_of(nobs), num_envs, gen,
                                   None if noise is None else noise[c])
            for a in ((naction + 1.0) / 2.0 * a_range + a_min).unbind(1):
                state, obs, rew, _ = env.step(state, a)
                window = torch.cat([window[:, 1:], obs[:, None]], 1)
                rews.append(rew)
        rews = torch.stack(rews)  # (T, E)
        return rews.sum(0).mean().item(), rews.max(0).values.mean().item()

    # ------------------------------------------------------------------
    @writer_only
    def save(self, path: str):
        self.agent.save(path)

    def load(self, path: str):
        self.agent.load(path)

    def load_jax_checkpoint(self, path: str):
        """Resume from the file the JAX pipeline's `save` wrote (its engine's
        TrainState), without JAX."""
        self.agent.load_jax_checkpoint(path)

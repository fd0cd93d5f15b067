"""DiffusionBC (counterpart of cleandiffuser_tpu/pipelines/dbc.py): one
action per control step, diffused by a PearceMlp or PearceTransformer
conditioned on the To-frame observation window through a
PearceObsCondition, on the DDPM, DDIM or EDM engine, with optional
Diffusion-X sampling (`diffusion_x_sampling_steps` extra steps at the last
noise level). The `dit` mode diffuses an action chunk (B, action_steps,
act) with a DiT1d conditioned on the flattened window through an
MLPCondition (dropout 0.25), and executes its first action.

    pipe = DBCPipeline(obs_dim=5, action_dim=2, nn="pearce_mlp", device="cpu")
    log = pipe.train_step(batch)          # the window's action at To - 1
    act = pipe.act(nobs)                  # (B, act), normalised
    rew, success = pipe.evaluate_on_device(env, dataset.normalizer, num_envs=10)

`train_step(batch, noise=None)`, `make_train_scan`, `save`, `load` and
`load_jax_checkpoint` as in pipelines/dp.py; `act(nobs, generator=None,
noise=None)` samples from the EMA (ddpm, ddim or Euler); `noise` is the
sampler's explicit draws, and for the `dit` mode's training the keep-mask
of the condition's dropout comes in `noise=(t, eps, keep)`.
`evaluate_on_device` runs the whole per-step rollout on the device
(normalise the window, denoise one action, step the env), one sampler call
per env step, with no host sync inside the loop; it returns (mean best
reward, share of episodes whose best reward reaches 1), as the JAX
pipeline's. No kernel runs on this path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..nn_condition import MLPCondition, PearceObsCondition
from ..nn_diffusion import DiT1d, PearceMlp, PearceTransformer
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from .dp import make_agent, minmax_consts
from .runner import train_window

__all__ = ["DBCPipeline"]


class DBCPipeline:
    LOG_KEYS = ("loss", "grad_norm")

    def __init__(self, obs_dim: int, action_dim: int, obs_steps: int = 2, action_steps: int = 1,
                 nn: str = "pearce_mlp", diffusion: str = "ddpm", emb_dim: int = 128,
                 sample_steps: int = 50, diffusion_x_sampling_steps: int = 0, lr: float = 1e-4,
                 gradient_steps: int = 1_000_000, ema_rate: float = 0.9999, rng: int = 0,
                 device=None):
        self.obs_dim, self.action_dim, self.To, self.Ta = obs_dim, action_dim, obs_steps, action_steps
        self.diffusion_kind = diffusion
        self.chunked = nn == "dit"  # chunk diffusion: x is (B, Ta, act)
        self.device = default_device(device)
        g = torch.Generator().manual_seed(rng)
        if nn in ("pearce_mlp", "pearce_transformer"):
            net = PearceMlp if nn == "pearce_mlp" else PearceTransformer
            nn_diffusion = net(act_dim=action_dim, To=obs_steps, emb_dim=emb_dim, generator=g)
            nn_condition = PearceObsCondition(obs_dim, emb_dim, flatten=False, dropout=0.0,
                                              generator=g)
        elif nn == "dit":
            nn_diffusion = DiT1d(in_dim=action_dim, emb_dim=256, d_model=384, n_heads=12, depth=6,
                                 timestep_emb_type="fourier", generator=g)
            nn_condition = MLPCondition(obs_steps * obs_dim, 256, (256,), act=F.relu,
                                        dropout=0.25, generator=g)
        else:
            raise ValueError(f"Invalid nn type {nn}")
        x_shape = (action_steps, action_dim) if self.chunked else (action_dim,)
        self.agent = make_agent(nn_diffusion, nn_condition, diffusion, x_shape, sample_steps, lr,
                                gradient_steps, ema_rate, rng, self.device)
        self.sample_kw = dict(solver={"ddim": "ddim", "edm": "euler"}.get(diffusion, "ddpm"),
                              sample_steps=sample_steps, cfg_mode="cond",
                              diffusion_x_sampling_steps=diffusion_x_sampling_steps,
                              final_logp=False)
        self._sample_fn = self.agent.build_sample_fn(**self.sample_kw)
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 1)

    # ------------------------------------------------------------------
    def _tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def condition_of(self, nobs):
        """(B, >= To, obs) -> the condition: the first To frames, flattened
        in the dit mode."""
        cond = nobs[:, :self.To]
        return cond.reshape(cond.shape[0], -1) if self.chunked else cond

    def prior_shape(self, B: int) -> tuple:
        return (B, self.Ta, self.action_dim) if self.chunked else (B, self.action_dim)

    def executed(self, x):
        """The executed action of a sample: a chunk's first."""
        return x[:, 0] if self.chunked else x

    def _x_and_cond(self, batch):
        """The diffused x (the action at To - 1, or the Ta-chunk from there)
        and the condition."""
        act = self._tensor(batch["action"])
        x = act[:, self.To - 1:self.To - 1 + self.Ta] if self.chunked else act[:, self.To - 1]
        return x, self.condition_of(self._tensor(batch["obs"]["state"]))

    def train_step(self, batch, noise=None) -> dict:
        x, cond = self._x_and_cond(batch)
        return self.agent.update(x, cond, noise=noise)

    def make_train_scan(self, dataset, batch_size: int, n_steps: int):
        return train_window(self.train_step, dataset, batch_size, n_steps, self.LOG_KEYS,
                            self.device)

    # ------------------------------------------------------------------
    def _sample(self, nobs, generator, noise):
        prior = torch.zeros(self.prior_shape(nobs.shape[0]), device=self.device)
        a, _ = self._sample_fn(self.agent.ema_params, generator, prior,
                               condition_cfg=self.condition_of(nobs), w_cfg=1.0, noise=noise)
        return self.executed(a)  # one action per control step

    @torch.no_grad()
    def act(self, nobs, generator: Optional[torch.Generator] = None, noise=None):
        """(B, To, obs) normalised observations -> (B, act) normalised actions."""
        return self._sample(self._tensor(nobs), generator or self._generator, noise)

    @torch.no_grad()
    def evaluate_on_device(self, env, normalizer, num_envs: int = 8,
                           max_episode_steps: int = 300,
                           generator: Optional[torch.Generator] = None, reset_to_state=None,
                           noise=None):
        """The per-step rollout on the device (module note). Returns (mean
        best reward, share of envs whose best reward reaches 1)."""
        gen = generator or self._generator
        o_min, o_range = minmax_consts(normalizer["obs"]["state"], self.device)
        a_min, a_range = minmax_consts(normalizer["action"], self.device)
        state, obs = env.reset(gen, num_envs, reset_to_state)
        window = obs[:, None].repeat(1, self.To, 1)
        best = None
        for t in range(max_episode_steps):
            na = self._sample((window - o_min) / o_range * 2.0 - 1.0, gen,
                              None if noise is None else noise[t])
            state, obs, rew, _ = env.step(state, (na + 1.0) / 2.0 * a_range + a_min)
            window = torch.cat([window[:, 1:], obs[:, None]], 1)
            best = rew if best is None else torch.maximum(best, rew)
        return best.mean().item(), (best >= 1.0).float().mean().item()

    # ------------------------------------------------------------------
    @writer_only
    def save(self, path: str):
        self.agent.save(path)

    def load(self, path: str):
        self.agent.load(path)

    def load_jax_checkpoint(self, path: str):
        """Resume from the file the JAX pipeline's `save` wrote, without JAX."""
        self.agent.load_jax_checkpoint(path)

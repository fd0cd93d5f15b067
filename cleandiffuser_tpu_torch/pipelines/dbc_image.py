"""DiffusionBC on image observations (counterpart of
cleandiffuser_tpu/pipelines/dbc_image.py): one action per control step,
diffused by a PearceMlp or PearceTransformer conditioned on a
`MultiImageObsCondition` over the To-frame window ((b, To, emb)), on the
DDPM, DDIM or EDM engine, with optional Diffusion-X sampling
(`diffusion_x_sampling_steps` extra steps at the last level).

    pipe = DBCImagePipeline(shape_meta, action_dim=2, device="cpu")
    log = pipe.train_step(batch)          # the window's action at To - 1
    act = pipe.act(obs)                   # (B, act), normalised
    rew, success = pipe.evaluate_on_device(env, dataset.normalizer, num_envs=10)

`condition_of`, `train_step(batch, noise=None, crops=None)`,
`make_train_scan`, `save`, `load` and `load_jax_checkpoint` as in
pipelines/dp_image.py (the first To frames of every key); `act(obs,
generator=None, noise=None)` samples from the EMA; `evaluate_on_device`
runs the per-step rollout on the device (render, encode the window,
denoise one action, step the env: one sampler call per env step, no host
sync inside the loop) and returns (mean best reward, share of envs whose
best reward reaches 1). No kernel runs on this path.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..nn_condition.images import CROP_KEY, MultiImageObsCondition
from ..nn_diffusion import PearceMlp, PearceTransformer
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from .dp import make_agent, minmax_consts
from .dp_image import image_condition_of, push_windows, rollout_windows
from .runner import train_window

__all__ = ["DBCImagePipeline"]


class DBCImagePipeline:
    LOG_KEYS = ("loss", "grad_norm")

    def __init__(self, shape_meta: Dict, action_dim: int, obs_steps: int = 2,
                 nn: str = "pearce_mlp", diffusion: str = "ddpm", emb_dim: int = 128,
                 sample_steps: int = 50, diffusion_x_sampling_steps: int = 0,
                 crop_shape=(84, 84), lr: float = 1e-3, gradient_steps: int = 1_000_000,
                 ema_rate: float = 0.9999, rng: int = 0, device=None):
        self.shape_meta, self.action_dim, self.To = shape_meta, action_dim, obs_steps
        self.diffusion_kind = diffusion
        self.device = default_device(device)
        g = torch.Generator().manual_seed(rng)
        if nn == "pearce_mlp":
            nn_diffusion = PearceMlp(act_dim=action_dim, To=obs_steps, emb_dim=emb_dim,
                                     generator=g)
        elif nn == "pearce_transformer":
            nn_diffusion = PearceTransformer(act_dim=action_dim, To=obs_steps, emb_dim=emb_dim,
                                             generator=g)
        else:
            raise ValueError(f"Invalid nn type {nn}")
        nn_condition = MultiImageObsCondition(shape_meta, emb_dim=emb_dim, crop_shape=crop_shape,
                                              use_seq=True, keep_horizon_dims=True, generator=g)
        self.agent = make_agent(nn_diffusion, nn_condition, diffusion, (action_dim,),
                                sample_steps, lr, gradient_steps, ema_rate, rng, self.device)
        self.sample_kw = dict(solver={"ddim": "ddim", "edm": "euler"}.get(diffusion, "ddpm"),
                              sample_steps=sample_steps, cfg_mode="cond",
                              diffusion_x_sampling_steps=diffusion_x_sampling_steps,
                              final_logp=False)
        self._sample_fn = self.agent.build_sample_fn(**self.sample_kw)
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 1)

    # ------------------------------------------------------------------
    def condition_of(self, obs: Dict) -> Dict:
        return image_condition_of(self.shape_meta, obs, self.To, True, self.device)

    def prior_shape(self, B: int) -> tuple:
        return (B, self.action_dim)

    def train_step(self, batch, noise=None, crops=None) -> dict:
        cond = self.condition_of(batch["obs"])
        if crops is not None:
            cond[CROP_KEY] = crops
        action = torch.as_tensor(batch["action"], dtype=torch.float32, device=self.device)
        return self.agent.update(action[:, self.To - 1], cond, noise=noise)

    def make_train_scan(self, dataset, batch_size: int, n_steps: int):
        return train_window(self.train_step, dataset, batch_size, n_steps, self.LOG_KEYS,
                            self.device)

    # ------------------------------------------------------------------
    def _sample(self, cond, generator, noise):
        B = next(iter(cond.values())).shape[0]
        prior = torch.zeros(self.prior_shape(B), device=self.device)
        a, _ = self._sample_fn(self.agent.ema_params, generator, prior, condition_cfg=cond,
                               w_cfg=1.0, noise=noise)
        return a

    @torch.no_grad()
    def act(self, obs: Dict, generator: Optional[torch.Generator] = None, noise=None):
        """The obs dict of (B, >= To, ...) windows -> (B, act) normalised
        actions."""
        return self._sample(self.condition_of(obs), generator or self._generator, noise)

    @torch.no_grad()
    def evaluate_on_device(self, env, normalizer, num_envs: int = 8,
                           max_episode_steps: int = 300,
                           generator: Optional[torch.Generator] = None, reset_to_state=None,
                           noise=None):
        """The per-step rollout on the device (module note); `noise` holds
        one sampler draw per env step."""
        gen = generator or self._generator
        p_min, p_range = minmax_consts(normalizer["obs"]["agent_pos"], self.device)
        a_min, a_range = minmax_consts(normalizer["action"], self.device)
        state, obs = env.reset(gen, num_envs, reset_to_state)
        img, pos = rollout_windows(obs, self.To, p_min, p_range)
        best = None
        for t in range(max_episode_steps):
            na = self._sample(self.condition_of({"image": img, "agent_pos": pos}), gen,
                              None if noise is None else noise[t])
            state, obs, rew, _ = env.step(state, (na + 1.0) / 2.0 * a_range + a_min)
            img, pos = push_windows(img, pos, obs, p_min, p_range)
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

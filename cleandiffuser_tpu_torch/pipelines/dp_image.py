"""Diffusion Policy on image observations (counterpart of
cleandiffuser_tpu/pipelines/dp_image.py): action-chunk diffusion
conditioned on a `MultiImageObsCondition` (a GN-ResNet18 per rgb key with
the crop randomiser, the low_dim keys beside), on the DDPM or EDM engine.

    pipe = DPImagePipeline(shape_meta, action_dim=2, nn="dit", device="cpu")
    log = pipe.train_step(batch)              # {"loss", "grad_norm"} on the device
    chunk = pipe.act_chunk(obs)               # (B, Ta, act), normalised
    rew, success = pipe.evaluate_on_device(env, dataset.normalizer, num_envs=10)

- `nn="chi_unet"`: the encoder embeds each of the first To frames, (b,
  To, emb), and the Chi U-Net (256, (1, 2, 2)) takes the window as its
  global condition; `nn="dit"`: the first frame only, (b, emb), into a
  DiT1d (320 wide, 10 heads, depth 2, Fourier time embedding).
- `condition_of(obs)`: the obs dict as the encoder takes it: images
  channels-last (the stores' uint8 layout) or channels-first, divided by
  255 only when integer; `chi_unet` keeps the first To frames of a window,
  `dit` the first; low_dim keys likewise.
- `train_step(batch, noise=None, crops=None)`: one engine update on the
  (B, horizon, act) actions; `noise` the loss's explicit draws, `crops`
  the random crops' offsets ({rgb key: (top, left)}, each (B * frames,)),
  else drawn from the engine's generator; `make_train_scan` a window of
  steps on device gathers (`runner.train_window`).
- `act_chunk(obs, generator=None, noise=None)`, `evaluate_on_device(env,
  normalizer, num_envs, max_episode_steps, generator=None,
  reset_to_state=None, noise=None)`: the rollout on the device with the
  image env (env/pusht.py `PushTImageEnv`): render, encode, denoise, Ta
  env steps per chunk, no host sync inside the loop; returns (mean best
  reward, share of envs whose best reward reaches 1), as the JAX
  pipeline's.
- `save`, `load`, `load_jax_checkpoint`.

No kernel runs on this path: the encoder is plain convolutions and
GroupNorm, the Chi U-Net builds its own residual block and the DiT1d is
built without the fused block, as the JAX pipeline's. Entry points run on
the CUDA device unless `device` names another.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..nn_condition.images import CROP_KEY, MultiImageObsCondition
from ..nn_diffusion import ChiUNet1d, DiT1d
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from .dp import make_agent, minmax_consts
from .runner import train_window

__all__ = ["DPImagePipeline", "image_condition_of"]


def image_condition_of(shape_meta: Dict, obs: Dict, To: int, seq: bool, device) -> Dict:
    """The encoder's input from an obs dict of (B, T, ...) windows or (B,
    ...) frames (module note): `seq` keeps the first To frames, else the
    first one."""
    cond = {}
    for key, meta in shape_meta["obs"].items():
        x = torch.as_tensor(obs[key], device=device)
        window = x.ndim == (5 if meta["type"] == "rgb" else 3)
        if window:
            x = x[:, :To] if seq else x[:, 0]
        if meta["type"] == "rgb":
            if x.shape[-1] == meta["shape"][0]:  # channels-last storage
                x = x.movedim(-1, -3)
            integer = not x.is_floating_point()
            x = x.to(torch.float32)
            if integer:
                x = x / 255.0
        else:
            x = x.to(torch.float32)
        cond[key] = x
    return cond


def rollout_windows(obs: Dict, To: int, pos_min, pos_range):
    """The first observation of an image-env rollout repeated To times: the
    image window and the normalised agent-position window."""
    img = obs["image"][:, None].repeat(1, To, 1, 1, 1)
    pos = ((obs["agent_pos"] - pos_min) / pos_range * 2.0 - 1.0)[:, None].repeat(1, To, 1)
    return img, pos


def push_windows(img, pos, obs: Dict, pos_min, pos_range):
    """The windows one env step later: the oldest frame out, obs in."""
    npos = (obs["agent_pos"] - pos_min) / pos_range * 2.0 - 1.0
    return (torch.cat([img[:, 1:], obs["image"][:, None]], 1),
            torch.cat([pos[:, 1:], npos[:, None]], 1))


class DPImagePipeline:
    LOG_KEYS = ("loss", "grad_norm")

    def __init__(self, shape_meta: Dict, action_dim: int, horizon: int = 16, obs_steps: int = 2,
                 action_steps: int = 8, nn: str = "chi_unet", diffusion: str = "ddpm",
                 sample_steps: int = 5, emb_dim: int = 256, crop_shape=(76, 76), lr: float = 1e-4,
                 gradient_steps: int = 1_000_000, ema_rate: float = 0.9999, rng: int = 0,
                 device=None):
        self.shape_meta, self.action_dim = shape_meta, action_dim
        self.horizon, self.To, self.Ta = horizon, obs_steps, action_steps
        self.nn_kind, self.diffusion_kind = nn, diffusion
        self.device = default_device(device)
        g = torch.Generator().manual_seed(rng)
        if nn == "chi_unet":
            nn_condition = MultiImageObsCondition(shape_meta, emb_dim=emb_dim,
                                                  crop_shape=crop_shape, use_seq=True,
                                                  keep_horizon_dims=True, generator=g)
            nn_diffusion = ChiUNet1d(act_dim=action_dim, obs_dim=emb_dim, To=obs_steps,
                                     model_dim=256, emb_dim=256, dim_mult=(1, 2, 2),
                                     obs_as_global_cond=True, generator=g)
        elif nn == "dit":
            nn_condition = MultiImageObsCondition(shape_meta, emb_dim=emb_dim,
                                                  crop_shape=crop_shape, generator=g)
            nn_diffusion = DiT1d(in_dim=action_dim, emb_dim=emb_dim, d_model=320, n_heads=10,
                                 depth=2, timestep_emb_type="fourier", generator=g)
        else:
            raise ValueError(nn)
        self.agent = make_agent(nn_diffusion, nn_condition, diffusion, (horizon, action_dim),
                                sample_steps, lr, gradient_steps, ema_rate, rng, self.device)
        self.sample_kw = dict(solver="ddpm" if diffusion == "ddpm" else "euler",
                              sample_steps=sample_steps, cfg_mode="cond", final_logp=False)
        self._sample_fn = self.agent.build_sample_fn(**self.sample_kw)
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 1)

    # ------------------------------------------------------------------
    def condition_of(self, obs: Dict) -> Dict:
        return image_condition_of(self.shape_meta, obs, self.To, self.nn_kind == "chi_unet",
                                  self.device)

    def prior_shape(self, B: int) -> tuple:
        return (B, self.horizon, self.action_dim)

    def executed(self, x):
        """The executed chunk of a (B, horizon, act) prediction."""
        return x[:, self.To - 1:self.To - 1 + self.Ta]

    def train_step(self, batch, noise=None, crops=None) -> dict:
        cond = self.condition_of(batch["obs"])
        if crops is not None:
            cond[CROP_KEY] = crops
        action = torch.as_tensor(batch["action"], dtype=torch.float32, device=self.device)
        return self.agent.update(action, cond, noise=noise)

    def make_train_scan(self, dataset, batch_size: int, n_steps: int):
        """`run(generator) -> log`: `n_steps` steps on device gathers (the
        frames stay uint8 until `condition_of`)."""
        return train_window(self.train_step, dataset, batch_size, n_steps, self.LOG_KEYS,
                            self.device)

    # ------------------------------------------------------------------
    def _sample(self, cond, B: int, generator, noise):
        prior = torch.zeros(self.prior_shape(B), device=self.device)
        out, _ = self._sample_fn(self.agent.ema_params, generator, prior, condition_cfg=cond,
                                 w_cfg=1.0, noise=noise)
        return self.executed(out)

    @torch.no_grad()
    def act_chunk(self, obs: Dict, generator: Optional[torch.Generator] = None, noise=None):
        """Normalised actions (B, Ta, act) for the obs dict."""
        cond = self.condition_of(obs)
        return self._sample(cond, next(iter(cond.values())).shape[0],
                            generator or self._generator, noise)

    @torch.no_grad()
    def evaluate_on_device(self, env, normalizer, num_envs: int = 8,
                           max_episode_steps: int = 300,
                           generator: Optional[torch.Generator] = None, reset_to_state=None,
                           noise=None):
        """The receding-horizon rollout on the device (module note); `noise`
        holds one sampler draw per chunk."""
        gen = generator or self._generator
        p_min, p_range = minmax_consts(normalizer["obs"]["agent_pos"], self.device)
        a_min, a_range = minmax_consts(normalizer["action"], self.device)
        state, obs = env.reset(gen, num_envs, reset_to_state)
        img, pos = rollout_windows(obs, self.To, p_min, p_range)
        best = None
        for c in range(max_episode_steps // self.Ta):
            naction = self._sample(self.condition_of({"image": img, "agent_pos": pos}),
                                   num_envs, gen, None if noise is None else noise[c])
            for a in ((naction + 1.0) / 2.0 * a_range + a_min).unbind(1):
                state, obs, rew, _ = env.step(state, a)
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

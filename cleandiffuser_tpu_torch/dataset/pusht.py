"""PushT imitation datasets (counterpart of cleandiffuser_tpu/dataset/pusht.py):
`PushTStateDataset`, `PushTKeypointDataset`, `PushTImageDataset` and
`generate_pusht_demos`.

Data source: a diffusion_policy-format zarr path (data/{action, img,
keypoint, state}, meta/episode_ends), an .npz archive of it (the JAX
package's layout, `ReplayBuffer.save_npz`), or a `ReplayBuffer`, e.g. the
demos of `generate_pusht_demos`. Windows of `horizon` steps with edge-replication
padding (`pad_before`, `pad_after`), min-max normalisers to [-1, 1].

Two access paths, as the reference's: `__getitem__` (numpy) and
`sample_batch(generator, batch_size)`, a gather on the device: every
window's padded row indices are built once, the normalised arrays live on
the device (the CUDA device unless `device` names another), and a batch is
one index draw from the explicit generator and one gather per array;
`gather(k)` takes the window indices explicitly. The image dataset keeps
its frames uint8 and channels-last on the device, as the buffer holds
them; the pipelines convert the frames they use (pipelines/dp_image.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.normalizers import DatasetMinMaxNormalizer, ImageNormalizer
from ..utils.tensors import default_device
from .base import BaseDataset, sample_indices
from .dataset_utils import SequenceSampler
from .replay_buffer import ReplayBuffer

__all__ = ["PushTStateDataset", "PushTKeypointDataset", "PushTImageDataset",
           "generate_pusht_demos", "render_buffer_images"]


def _load_buffer(dataset_path, obs_keys) -> ReplayBuffer:
    if isinstance(dataset_path, ReplayBuffer):
        return dataset_path
    path = str(dataset_path)
    if path.endswith(".npz"):
        return ReplayBuffer.load_npz(path)
    return ReplayBuffer.copy_from_path(path, keys=obs_keys)


def window_rows(indices: np.ndarray, horizon: int) -> np.ndarray:
    """(N, horizon) buffer rows of each window of `create_indices`'
    (N, 4) [buffer_start, buffer_end, sample_start, sample_end], the edges
    replicated as `SequenceSampler` pads them."""
    rows = np.empty((len(indices), horizon), np.int64)
    for r, (b_start, b_end, s_start, s_end) in zip(rows, indices):
        r[s_start:s_end] = np.arange(b_start, b_end)
        r[:s_start] = b_start
        r[s_end:] = b_end - 1
    return rows


class _PushTBase(BaseDataset):
    obs_keys: Sequence[str] = ("state", "action")

    def __init__(self, dataset_path, obs_keys=None, horizon: int = 1, pad_before: int = 0,
                 pad_after: int = 0, abs_action: bool = False, device=None):
        del abs_action
        obs_keys = list(obs_keys) if obs_keys is not None else list(self.obs_keys)
        self.replay_buffer = _load_buffer(dataset_path, obs_keys)
        self.sampler = SequenceSampler(self.replay_buffer, sequence_length=horizon,
                                       pad_before=pad_before, pad_after=pad_after, keys=obs_keys)
        self.horizon, self.pad_before, self.pad_after = horizon, pad_before, pad_after
        self.normalizer = self.get_normalizer()
        self.device = default_device(device)
        self._rows = torch.as_tensor(window_rows(self.sampler.indices, horizon),
                                     device=self.device)
        arrays = self._device_arrays()
        obs = arrays.get("obs", {"state": arrays.get("state")})
        self._store = {"obs": {k: torch.as_tensor(v, device=self.device) for k, v in obs.items()},
                       "action": torch.as_tensor(arrays["action"], device=self.device)}

    def __len__(self):
        return len(self.sampler)

    def __str__(self):
        rb = self.replay_buffer
        return f"Keys: {list(rb.keys())} Steps: {rb.n_steps} Episodes: {rb.n_episodes}"

    def _device_arrays(self) -> Dict[str, np.ndarray]:
        """The normalised per-step arrays the device store holds: "state"
        (the observation) and "action", or "obs" (a dict of observation
        arrays) and "action"."""
        raise NotImplementedError

    def gather(self, k: torch.Tensor) -> dict:
        """The windows of indices k (B,): {"obs": {"state": (B, horizon,
        obs)} (or the dataset's observation keys), "action": (B, horizon,
        act)}."""
        rows = self._rows[k.to(self.device)]
        return {"obs": {key: v[rows] for key, v in self._store["obs"].items()},
                "action": self._store["action"][rows]}

    def sample_batch(self, generator: torch.Generator, batch_size: int) -> dict:
        return self.gather(sample_indices(generator, len(self._rows), batch_size,
                                          getattr(self, "_mesh_rows", None)))


def _normalized(normalizer, x: np.ndarray) -> np.ndarray:
    return normalizer.normalize(x.astype(np.float32))


class PushTStateDataset(_PushTBase):
    obs_keys = ("state", "action")

    def get_normalizer(self):
        return {"obs": {"state": DatasetMinMaxNormalizer(self.replay_buffer["state"][:])},
                "action": DatasetMinMaxNormalizer(self.replay_buffer["action"][:])}

    def _device_arrays(self):
        return {"state": _normalized(self.normalizer["obs"]["state"], self.replay_buffer["state"]),
                "action": _normalized(self.normalizer["action"], self.replay_buffer["action"])}

    def __getitem__(self, idx):
        sample = self.sampler.sample_sequence(idx)
        return {"obs": {"state": _normalized(self.normalizer["obs"]["state"], sample["state"])},
                "action": _normalized(self.normalizer["action"], sample["action"])}


class PushTKeypointDataset(_PushTBase):
    """obs = [9 keypoints (18), agent position (2)], each part normalised
    on its own; the combined 20-dim "state" normaliser equals the two
    (per-dim min-max), so the on-device eval treats the keypoint env's
    observation like the state variant's."""

    obs_keys = ("keypoint", "state", "action")

    def get_normalizer(self):
        kp_flat = self.replay_buffer["keypoint"].reshape(len(self.replay_buffer["keypoint"]), -1)
        agent = self.replay_buffer["state"][:, :2]
        return {"obs": {"keypoint": DatasetMinMaxNormalizer(kp_flat),
                        "agent_pos": DatasetMinMaxNormalizer(agent),
                        "state": DatasetMinMaxNormalizer(np.concatenate([kp_flat, agent], -1))},
                "action": DatasetMinMaxNormalizer(self.replay_buffer["action"][:])}

    def _obs_from(self, kp, state):
        kp_n = _normalized(self.normalizer["obs"]["keypoint"], kp.reshape(kp.shape[0], -1))
        ap_n = _normalized(self.normalizer["obs"]["agent_pos"], state[:, :2])
        return np.concatenate([kp_n, ap_n], -1)

    def _device_arrays(self):
        return {"state": self._obs_from(self.replay_buffer["keypoint"],
                                        self.replay_buffer["state"]),
                "action": _normalized(self.normalizer["action"], self.replay_buffer["action"])}

    def __getitem__(self, idx):
        sample = self.sampler.sample_sequence(idx)
        return {"obs": {"state": self._obs_from(sample["keypoint"], sample["state"])},
                "action": _normalized(self.normalizer["action"], sample["action"])}


def _uint8_frames(img: np.ndarray) -> np.ndarray:
    """Frames as uint8: [0, 1] floats scaled by 255, others clipped to
    [0, 255], as the JAX datasets store them."""
    if img.dtype == np.uint8:
        return img
    return np.clip(img * 255.0 if img.max() <= 1.0 else img, 0, 255).astype(np.uint8)


def _frames_chw(img: np.ndarray) -> np.ndarray:
    """A window's frames (T, H, W, C) as float (T, C, H, W), in [0, 1]."""
    img = img.astype(np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    return np.moveaxis(img, -1, 1)


class PushTImageDataset(_PushTBase):
    """obs = {"image": the rendered frame, "agent_pos": the agent's
    position}: on the device the frames stay uint8 (H, W, C), in
    `__getitem__` float (T, C, H, W) in [0, 1], as the reference serves
    them."""

    obs_keys = ("img", "state", "action")

    def get_normalizer(self):
        return {"obs": {"image": ImageNormalizer(),
                        "agent_pos": DatasetMinMaxNormalizer(self.replay_buffer["state"][:, :2])},
                "action": DatasetMinMaxNormalizer(self.replay_buffer["action"][:])}

    def _device_arrays(self):
        return {"obs": {"image": _uint8_frames(self.replay_buffer["img"]),
                        "agent_pos": _normalized(self.normalizer["obs"]["agent_pos"],
                                                 self.replay_buffer["state"][:, :2])},
                "action": _normalized(self.normalizer["action"], self.replay_buffer["action"])}

    def __getitem__(self, idx):
        sample = self.sampler.sample_sequence(idx)
        return {"obs": {"image": _frames_chw(sample["img"]),
                        "agent_pos": _normalized(self.normalizer["obs"]["agent_pos"],
                                                 sample["state"][:, :2])},
                "action": _normalized(self.normalizer["action"], sample["action"])}


# ---------------------------------------------------------------------------
def generate_pusht_demos(n_episodes: int = 16, max_steps: int = 150, seed: int = 0,
                         expert: bool = False, mpc_kwargs: Optional[dict] = None,
                         batch: Optional[int] = None, device=None, with_images: bool = False,
                         image_size: int = 96) -> ReplayBuffer:
    """PushT demonstrations from the port's env, as a ReplayBuffer with
    "state", "action" and "keypoint" (float32), and with `with_images`
    "img", each state rendered (uint8, (image_size, image_size, 3)).

    expert=False: the scripted pusher (go behind the block, push toward the
    goal), which ignores the angle (policies trained on it reach ~12 %
    success); cheap, for the hermetic tests. It reads the state back every
    step, so it runs on the CPU whatever `device` says, as the JAX
    package's does, and renders each state before its step.

    expert=True: the CEM expert (env/pusht_expert.py) on `device` (the CUDA
    device by default), `batch` episodes per rollout (all of them by
    default); every kept episode reaches the 0.95 coverage threshold. The
    images are rendered after the rollout from the recorded observations
    (`render_buffer_images`), so the planning stays image-free.
    """
    if expert:
        from ..env.pusht_expert import generate_pusht_expert_trajectories

        episodes, _ = generate_pusht_expert_trajectories(
            n_episodes=n_episodes, max_steps=max_steps, seed=seed, batch=batch,
            mpc_kwargs=mpc_kwargs, device=device)
        episodes = [{k: np.asarray(v, np.float32) for k, v in ep.items()} for ep in episodes]
        if with_images and episodes:
            imgs = render_buffer_images(np.concatenate([ep["state"] for ep in episodes], 0),
                                        image_size, device)
            ends = np.cumsum([len(ep["state"]) for ep in episodes])
            for ep, img in zip(episodes, np.split(imgs, ends[:-1])):
                ep["img"] = img
        buffer = ReplayBuffer.create_empty_numpy()
        for ep in episodes:
            buffer.add_episode(ep)
        return buffer
    return _scripted_demos(n_episodes, max_steps, seed, with_images, image_size)


RENDER_CHUNK = 4096  # states per render call: bounds the renderer's memory


def render_buffer_images(obs: np.ndarray, image_size: int = 96, device=None) -> np.ndarray:
    """(N, 5) observations [agent xy, block xy, angle] rendered on `device`
    (the CUDA device by default), RENDER_CHUNK states per call: (N,
    image_size, image_size, 3) uint8."""
    from ..env.pusht import PushTState, render_state

    dev = default_device(device)
    out = np.zeros((len(obs), image_size, image_size, 3), np.uint8)
    for i in range(0, len(obs), RENDER_CHUNK):
        o = torch.as_tensor(obs[i:i + RENDER_CHUNK], dtype=torch.float32, device=dev)
        state = PushTState(o[:, :2], torch.zeros_like(o[:, :2]), o[:, 2:4], o[:, 4])
        out[i:i + len(o)] = render_state(state, image_size).cpu().numpy()
    return out


def _scripted_demos(n_episodes: int, max_steps: int, seed: int, with_images: bool = False,
                    image_size: int = 96) -> ReplayBuffer:
    from ..env.pusht import GOAL_POSE, PushTEnv, render_state

    env = PushTEnv(device="cpu")
    generator = torch.Generator().manual_seed(seed)
    buffer = ReplayBuffer.create_empty_numpy()
    goal = GOAL_POSE[:2]
    for _ in range(n_episodes):
        state, obs = env.reset(generator, 1)
        states, actions, keypoints, imgs = [], [], [], []
        for _ in range(max_steps):
            block = state.block_pos[0].numpy()
            d = goal - block
            d = d / (np.linalg.norm(d) + 1e-6)
            target = block - d * 40.0  # a point behind the block on the block-goal line
            agent = state.agent_pos[0].numpy()
            to_target = target - agent
            if np.linalg.norm(to_target) > 20.0:
                action = agent + to_target * 0.5
            else:
                action = block + d * 30.0  # push through the block
            action = np.clip(action, 10.0, 500.0)[None].astype(np.float32)
            states.append(env.get_obs(state)[0].numpy())
            actions.append(action[0])
            keypoints.append(env.keypoints(state)[0].numpy())
            if with_images:
                imgs.append(render_state(state, image_size)[0].numpy())
            state, obs, rew, done = env.step(state, torch.from_numpy(action))
            if bool(done[0]):
                break
        episode = {"state": np.asarray(states, np.float32),
                   "action": np.asarray(actions, np.float32),
                   "keypoint": np.asarray(keypoints, np.float32)}
        if with_images:
            episode["img"] = np.asarray(imgs, np.uint8)
        buffer.add_episode(episode)
    return buffer

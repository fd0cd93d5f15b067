"""Robomimic imitation datasets (counterpart of
cleandiffuser_tpu/dataset/robomimic.py): `RobomimicDataset` (low-dim),
`RobomimicImageDataset` (camera frames too) and `RobomimicTDDataset`
(transitions), with `abs_action_transform` / `undo_transform_action`.

Data source: a robomimic hdf5 file (data/demo_<i>/obs/<key>,
data/demo_<i>/actions, read with h5py: the observation keys concatenated
into "obs"), or a `ReplayBuffer` already in that layout (e.g.
`fake_robomimic_buffer`, which the CLIs use where the file is missing).
With `abs_action` the hdf5's actions go from pos + axis-angle + gripper to
pos + rotation_6d + gripper (7 -> 10 dims, dual-arm 14 -> 20); a buffer is
taken as it is, as the reference takes it.

The windows and the device store are those of dataset/pusht.py: min-max
normalisers to [-1, 1] for "state" (the concatenated obs) and "action",
and for the image variant the frames uint8 and channels-last on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..utils.normalizers import DatasetMinMaxNormalizer, ImageNormalizer
from .dataset_utils import RotationTransformer
from .pusht import _frames_chw, _normalized, _PushTBase, _uint8_frames
from .replay_buffer import ReplayBuffer

__all__ = ["RobomimicDataset", "RobomimicImageDataset", "RobomimicTDDataset",
           "abs_action_transform", "undo_transform_action", "LOWDIM_OBS_KEYS",
           "IMAGE_LOWDIM_KEYS"]

LOWDIM_OBS_KEYS = ("object", "robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos")
IMAGE_LOWDIM_KEYS = ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos")


def abs_action_transform(raw_actions: np.ndarray, rt: RotationTransformer) -> np.ndarray:
    """pos + axis-angle + gripper -> pos + rotation_6d + gripper, per arm."""
    is_dual_arm = raw_actions.shape[-1] == 14
    if is_dual_arm:
        raw_actions = raw_actions.reshape(-1, 2, 7)
    pos, rot, gripper = raw_actions[..., :3], raw_actions[..., 3:6], raw_actions[..., 6:]
    out = np.concatenate([pos, rt.forward(rot), gripper], axis=-1).astype(np.float32)
    return out.reshape(-1, 20) if is_dual_arm else out


def undo_transform_action(action: np.ndarray, rt: RotationTransformer) -> np.ndarray:
    """rotation_6d back to axis-angle, before `env.step`."""
    raw_shape = action.shape
    if raw_shape[-1] == 20:
        action = action.reshape(-1, 2, 10)
    d_rot = action.shape[-1] - 4
    pos, rot, gripper = action[..., :3], action[..., 3:3 + d_rot], action[..., -1:]
    uaction = np.concatenate([pos, rt.inverse(rot), gripper], axis=-1)
    if raw_shape[-1] == 20:
        uaction = uaction.reshape(*raw_shape[:-1], 14)
    return uaction


def _load_robomimic_buffer(dataset_dir, obs_keys, abs_action: bool, rt,
                           image_keys: Sequence[str] = ()) -> ReplayBuffer:
    if isinstance(dataset_dir, ReplayBuffer):
        return dataset_dir
    import h5py

    rb = ReplayBuffer.create_empty_numpy()
    with h5py.File(dataset_dir) as file:
        demos = file["data"]
        for i in range(len(demos)):
            demo = demos[f"demo_{i}"]
            obs = np.concatenate([demo["obs"][key] for key in obs_keys],
                                 axis=-1).astype(np.float32)
            actions = demo["actions"][:].astype(np.float32)
            if abs_action:
                actions = abs_action_transform(actions, rt)
            episode = {"obs": obs, "action": actions}
            for k in image_keys:
                episode[k] = np.asarray(demo["obs"][k])
            rb.add_episode(episode)
    return rb


class RobomimicDataset(_PushTBase):
    """Low-dim robomimic demos as state / action windows."""

    def __init__(self, dataset_dir, horizon: int = 1, pad_before: int = 0, pad_after: int = 0,
                 obs_keys=LOWDIM_OBS_KEYS, abs_action: bool = False,
                 rotation_rep: str = "rotation_6d", device=None):
        self.rotation_transformer = RotationTransformer("axis_angle", rotation_rep)
        rb = _load_robomimic_buffer(dataset_dir, obs_keys, abs_action, self.rotation_transformer)
        self.abs_action = abs_action
        super().__init__(rb, obs_keys=["obs", "action"], horizon=horizon, pad_before=pad_before,
                         pad_after=pad_after, device=device)

    def undo_transform_action(self, action):
        return undo_transform_action(np.asarray(action), self.rotation_transformer)

    def get_normalizer(self):
        return {"obs": {"state": DatasetMinMaxNormalizer(self.replay_buffer["obs"][:])},
                "action": DatasetMinMaxNormalizer(self.replay_buffer["action"][:])}

    def _device_arrays(self):
        return {"state": _normalized(self.normalizer["obs"]["state"], self.replay_buffer["obs"]),
                "action": _normalized(self.normalizer["action"], self.replay_buffer["action"])}

    def __getitem__(self, idx):
        sample = self.sampler.sample_sequence(idx)
        return {"obs": {"state": _normalized(self.normalizer["obs"]["state"], sample["obs"])},
                "action": _normalized(self.normalizer["action"], sample["action"])}


class RobomimicImageDataset(RobomimicDataset):
    """Robomimic demos with camera frames: each window's obs holds "state"
    (the low-dim keys concatenated, normalised) and one entry per image
    key (uint8 (H, W, C) on the device; float (T, C, H, W) in [0, 1] from
    `__getitem__`)."""

    def __init__(self, dataset_dir, horizon: int = 1, pad_before: int = 0, pad_after: int = 0,
                 obs_keys=IMAGE_LOWDIM_KEYS, image_keys=("agentview_image",),
                 abs_action: bool = False, rotation_rep: str = "rotation_6d", device=None):
        self.rotation_transformer = RotationTransformer("axis_angle", rotation_rep)
        rb = _load_robomimic_buffer(dataset_dir, obs_keys, abs_action, self.rotation_transformer,
                                    image_keys)
        self.abs_action = abs_action
        self.image_keys = list(image_keys)
        _PushTBase.__init__(self, rb, obs_keys=["obs", "action"] + self.image_keys,
                            horizon=horizon, pad_before=pad_before, pad_after=pad_after,
                            device=device)

    def get_normalizer(self):
        norm = super().get_normalizer()
        norm["obs"]["image"] = ImageNormalizer()
        return norm

    def _device_arrays(self):
        arrays = super()._device_arrays()
        obs = {"state": arrays["state"]}
        obs.update({k: _uint8_frames(self.replay_buffer[k]) for k in self.image_keys})
        return {"obs": obs, "action": arrays["action"]}

    def __getitem__(self, idx):
        sample = self.sampler.sample_sequence(idx)
        out = {"obs": {"state": _normalized(self.normalizer["obs"]["state"], sample["obs"])},
               "action": _normalized(self.normalizer["action"], sample["action"])}
        for k in self.image_keys:
            out["obs"][k] = _frames_chw(sample[k])
        return out


class RobomimicTDDataset(RobomimicDataset):
    """Transitions of the low-dim demos for RL: (obs, next_obs, act) of
    each 2-step window, with zero reward and terminal, as the reference's."""

    def __init__(self, dataset_dir, reward_mode: str = "sparse", **kwargs):
        super().__init__(dataset_dir, horizon=2, **kwargs)
        self.reward_mode = reward_mode

    def __getitem__(self, idx):
        sample = self.sampler.sample_sequence(idx)
        obs = _normalized(self.normalizer["obs"]["state"], sample["obs"])
        act = _normalized(self.normalizer["action"], sample["action"])
        return {"obs": {"state": obs[0]}, "next_obs": {"state": obs[1]}, "act": act[0],
                "rew": np.zeros((1,), np.float32), "tml": np.zeros((1,), np.float32)}

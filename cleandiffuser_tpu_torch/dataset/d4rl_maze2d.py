"""D4RL-Maze2D datasets of Diffusion Veteran (counterpart of
cleandiffuser_tpu/dataset/d4rl_maze2d.py).

Maze2d specifics, in numpy on the host as the JAX package computes them:
the episodes are goal-reaching segments found by scanning backwards for
reward == 1 events (segments longer than `max_path_length` keep their
last steps; a stream with no goal event is chopped into fixed-length
windows instead); `learn_policy=True` chops fixed `max_path_length`
windows and recenters each window's x-y at its start; the IQL reward tune
(r - 1); a Monte-Carlo value mapped to [0, 1], or [-1, 1] with
`center_mapping`. Batches come from `__getitem__` (numpy) or from
`sample_batch(generator, batch_size)`, a gather on the device-resident
store (dataset/base.py), on the CUDA device unless `device` names another.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..utils.normalizers import GaussianNormalizer
from .base import BaseDataset, DeviceSeqSampler, DeviceTDSampler, sample_indices
from .d4rl_mujoco import D4RLMuJoCoDataset, D4RLMuJoCoTDDataset

__all__ = ["DV_D4RLMaze2DSeqDataset", "D4RLMaze2DTDDataset"]


def _goal_segments(rewards: np.ndarray, max_path_length: int):
    """(start, end) of each goal-reaching segment: from the step after a
    goal event (or the stream's start) to the next goal event, cut to its
    last `max_path_length` steps."""
    N = rewards.shape[0]
    next_end = [-1] * (N + 1)
    next_start = [-1] * (N + 1)
    for index in reversed(range(N)):
        if rewards[index] == 1.0:
            next_end[index] = index
            next_start[index] = next_start[index + 1]
        else:
            next_end[index] = next_end[index + 1]
            next_start[index] = index
    segments = []
    path_start = next_start[0]
    path_end = next_end[path_start] if path_start != -1 else -1
    while path_end != -1:
        path_start = max(path_start, path_end - max_path_length + 1)
        assert path_end - path_start + 1 >= 2
        segments.append((path_start, path_end))
        path_start = next_start[path_end]
        path_end = next_end[path_start] if path_start != -1 else -1
    return segments


class DV_D4RLMaze2DSeqDataset(BaseDataset):
    def __init__(
        self,
        dataset: Dict[str, np.ndarray],
        horizon: int = 1,
        max_path_length: int = 300,
        discount: float = 0.99,
        continous_reward_at_done: bool = False,
        center_mapping: bool = True,
        reward_tune: str = "none",
        stride: int = 1,
        learn_policy: bool = False,
        device=None,
    ):
        observations, actions, rewards = (
            dataset["observations"].astype(np.float32),
            dataset["actions"].astype(np.float32),
            dataset["rewards"].astype(np.float32),
        )
        self.stride, self.horizon = stride, horizon
        self.learn_policy = learn_policy
        self.o_dim, self.a_dim = observations.shape[-1], actions.shape[-1]
        self.normalizers = {"state": GaussianNormalizer(observations, start_dim=1)}
        normed_observations = self.normalizers["state"].normalize(observations)

        N = rewards.shape[0]
        pad = (horizon - 1) * stride
        seq_obs, seq_act, seq_rew, indices = [], [], [], []

        def add_path(path_start, path_end):
            path_length = path_end - path_start + 1
            _o = np.zeros((max_path_length + pad, self.o_dim), np.float32)
            _a = np.zeros((max_path_length + pad, self.a_dim), np.float32)
            _r = np.zeros((max_path_length + pad, 1), np.float32)
            _o[:path_length] = normed_observations[path_start:path_end + 1]
            _a[:path_length] = actions[path_start:path_end + 1]
            _r[:path_length] = rewards[path_start:path_end + 1][:, None]
            _o[path_length:] = normed_observations[path_end]
            _r[path_length:] = 1.0 if continous_reward_at_done else 0.0
            indices.extend((len(seq_obs), s) for s in range(path_length))
            seq_obs.append(_o)
            seq_act.append(_a)
            seq_rew.append(_r)

        def chop(last_start):
            for path_start in range(0, last_start, max_path_length):
                add_path(path_start, min(path_start + max_path_length - 1, N - 1))

        if learn_policy:
            chop(N)
        else:
            for start, end in _goal_segments(rewards, max_path_length):
                add_path(start, end)
            if not seq_obs:
                # no goal event in the stream (e.g. the synthetic fallback)
                print("[DV_D4RLMaze2DSeqDataset] no goal-reaching segments "
                      "found; falling back to fixed-length chunking")
                chop(N - 1)

        self.seq_obs = np.array(seq_obs, np.float32)
        self.seq_act = np.array(seq_act, np.float32)
        self.seq_rew = np.array(seq_rew, np.float32)
        self.indices = np.asarray(indices, np.int32)

        if reward_tune == "iql":
            self.seq_rew += -1
        elif reward_tune != "none":
            raise ValueError(f"reward_tune: {reward_tune} is not supported.")

        self.seq_val = np.copy(self.seq_rew)
        for i in reversed(range(max_path_length - 1)):
            self.seq_val[:, i] = self.seq_rew[:, i] + discount * self.seq_val[:, i + 1]
        vmin, vmax = self.seq_val.min(), self.seq_val.max()
        self.seq_val = (self.seq_val - vmin) / max(vmax - vmin, 1e-8)
        if center_mapping:
            self.seq_val = self.seq_val * 2 - 1

        self._sampler = DeviceSeqSampler(
            {"obs": self.seq_obs, "act": self.seq_act, "rew": self.seq_rew},
            self.indices, horizon, stride=stride, scalars={"val": self.seq_val}, device=device,
        )

    def get_normalizer(self):
        return self.normalizers["state"]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int):
        path_idx, start = self.indices[idx]
        end = start + (self.horizon - 1) * self.stride + 1
        state = self.seq_obs[path_idx, start:end:self.stride]
        if self.learn_policy:
            state = state.copy()
            state[:, :2] -= state[0, :2]
        return {
            "obs": {"state": state},
            "act": self.seq_act[path_idx, start:end:self.stride],
            "rew": self.seq_rew[path_idx, start:end:self.stride],
            "val": self.seq_val[path_idx, start],
        }

    def gather(self, k):
        """The batch of index rows `k` (B,); `learn_policy` recentres each
        window's x-y at its start."""
        batch = D4RLMuJoCoDataset.batch(self._sampler.gather(k))
        if self.learn_policy:
            obs = batch["obs"]["state"].clone()
            obs[..., :2] -= obs[:, :1, :2].clone()
            batch["obs"]["state"] = obs
        return batch

    def sample_batch(self, generator, batch_size: int):
        return self.gather(sample_indices(generator, len(self.indices), batch_size,
                                          getattr(self, "_mesh_rows", None)))


class D4RLMaze2DTDDataset(BaseDataset):
    """TD transitions: the next observation is the stream's next step (or
    the dataset's `next_observations`), a goal event is terminal, and the
    IQL reward tune is r - 1."""

    def __init__(self, dataset: Dict[str, np.ndarray], reward_tune: str = "none", device=None):
        observations, actions, rewards = (
            dataset["observations"].astype(np.float32),
            dataset["actions"].astype(np.float32),
            dataset["rewards"].astype(np.float32),
        )
        next_observations = np.concatenate([observations[1:], observations[-1:]], 0)
        if "next_observations" in dataset:
            next_observations = dataset["next_observations"].astype(np.float32)
        terminals = (rewards == 1.0).astype(np.float32)
        if reward_tune == "iql":
            rewards = rewards - 1.0

        self.normalizers = {"state": GaussianNormalizer(observations, start_dim=1)}
        self.obs = self.normalizers["state"].normalize(observations)
        self.next_obs = self.normalizers["state"].normalize(next_observations)
        self.act, self.rew, self.tml = actions, rewards[:, None], terminals[:, None]
        self.size = self.obs.shape[0]
        self.o_dim, self.a_dim = observations.shape[-1], actions.shape[-1]
        self._sampler = DeviceTDSampler(
            {"obs": self.obs, "next_obs": self.next_obs, "act": self.act,
             "rew": self.rew, "tml": self.tml}, device=device,
        )

    def get_normalizer(self):
        return self.normalizers["state"]

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int):
        return {
            "obs": {"state": self.obs[idx]},
            "next_obs": {"state": self.next_obs[idx]},
            "act": self.act[idx], "rew": self.rew[idx], "tml": self.tml[idx],
        }

    def sample_batch(self, generator, batch_size: int):
        return D4RLMuJoCoTDDataset.batch(self._sampler.sample(generator, batch_size))

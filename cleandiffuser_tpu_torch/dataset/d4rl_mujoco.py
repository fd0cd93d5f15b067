"""D4RL-MuJoCo datasets: sequence, TD, multi-horizon and DV variants
(counterpart of cleandiffuser_tpu/dataset/d4rl_mujoco.py).

Episode chunking, Gaussian obs normalization, the terminal penalty and the
backward Monte-Carlo value recursion are the reference's, in numpy on the
host; batches come from `__getitem__` (numpy) or from `sample_batch(
generator, batch_size)`, a gather on the device-resident store
(dataset/base.py), on the CUDA device unless `device` names another.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..utils.normalizers import GaussianNormalizer
from .base import BaseDataset, DeviceSeqSampler, DeviceTDSampler

__all__ = [
    "D4RLMuJoCoDataset",
    "D4RLMuJoCoTDDataset",
    "MultiHorizonD4RLMuJoCoDataset",
    "DV_D4RLMuJoCoSeqDataset",
    "return_reward_range",
    "modify_reward",
]


def return_reward_range(dataset, max_episode_steps):
    """Range of episodic returns, with episodes cut at terminals and at the
    max_episode_steps cap (episode starts from flatnonzero(terminals) plus
    cap-sized splits of each terminal-free stretch, returns by one
    add.reduceat)."""
    rewards = np.asarray(dataset["rewards"], np.float64).ravel()
    terminals = np.asarray(dataset["terminals"], bool).ravel()
    n = rewards.shape[0]
    seg = np.concatenate(([0], np.flatnonzero(terminals) + 1, [n]))
    starts = np.concatenate([np.arange(lo, hi, max_episode_steps)
                             for lo, hi in zip(seg[:-1], seg[1:]) if lo < hi])
    returns = np.add.reduceat(rewards, starts)
    if not terminals[-1] and n - starts[-1] < max_episode_steps:
        returns = returns[:-1]  # unterminated trailing stub: not an episode
    return float(returns.min()), float(returns.max())


def modify_reward(dataset, max_episode_steps=1000):
    """Antmaze-style IQL reward scaling: divide by the return spread so one
    full traversal of the return range is worth max_episode_steps."""
    min_ret, max_ret = return_reward_range(dataset, max_episode_steps)
    dataset["rewards"] = dataset["rewards"] / (max_ret - min_ret) * max_episode_steps
    return dataset


def _mc_value_backward(seq_rew: np.ndarray, discount: float) -> np.ndarray:
    """Backward discounted-return recursion over the time axis."""
    seq_val = np.copy(seq_rew)
    for i in reversed(range(seq_rew.shape[1] - 1)):
        seq_val[:, i] = seq_rew[:, i] + discount * seq_val[:, i + 1]
    return seq_val


class D4RLMuJoCoDataset(BaseDataset):
    """Sequence dataset: (b,H,o), (b,H,a), (b,H,1), val (b,1)."""

    def __init__(
        self,
        dataset: Dict[str, np.ndarray],
        terminal_penalty: float = -100.0,
        horizon: int = 1,
        max_path_length: int = 1000,
        discount: float = 0.99,
        device=None,
    ):
        observations, actions, rewards, timeouts, terminals = (
            dataset["observations"].astype(np.float32),
            dataset["actions"].astype(np.float32),
            dataset["rewards"].astype(np.float32).copy(),
            dataset["timeouts"],
            dataset["terminals"],
        )
        self.normalizers = {"state": GaussianNormalizer(observations, start_dim=1)}
        normed_observations = self.normalizers["state"].normalize(observations)

        self.horizon = horizon
        self.o_dim, self.a_dim = observations.shape[-1], actions.shape[-1]

        n_paths = int(np.sum(np.logical_or(terminals, timeouts)))
        self.seq_obs = np.zeros((n_paths, max_path_length, self.o_dim), np.float32)
        self.seq_act = np.zeros((n_paths, max_path_length, self.a_dim), np.float32)
        self.seq_rew = np.zeros((n_paths, max_path_length, 1), np.float32)
        self.tml_and_not_timeout = []
        indices = []

        path_lengths, ptr, path_idx = [], 0, 0
        for i in range(timeouts.shape[0]):
            if timeouts[i] or terminals[i]:
                path_lengths.append(i - ptr + 1)
                if terminals[i] and not timeouts[i]:
                    rewards[i] = terminal_penalty if terminal_penalty is not None else rewards[i]
                    self.tml_and_not_timeout.append([path_idx, i - ptr])
                self.seq_obs[path_idx, : i - ptr + 1] = normed_observations[ptr : i + 1]
                self.seq_act[path_idx, : i - ptr + 1] = actions[ptr : i + 1]
                self.seq_rew[path_idx, : i - ptr + 1] = rewards[ptr : i + 1][:, None]
                max_start = min(path_lengths[-1] - 1, max_path_length - horizon)
                indices += [(path_idx, start) for start in range(max_start + 1)]
                ptr = i + 1
                path_idx += 1

        self.seq_val = _mc_value_backward(self.seq_rew, discount)
        self.path_lengths = np.array(path_lengths)
        self.tml_and_not_timeout = np.array(self.tml_and_not_timeout, np.int64)
        self.indices = np.asarray(indices, np.int32)

        self._sampler = DeviceSeqSampler(
            {"obs": self.seq_obs, "act": self.seq_act, "rew": self.seq_rew},
            self.indices,
            horizon,
            scalars={"val": self.seq_val},
            device=device,
        )

    def get_normalizer(self):
        return self.normalizers["state"]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int):
        path_idx, start = self.indices[idx]
        end = start + self.horizon
        return {
            "obs": {"state": self.seq_obs[path_idx, start:end]},
            "act": self.seq_act[path_idx, start:end],
            "rew": self.seq_rew[path_idx, start:end],
            "val": self.seq_val[path_idx, start],
        }

    def sample_batch(self, generator, batch_size: int):
        return self.batch(self._sampler.sample(generator, batch_size))

    @staticmethod
    def batch(out):
        """The sampler's gather as the dataset's batch dict."""
        return {"obs": {"state": out["obs"]}, "act": out["act"], "rew": out["rew"],
                "val": out["val"]}


class D4RLMuJoCoTDDataset(BaseDataset):
    """Transition dataset."""

    def __init__(self, dataset: Dict[str, np.ndarray], normalize_reward: bool = False,
                 device=None):
        if normalize_reward:
            dataset = modify_reward(dataset, 1000)

        observations, actions, next_observations, rewards, terminals = (
            dataset["observations"].astype(np.float32),
            dataset["actions"].astype(np.float32),
            dataset["next_observations"].astype(np.float32),
            dataset["rewards"].astype(np.float32),
            dataset["terminals"].astype(np.float32),
        )
        self.normalizers = {"state": GaussianNormalizer(observations, start_dim=1)}
        self.obs = self.normalizers["state"].normalize(observations)
        self.next_obs = self.normalizers["state"].normalize(next_observations)
        self.act = actions
        self.rew = rewards[:, None]
        self.tml = terminals[:, None]
        self.size = self.obs.shape[0]
        self.o_dim, self.a_dim = observations.shape[-1], actions.shape[-1]

        self._sampler = DeviceTDSampler(
            {
                "obs": self.obs,
                "next_obs": self.next_obs,
                "act": self.act,
                "rew": self.rew,
                "tml": self.tml,
            },
            device=device,
        )

    def get_normalizer(self):
        return self.normalizers["state"]

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int):
        return {
            "obs": {"state": self.obs[idx]},
            "next_obs": {"state": self.next_obs[idx]},
            "act": self.act[idx],
            "rew": self.rew[idx],
            "tml": self.tml[idx],
        }

    def sample_batch(self, generator, batch_size: int):
        return self.batch(self._sampler.sample(generator, batch_size))

    @staticmethod
    def batch(out):
        """The sampler's gather as the dataset's batch dict."""
        return {"obs": {"state": out["obs"]}, "next_obs": {"state": out["next_obs"]},
                "act": out["act"], "rew": out["rew"], "tml": out["tml"]}


class MultiHorizonD4RLMuJoCoDataset(BaseDataset):
    """Multi-horizon variant for DiffuserLite."""

    def __init__(
        self,
        dataset,
        terminal_penalty: float = -100.0,
        horizons: Sequence[int] = (10, 20),
        max_path_length: int = 1000,
        discount: float = 0.99,
        device=None,
    ):
        # the base's own store is built on the CPU and dropped
        base = D4RLMuJoCoDataset(
            dataset, terminal_penalty, max(horizons), max_path_length, discount, device="cpu"
        )
        self.normalizers = base.normalizers
        self.horizons = tuple(horizons)
        self.o_dim, self.a_dim = base.o_dim, base.a_dim
        self.seq_obs, self.seq_act = base.seq_obs, base.seq_act
        self.seq_val = base.seq_val
        self.path_lengths = base.path_lengths

        self.indices = []
        for horizon in self.horizons:
            idxs = []
            for path_idx, plen in enumerate(self.path_lengths):
                max_start = min(plen - 1, max_path_length - horizon)
                idxs += [(path_idx, s) for s in range(max_start + 1)]
            self.indices.append(np.asarray(idxs, np.int32))
        self.len_each_horizon = [len(i) for i in self.indices]

        self._samplers = [
            DeviceSeqSampler(
                {"obs": self.seq_obs, "act": self.seq_act},
                idxs,
                horizon,
                scalars={"val": self.seq_val},
                device=device,
            )
            for idxs, horizon in zip(self.indices, self.horizons)
        ]

    def get_normalizer(self):
        return self.normalizers["state"]

    def __len__(self):
        return max(self.len_each_horizon)

    def __getitem__(self, idx: int):
        indices = [
            int(self.len_each_horizon[i] * (idx / self.len_each_horizon[-1]))
            for i in range(len(self.horizons))
        ]
        out = []
        for i, horizon in enumerate(self.horizons):
            path_idx, start = self.indices[i][indices[i]]
            out.append(
                {
                    "horizon": horizon,
                    "data": {
                        "obs": {"state": self.seq_obs[path_idx, start : start + horizon]},
                        "act": self.seq_act[path_idx, start : start + horizon],
                        "val": self.seq_val[path_idx, start],
                    },
                }
            )
        return out

    def sample_batch(self, generator, batch_size: int, horizon_idx: int = 0):
        out = self._samplers[horizon_idx].sample(generator, batch_size)
        return {"obs": {"state": out["obs"]}, "act": out["act"], "val": out["val"]}


class DV_D4RLMuJoCoSeqDataset(BaseDataset):
    """Diffusion-Veteran variant: stride + [-1,1]-normalized value."""

    def __init__(
        self,
        dataset: Dict[str, np.ndarray],
        terminal_penalty: float = -100,
        horizon: int = 1,
        max_path_length: int = 1000,
        discount: float = 0.99,
        center_mapping: bool = True,
        stride: int = 1,
        full_traj_bonus: float = 100,
        device=None,
    ):
        observations, actions, rewards, timeouts, terminals = (
            dataset["observations"].astype(np.float32),
            dataset["actions"].astype(np.float32),
            dataset["rewards"].astype(np.float32).copy(),
            dataset["timeouts"].astype(np.float32),
            dataset["terminals"].astype(np.float32),
        )
        self.stride = stride
        self.normalizers = {"state": GaussianNormalizer(observations, start_dim=1)}
        normed_observations = self.normalizers["state"].normalize(observations)

        self.horizon = horizon
        self.o_dim, self.a_dim = observations.shape[-1], actions.shape[-1]

        n_paths = int(np.sum(np.logical_or(terminals, timeouts)))
        self.seq_obs = np.zeros((n_paths + 1, max_path_length, self.o_dim), np.float32)
        self.seq_act = np.zeros((n_paths + 1, max_path_length, self.a_dim), np.float32)
        self.seq_rew = np.zeros((n_paths + 1, max_path_length, 1), np.float32)
        indices = []

        ptr, path_idx = 0, 0
        for i in range(timeouts.shape[0]):
            if timeouts[i] or terminals[i] or i == timeouts.shape[0] - 1:
                path_length = i - ptr + 1
                assert path_length <= max_path_length
                if terminals[i]:
                    rewards[i] = terminal_penalty if terminal_penalty is not None else rewards[i]
                if path_length == max_path_length and full_traj_bonus is not None:
                    rewards[i] = rewards[i] + full_traj_bonus
                self.seq_obs[path_idx, :path_length] = normed_observations[ptr : i + 1]
                self.seq_act[path_idx, :path_length] = actions[ptr : i + 1]
                self.seq_rew[path_idx, :path_length] = rewards[ptr : i + 1][:, None]
                max_start = path_length - (horizon - 1) * stride - 1
                indices += [(path_idx, s) for s in range(max_start + 1)]
                ptr = i + 1
                path_idx += 1

        self.seq_val = _mc_value_backward(self.seq_rew, discount)
        vmin, vmax = self.seq_val.min(), self.seq_val.max()
        self.seq_val = (self.seq_val - vmin) / (vmax - vmin)
        if center_mapping:
            self.seq_val = self.seq_val * 2 - 1
        self.indices = np.asarray(indices, np.int32)

        self._sampler = DeviceSeqSampler(
            {"obs": self.seq_obs, "act": self.seq_act, "rew": self.seq_rew},
            self.indices,
            horizon,
            stride=stride,
            scalars={"val": self.seq_val},
            device=device,
        )

    def get_normalizer(self):
        return self.normalizers["state"]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int):
        path_idx, start = self.indices[idx]
        end = start + (self.horizon - 1) * self.stride + 1
        return {
            "obs": {"state": self.seq_obs[path_idx, start : end : self.stride]},
            "act": self.seq_act[path_idx, start : end : self.stride],
            "rew": self.seq_rew[path_idx, start : end : self.stride],
            "val": self.seq_val[path_idx, start],
        }

    def sample_batch(self, generator, batch_size: int):
        return D4RLMuJoCoDataset.batch(self._sampler.sample(generator, batch_size))

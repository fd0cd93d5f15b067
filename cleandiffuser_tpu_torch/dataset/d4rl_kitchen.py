"""D4RL-Kitchen datasets: sequence, TD, multi-horizon and DV variants
(counterpart of cleandiffuser_tpu/dataset/d4rl_kitchen.py).

Kitchen specifics, in numpy on the host as the JAX package computes them:
an episode ends at a timeout, a terminal or the last index; short episodes
are padded by repeating the last obs and the last REWARD (antmaze pads the
reward with zeros), with zero actions; paths are 280 steps. Batches come
from `__getitem__` (numpy) or from `sample_batch(generator, batch_size)`,
a gather on the device-resident store (dataset/base.py), on the CUDA
device unless `device` names another.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..utils.normalizers import GaussianNormalizer
from .base import BaseDataset, DeviceSeqSampler, DeviceTDSampler
from .d4rl_mujoco import D4RLMuJoCoDataset, D4RLMuJoCoTDDataset, _mc_value_backward

__all__ = [
    "D4RLKitchenDataset",
    "D4RLKitchenTDDataset",
    "MultiHorizonD4RLKitchenDataset",
    "DV_D4RLKitchenSeqDataset",
]


def _chunk_kitchen(observations, actions, rewards, timeouts, terminals,
                   max_path_length, normalizer):
    normed_observations = normalizer.normalize(observations)
    o_dim, a_dim = observations.shape[-1], actions.shape[-1]

    seq_obs, seq_act, seq_rew = [], [], []
    path_lengths, tml = [], []
    ptr, path_idx = 0, 0
    for i in range(timeouts.shape[0]):
        if timeouts[i] or terminals[i] or i == timeouts.shape[0] - 1:
            path_lengths.append(i - ptr + 1)
            if terminals[i] and not timeouts[i]:
                tml.append([path_idx, i - ptr])

            _o = np.zeros((max_path_length, o_dim), np.float32)
            _a = np.zeros((max_path_length, a_dim), np.float32)
            _r = np.zeros((max_path_length, 1), np.float32)
            _o[: i - ptr + 1] = normed_observations[ptr : i + 1]
            _a[: i - ptr + 1] = actions[ptr : i + 1]
            _r[: i - ptr + 1] = rewards[ptr : i + 1][:, None]
            _o[i - ptr + 1 :] = normed_observations[i]
            _r[i - ptr + 1 :] = rewards[i]  # repeat last reward
            seq_obs.append(_o)
            seq_act.append(_a)
            seq_rew.append(_r)
            ptr = i + 1
            path_idx += 1

    return (
        np.array(seq_obs, np.float32),
        np.array(seq_act, np.float32),
        np.array(seq_rew, np.float32),
        path_lengths,
        np.array(tml, np.int64),
    )


class D4RLKitchenDataset(BaseDataset):
    def __init__(
        self,
        dataset: Dict[str, np.ndarray],
        horizon: int = 1,
        max_path_length: int = 280,
        discount: float = 0.99,
        device=None,
    ):
        observations, actions, rewards, timeouts, terminals = (
            dataset["observations"].astype(np.float32),
            dataset["actions"].astype(np.float32),
            dataset["rewards"].astype(np.float32),
            dataset["timeouts"],
            dataset["terminals"],
        )
        self.normalizers = {"state": GaussianNormalizer(observations, start_dim=1)}
        self.horizon = horizon
        self.o_dim, self.a_dim = observations.shape[-1], actions.shape[-1]

        (self.seq_obs, self.seq_act, self.seq_rew, self.path_lengths,
         self.tml_and_not_timeout) = _chunk_kitchen(
            observations, actions, rewards, timeouts, terminals,
            max_path_length, self.normalizers["state"],
        )
        indices = []
        for path_idx, plen in enumerate(self.path_lengths):
            max_start = min(plen - 1, max_path_length - horizon)
            indices += [(path_idx, s) for s in range(max_start + 1)]
        self.indices = np.asarray(indices, np.int32)
        self.seq_val = _mc_value_backward(self.seq_rew, discount)

        self._sampler = DeviceSeqSampler(
            {"obs": self.seq_obs, "act": self.seq_act, "rew": self.seq_rew},
            self.indices, horizon, scalars={"val": self.seq_val}, device=device,
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
        return D4RLMuJoCoDataset.batch(self._sampler.sample(generator, batch_size))


class D4RLKitchenTDDataset(BaseDataset):
    """Transition dataset."""

    def __init__(self, dataset: Dict[str, np.ndarray], device=None):
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


class MultiHorizonD4RLKitchenDataset(BaseDataset):
    def __init__(
        self,
        dataset,
        horizons: Sequence[int] = (10, 20),
        max_path_length: int = 280,
        discount: float = 0.99,
        device=None,
    ):
        # the base's own store is built on the CPU and dropped
        base = D4RLKitchenDataset(dataset, max(horizons), max_path_length, discount, device="cpu")
        self.normalizers = base.normalizers
        self.horizons = tuple(horizons)
        self.o_dim, self.a_dim = base.o_dim, base.a_dim
        self.seq_obs, self.seq_act, self.seq_val = base.seq_obs, base.seq_act, base.seq_val
        self.seq_rew = base.seq_rew
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
                {"obs": self.seq_obs, "act": self.seq_act}, idxs, horizon,
                scalars={"val": self.seq_val}, device=device,
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
            out.append({
                "horizon": horizon,
                "data": {
                    "obs": {"state": self.seq_obs[path_idx, start:start + horizon]},
                    "act": self.seq_act[path_idx, start:start + horizon],
                    "val": self.seq_val[path_idx, start],
                },
            })
        return out

    def sample_batch(self, generator, batch_size: int, horizon_idx: int = 0):
        out = self._samplers[horizon_idx].sample(generator, batch_size)
        return {"obs": {"state": out["obs"]}, "act": out["act"], "val": out["val"]}


class DV_D4RLKitchenSeqDataset(BaseDataset):
    """Diffusion-Veteran kitchen variant with stride and [0/-1,1] value."""

    def __init__(
        self,
        dataset: Dict[str, np.ndarray],
        horizon: int = 1,
        max_path_length: int = 280,
        discount: float = 0.99,
        center_mapping: bool = True,
        stride: int = 1,
        device=None,
    ):
        base = D4RLKitchenDataset(dataset, 1, max_path_length, discount, device="cpu")
        self.normalizers = base.normalizers
        self.horizon, self.stride = horizon, stride
        self.o_dim, self.a_dim = base.o_dim, base.a_dim
        self.seq_obs, self.seq_act, self.seq_rew = base.seq_obs, base.seq_act, base.seq_rew
        self.path_lengths = base.path_lengths

        indices = []
        for path_idx, plen in enumerate(self.path_lengths):
            max_start = plen - (horizon - 1) * stride - 1
            indices += [(path_idx, s) for s in range(max(max_start + 1, 0))]
        self.indices = np.asarray(indices, np.int32)

        self.seq_val = _mc_value_backward(self.seq_rew, discount)
        vmin, vmax = self.seq_val.min(), self.seq_val.max()
        self.seq_val = (self.seq_val - vmin) / (vmax - vmin)
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
        return {
            "obs": {"state": self.seq_obs[path_idx, start:end:self.stride]},
            "act": self.seq_act[path_idx, start:end:self.stride],
            "rew": self.seq_rew[path_idx, start:end:self.stride],
            "val": self.seq_val[path_idx, start],
        }

    def sample_batch(self, generator, batch_size: int):
        return D4RLMuJoCoDataset.batch(self._sampler.sample(generator, batch_size))

"""Episodic replay buffer (counterpart of
cleandiffuser_tpu/dataset/replay_buffer.py), numpy backed.

The reference's is a zarr store; the JAX package keeps dense numpy arrays,
and so does the port: `data` (key -> (n_steps, ...)) and
`meta["episode_ends"]`. `save_npz` / `load_npz` use the JAX package's
layout (the arrays under their keys beside `episode_ends`), so a buffer
written by either package loads in the other; `copy_from_path` reads a
diffusion_policy-format zarr directory store with the zarr package when
installed, else with the hand-rolled reader (dataset/zarr_compat.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["ReplayBuffer"]


class ReplayBuffer:
    def __init__(self, root: Optional[Dict] = None):
        root = root or {"data": {}, "meta": {"episode_ends": np.zeros((0,), np.int64)}}
        self.data: Dict[str, np.ndarray] = root["data"]
        self.meta: Dict[str, np.ndarray] = root["meta"]

    # ------------------------------------------------------------------
    @classmethod
    def create_empty_numpy(cls) -> "ReplayBuffer":
        return cls()

    @classmethod
    def create_from_data(cls, data: Dict[str, np.ndarray],
                         episode_ends: np.ndarray) -> "ReplayBuffer":
        return cls({"data": dict(data), "meta": {"episode_ends": np.asarray(episode_ends, np.int64)}})

    @classmethod
    def copy_from_path(cls, zarr_path: str, keys: Optional[Sequence[str]] = None) -> "ReplayBuffer":
        """Load a diffusion_policy-format zarr store into memory
        (reference replay_buffer.py:212). Uses the zarr package when
        installed; otherwise the built-in pure-numpy zarr-v2 directory
        reader (zarr_compat — null/zlib/gzip compressors; blosc stores
        raise with a pointer to tools/convert_pusht_zarr.py)."""
        from .zarr_compat import open_zarr

        group = open_zarr(zarr_path)
        keys = keys if keys is not None else list(group["data"].keys())
        data = {k: np.asarray(group["data"][k]) for k in keys}
        episode_ends = np.asarray(group["meta"]["episode_ends"])
        return cls.create_from_data(data, episode_ends)

    @classmethod
    def load_npz(cls, path: str) -> "ReplayBuffer":
        arrs = np.load(path)
        data = {k: arrs[k] for k in arrs.files if k != "episode_ends"}
        return cls.create_from_data(data, arrs["episode_ends"])

    def save_npz(self, path: str):
        np.savez_compressed(path, episode_ends=self.episode_ends, **self.data)

    # ------------------------------------------------------------------
    @property
    def episode_ends(self) -> np.ndarray:
        return self.meta["episode_ends"]

    @property
    def n_episodes(self) -> int:
        return len(self.episode_ends)

    @property
    def n_steps(self) -> int:
        return 0 if self.n_episodes == 0 else int(self.episode_ends[-1])

    def keys(self):
        return self.data.keys()

    def __getitem__(self, key: str) -> np.ndarray:
        return self.data[key]

    def __contains__(self, key: str) -> bool:
        return key in self.data

    def __repr__(self):
        shapes = {k: v.shape for k, v in self.data.items()}
        return f"ReplayBuffer(n_episodes={self.n_episodes}, n_steps={self.n_steps}, {shapes})"

    # ------------------------------------------------------------------
    def add_episode(self, episode: Dict[str, np.ndarray]):
        """Append one episode dict of (T, ...) arrays (reference :447)."""
        lengths = {k: len(v) for k, v in episode.items()}
        assert len(set(lengths.values())) == 1, f"ragged episode: {lengths}"
        T = next(iter(lengths.values()))
        for k, v in episode.items():
            v = np.asarray(v)
            if k not in self.data:
                self.data[k] = v.copy()
            else:
                self.data[k] = np.concatenate([self.data[k], v], axis=0)
        self.meta["episode_ends"] = np.append(self.episode_ends, self.n_steps + T)

    def get_episode(self, idx: int) -> Dict[str, np.ndarray]:
        start = 0 if idx == 0 else int(self.episode_ends[idx - 1])
        end = int(self.episode_ends[idx])
        return {k: v[start:end] for k, v in self.data.items()}

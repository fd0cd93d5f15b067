"""Dataset base and the device-resident batch samplers (counterpart of
cleandiffuser_tpu/dataset/base.py).

Two access paths, as in the reference:

1. `__getitem__` / `__len__`: numpy dict items, for a DataLoader.
2. `sample_batch(generator, batch_size)`: the training path. The whole
   (normalized) dataset lives on the device as dense tensors; a batch is a
   random index draw from an explicit `torch.Generator` (on the store's
   device) and one gather per array, with no host round trip. The
   reference draws from a JAX key; the two give different indices from
   one seed, so `gather(k)` takes the indices explicitly too.

The stores live on the CUDA device unless the caller names another
(`device="cpu"` for the CPU tests). Placing a store on a mesh waits for
the multi-device path (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.tensors import default_device

__all__ = ["BaseDataset", "DeviceSeqSampler", "DeviceTDSampler"]


class BaseDataset:
    """Dict-batch contract: {"obs": {"state": ...}, "act": ..., ...}."""

    def get_normalizer(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx: int):
        raise NotImplementedError

    def sample_batch(self, generator: torch.Generator, batch_size: int):
        raise NotImplementedError


def _on(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in arrays.items()}


class DeviceSeqSampler:
    """Device-resident (paths, time, dim) store with windowed gather.

    arrays: name -> (n_paths, max_len, d); indices: (N, 2) [path, start];
    a window is `horizon` steps `stride` apart from its start. A name in
    `scalars` gathers the single step at the window's start (e.g. "val")."""

    def __init__(self, arrays: Dict[str, np.ndarray], indices: np.ndarray, horizon: int,
                 stride: int = 1, scalars: Optional[Dict[str, np.ndarray]] = None, device=None):
        self.device = default_device(device)
        self.arrays = _on(arrays, self.device)
        self.scalars = _on(scalars or {}, self.device)
        self.indices = torch.as_tensor(np.asarray(indices, np.int64), device=self.device)
        self.horizon, self.stride = horizon, stride
        self._steps = torch.arange(horizon, device=self.device) * stride

    def gather(self, k: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The windows of index rows `k` (B,): name -> (B, horizon, d), a
        scalar name -> (B, d)."""
        idx = self.indices[k.to(self.device)]
        path, start = idx[:, 0], idx[:, 1]
        steps = start[:, None] + self._steps  # (B, horizon)
        out = {name: arr[path[:, None], steps] for name, arr in self.arrays.items()}
        out.update({name: arr[path, start] for name, arr in self.scalars.items()})
        return out

    def sample(self, generator: torch.Generator, batch_size: int) -> Dict[str, torch.Tensor]:
        k = torch.randint(len(self.indices), (batch_size,), generator=generator,
                          device=generator.device)
        return self.gather(k)


class DeviceTDSampler:
    """Device-resident flat transition store with random gather."""

    def __init__(self, arrays: Dict[str, np.ndarray], device=None):
        self.device = default_device(device)
        self.arrays = _on(arrays, self.device)
        self.size = next(iter(arrays.values())).shape[0]

    def gather(self, k: torch.Tensor) -> Dict[str, torch.Tensor]:
        k = k.to(self.device)
        return {name: arr[k] for name, arr in self.arrays.items()}

    def sample(self, generator: torch.Generator, batch_size: int) -> Dict[str, torch.Tensor]:
        k = torch.randint(self.size, (batch_size,), generator=generator, device=generator.device)
        return self.gather(k)

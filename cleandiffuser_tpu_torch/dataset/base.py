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
(`device="cpu"` for the CPU tests). `place_on_mesh(mesh)` (on a dataset,
or on a sampler) keeps the whole store on every rank and makes each batch
this rank's rows of the global one: the indices are drawn for the whole
`batch_size` from the generator, which is the same on every rank, and the
rank gathers its block of them, so the global batch is the one a single
process draws. `batch_size` must divide the mesh's "dp" size. A dataset's
batches come out tagged as the rank's rows (utils/ranks.py), which is what
a placed pipeline's step reads to run data-parallel.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.ranks import mark_rows
from ..utils.tensors import default_device

__all__ = ["BaseDataset", "DeviceSeqSampler", "DeviceTDSampler", "place_on_mesh",
           "sample_indices"]


def sample_indices(generator: torch.Generator, high: int, batch_size: int, rows=None):
    """`batch_size` indices uniform on [0, high) from `generator`; with
    `rows` = (rank, n, group) (a store placed on a mesh) the rank's block
    of them."""
    k = torch.randint(high, (batch_size,), generator=generator, device=generator.device)
    if rows is None:
        return k
    rank, n, _ = rows
    assert batch_size % n == 0, f"batch_size={batch_size} not divisible by dp size {n}"
    b = batch_size // n
    return k[rank * b:(rank + 1) * b]


def place_on_mesh(dataset, mesh, axis: str = "dp"):
    """Place `dataset`'s samplers (its attributes, one level of list
    nesting) and its own index draws on the mesh (module note), and tag its
    `sample_batch` output as the rank's rows. Returns the dataset."""
    from ..parallel.mesh import mesh_rows

    rows = mesh_rows(mesh, axis)
    dataset._mesh_rows = rows
    for val in list(vars(dataset).values()):
        for item in (val if isinstance(val, (list, tuple)) else [val]):
            if isinstance(item, (DeviceSeqSampler, DeviceTDSampler)):
                item.place_on_mesh(mesh, axis)
    sample = dataset.sample_batch
    dataset.sample_batch = lambda *a, **kw: mark_rows(sample(*a, **kw), *rows)
    return dataset


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

    def place_on_mesh(self, mesh, axis: str = "dp"):
        return place_on_mesh(self, mesh, axis)


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

    def place_on_mesh(self, mesh, axis: str = "dp"):
        from ..parallel.mesh import mesh_rows

        self._mesh_rows = mesh_rows(mesh, axis)
        return self

    def sample(self, generator: torch.Generator, batch_size: int) -> Dict[str, torch.Tensor]:
        return self.gather(sample_indices(generator, len(self.indices), batch_size,
                                          getattr(self, "_mesh_rows", None)))


class DeviceTDSampler:
    """Device-resident flat transition store with random gather."""

    def __init__(self, arrays: Dict[str, np.ndarray], device=None):
        self.device = default_device(device)
        self.arrays = _on(arrays, self.device)
        self.size = next(iter(arrays.values())).shape[0]

    def gather(self, k: torch.Tensor) -> Dict[str, torch.Tensor]:
        k = k.to(self.device)
        return {name: arr[k] for name, arr in self.arrays.items()}

    place_on_mesh = DeviceSeqSampler.place_on_mesh

    def sample(self, generator: torch.Generator, batch_size: int) -> Dict[str, torch.Tensor]:
        return self.gather(sample_indices(generator, self.size, batch_size,
                                          getattr(self, "_mesh_rows", None)))

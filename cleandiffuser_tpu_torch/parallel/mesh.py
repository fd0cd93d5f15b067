"""Device meshes for multi-device training and sampling (counterpart of
cleandiffuser_tpu/parallel/mesh.py).

The reference drives n devices from one process through a
`jax.sharding.Mesh`. The port runs one process per rank (`torchrun`, or a
test's spawned ranks) on an initialised process group, NCCL on the card and
gloo on the CPU, and the mesh is a `torch.distributed.device_mesh.DeviceMesh`
with the reference's dims: ("dp",) for data parallelism, ("dp", "fsdp") for
a 2-D mesh whose second dim shards parameters (parallel/dp.py).

- `make_mesh(n_devices, axis_names, shape)`: the mesh over the process
  group's ranks (all of them: a mesh over fewer raises).
- `replicated(mesh)` / `batch_sharded(mesh, axis)`: the placements of a
  tensor held whole on every rank and of a batch split by rows over `axis`
  (`torch.distributed.tensor` `Replicate()` / `Shard(0)`, one per dim).
- `shard_batch(mesh, batch, axis)`: this rank's rows of a global batch
  (nested dicts of tensors or arrays), tagged as such (utils/ranks.py
  `mark_rows`): a placed pipeline's step takes a tagged batch data-parallel.
- `mesh_rows(mesh, axis)`: (this rank's index along `axis`, the axis' size,
  its process group), the tag `shard_batch` sets.
- `place_state(state, mesh)`: rank 0's values of a module's params and
  buffers, or of an optimizer's moments, on every rank; an optimizer then
  averages its gradients over the dp ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..utils.ranks import mark_rows
from ..utils.train_state import TrainOptimizer

__all__ = ["make_mesh", "replicated", "batch_sharded", "shard_batch", "mesh_rows", "axis_size",
           "place_state"]


def _check_mesh(mesh):
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"not a DeviceMesh: {type(mesh).__name__} (parallel/mesh.py make_mesh)")


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None):
    """A DeviceMesh of `shape` (default: one "dp" dim over all ranks) over the
    initialised process group, whose size must be `n_devices` (default: the
    group's). On the card each rank's device is its CUDA device (set by
    `setup_mesh` or the caller)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group: launch with torchrun "
                           "and call parallel.setup_mesh, or init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a process group of {world} ranks: "
                         "the mesh takes every rank")
    axis_names = tuple(axis_names)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis mesh")
        shape = (n,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} with dims {axis_names} does not hold {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def replicated(mesh):
    """Placements of a tensor held whole on every rank."""
    from torch.distributed.tensor import Replicate

    _check_mesh(mesh)
    return (Replicate(),) * mesh.ndim


def batch_sharded(mesh, axis: str = "dp"):
    """Placements of a batch split by rows over `axis` (whole along the
    other dims)."""
    from torch.distributed.tensor import Replicate, Shard

    _check_mesh(mesh)
    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def axis_size(mesh, axis: str) -> int:
    _check_mesh(mesh)
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def mesh_rows(mesh, axis: str = "dp"):
    """(rank along `axis`, the axis' size, its process group)."""
    _check_mesh(mesh)
    return mesh.get_local_rank(axis), axis_size(mesh, axis), mesh.get_group(axis)


def shard_batch(mesh, batch, axis: str = "dp"):
    """This rank's rows of a global batch (nested dicts / lists of tensors or
    arrays, each with the batch's leading dim, which must divide the axis'
    size; None stays None), tagged as the rank's rows."""
    rank, n, group = mesh_rows(mesh, axis)

    def rows(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rows(v) for v in x)
        x = torch.as_tensor(x)
        assert x.shape[0] % n == 0, (
            f"batch of {x.shape[0]} rows not divisible by {axis} size {n}")
        b = x.shape[0] // n
        return x[rank * b:(rank + 1) * b]

    return mark_rows(rows(batch), rank, n, group)


def _tensors_of(state):
    """A module's params and buffers, or an optimizer's moment tensors;
    FSDP-sharded params (DTensors) left out: FSDP holds them."""
    if isinstance(state, nn.Module):
        ts = [*state.parameters(), *state.buffers()]
    else:
        ts = [v for st in state.optimizer.state.values() for v in st.values()
              if isinstance(v, torch.Tensor) and v.ndim]
    return [t for t in ts if type(t).__name__ != "DTensor"]


def place_state(state, mesh, axis: str = "dp"):
    """Rank 0's values of a module's params and buffers, or of a
    `TrainOptimizer`'s moments, on every rank (in place, one broadcast per
    tensor); the optimizer then averages its gradients over `axis`."""
    _check_mesh(mesh)
    for t in _tensors_of(state):
        dist.broadcast(t.data, src=0)
    if isinstance(state, TrainOptimizer):
        state.grad_group = mesh_rows(mesh, axis)[2]
    return state

"""The config keys that set up a run's devices, mesh and precision
(counterpart of cleandiffuser_tpu/parallel/integrate.py).

Every CLI passes its config through here before its first device use:

    mesh = setup_mesh(args)            # None: one device
    device = device_of(args)           # "cpu" with platform=cpu, else this rank's CUDA device
    pipe = ...
    place_pipeline(pipe, mesh)         # rank 0's state on every rank
    dataset.place_on_mesh(mesh)        # batches come out as this rank's rows

Config keys:

    n_devices:  1      ranks; > 1 runs one process per rank under torchrun:
                       `torchrun --nproc-per-node N -m cleandiffuser_tpu_torch.cli.<cli>
                       n_devices=N` (NCCL, one GPU per rank; `platform=cpu`: gloo)
    mesh_shape: null   e.g. [2, 2] for a ("dp", "fsdp") 2-D mesh
    platform:   null   the CUDA device, which must be present; "cpu" by request
    bf16_sampling: true   samplers cast their params once per call and run
                          the network forward in bf16; solver math stays f32
    bf16_training: true   the network forward and backward in bf16; loss,
                          master weights, optimizer state and EMA stay f32

Each bf16 key sets the class attribute on `DiffusionModel` (a key left out
or false leaves the flag as it was), so it reaches every engine.
`setup_mesh` raises, with the torchrun command line, when `n_devices` > 1
and the process group (or torchrun's WORLD_SIZE) is of another size, when
`n_devices` is more than the GPUs present, and when `mesh_shape` does not
multiply to `n_devices`, as the reference raises: nothing carries on with
one device in their place.

`place_pipeline(pipe, mesh)` walks the pipeline's state (engines,
classifiers, critics, IQL, inverse dynamics, one level of list / dict
nesting and what the port's own objects hold): it broadcasts rank 0's
params, buffers and optimizer state, sets every optimizer's `grad_group`
(its step averages the gradients over the dp ranks), and enters every
public `*step` and `update*` method of the pipeline through
utils/ranks.py `rows_step`, the one place that picks a step's mode: on a
batch tagged as this rank's rows (a placed dataset's, `shard_batch`'s) it
runs data-parallel, its batch-shaped draws at the global shape and its
scalar logs those of the global batch; on an untagged (global) batch it
runs whole on every rank, the same numbers as one process, and the first
such call says so. A step called by a data-parallel step (DiffuserLite's
`update_level` inside `train_step`) runs within its rows. It sets
`pipe.mesh` and raises ValueError when it finds no state.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..diffusion.basic import DiffusionModel
from ..utils.ranks import current_rows, rows_of, rows_step
from ..utils.tensors import default_device
from ..utils.train_state import TrainOptimizer
from .mesh import _check_mesh, axis_size, make_mesh, place_state

__all__ = ["setup_mesh", "place_state", "place_pipeline", "device_of"]


def _torchrun_hint(n: int, platform) -> str:
    cpu = " platform=cpu" if platform == "cpu" else ""
    return (f"launch one process per rank: torchrun --nproc-per-node {n} -m "
            f"cleandiffuser_tpu_torch.cli.<cli> n_devices={n}{cpu}")


def setup_mesh(args=None, n_devices: Optional[int] = None, mesh_shape=None,
               platform: Optional[str] = None):
    """Apply the config's device, mesh and precision keys. Returns None for
    one device, else the DeviceMesh over the process group (initialised
    here from torchrun's environment when it is not yet)."""
    if args is not None:
        if n_devices is None:
            n_devices = int(args.get("n_devices", 1) or 1)
        mesh_shape = args.get("mesh_shape", None) if mesh_shape is None else mesh_shape
        platform = args.get("platform", None) if platform is None else platform
        if bool(args.get("bf16_sampling", False)):
            DiffusionModel.bf16_sampling = True
        if bool(args.get("bf16_training", False)):
            DiffusionModel.bf16_training = True
    if platform not in (None, "cpu"):
        raise ValueError(f"unknown platform={platform!r} (null: the CUDA device; 'cpu': the "
                         "CPU)")
    n = int(n_devices or 1)
    shape = None if not mesh_shape else tuple(int(s) for s in mesh_shape)
    if shape is not None and int(np.prod(shape)) != n:
        raise ValueError(f"mesh_shape {shape} does not multiply to n_devices={n}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        if world > 1:
            raise RuntimeError(f"WORLD_SIZE={world} but n_devices=1: pass n_devices={world}")
        return None
    initialised = dist.is_available() and dist.is_initialized()
    if initialised:
        world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"n_devices={n} but {world} process(es) run: "
                           + _torchrun_hint(n, platform))
    if platform != "cpu":
        gpus = torch.cuda.device_count()
        if n > gpus:
            raise RuntimeError(f"n_devices={n} but {gpus} GPU(s) present; pass platform=cpu "
                               "for ranks on the CPU: " + _torchrun_hint(n, "cpu"))
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not initialised:
        dist.init_process_group("gloo" if platform == "cpu" else "nccl")
    if shape is not None:
        return make_mesh(n, axis_names=("dp", "fsdp"), shape=shape)
    return make_mesh(n)


def device_of(args) -> torch.device:
    """The device a CLI runs on: the CPU when the config says `platform:
    cpu`, else the CUDA device (this rank's on a mesh: `setup_mesh` made it
    current; `default_device` raises without one)."""
    return default_device("cpu" if args.get("platform") == "cpu" else None)


# ----------------------------------------------------------------------
_PORT = __name__.split(".")[0]


def _place_obj(obj, mesh, seen: set, depth: int = 0) -> bool:
    """Place every module and optimizer `obj` holds (itself, its attributes,
    one level of list / tuple / dict nesting, and the port's own objects
    inside it, a few levels deep). Returns whether anything was placed."""
    if id(obj) in seen or obj is None or isinstance(obj, (int, float, str, bool, np.ndarray,
                                                          torch.Tensor, type)):
        return False
    seen.add(id(obj))
    if isinstance(obj, (nn.Module, TrainOptimizer)):
        place_state(obj, mesh)
        return True
    # lists, not generators, in any(): every item is placed, not the first
    if isinstance(obj, (list, tuple)):
        return any([_place_obj(v, mesh, seen, depth) for v in obj])
    if isinstance(obj, dict):
        return any([_place_obj(v, mesh, seen, depth) for v in obj.values()])
    if depth > 3 or not type(obj).__module__.startswith(_PORT) or not hasattr(obj, "__dict__"):
        return False
    if getattr(obj, "_optimizer", False) is None and any(
            p.requires_grad for p in obj.params.parameters()):
        obj.optimizer  # an engine's optimizer is built at first use: build it here
    return any([_place_obj(v, mesh, seen, depth + 1) for v in vars(obj).values()])


def _placed_step(step, label: str, dp: int):
    """A placed pipeline's step (utils/ranks.py `rows_step`: data-parallel on
    a batch tagged as the rank's rows, whole on an untagged one). With dp >
    1 the first untagged call outside a data-parallel step says that the
    step runs whole on every rank."""
    run_rows = rows_step(step)
    told = []

    @functools.wraps(step)
    def run(*args, **kwargs):
        if dp > 1 and not told and current_rows() is None and rows_of((args, kwargs)) is None:
            told.append(label)
            print(f"[parallel] {label}: its batch is not tagged as this rank's rows "
                  "(dataset.place_on_mesh, parallel.shard_batch): it runs whole on every "
                  "rank", flush=True)
        return run_rows(*args, **kwargs)

    return run


def place_pipeline(pipe, mesh=None) -> None:
    """Place a pipeline's state on the mesh (module note). With no mesh (one
    device) the state already lives on the pipeline's device and nothing is
    done; anything but a DeviceMesh raises TypeError."""
    if mesh is None:
        return
    _check_mesh(mesh)
    seen = set()
    placed = [name for name, val in list(vars(pipe).items())
              if _place_obj(val, mesh, seen)]
    if not placed:
        raise ValueError(f"place_pipeline found no device state on {type(pipe).__name__}")
    dp = axis_size(mesh, "dp")
    for name in dir(type(pipe)):
        if ((name.endswith("step") or name.startswith("update")) and not name.startswith("_")
                and callable(getattr(type(pipe), name))):
            setattr(pipe, name, _placed_step(getattr(pipe, name),
                                             f"{type(pipe).__name__}.{name}", dp))
    pipe.mesh = mesh

"""The config keys that set up a run's devices and precision (counterpart of
cleandiffuser_tpu/parallel/integrate.py).

    mesh = setup_mesh(args)      # None: one device
    device = device_of(args)     # "cpu" with platform=cpu, else the CUDA device
    place_pipeline(pipe, mesh)   # one device: the state is already there

Every CLI of the reference passes its config through `setup_mesh` before
its first device use. Ported so far: one device, and the two precision keys
the reference reads there:

    bf16_sampling: true   samplers cast their params once per call and run
                          the network forward in bf16; solver math stays f32
    bf16_training: true   the network forward and backward in bf16; loss,
                          master weights, optimizer state and EMA stay f32

Each sets the class attribute on `DiffusionModel` (as the reference does;
a key left out or false leaves the flag as it was), so it reaches every
engine. `n_devices > 1` raises: the multi-device path is ROADMAP queue 1,
item 10. The config's `platform` key is `null` (the CUDA device, which
must be present) or `cpu` (the CPU, by request): `device_of(args)`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..diffusion.basic import DiffusionModel
from ..utils.tensors import default_device

__all__ = ["setup_mesh", "place_pipeline", "device_of"]


def setup_mesh(args=None, n_devices: Optional[int] = None):
    """Apply the config's device and precision keys. Returns None (no mesh:
    one device)."""
    if args is not None:
        if n_devices is None:
            n_devices = int(args.get("n_devices", 1) or 1)
        if args.get("platform") not in (None, "cpu"):
            raise ValueError(f"unknown platform={args.get('platform')!r} (null: the CUDA "
                             "device; 'cpu': the CPU)")
        if bool(args.get("bf16_sampling", False)):
            DiffusionModel.bf16_sampling = True
        if bool(args.get("bf16_training", False)):
            DiffusionModel.bf16_training = True
    if (n_devices or 1) > 1:
        raise NotImplementedError(
            f"n_devices={n_devices}: the multi-device path is not ported yet "
            "(ROADMAP queue 1, item 10)")
    return None


def place_pipeline(pipe, mesh=None) -> None:
    """Place a pipeline's state on the mesh. With no mesh (one device, all
    `setup_mesh` returns so far) the state already lives on the pipeline's
    device, and this does nothing; a mesh raises until the multi-device path
    is ported (ROADMAP queue 1, item 10)."""
    if mesh is not None:
        raise NotImplementedError(
            f"placing {type(pipe).__name__} on a mesh: the multi-device path is not "
            "ported yet (ROADMAP queue 1, item 10)")


def device_of(args) -> torch.device:
    """The device a CLI runs on: the CPU when the config says `platform:
    cpu`, else the CUDA device (`default_device`, which raises without
    one)."""
    return default_device("cpu" if args.get("platform") == "cpu" else None)

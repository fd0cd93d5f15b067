"""Small tensor helpers (counterpart of cleandiffuser_tpu/utils/tensors.py)."""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["at_least_ndim", "default_device", "set_seed"]


def set_seed(seed: int) -> torch.Generator:
    """Seed python, numpy and torch, and return a fresh CPU
    `torch.Generator` seeded with `seed`: the counterpart of the
    reference's returned PRNG key."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def at_least_ndim(x, ndim: int, pad: int = 0):
    """Pad shape with size-1 dims until `x.ndim == ndim`.

    pad=0 appends trailing dims (broadcast per-batch scalars over features);
    pad=1 prepends leading dims.
    """
    if isinstance(x, (int, float)):
        return x
    n = ndim - x.ndim
    if n <= 0:
        return x
    if pad == 0:
        return x.reshape(tuple(x.shape) + (1,) * n)
    return x.reshape((1,) * n + tuple(x.shape))


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` as given, or the CUDA
    device when None. Without a CUDA device, None raises: the port never
    falls back to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU by default; "
                           "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")

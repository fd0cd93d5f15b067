"""Small tensor helpers (counterpart of cleandiffuser_tpu/utils/tensors.py)."""

from __future__ import annotations

import random
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ["at_least_ndim", "default_device", "set_seed", "dict_apply", "loop_dataloader",
           "count_parameters", "report_parameters"]


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


def dict_apply(d: Dict[str, Any], fn: Callable) -> Dict[str, Any]:
    """Recursively apply `fn` to the leaves of a nested dict."""
    return {k: dict_apply(v, fn) if isinstance(v, dict) else fn(v) for k, v in d.items()}


def loop_dataloader(iterable):
    """Infinitely cycle an iterable (e.g. a data loader)."""
    while True:
        for batch in iterable:
            yield batch


def _named_sizes(params) -> Dict[str, int]:
    """Name -> element count of a module's parameters, or of the leaves of
    a nested dict of arrays (names joined by "/")."""
    if isinstance(params, torch.nn.Module):
        return {k: p.numel() for k, p in params.named_parameters()}
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": n for kk, n in _named_sizes(v).items()})
        else:
            out[k] = int(np.prod(np.shape(v)))
    return out


def count_parameters(params) -> int:
    """The number of parameters of a module, or of a nested dict of arrays."""
    return sum(_named_sizes(params).values())


def _to_str(num: float) -> str:
    return f"{num / 1e6:.2f} M" if num >= 1e6 else f"{num / 1e3:.2f} k"


def report_parameters(params, topk: int = 10) -> int:
    """Print the total and the top-k largest parameters of a module (or a
    nested dict of arrays); returns the total."""
    counts = _named_sizes(params)
    total = sum(counts.values())
    print(f"Total parameters: {_to_str(total)}")
    print(f"Top {topk} parameters:")
    for k, v in sorted(counts.items(), key=lambda kv: -kv[1])[:topk]:
        print(f"  {k}: {_to_str(v)}")
    return total

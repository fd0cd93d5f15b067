"""Small tensor helpers (counterpart of cleandiffuser_tpu/utils/tensors.py)."""

from __future__ import annotations

__all__ = ["at_least_ndim"]


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

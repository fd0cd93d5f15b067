"""Normalizers (counterpart of cleandiffuser_tpu/utils/normalizers.py).

Statistics are computed once on the host with numpy and kept as numpy
arrays. `normalize` / `unnormalize` take a numpy array or a torch tensor
and answer in the same kind: a tensor is met with the statistics as
tensors of its own device and type, so a batch on the card is normalized
there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = [
    "EmptyNormalizer",
    "GaussianNormalizer",
    "MinMaxNormalizer",
    "ImageNormalizer",
    "DatasetGaussianNormalizer",
    "DatasetMinMaxNormalizer",
    "CDFNormalizer",
    "CDFNormalizer1d",
]


def _like(stat: np.ndarray, x, ndim: Optional[int] = None):
    """`stat` padded with leading 1s to `ndim` dims, as a tensor of x's
    device and type when x is a tensor."""
    if ndim is not None and ndim > stat.ndim:
        stat = stat.reshape((1,) * (ndim - stat.ndim) + stat.shape)
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(stat, dtype=x.dtype, device=x.device)
    return stat


class EmptyNormalizer:
    """Identity normalizer."""

    def normalize(self, x):
        return x

    def unnormalize(self, x):
        return x


class GaussianNormalizer(EmptyNormalizer):
    """Zero-mean unit-variance per dim. `start_dim` selects which trailing
    dims keep their own statistics; leading dims are reduced over."""

    def __init__(self, X: np.ndarray, start_dim: int = -1):
        X = np.asarray(X)
        if start_dim < 0:
            start_dim = X.ndim + start_dim
        axes = tuple(range(start_dim))
        self.mean = np.mean(X, axis=axes).astype(np.float32)
        self.std = np.std(X, axis=axes).astype(np.float32)
        self.std[self.std == 0] = 1.0

    def normalize(self, x):
        return (x - _like(self.mean, x, x.ndim)) / _like(self.std, x, x.ndim)

    def unnormalize(self, x):
        return x * _like(self.std, x, x.ndim) + _like(self.mean, x, x.ndim)


class MinMaxNormalizer(EmptyNormalizer):
    """[min, max] -> [-1, 1] per dim."""

    def __init__(self, X: np.ndarray, start_dim: int = -1, X_max: Optional[np.ndarray] = None,
                 X_min: Optional[np.ndarray] = None):
        X = np.asarray(X)
        if start_dim < 0:
            start_dim = X.ndim + start_dim
        axes = tuple(range(start_dim))
        self.max = (np.max(X, axis=axes) if X_max is None else np.asarray(X_max)).astype(np.float32)
        self.min = (np.min(X, axis=axes) if X_min is None else np.asarray(X_min)).astype(np.float32)
        self.mask = np.ones_like(self.max)
        self.range = self.max - self.min
        self.mask[self.max == self.min] = 0.0
        self.range[self.range == 0] = 1.0

    def normalize(self, x):
        nd = x.ndim
        x = (x - _like(self.min, x, nd)) / _like(self.range, x, nd)
        return (x * 2 - 1) * _like(self.mask, x, nd)

    def unnormalize(self, x):
        nd = x.ndim
        x = (x + 1) / 2
        x = x * _like(self.mask, x, nd)
        return x * _like(self.range, x, nd) + _like(self.min, x, nd)


class ImageNormalizer(EmptyNormalizer):
    """[0, 1] -> [-1, 1]."""

    def normalize(self, x):
        return x * 2.0 - 1.0

    def unnormalize(self, x):
        return (x + 1.0) / 2.0


class DatasetGaussianNormalizer(EmptyNormalizer):
    """Dataset-side Gaussian: reduce over axis 0 only."""

    def __init__(self, X: np.ndarray):
        X = np.asarray(X, dtype=np.float32)
        self.means, self.stds = X.mean(0), X.std(0)
        self.stds[self.stds == 0] = 1.0

    def normalize(self, x):
        return (x - _like(self.means, x)) / _like(self.stds, x)

    def unnormalize(self, x):
        return x * _like(self.stds, x) + _like(self.means, x)


class DatasetMinMaxNormalizer(EmptyNormalizer):
    """Dataset-side MinMax: flatten to (-1, D), reduce over axis 0."""

    def __init__(self, X: np.ndarray):
        X = np.asarray(X, dtype=np.float32).reshape(-1, X.shape[-1])
        self.min, self.max = np.min(X, axis=0), np.max(X, axis=0)
        self.range = self.max - self.min
        self.range[self.range == 0] = 1.0

    def normalize(self, x):
        return (x - _like(self.min, x)) / _like(self.range, x) * 2 - 1

    def unnormalize(self, x):
        return (x + 1) / 2 * _like(self.range, x) + _like(self.min, x)


def empirical_cdf(sample: np.ndarray):
    """(quantiles, cumprob) of a 1-D sample."""
    quantiles, counts = np.unique(sample, return_counts=True)
    cumprob = np.cumsum(counts).astype(np.float64) / sample.size
    return quantiles, cumprob


class CDFNormalizer1d:
    """Per-dimension empirical-CDF normalizer by linear interpolation
    (numpy; host data)."""

    def __init__(self, X: np.ndarray):
        assert X.ndim == 1
        X = X.astype(np.float32)
        self.quantiles, self.cumprob = empirical_cdf(X)
        self.xmin, self.xmax = self.quantiles.min(), self.quantiles.max()
        self.ymin, self.ymax = self.cumprob.min(), self.cumprob.max()

    def normalize(self, x):
        x = np.clip(x, self.xmin, self.xmax)
        y = np.interp(x, self.quantiles, self.cumprob)
        return 2 * y - 1

    def unnormalize(self, x, eps=1e-4):
        x = (np.asarray(x) + 1) / 2.0
        x = np.clip(x, self.ymin, self.ymax)
        return np.interp(x, self.cumprob, self.quantiles)


class CDFNormalizer(EmptyNormalizer):
    """Marginal-CDF normalizer (numpy; host data)."""

    def __init__(self, X: np.ndarray):
        X = np.asarray(X, dtype=np.float32)
        self.dim = X.shape[-1]
        flat = X.reshape(-1, self.dim)
        self.cdfs = [CDFNormalizer1d(flat[:, i]) for i in range(self.dim)]

    def _wrap(self, fn_name, x):
        shape = x.shape
        x = np.asarray(x).reshape(-1, self.dim)
        out = np.zeros_like(x)
        for i, cdf in enumerate(self.cdfs):
            out[:, i] = getattr(cdf, fn_name)(x[:, i])
        return out.reshape(shape)

    def normalize(self, x):
        return self._wrap("normalize", x)

    def unnormalize(self, x):
        return self._wrap("unnormalize", x)

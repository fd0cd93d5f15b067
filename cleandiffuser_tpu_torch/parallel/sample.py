"""Sampling with the batch split over a mesh (counterpart of
cleandiffuser_tpu/parallel/sample.py).

The eval hot path of the RL pipelines and planners is a batch of denoise
chains (num_envs x num_candidates). `shard_sample_fn` gives each rank its
rows of the prior and of every batched condition, denoises them, and
all-gathers the samples (and the log's batch-shaped entries) into the global
batch on every rank. The noise of each row is the one a single process
draws for it: the sampler draws the global batch's shape from its generator
(the same stream on every rank) and keeps the rank's rows (utils/ranks.py),
and explicit `noise=(initial, per_step)` is cut the same way. The params
are those every rank holds (placed from rank 0, or gathered by FSDP in each
forward).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.ranks import batch_rows
from .mesh import mesh_rows

__all__ = ["shard_sample_fn"]

# the sample fn's arguments whose leading dim is the batch's
_BATCHED = ("condition_cfg", "mask_cfg", "condition_cg", "warm_reference", "x1")


def _gather(x: torch.Tensor, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def shard_sample_fn(sample_fn, mesh, axis: str = "dp"):
    """Wrap an engine's sample fn (`fn(params, generator, prior, ...)`,
    diffusion/*.py `build_sample_fn`) for a batch split over `axis`. The
    returned fn has the same signature and results; the prior's batch must
    divide the axis' size."""
    rank, n, group = mesh_rows(mesh, axis)

    def fn(params, generator, prior, noise=None, **kwargs):
        B = prior.shape[0]
        assert B % n == 0, f"batch of {B} rows not divisible by {axis} size {n}"
        b = B // n
        rows = lambda x: x[rank * b:(rank + 1) * b]

        def take(x):
            if isinstance(x, dict):
                return {k: take(v) for k, v in x.items()}
            return rows(x) if isinstance(x, torch.Tensor) and x.ndim else x

        kwargs = {k: take(v) if k in _BATCHED else v for k, v in kwargs.items()}
        if noise is not None:
            initial, per_step = noise
            noise = (None if initial is None else rows(initial),
                     None if per_step is None else per_step[:, rank * b:(rank + 1) * b])
        with batch_rows(rank, n, group):
            x, log = sample_fn(params, generator, rows(prior), noise=noise, **kwargs)
        log = {k: _gather(v, n, group) if isinstance(v, torch.Tensor) and v.ndim
               and v.shape[0] == b else v for k, v in log.items()}
        return _gather(x, n, group), log

    return fn

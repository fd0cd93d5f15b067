"""Data-parallel (+ optional FSDP) training of an engine (counterpart of
cleandiffuser_tpu/parallel/dp.py).

The batch splits by rows over the mesh's "dp" dim. The reference lets XLA
derive the gradient all-reduce from its shardings; here the engine's
optimizer (utils/train_state.py `TrainOptimizer.grad_group`) averages the
gradients over the ranks with one all-reduce after `backward` and before
its own step and the EMA. The engine's loss runs through `engine.params`,
not a wrapper's `forward`, so `DistributedDataParallel`'s reducer would not
see it.

Every draw of the update (levels, noise, the condition's keep-mask, dropout)
is taken at the global batch's shape and cut to the rank's rows
(utils/ranks.py), and so are the `noise=` draws a caller passes: a step on
the mesh equals the step one process takes on the whole batch.

With `fsdp_axis`, `fsdp_shard_params` shards each parameter of at least
`fsdp_min_size` elements over that dim with FSDP2 (`fully_shard`; on a
("dp", "fsdp") mesh that is HSDP: replicated over dp, sharded over fsdp);
smaller ones stay replicated, as in the reference. FSDP2 shards dim 0 where
the reference takes the largest divisible dim (ROADMAP "Not faults"). The
EMA is sharded alike, so its sampler gathers the params back in each
forward, and the Adam moments follow their params. Gradients of sharded
params come back averaged by FSDP; the replicated ones' by the optimizer's
all-reduce over the whole mesh; the clipping norm is the global one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..utils.ranks import rows_step
from .mesh import place_state, shard_batch

__all__ = ["DataParallelEngine", "fsdp_shard_params"]


def fsdp_shard_params(module: nn.Module, mesh, axis: str = "fsdp",
                      min_size: int = 2**16) -> int:
    """Shard `module`'s parameters of at least `min_size` elements over the
    mesh's `axis` (its last dim) with `fully_shard`, in place; the others
    stay whole on every rank. Returns how many were sharded."""
    from torch.distributed.fsdp import fully_shard

    if mesh.mesh_dim_names[-1] != axis:
        raise ValueError(f"the fsdp axis {axis!r} must be the mesh's last dim "
                         f"{mesh.mesh_dim_names}")
    small = {p for p in module.parameters() if p.numel() < min_size}
    n = sum(1 for p in module.parameters() if p not in small)
    if n:
        fully_shard(module, mesh=mesh, ignored_params=small)
    return n


class DataParallelEngine:
    """Train a DiffusionModel engine on a mesh.

        mesh = make_mesh(world)
        dp = DataParallelEngine(engine, mesh).place()   # rank 0's state on every rank
        log = dp.update(x0, cond)   # the global batch; this rank takes its rows
    """

    def __init__(self, engine, mesh, axis: str = "dp", fsdp_axis: Optional[str] = None,
                 fsdp_min_size: int = 2**16):
        self.engine = engine
        self.mesh = mesh
        self.axis = axis
        self.fsdp_axis = fsdp_axis
        self.fsdp_min_size = fsdp_min_size

    def place(self):
        """Rank 0's params, EMA and optimizer state on every rank; with
        `fsdp_axis`, the params, EMA and moments sharded (module note)."""
        e = self.engine
        if self.fsdp_axis is not None:
            if e.bf16_sampling or e.bf16_training:
                raise NotImplementedError("bf16 with FSDP-sharded params: the bf16 casts copy "
                                          "whole params (diffusion/basic.py bf16_params)")
            if e.optimizer.optimizer.state:
                raise ValueError("shard the params before the first update: the optimizer "
                                 "already holds moments")
        for state in (e.params, e.ema_params, e.optimizer):
            place_state(state, self.mesh, self.axis)
        if self.fsdp_axis is None:
            return self
        for name in e.params.keys():
            fsdp_shard_params(e.params[name], self.mesh, self.fsdp_axis, self.fsdp_min_size)
            fsdp_shard_params(e.ema_params[name], self.mesh, self.fsdp_axis,
                              self.fsdp_min_size)
        # the optimizer on the sharded params (fully_shard replaced them);
        # the whole mesh averages the replicated ones' gradients
        e._optimizer = None
        e.optimizer.grad_group = dist.group.WORLD
        return self

    def update(self, x0, condition=None, noise=None, weighted_regression_tensor=None,
               **loss_kwargs) -> dict:
        """The engine's `update` on this rank's rows of the global batch
        `x0` (B, ...), its condition and any batch-shaped `noise` /
        weights / loss arguments (every tensor of them leads with B), as a
        placed pipeline's step runs (utils/ranks.py `rows_step`). Returns
        the global batch's loss (the ranks' mean) and the gradient's global
        norm, device scalars."""
        dev = self.engine.device
        on = lambda x: torch.as_tensor(x, device=dev) if isinstance(x, np.ndarray) else x
        args = shard_batch(self.mesh, (on(x0), condition, noise, on(weighted_regression_tensor),
                                       {k: on(v) for k, v in loss_kwargs.items()}), self.axis)
        x0, condition, noise, weights, loss_kwargs = args
        return rows_step(self.engine.update)(x0, condition, noise=noise,
                                             weighted_regression_tensor=weights, **loss_kwargs)

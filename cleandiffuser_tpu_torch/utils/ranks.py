"""A process's share of a batch split over ranks, and which rank writes.

The port runs one process per rank (`torchrun`). A batch split over the
mesh's "dp" axis leaves each rank its own rows; every random draw whose
leading dim is the batch's is then taken at the *global* batch's shape
from the rank's generator (the same stream on every rank) and cut to the
rank's rows, so each row gets the number one process would draw for it:

    with batch_rows(rank, n, group):        # parallel/ enters this
        eps = batch_draw(lambda s: torch.randn(s, generator=g), x0.shape)

Outside a `batch_rows` context `batch_draw(draw, shape)` is `draw(shape)`.
`batch_mean(x)` is the detached mean over the global batch of a per-row
quantity (DQL's Q normaliser), `mark_rows` / `rows_of` tag the tensors of a batch
that holds one rank's rows (parallel/mesh.py `shard_batch`, the dataset
samplers placed on a mesh), and `is_writer()` is False on every rank but 0
of an initialised process group: logs and checkpoints are written once
(`writer_only` makes a save method a no-op on the other ranks).

A step runs in one of two modes, chosen where it is entered
(`rows_step`, which parallel/integrate.py `place_pipeline` puts around a
placed pipeline's steps): on a batch tagged as the rank's rows it runs
data-parallel (within `batch_rows` of the tag, its scalar logs those of
the global batch); on an untagged batch it runs whole, the same numbers
on every rank. The tag is read only where the step is entered, so a
caller that transforms a batch (a slice, a copy, a dtype cast) before the
step enters `rows_step` itself first (pipelines/diffuserlite_value.py
`value_train_step`); what a step does inside `batch_rows` needs no tag.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["batch_rows", "current_rows", "batch_draw", "batch_mean", "mark_rows", "rows_of",
           "global_logs", "rows_step", "is_writer", "writer_only"]

# (rank, n, group): the rows of a global batch this process holds; None: all
_ROWS: Optional[Tuple[int, int, object]] = None


@contextlib.contextmanager
def batch_rows(rank: int, n: int, group=None):
    """Within the block, batch-shaped draws are the rank's `rank`-th of `n`
    equal row blocks of the global batch's draw, and `batch_mean` reduces
    over `group`."""
    global _ROWS
    prev, _ROWS = _ROWS, (rank, n, group)
    try:
        yield
    finally:
        _ROWS = prev


def current_rows() -> Optional[Tuple[int, int, object]]:
    return _ROWS


def batch_draw(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """`draw(shape)` for a draw whose leading dim is the batch's; within
    `batch_rows(rank, n)` the rank's rows of `draw((n * shape[0], ...))`."""
    shape = tuple(shape)
    if _ROWS is None:
        return draw(shape)
    rank, n, _ = _ROWS
    b = shape[0]
    return draw((n * b, *shape[1:]))[rank * b:(rank + 1) * b]


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() over the global batch, detached: within `batch_rows` the
    mean of the ranks' means (their row counts are equal)."""
    m = x.detach().mean()
    if _ROWS is None:
        return m
    _, n, group = _ROWS
    dist.all_reduce(m, group=group)
    return m / n


_MARK = "_batch_rows"


def mark_rows(tree, rank: int, n: int, group=None):
    """Tag every tensor of a (nested dict / list) batch as the rank's rows
    of a batch split `n` ways over `group`; returns the batch."""
    if isinstance(tree, torch.Tensor):
        setattr(tree, _MARK, (rank, n, group))
    elif isinstance(tree, dict):
        for v in tree.values():
            mark_rows(v, rank, n, group)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            mark_rows(v, rank, n, group)
    return tree


def rows_of(tree) -> Optional[Tuple[int, int, object]]:
    """The (rank, n, group) tag of the first tagged tensor in `tree`
    (nested dicts, lists, tuples), or None."""
    if isinstance(tree, torch.Tensor):
        return getattr(tree, _MARK, None)
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        found = rows_of(v)
        if found is not None:
            return found
    return None


def is_writer() -> bool:
    """Whether this process writes logs and checkpoints: rank 0 of the
    default process group, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def global_logs(log, group, n: int):
    """A step's scalar logs over the global batch: a scalar tensor, or the
    scalar tensors of a log dict, as the ranks' mean, but a key ending in
    "max" / "min" (QGPO's `f_max`, `f_min`) as their max / min (one
    all-reduce per kind); anything else as it is."""
    if isinstance(log, torch.Tensor) and log.ndim == 0 and log.is_floating_point():
        return global_logs({"_": log}, group, n)["_"]
    if not isinstance(log, dict):
        return log
    out = dict(log)
    for op, pick in ((dist.ReduceOp.MAX, lambda k: k.endswith("max")),
                     (dist.ReduceOp.MIN, lambda k: k.endswith("min")),
                     (dist.ReduceOp.SUM, lambda k: not k.endswith(("max", "min")))):
        keys = [k for k, v in log.items() if pick(k) and isinstance(v, torch.Tensor)
                and v.ndim == 0 and v.is_floating_point()]
        if keys:
            vals = torch.stack([log[k].detach().float() for k in keys])
            dist.all_reduce(vals, op=op, group=group)
            if op == dist.ReduceOp.SUM:
                vals = vals / n
            out.update({k: vals[i] for i, k in enumerate(keys)})
    return out


def rows_step(step: Callable) -> Callable:
    """`step` data-parallel on a batch tagged as this rank's rows, whole on
    an untagged one (module note). Within an active `batch_rows` (a step
    called by a data-parallel step) it runs as it is."""
    @functools.wraps(step)
    def run(*args, **kwargs):
        rows = None if _ROWS is not None else rows_of((args, kwargs))
        if rows is None:
            return step(*args, **kwargs)
        rank, n, group = rows
        with batch_rows(rank, n, group):
            log = step(*args, **kwargs)
        return global_logs(log, group, n)

    return run


def writer_only(save: Callable) -> Callable:
    """A save method that writes on the writing rank only (`is_writer`)."""
    @functools.wraps(save)
    def run(*args, **kwargs):
        if is_writer():
            return save(*args, **kwargs)

    return run

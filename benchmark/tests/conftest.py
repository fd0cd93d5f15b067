"""Shared helpers of the benchmark's tests: the cells at a size the CPU runs
in about a second, and a card fixture for the tests marked `gpu`, which run
on the card with `python3 -m pytest benchmark/tests -m gpu`."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

WORKLOADS = ("diffuser_mujoco.eval50x64", "dd_mujoco.eval1024")


def tiny(workload: str):
    """(configuration, traffic) of a cell cut to a CPU test's size: widths,
    depth, horizon, steps and batch shrunk; everything else as the cell's
    files say."""
    _, cfg, traffic = run.find_cell(run.load_manifest(), workload)
    if cfg["family"] == "dd":
        cfg.update(d_model=64, n_heads=2, emb_dim=32, sampling_steps=4, horizon=8)
        traffic.update(envs=4)
    else:
        cfg.update(model_dim=8, dim_mult=[1, 2], sampling_steps=4, diffusion_steps=4, horizon=8)
        traffic.update(envs=4, candidates=4)
    traffic.update(warmup_plans=1, check_plans=2, trace_plans=2, trace_host_plans=1)
    return cfg, traffic


def run_tiny(workload: str, seed: int = 2 ** 33 + 7, trace: bool = False, seconds: float = 0.05,
             **kw):
    """One run of a cell at the tiny size on the CPU, the chip's look
    skipped: (result, numbers compared)."""
    import torch

    cfg, traffic = tiny(workload)
    return run.run_cell(workload, seed, seconds, trace, torch.device("cpu"), config=cfg,
                        traffic=traffic, **kw)


@pytest.fixture
def card():
    """The CUDA device; skips where there is none (decided here, not at
    import, so that every test process collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

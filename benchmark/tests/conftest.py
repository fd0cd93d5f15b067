"""Shared helpers of the benchmark's tests: the manifest's cells, each cut
to a size the CPU runs in about a second by its family's `tiny`, the faults
planted in its family's program (`faults/<family>.py`), and a card fixture
for the tests marked `gpu`, which run on the card with
`python3 -m pytest benchmark/tests -m gpu`."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

# every cell of BENCHMARK.json, in its order
WORKLOADS = tuple(c["name"] for c in run.load_manifest()["workloads"])


def family(workload: str):
    """The module of the cell's family (`benchmark/families/<family>.py`)."""
    return run.load_family(run.find_cell(run.load_manifest(), workload)[1])


def faults(workload: str):
    """The faults planted in the program of the cell's family: the module
    `faults/<family>.py`, whose `plant(monkeypatch, fault)` plants one."""
    _, cfg, _ = run.find_cell(run.load_manifest(), workload)
    return run.load_module(Path(__file__).resolve().parent / "faults" / f"{cfg['family']}.py")


def tiny(workload: str):
    """(configuration, traffic) of a cell cut to a CPU test's size by its
    family's `tiny`, with a plan or two in each phase of a run."""
    _, cfg, traffic = run.find_cell(run.load_manifest(), workload)
    cfg, traffic = run.load_family(cfg).tiny(cfg, traffic)
    traffic.update(warmup_plans=1, check_plans=2, trace_plans=2, trace_host_plans=1)
    return cfg, traffic


def halve(t, axis: int):
    """A planted fault's half batch: the second half of t along `axis`
    replaced, in place, by the mean of the first."""
    n = t.shape[axis]
    rest = t.narrow(axis, n // 2, n - n // 2)
    rest.copy_(t.narrow(axis, 0, n // 2).float().mean(axis, keepdim=True).expand_as(rest))


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

"""`correct` on the CPU at a test's size: the plain reference against the
port's CPU path, each fault a cell can have read as not correct, and the
control (the reference in TF32) on the card.

The faults are planted in the program underneath a run whose look for a
chip is skipped, each family's in its own file (`faults/<family>.py`): a
sampler step that returns its state unchanged, half of the batch left out
with the mean of the other half in its place, and an answer altered where
it is produced. The exchange between chips has no cell here (every cell
runs on one chip). Every test runs on every cell of BENCHMARK.json."""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from conftest import WORKLOADS, faults, run_tiny, tiny


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_matches_the_reference_on_the_cpu(workload):
    result, checks = run_tiny(workload)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    for name, (value, limit) in checks.items():
        assert value <= limit
        # the CPU runs both sides in plain float32: far inside any limit
        assert value <= 1e-4 * (1 if name != "logp_gap" else 10), name


@pytest.mark.parametrize("fault", ["step_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_fault_reads_not_correct(monkeypatch, workload, fault):
    faults(workload).plant(monkeypatch, fault)
    result, checks = run_tiny(workload)
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_is_judged_alike(workload):
    result, _ = run_tiny(workload, trace=True, seconds=60)
    assert result["correct"] and result["attempted"] == 3
    assert "breakdown" in result and result["window_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_in_tf32_reads_not_correct(card, workload):
    """The reference computed with TF32 on, in the program's place, at a
    size a test holds (the cell's widths, a smaller batch): at least one
    number over its limit. benchmark/control.py reads it at the cells'
    own sizes."""
    from benchmark import control

    _, cfg, traffic = run.find_cell(run.load_manifest(), workload)
    traffic.update(envs=min(traffic["envs"], 16), check_plans=1)
    readings = control.readings(cfg, traffic, seeds=[3], device=card)
    assert any(v > cfg["limits"][k] for r in readings for k, v in r.items()), readings


@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_sizes_keep_the_cells_configuration_keys(workload):
    cfg, traffic = tiny(workload)
    _, file_cfg, file_traffic = run.find_cell(run.load_manifest(), workload)
    assert set(cfg) == set(file_cfg) and set(traffic) == set(file_traffic)


def test_record_keeps_a_seeded_sample_of_bounded_size():
    draws = []
    for seed in (5, 5, 6):
        record = run.Record(seed, 3)
        for i in range(200):
            record.add(0.01, {"act": torch.zeros(1), "i": i})
        assert len(record.answers) == 200 and len(record.sample) == 3
        assert all(out["i"] == i for i, out in record.sample.items())
        draws.append(sorted(record.sample))
    assert draws[0] == draws[1] != draws[2]
    assert max(draws[0]) >= 3

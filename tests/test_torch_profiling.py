"""The port's profiling hooks (utils/profiling.py) on the CPU: `Throughput`
against the JAX package's under one patched clock, `trace` writing a trace
file, and an `annotate` range among the profiler's events."""

import json
import time

import pytest
import torch

import cleandiffuser_tpu.utils.profiling as jprof
import cleandiffuser_tpu_torch.utils.profiling as tprof


@pytest.mark.parametrize("ema", (0.9, 0.5))
def test_throughput_matches_jax(monkeypatch, ema):
    clock = {"now": 0.0}

    def fake():
        return clock["now"]

    monkeypatch.setattr(time, "perf_counter", fake)
    meters = (jprof.Throughput(ema), tprof.Throughput(ema))
    for items, now in zip((100, 7, 3, 250), (0.5, 1.25, 1.25, 3.0)):
        clock["now"] = now
        rates = [m.update(items) for m in meters]
        assert rates[0] == rates[1] and rates[1] == meters[1].rate
    assert meters[1].rate > 0


def test_trace_writes_a_trace_file(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path), with_memory=True) as prof:
        (x @ x).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_annotate_range_is_a_profiler_event(tmp_path):
    x = torch.randn(32, 32)
    with tprof.trace(str(tmp_path), with_memory=False) as prof:
        with tprof.annotate("picard.sweep"):
            x.exp()
    names = [e.name for e in prof.events()]
    assert "picard.sweep" in names
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert "picard.sweep" in files[0].read_text()

"""The port's profiling hooks (utils/profiling.py) on the CPU: `trace`
writing a trace file, and an `annotate` range among the profiler's events
(tests/test_torch_spans.py holds the spans of the pipelines' path)."""

import json

import torch

import cleandiffuser_tpu_torch.utils.profiling as tprof


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

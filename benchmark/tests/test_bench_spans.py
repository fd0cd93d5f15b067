"""The readers of the program's spans (benchmark/program_spans.py and the
metrics `denoise_ms_per_plan`, `guide_ms_per_plan`, `update_ms_per_plan`):
on synthetic events, on a tiny traced run on the CPU, and on the card."""

from __future__ import annotations

from types import SimpleNamespace as NS

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import program_spans, run, tracing
from conftest import WORKLOADS, family, run_tiny, tiny

SPAN_METRICS = ("denoise_ms_per_plan", "guide_ms_per_plan", "update_ms_per_plan")


def _ev(name, start, end, device=False, thread=1, kernels=(), parent=None):
    e = NS(name=name, time_range=NS(start=start, end=end), thread=thread,
           kernels=[NS(name=k, duration=us) for k, us in kernels], cpu_parent=parent,
           cpu_children=[], is_user_annotation=device and "." in name,
           device_type=torch.autograd.DeviceType.CUDA if device else
           torch.autograd.DeviceType.CPU)
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def _two_plans(plan_span: str):
    """A window of two plans, each one step: the denoiser, the guidance
    (its backward on the engine's thread) and the update; a backward
    that starts after the guidance, and a plan span outside the window."""
    win = _ev("bench.window", 0, 300)
    events = [win, _ev(plan_span, 310, 320), _ev(plan_span, 10, 20, device=True)]
    for base in (0, 100):
        plan = _ev(plan_span, base + 10, base + 90)
        den = _ev("sampler.denoise", base + 12, base + 20, parent=plan,
                  kernels=[("sampler.denoise", 8)])
        _ev("aten::conv1d", base + 13, base + 18, parent=den, kernels=[("conv", 4)])
        guide = _ev("sampler.guide", base + 20, base + 50, parent=plan)
        _ev("aten::conv1d", base + 21, base + 25, parent=guide, kernels=[("conv", 3)])
        upd = _ev("sampler.update", base + 50, base + 60, parent=plan)
        _ev("aten::add", base + 51, base + 52, parent=upd, kernels=[("add", 1)])
        events += [plan, den, guide, upd, *den.cpu_children, *guide.cpu_children,
                   *upd.cpu_children,
                   _ev(f"{program_spans.BACKWARD}: ConvBackward0", base + 30, base + 45,
                       thread=2, kernels=[("dgrad", 5)]),
                   _ev(f"{program_spans.BACKWARD}: AddBackward0", base + 70, base + 75,
                       thread=2, kernels=[("add", 7)]),
                   _ev("sampler.guide", base + 22, base + 48, device=True)]
    return tracing.Trace(events)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_readers_on_synthetic_events(workload):
    """The readers, and the metrics through them, count the plans by the
    cell's family's plan span and read what they read when the span names
    were a fixed list (the same numbers); a trace whose plans another span
    names has nothing to read."""
    plan_span = family(workload).Cell.plan_span
    trace = _two_plans(plan_span)
    assert program_spans.host_spans(trace, (plan_span,)) == [(10, 90), (110, 190)]
    # per plan, through the metrics, which take the span from the run's
    # context: the conv under the denoiser, not the span's device copy; the
    # guidance's forward conv and the backward that starts inside its span,
    # not the one that starts after it; the update's add. To the bit what
    # the readers gave with the plan spans a fixed list.
    ctx = NS(host_trace=trace, plan_span=plan_span)
    read = lambda name: run.load_module(run.BENCH / "metrics" / f"{name}.py").read(ctx)
    assert [read(name) for name in SPAN_METRICS] == [4e-3, 8e-3, 1e-3]
    other = plan_span + ".other"
    assert program_spans.span_ms_per_plan(trace, other, "sampler.denoise") is None
    assert program_spans.guide_ms_per_plan(trace, other) is None


def test_readers_find_nothing_without_plan_spans():
    trace = _two_plans("some.plan")
    trace.events = [e for e in trace.events if e.name != "some.plan"]
    assert program_spans.span_ms_per_plan(trace, "some.plan", "sampler.denoise") is None
    assert program_spans.guide_ms_per_plan(trace, "some.plan") is None
    assert program_spans.span_ms_per_plan(_two_plans("some.plan"), "some.plan",
                                          "sampler.nothing") is None


@pytest.mark.parametrize("workload", WORKLOADS)
def test_plan_spans_of_a_tiny_cell_on_the_cpu(workload):
    """The program's spans as a real record holds them: one plan span per
    plan; no kernels on the CPU, so no device time to read."""
    cfg, traffic = tiny(workload)
    cell = run.load_family(cfg).Cell(cfg, traffic, 11, torch.device("cpu"))
    cell.build()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            for i in range(2):
                cell.serve(cell.request(i))
    trace = tracing.Trace(prof.events())
    assert len(program_spans.host_spans(trace, (cell.plan_span,))) == 2
    steps = 2 * cfg["sampling_steps"]
    assert len(program_spans.host_spans(trace, ("sampler.denoise",))) == steps
    assert len(program_spans.host_spans(trace, ("sampler.update",))) == steps
    # the sampler guides where the configuration gives the classifier a weight
    guides = steps if cfg.get("w_cg", 0) != 0 else 0
    assert len(program_spans.host_spans(trace, (program_spans.GUIDE_SPAN,))) == guides
    assert program_spans.span_ms_per_plan(trace, cell.plan_span, "sampler.denoise") is None


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_tiny_run_reports_the_span_metrics_or_none(workload):
    result, _ = run_tiny(workload, trace=True, seconds=60)
    assert result["correct"]
    for name in SPAN_METRICS:
        if name in result["metrics"]:
            assert result["metrics"][name]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_span_metrics_on_the_card(card, workload):
    """The cell at its own size, traced over a few plans: each span metric
    of the cell above 0, and each share of a roofline or of the peak
    (`*_roofline`, `*mfu*`) read, above 0 and at most 100 %."""
    manifest = run.load_manifest()
    _, cfg, traffic = run.find_cell(manifest, workload)
    traffic.update(warmup_plans=1, check_plans=1, trace_plans=2, trace_host_plans=2)
    result, _ = run.run_cell(workload, 5, 600, True, card, manifest, config=cfg,
                             traffic=traffic)
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    wanted = [m["name"] for m in run.metrics_of(manifest, workload, "per_layer")
              if m["name"] in SPAN_METRICS]
    assert wanted and all(metrics.get(name, 0) > 0 for name in wanted), metrics
    shares = [m["name"] for m in run.metrics_of(manifest, workload, "per_layer")
              if m["name"].endswith("_roofline") or "mfu" in m["name"]]
    assert all(0 < metrics.get(name, 0) <= 100 for name in shares), metrics

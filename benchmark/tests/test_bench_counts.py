"""The operation and byte counters against the counts PERF.md's kernel
table gives, the window's rate and percentile arithmetic, and the trace
reduction on synthetic events."""

from __future__ import annotations

from types import SimpleNamespace as NS

import pytest
import torch

from benchmark import run, stats, tracing, work
from benchmark.reference import diffuser
from conftest import ROOT

MUJOCO_UNET = dict(obs_dim=17, act_dim=6, horizon=32, model_dim=32, dim_mult=[1, 2, 2, 2],
                   kernel_size=5, classifier_kernel_size=3)


def test_k1_counts():
    ops, nbytes = work.dit_block(100, 32, 320, 10)
    assert round(ops / 1e9, 3) == 7.995 and round(nbytes / 1e6, 2) == 13.89
    assert round(work.dit_block(3200, 32, 320, 10)[0] / 1e9, 2) == 255.85
    assert round(work.dit_block(100, 64, 320, 10)[0] / 1e9, 2) == 16.25


def test_k3_counts():
    calls = [work.film_resblock(3200, h, ci, co, 5) for h, ci, co in diffuser.unet_blocks(MUJOCO_UNET)]
    assert len(calls) == 16
    assert round(sum(ops for ops, _ in calls) / 1e9, 2) == 119.08
    assert round(work.film_resblock(3200, 4, 256, 256, 5)[0] / 1e9, 2) == 16.78


def test_vjp_counts():
    """The classifier VJP pair at one shape by hand, (H 4, 256 -> 256, K 3,
    8 groups) at B = 3200 (12,800 rows): two convs each way, no skip."""
    fwd = work.film_vjp_forward(3200, 4, 256, 256, 3, 8)
    grad = work.film_vjp_input_grad(3200, 4, 256, 256, 3, 8)
    assert fwd[0] == grad[0] == 2 * (2 * 12800 * 3 * 256 * 256) == 10_066_329_600
    # reads x, emb, both convs and six vectors; writes out, n1, n2, r1, r2
    assert fwd[1] == 4 * (12800 * 256 + 3200 * 256 + 2 * 3 * 256 * 256 + 6 * 256
                          + 3 * 12800 * 256 + 2 * 3200 * 8) == 57_489_408
    # reads the gradient at out, n1, n2, r1, r2, both convs and four
    # vectors; writes dx
    assert grad[1] == 4 * (3 * 12800 * 256 + 2 * 3200 * 8 + 2 * 3 * 256 * 256 + 4 * 256
                           + 12800 * 256) == 54_210_560
    # without residuals the forward is K3's block; a skip adds its 1x1 conv
    assert work.film_vjp_forward(3200, 4, 256, 256, 3, 8, residuals=False) == \
        work.film_resblock(3200, 4, 256, 256, 3)
    skip = work.film_vjp_input_grad(3200, 4, 128, 256, 3, 8)
    assert skip[0] == 2 * 12800 * (3 * 128 * 256 + 3 * 256 * 256 + 128 * 256)


def test_vjp_launches_of_a_diffuser_plan():
    """A Diffuser plan at 50 envs x 64 candidates: per step of 20 the ten
    classifier blocks forward and their ten input gradients (85.62 GFLOP,
    PERF.md's kernel table), then the ten forwards of the final log p."""
    diffuser_family = run.load_module(run.BENCH / "families" / "diffuser.py")
    cfg = dict(MUJOCO_UNET, sampling_steps=20, w_cg=0.1)
    cell = diffuser_family.Cell(cfg, {"envs": 50, "candidates": 64}, 0, torch.device("cpu"))
    pair = cell.work()["kernels"]["vjp"]
    launches = pair["launches"]
    assert pair["match"] == "film_vjp_" and len(launches) == pair["per_plan"] == 20 * 20 + 10
    step = launches[:20]
    assert round(sum(ops for ops, _ in step) / 1e9, 2) == 85.62
    assert launches[6] == work.film_vjp_forward(3200, 4, 128, 256, 3, 8)
    assert launches[13] == work.film_vjp_input_grad(3200, 4, 128, 256, 3, 8)
    assert launches[20:40] == step and launches[-10:] == [
        work.film_vjp_forward(3200, h, ci, co, k, diffuser.groups(co), residuals=False)
        for h, ci, co, k in diffuser.classifier_blocks(cfg)]
    unguided = dict(cfg, w_cg=0.0)
    assert len(diffuser_family.Cell(unguided, {"envs": 50, "candidates": 64}, 0,
                                    torch.device("cpu")).work()["kernels"]["vjp"]["launches"]) == 10


def test_roofline_share_counts_each_launch_once():
    trace = NS(kernel_time_s=lambda match: (80, 80 * 1e-3))
    ops, nbytes = work.dit_block(300, 32, 320, 10)
    ctx = NS(work={"kernels": {"k1": {"match": "dit_block_kernel", "launches": [(ops, nbytes)]}}},
             trace=trace, config={"peak": "tf32_ops_per_s"},
             peaks=work.peaks("NVIDIA H100 80GB HBM3"))
    assert work.roofline_pct(ctx, "k1") == pytest.approx(100 * ops / 495e12 / 1e-3)
    assert work.roofline_pct(ctx, "k3") is None


def _window(latencies):
    return NS(latencies_s=latencies, actions=150 * len(latencies), window_s=sum(latencies))


@pytest.mark.parametrize("stall", [0.4, 2.0])
def test_a_stall_moves_the_rate_and_the_tail(stall):
    rate = run.load_module(run.BENCH / "metrics" / "actions_per_s.py").read
    p95 = run.load_module(run.BENCH / "metrics" / "plan_p95_ms.py").read
    steady = [0.040] * 200
    stalled = [0.040] * 180 + [stall] * 20
    assert rate(_window(steady)) == pytest.approx(150 / 0.040)
    assert rate(_window(stalled)) < 0.9 * rate(_window(steady))
    assert p95(_window(steady)) == pytest.approx(40.0)
    assert p95(_window(stalled)) == pytest.approx(stall * 1e3)


def test_percentile_and_spread():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == pytest.approx(95.05)
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([9, 10, 10, 11]) == pytest.approx((10.75 - 9.25) / 10)


def _ev(name, start, end, device=False, thread=1, kernels=(), parent=None):
    e = NS(name=name, time_range=NS(start=start, end=end), thread=thread, kernels=list(kernels),
           cpu_parent=parent, cpu_children=[], is_user_annotation=False,
           device_type=torch.autograd.DeviceType.CUDA if device else
           torch.autograd.DeviceType.CPU)
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def test_trace_reduction():
    k = lambda name, us: NS(name=name, duration=us)
    win = _ev("bench.window", 0, 100)
    span = _ev("bench.plan", 10, 40, kernels=[k("bench.plan", 30)])
    conv = _ev("aten::conv1d", 12, 20, kernels=[k("conv", 8)], parent=span)
    back = _ev("autograd::engine::evaluate_function: X", 40, 50, thread=2, kernels=[k("dgrad", 6)])
    events = [win, span, conv, back,
              _ev("conv", 15, 23, device=True), _ev("dgrad", 44, 50, device=True),
              _ev("dgrad", 48, 52, device=True), _ev("bench.plan", 15, 52, device=True),
              _ev("Memcpy HtoD", 60, 62, device=True)]
    t = tracing.Trace(events)
    assert t.window_s == pytest.approx(1e-4)
    assert t.busy_s == pytest.approx((8 + 8 + 2) * 1e-6)
    assert [op[0] for op in t.kernels()] == ["conv", "dgrad", "dgrad"]
    assert t.gaps() == [(0, 15), (23, 44), (52, 60), (62, 100)]
    assert t.kernel_time_s("dgrad") == (2, pytest.approx(10e-6))
    roots = lambda e: e.name == "bench.plan" or e.name.startswith("autograd::")
    assert t.device_time_under(roots) == pytest.approx(14e-6)
    labels = dict(t.idle_gaps())
    assert labels["bench.plan"] == pytest.approx(21e-6)
    assert labels["python between operations"] == pytest.approx((15 + 8 + 38) * 1e-6)


def test_peaks_table_holds_the_card():
    entry = work.peaks("NVIDIA H100 80GB HBM3")
    assert entry["tf32_ops_per_s"] == 495e12 and entry["bytes_per_s"] == 3.35e12
    assert (ROOT / "benchmark" / "peaks.json").exists()

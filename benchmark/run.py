"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json` "workloads") names a
configuration (its file under `benchmark/configs/`, whose "family" names
`benchmark/families/<family>.py` and `benchmark/reference/<family>.py`) and
a traffic mix (`benchmark/traffic/<traffic>.json`); each metric is read by
`benchmark/metrics/<name>.py`. A family's file holds its `Cell`, which
names the program's span around a plan (`plan_span`), and `tiny`, its size
for the CPU tests; its planted faults are in
`benchmark/tests/faults/<family>.py`. So a cell, a configuration, a mix, a
metric or a whole family is added with files and manifest entries alone.

A run is one process: set-up (the program's import, seeded weights on the
card, the pipeline, its kernels, the warm-up plans of the cell's shapes),
then a closed loop of one client for `--seconds`, each request sent when
the last one returned; the window ends with the first plan that finishes
past `--seconds`. With `--trace 1` the window runs under `torch.profiler`,
recording the device alone for the mix's `trace_plans` plans (busy time,
launches, kernel times: little host overhead), then the host and the
device for `trace_host_plans` more (what the host did while the device
idled, device time under a span), and the run reports the per-layer
metrics instead of the end-to-end ones. Once the window has
closed, the peak memory is read, the program is freed, and a sample of the
window's plans drawn from the seed (the mix's `check_plans`) is replayed by
the plain reference;
`correct` holds where every number compared is within its limit (the
configuration's "limits") and no plan returned an invalid answer. Those
numbers and limits are the last lines on standard error and the last key
("checks") of the result, the last line on standard output.

Without a CUDA device, or with fewer than the cell asks for, it exits with
code 2 and prints no result; with jax, jaxlib, flax, optax or the JAX
package loaded once the window has closed, with code 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded, compared whole: the port's
# own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cleandiffuser_tpu")
# the caches Triton and the CUDA driver may write, at fixed paths inside the
# checkout (the kernels' libraries build into cleandiffuser_tpu_torch/_build)
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def set_cache_dirs():
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(BENCH / ".cache" / sub)


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_family(config: dict):
    """The module of a configuration's family, `families/<family>.py`."""
    return load_module(BENCH / "families" / f"{config['family']}.py")


def find_cell(manifest: dict, workload: str):
    """(cell, configuration, traffic mix) of a workload, read from its files."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def metrics_of(manifest: dict, workload: str, kind: str):
    """The manifest's `kind` ("end_to_end" or "per_layer") metrics that the
    cell reports: those that list it, and those that list no cells."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


class Record:
    """What the window keeps of its plans: every plan's latency and answer
    (the actions, a few kilobytes), and the whole outputs of a sample of
    `size` plans drawn uniformly from the seed as they finish (a reservoir,
    so that memory does not grow with the window)."""

    def __init__(self, seed: int, size: int):
        self.rng, self.size = random.Random(seed), size
        self.latencies, self.answers, self.sample = [], [], {}

    def add(self, latency: float, out: dict):
        i = len(self.answers)
        self.latencies.append(latency)
        self.answers.append(out["act"])
        if i < self.size:
            self.sample[i] = out
        else:
            j = self.rng.randrange(i + 1)
            if j < self.size:
                del self.sample[sorted(self.sample)[j]]
                self.sample[i] = out


def _loop(cell, device, seconds: float, max_plans, span, record: Record) -> float:
    """The closed loop of one client: the next request is made and sent
    when the last plan has returned, until `seconds` have passed (or
    `max_plans` plans, where given). Returns the window's seconds."""
    t_window = time.perf_counter()
    count = 0
    while True:
        t0 = time.perf_counter()
        with span("bench.request"):
            req = cell.request(len(record.answers))
        with span("bench.plan"):
            out = cell.serve(req)
        with span("bench.sync"):
            _sync(device)
        t1 = time.perf_counter()
        record.add(t1 - t0, out)
        count += 1
        if t1 - t_window >= seconds or (max_plans is not None and count >= max_plans):
            return t1 - t_window


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, manifest=None,
             config=None, traffic=None, t_start=None):
    """Run the cell once on `device`. `config` and `traffic` replace the
    cell's files (the tests' small sizes). Returns (result without the
    device's name, numbers compared {name: (value, limit)})."""
    import torch

    t_start = T_START if t_start is None else t_start
    manifest = manifest or load_manifest()
    _, file_config, file_traffic = find_cell(manifest, workload)
    config, traffic = config or file_config, traffic or file_traffic
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
    torch.backends.cudnn.allow_tf32 = config["tf32"]
    cell = load_family(config).Cell(config, traffic, seed, device)

    cell.build()
    for k in range(traffic["warmup_plans"]):
        cell.serve(cell.request(-2 - k))
    _sync(device)
    setup_s = time.perf_counter() - t_start

    record = Record(seed, traffic["check_plans"])
    nospan = lambda name: contextlib.nullcontext()
    if not trace:
        window_s = _loop(cell, device, seconds, None, nospan, record)
    else:
        from torch.profiler import ProfilerActivity, profile

        from benchmark import tracing

        # the device's record alone over the mix's trace_plans: busy time,
        # launches and kernel times with little host overhead; then the host
        # too over trace_host_plans, for what the host did in the idle gaps
        # and the device time under a span
        # (a CPU test's run has no device to record: it records the host)
        prof = profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.start()
        window_s = _loop(cell, device, seconds, traffic["trace_plans"], nospan, record)
        prof.stop()
        device_trace = tracing.Trace(prof.events(), window_s)
        n_device = len(record.answers)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            _loop(cell, device, seconds, traffic["trace_host_plans"],
                  torch.profiler.record_function, record)
        prof.stop()
        host_trace = tracing.Trace(prof.events())
        prof = None
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    failed = sum(cell.invalid(act) for act in record.answers)
    n_plans, kept = len(record.answers), record.sample
    work = cell.work()
    cell.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": n_plans, "failed": failed}
    ctx = SimpleNamespace(config=config, traffic=traffic, work=work, plans=n_plans,
                          actions=cell.actions_per_plan * n_plans, latencies_s=record.latencies,
                          window_s=window_s, setup_s=setup_s, plan_span=cell.plan_span,
                          trace=None, host_trace=None, peaks=None)
    if trace:
        from benchmark import work as counting

        ctx.trace, ctx.host_trace = device_trace, host_trace
        ctx.plans, ctx.host_plans = n_device, n_plans - n_device
        ctx.peaks = counting.peaks(torch.cuda.get_device_name(device)
                                   if device.type == "cuda" else "")
        result["busy_s"], result["window_s"] = device_trace.busy_s, device_trace.window_s
        result["breakdown"] = {"device_ops": device_trace.device_ops(),
                               "idle_gaps": host_trace.idle_gaps()}
    metrics = {}
    for m in metrics_of(manifest, workload, "per_layer" if trace else "end_to_end"):
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["memory_peak_bytes"] = memory_peak

    with torch.no_grad():
        cases = []
        for i in sorted(kept):
            req = cell.request(i)
            cases.append((req, kept[i], cell.reference(req)))
        numbers = cell.judge(cases)
    limits = config["limits"]
    checks = {name: (value, limits[name]) for name, value in numbers.items()}
    result["correct"] = failed == 0 and all(v <= lim for v, lim in checks.values())
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_cache_dirs()
    # the checkout's root, in place of this script's folder, whose module
    # names (tracing, work, ...) would shadow others'
    sys.path[0] = str(ROOT)
    import torch

    manifest = load_manifest()
    cell, _, _ = find_cell(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                              manifest)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules loaded that the benchmark forbids: {loaded}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell["chips"], "memory_peak_bytes": result.pop("memory_peak_bytes")}
    if args.trace:
        dev["busy_s"], dev["window_s"] = result.pop("busy_s"), result.pop("window_s")
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"], "device": dev}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What a later change adds as files and manifest entries, with no file
edited, found by name in a copy of the benchmark: a configuration, a
traffic mix, a cell and a metric; and a whole family, whose cell the
copy's own tests then cover. And what the run path and the references
load, by top-level module name, compared whole. Each case starts from the
manifest's cells, never from a cell or a family named here."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

from benchmark import run
from conftest import ROOT, WORKLOADS

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cleandiffuser_tpu"}


def _env(cwd, extra_path=()):
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(cwd), *map(str, extra_path)]))


def _python(code: str, cwd, extra_path=()):
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          env=_env(cwd, extra_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _copy(tmp_path):
    """A copy of the benchmark and its manifest under tmp_path: (manifest,
    the bytes of every file in the copy)."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    return manifest, _files(tmp_path)


def _files(tmp_path):
    return {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts and ".cache" not in p.parts}


def _add(tmp_path, manifest, config_name, config, entry, traffic_name, traffic):
    """A configuration (its manifest entry copied from `entry`), a mix and
    their cell, written into the copy: the cell's name."""
    (tmp_path / f"benchmark/configs/{config_name}.json").write_text(json.dumps(config))
    (tmp_path / f"benchmark/traffic/{traffic_name}.json").write_text(json.dumps(traffic))
    manifest["configs"].append(dict(entry, name=config_name,
                                    file=f"benchmark/configs/{config_name}.json"))
    cell = f"{config_name}.{traffic_name}"
    manifest["workloads"].append({"name": cell, "config": config_name, "traffic": traffic_name,
                                  "chips": 1, "why": "added by files alone"})
    return cell


def test_new_config_mix_cell_and_metric_are_found_by_name(tmp_path):
    manifest, before = _copy(tmp_path)
    base, cfg, traffic = run.find_cell(manifest, WORKLOADS[0])
    cfg, traffic = run.load_family(cfg).tiny(cfg, traffic)
    traffic.update(warmup_plans=1, check_plans=1, trace_plans=2, trace_host_plans=1)
    entry = next(c for c in manifest["configs"] if c["name"] == base["config"])
    cell = _add(tmp_path, manifest, "added_small", cfg, entry, "added_mix", traffic)
    (tmp_path / "benchmark/metrics/plans_in_window.py").write_text(
        "def read(ctx):\n    return ctx.plans\n")
    manifest["end_to_end"].append({"name": "plans_in_window", "unit": "plans",
                                   "better": "higher", "bound": 0.1, "source": "host_clock",
                                   "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    out = _python(f"""
        import json, torch
        from benchmark import run
        result, checks = run.run_cell({cell!r}, 5, 0.05, False, torch.device("cpu"))
        print(json.dumps({{"root": str(run.ROOT), "result": result}}))
        """, tmp_path, [ROOT])
    assert out["root"] == str(tmp_path)
    assert out["result"]["correct"]
    assert set(out["result"]["metrics"]) == {"actions_per_s", "setup_s", "plans_in_window"}
    assert out["result"]["metrics"]["plans_in_window"]["value"] == out["result"]["attempted"]
    after = _files(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


# a family that runs the cell of another under a plan span of its own
WRAPPED_FAMILY = """\
\"\"\"The {base} family's cell under a plan span of its own.\"\"\"

from pathlib import Path

import torch

from benchmark import run

_base = run.load_module(Path(__file__).resolve().parent / "{base}.py")


def tiny(config, traffic):
    return _base.tiny(config, traffic)


class Cell(_base.Cell):
    plan_span = "wrapped.plan"

    def serve(self, req):
        with torch.profiler.record_function(self.plan_span):
            return super().serve(req)
"""
WRAPPED_FAULTS = """\
from pathlib import Path

from benchmark import run

plant = run.load_module(Path(__file__).resolve().parent / "{base}.py").plant
"""


def test_a_new_family_is_added_by_files_alone(tmp_path):
    """A family `wrapped` (its `Cell`, `tiny` and plan span, its reference
    and its planted faults) with a configuration, a mix, a cell and a
    per-layer metric, all new files and manifest entries, in a copy of the
    benchmark. It wraps the family of the manifest's first cell. The copy's
    own manifest, correctness and span tests then cover the new cell, and
    every file that was there is unchanged."""
    manifest, before = _copy(tmp_path)
    base, cfg, traffic = run.find_cell(manifest, WORKLOADS[0])
    family = cfg["family"]
    bench = tmp_path / "benchmark"
    (bench / "families/wrapped.py").write_text(WRAPPED_FAMILY.format(base=family))
    (bench / "reference/wrapped.py").write_text(f"from .{family} import *  # noqa: F403\n")
    (bench / "tests/faults/wrapped.py").write_text(WRAPPED_FAULTS.format(base=family))
    entry = next(c for c in manifest["configs"] if c["name"] == base["config"])
    cell = _add(tmp_path, manifest, "wrapped_cfg", dict(cfg, family="wrapped"), entry,
                "wrapped_mix", traffic)
    (bench / "metrics/plans_traced.py").write_text("def read(ctx):\n    return ctx.plans\n")
    manifest["per_layer"].append({"name": "plans_traced", "unit": "plans", "better": "higher",
                                  "source": "host_clock", "layer": "client",
                                  "moves": "actions_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    tests = [f"benchmark/tests/test_bench_{name}.py" for name in ("manifest", "correct", "spans")]
    proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                           "-m", "not gpu", "-k", cell, *tests], cwd=tmp_path,
                          env=_env(tmp_path, [ROOT]), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    counts = dict((k, int(n)) for n, k in re.findall(r"(\d+) (passed|failed|skipped|error)",
                                                     proc.stdout))
    # the cell's own cases: 2 of the manifest, 6 of correct, 3 of the spans
    assert counts == {"passed": 11}, proc.stdout[-2000:]
    assert {k: v for k, v in _files(tmp_path).items() if k in before} == before


def test_run_path_loads_nothing_forbidden():
    out = _python("""
        import json, sys, torch
        from benchmark import run
        sys.path.insert(0, "benchmark/tests")
        from conftest import WORKLOADS, run_tiny
        for w in WORKLOADS:
            run_tiny(w)
        print(json.dumps({"forbidden": run.forbidden_modules(),
                          "port": "cleandiffuser_tpu_torch" in sys.modules}))
        """, ROOT)
    assert out == {"forbidden": [], "port": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cleandiffuser_tpu_torch_extra", sys)
    assert "cleandiffuser_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cleandiffuser_tpu.models", sys)
    assert "cleandiffuser_tpu" in run.forbidden_modules()


def test_references_load_nothing_of_the_program():
    out = _python("""
        import importlib, json, sys
        from pathlib import Path
        for path in sorted(Path("benchmark/reference").glob("[!_]*.py")):
            importlib.import_module(f"benchmark.reference.{path.stem}")
        roots = {m.split(".")[0] for m in sys.modules}
        print(json.dumps(sorted(roots & {"cleandiffuser_tpu_torch", "jax", "jaxlib", "flax",
                                         "optax", "cleandiffuser_tpu"})))
        """, ROOT)
    assert out == []


def test_run_exits_without_a_result_where_only_the_benchmark_is():
    """A directory that holds only BENCHMARK.json and the benchmark's files:
    no program, so the run fails and prints no result."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "benchmark", f"{tmp}/benchmark",
                        ignore=shutil.ignore_patterns("__pycache__", ".cache"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp)
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                               WORKLOADS[0], "--seed", "1", "--seconds", "1"],
                              cwd=tmp, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "{" not in proc.stdout

"""What a later change adds as files and manifest entries, with no file
edited: a configuration, a traffic mix, a cell and a metric, found by name
in a copy of the benchmark. And what the run path and the references load,
by top-level module name, compared whole."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

from benchmark import run
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cleandiffuser_tpu"}


def _python(code: str, cwd, extra_path=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(cwd), *map(str, extra_path)]))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_new_config_mix_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}

    cfg = json.loads((ROOT / "benchmark/configs/dd_mujoco.json").read_text())
    cfg.update(d_model=64, n_heads=2, emb_dim=32, sampling_steps=3, horizon=8)
    (tmp_path / "benchmark/configs/dd_small.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/eval3.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "envs": 3, "warmup_plans": 1, "check_plans": 1,
         "trace_plans": 2, "trace_host_plans": 1}))
    (tmp_path / "benchmark/metrics/plans_in_window.py").write_text(
        "def read(ctx):\n    return ctx.plans\n")
    manifest["configs"].append({"name": "dd_small", "source": "https://arxiv.org/abs/2211.15657",
                                "file": "benchmark/configs/dd_small.json", "reduced": [],
                                "why": "a small DD"})
    manifest["workloads"].append({"name": "dd_small.eval3", "config": "dd_small",
                                  "traffic": "eval3", "chips": 1, "why": "3 envs"})
    manifest["end_to_end"].append({"name": "plans_in_window", "unit": "plans",
                                   "better": "higher", "bound": 0.1, "source": "host_clock",
                                   "workloads": ["dd_small.eval3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    out = _python("""
        import json, torch
        from benchmark import run
        result, checks = run.run_cell("dd_small.eval3", 5, 0.05, False, torch.device("cpu"))
        print(json.dumps({"root": str(run.ROOT), "result": result}))
        """, tmp_path, [ROOT])
    assert out["root"] == str(tmp_path)
    assert out["result"]["correct"]
    assert set(out["result"]["metrics"]) == {"actions_per_s", "setup_s", "plans_in_window"}
    assert out["result"]["metrics"]["plans_in_window"]["value"] == out["result"]["attempted"]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts and ".cache" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before


def test_run_path_loads_nothing_forbidden():
    out = _python("""
        import json, sys, torch
        from benchmark import run
        sys.path.insert(0, "benchmark/tests")
        from conftest import run_tiny
        for w in ("dd_mujoco.eval1024", "diffuser_mujoco.eval50x64"):
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
        import json, sys
        import benchmark.reference.dd, benchmark.reference.diffuser, benchmark.reference.plain
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
                               "dd_mujoco.eval1024", "--seed", "1", "--seconds", "1"],
                              cwd=tmp, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "{" not in proc.stdout

"""BENCHMARK.json against the benchmark's contract: names, units and
lengths, the files every entry is found by, and what each cell reports."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import run
from conftest import ROOT, WORKLOADS, faults

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
            assert (ROOT / word).exists()


def test_run_seconds_fits_the_full_check():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in MANIFEST[k]]
    for group in ("configs", "workloads"):
        cells = [e["name"] for e in MANIFEST[group]]
        assert len(cells) == len(set(cells))
    assert len(names) == len(set(names))
    for entry in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert NAME.match(entry["name"]) and _line(entry["why"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cell_pairs_and_chips():
    cells = MANIFEST["workloads"]
    pairs = [(c["config"], c["traffic"]) for c in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    used = {c["config"] for c in cells}
    assert used == {c["name"] for c in MANIFEST["configs"]}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cells(workload):
    """What a cell needs: its keys and metrics, and its family's files and
    hooks (the family's `Cell` with its plan span and `tiny`, the
    reference, the planted faults)."""
    c = next(c for c in MANIFEST["workloads"] if c["name"] == workload)
    assert set(c) == {"name", "config", "traffic", "chips", "why"} and c["chips"] in (1, 4)
    e2e = [m["name"] for m in run.metrics_of(MANIFEST, workload, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.metrics_of(MANIFEST, workload, "per_layer")
    for m in run.metrics_of(MANIFEST, workload, "per_layer"):
        assert m["moves"] in e2e
    _, config, _ = run.find_cell(MANIFEST, workload)
    assert (run.BENCH / "reference" / f"{config['family']}.py").exists()
    family = run.load_family(config)
    assert callable(family.tiny) and isinstance(family.Cell.plan_span, str)
    for hook in ("build", "request", "serve", "reference", "invalid", "judge", "work", "free"):
        assert callable(getattr(family.Cell, hook)), hook
    assert callable(faults(workload).plant)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_file_is_found_by_name(workload):
    cell, config, traffic = run.find_cell(MANIFEST, workload)
    entry = next(c for c in MANIFEST["configs"] if c["name"] == cell["config"])
    assert entry["file"].startswith("benchmark/configs/")
    assert config["reduced"] == entry["reduced"]
    assert (run.BENCH / "families" / f"{config['family']}.py").exists()
    assert (run.BENCH / "reference" / f"{config['family']}.py").exists()
    for kind in ("end_to_end", "per_layer"):
        for m in run.metrics_of(MANIFEST, workload, kind):
            assert hasattr(run.load_module(run.BENCH / "metrics" / f"{m['name']}.py"), "read")
    assert set(config["limits"]) and traffic["loop"] == "closed" and traffic["clients"] == 1


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or rel.startswith("benchmark/.cache"):
            continue
        assert PATH.match(rel), rel

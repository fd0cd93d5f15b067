"""Run cells of the benchmark several times, one process each in turn, and
report every metric's median and spread: the numbers a bound is set from.

    python3 benchmark/spread.py --workload <name> [--workload ...] --seeds 11 12 13
        [--trace 0|1] [--seconds S] [--out DIR]

Each run is `benchmark/run.py` as the driver starts it, with `--seconds`
the manifest's `run_seconds` unless given. The runs of each workload go in
the order of the seeds; every result line, with the numbers compared and
the run's exit code and wall seconds, is appended to DIR/<workload>.jsonl
(default `chiprun_out/spread`). The spread of a metric is the distance
between its first and third quartile over its median (`stats.spread`).
The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[0] = str(ROOT)

from benchmark import stats  # noqa: E402


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(BENCH / "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": proc.returncode,
            "wall_s": wall, "line": line, "stderr_tail": proc.stderr[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "spread"))
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failures = 0
    for workload in args.workload:
        runs = []
        for seed in args.seeds:
            r = run_once(workload, seed, seconds, args.trace)
            runs.append(r)
            with open(out / f"{workload}.jsonl", "a") as f:
                f.write(json.dumps({**r, "card": smi}) + "\n")
            line = r["line"] or {}
            checks = {k: v["value"] for k, v in line.get("checks", {}).items()}
            values = {k: v["value"] for k, v in line.get("metrics", {}).items()}
            print(f"{workload} seed {seed} rc {r['rc']} wall {r['wall_s']:.1f} s correct "
                  f"{line.get('correct')} attempted {line.get('attempted')} failed "
                  f"{line.get('failed')} metrics {values} checks {checks}", flush=True)
            if r["rc"] != 0 or not line.get("correct"):
                failures += 1
                print(r["stderr_tail"], flush=True)
        names = sorted({k for r in runs if r["line"] for k in r["line"]["metrics"]})
        for name in names:
            values = [r["line"]["metrics"][name]["value"] for r in runs
                      if r["line"] and name in r["line"]["metrics"]]
            if len(values) >= 4:
                print(f"{workload} {name}: median {statistics.median(values)!r} spread "
                      f"{stats.spread(values)!r} over {len(values)} runs", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

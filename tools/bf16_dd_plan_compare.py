"""The bf16 DD plan against another checkout's (e.g. the parent unpacked by
`git archive`): latency and device busy time of the same requests in bf16
and in f32, each checkout in a process of its own, in turns.

    python tools/bf16_dd_plan_compare.py --other DIR [--requests 20] [--out FILE]

Each process builds DD planning as `chip_smoke.py`'s bf16 phase does
(configs/dd/mujoco with `bf16_sampling=true` through `setup_mesh`, seeded
weights, 50 envs), serves one warm-up request, then twice in turn: the
requests in bf16 and in f32 (median latency on the host clock, the
launches of K1's two routes), each followed by one request under
`torch.profiler` (device busy ms, `chip_smoke.py`'s `profile_request`);
then each route's host time per wrapper call at the plan's shape (100,
32, 320). The checkouts run other, this, this, other; each process
imports the `chip_smoke.py` and package of the directory it runs in.
Needs a CUDA device; prints one JSON line per process and writes them all
to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(n_requests: int) -> dict:
    """The measurement in this process, with the checkout of the working
    directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as c

    c.check_device()
    dev = torch.device("cuda", 0)
    args = c.load_config(c.ROOT / "configs/dd" / "mujoco", "mujoco",
                         overrides=["bf16_sampling=true"])
    c.setup_mesh(args)
    rng = np.random.default_rng(c.SEED + 11)
    pipe = c.build_pipeline(args, dev, args.use_pallas_block, c.dd_weights(args, rng))
    E, O = args.num_envs, args.task.obs_dim
    obs = [torch.from_numpy(rng.standard_normal((E, O)).astype(np.float32)).to(dev)
           for _ in range(n_requests + 1)]
    gen = torch.Generator(device=dev).manual_seed(c.SEED)
    c.serve(pipe, obs[:1], gen)
    out = {}
    for _ in range(2):
        for mode in ("bf16", "f32"):
            if mode == "f32":
                pipe.agent.bf16_sampling = False
            elif "bf16_sampling" in vars(pipe.agent):
                del pipe.agent.bf16_sampling
            c.reset_counts()
            lat = c.serve(pipe, obs[1:], gen)
            n16, n32 = c.fused_dit_block_bf16.launches, c.fused_dit_block.launches
            prof = c.profile_request(lambda: pipe.act(obs[1], generator=gen),
                                     statistics.median(lat), ())
            out.setdefault(mode, []).append({
                "median_ms": statistics.median(lat), "lat": [round(v, 3) for v in lat],
                "busy_ms": prof["device_busy_ms"], "launches_bf16": n16, "launches_f32": n32})
    # each route's host time per wrapper call at the plan's shape: the
    # enqueue time of 200 calls, which never wait for the device (its queue
    # holds more), 5 runs
    x, mod, ws = c.block_inputs(np.random.default_rng(c.SEED), dev, 100, 32, 320)
    wb = [w.to(torch.bfloat16) for w in ws]
    for name, fn in (("bf16", lambda: c.fused_dit_block_bf16(x, mod, *wb, n_heads=10)),
                     ("f32", lambda: c.fused_dit_block(x, mod, *ws, n_heads=10))):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            runs.append((time.perf_counter() - t0) / 200 * 1e3)
            torch.cuda.synchronize()
        out[f"wrapper_host_ms_{name}"] = runs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/bf16_dd_plan_compare.json")
    ap.add_argument("--one", action="store_true", help="measure in this process only")
    args = ap.parse_args(argv)
    if args.one:
        print("PLAN " + json.dumps(one(args.requests)), flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    runs = []
    for name, cwd in (("other", args.other), ("this", ROOT), ("this", ROOT),
                      ("other", args.other)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                               "--requests", str(args.requests)], cwd=cwd,
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("PLAN ")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"{name} ({cwd}) failed:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        runs.append({"checkout": name, **json.loads(lines[-1][5:])})
        print(json.dumps(runs[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a training step's time goes on the card, in the PyTorch port: DD and
Diffuser `train_step` time, device time, idle share and the fused blocks'
part (K1 in DD, K3 in the Diffuser U-Net), through the kernels and through
the plain blocks.

    python tools/profile_train_step.py [--out DIR]

Builds both training pipelines as `chip_smoke.py` does (configs/dd/mujoco
and configs/diffuser/mujoco, halfcheetah-medium-v2, batch 64, seeded
weights and batches), then for each pipeline and path:
- step time: the median of 12 `train_step`s per path, in turns kernel,
  plain, plain, kernel (CUDA events around each step, host enqueue
  included), after a warm-up step;
- `torch.profiler` over 3 steps per path: device busy time per step (the
  sum of every device event: one stream, so they do not overlap), the fused
  block kernel's device time and launches, every kernel launch, and the
  largest kernels;
- the idle share: 1 - device busy / unprofiled median step time.
Needs a CUDA device; writes the numbers to DIR/profile_train_step.json.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cleandiffuser_tpu_torch.pipelines import DiffuserPipeline  # noqa: E402
from cleandiffuser_tpu_torch.utils.config import load_config  # noqa: E402
from profile_dd_plan import device_events  # noqa: E402


def build(name: str, dev):
    """{"kernel": pipe, "plain": pipe} and seeded batches for `name`."""
    if name == "dd":
        args = load_config(ROOT / "configs/dd/mujoco", "mujoco")
        rng = np.random.default_rng(cs.SEED + 6)
        weights = cs.dd_weights(args, rng)
        pipes = {k: cs.build_pipeline(args, dev, k == "kernel", weights)
                 for k in ("kernel", "plain")}
        scale = pipes["kernel"].return_scale
    else:
        args = load_config(ROOT / "configs/diffuser/mujoco", "mujoco")
        rng = np.random.default_rng(cs.SEED + 7)
        kw, weights = cs.diffuser_setup(args, rng)
        pipes = {k: DiffuserPipeline(**kw, use_pallas_block=k == "kernel", device=dev)
                 for k in ("kernel", "plain")}
        for p in pipes.values():
            p.load_jax_params(**weights)
        scale = 0.0
    batches = cs.train_batches(rng, 4, args.batch_size, args.task.horizon, args.task.obs_dim,
                               args.task.act_dim, dev, scale)
    return pipes, batches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    result = {"device": smi}
    for name, block in (("dd", "dit_block_kernel"), ("diffuser", "film_resblock")):
        pipes, batches = build(name, dev)
        times = cs.step_ms(pipes, batches)
        result[name] = {}
        for k, pipe in pipes.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for b in batches[:3]:
                    pipe.train_step(b)
                torch.cuda.synchronize()
            events = device_events(prof)
            busy = sum(ms for _, ms, _ in events) / 3
            fused = [(ms, n) for ev, ms, n in events if block in ev]
            launches = sum(n for ev, _, n in events if not ev.startswith("Memcpy")
                           and not ev.startswith("Memset")) / 3
            median = statistics.median(times[k])
            line = {"step_ms": times[k], "median_step_ms": median, "device_busy_ms": busy,
                    "idle_share": 1 - busy / median, "kernel_launches_per_step": launches,
                    "fused_block_device_ms_per_step": sum(ms for ms, _ in fused) / 3,
                    "fused_block_launches_per_step": sum(n for _, n in fused) / 3,
                    "top": sorted(((ms / 3, ev) for ev, ms, _ in events), reverse=True)[:10]}
            result[name][k] = line
            print(name, k, json.dumps(line), flush=True)
        del pipes
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_train_step.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a training step's time goes on the card, in the PyTorch port: DD and
Diffuser `train_step` time, device time, idle share and the fused blocks'
part (K1 in DD, K3 in the Diffuser U-Net), through the kernels and through
the plain blocks; and the DQL, IDQL and EDP policies' steps and requests
(MLPs, no kernel).

    python tools/profile_train_step.py [--out DIR] [--pipelines dd diffuser dql idql edp]

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
DQL, IDQL and EDP are built by their CLIs' `build` from
configs/{dql,idql,edp}/mujoco (halfcheetah-medium-v2, the synthetic data,
seeded init) and measured at the config's batch (256, batches from the
device sampler) over RL_STEPS steps, a whole number of their gates'
periods (IDQL's critic moves on even steps, DQL's and EDP's target every
5th): the mean step time (CUDA events), and `torch.profiler` around each
step on its own for the mean device busy time and launches; for IDQL also
each of these over its critic steps and its frozen steps apart. Then a
request (`act` at 50 envs with the config's candidates: latency, device
busy, idle share, launches).
Needs a CUDA device; writes the numbers to DIR/profile_train_step.json.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cleandiffuser_tpu_torch.cli import dql_d4rl_mujoco, edp_d4rl_mujoco, idql_d4rl_mujoco  # noqa: E402
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


RL_CLIS = {"dql": dql_d4rl_mujoco, "idql": idql_d4rl_mujoco, "edp": edp_d4rl_mujoco}


def profiled(fn, n: int) -> dict:
    """`torch.profiler` over n calls of fn: device busy ms and kernel
    launches per call, and the largest device events."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    busy = sum(ms for _, ms, _ in events) / n
    launches = sum(c for ev, _, c in events if not ev.startswith(("Memcpy", "Memset"))) / n
    top_all = sorted(((ms / n, ev) for ev, ms, _ in events), reverse=True)
    return {"device_busy_ms": busy, "kernel_launches": launches, "top": top_all[:10],
            "top_all": top_all}


RL_STEPS = 20  # timed steps; the profiler takes half as many, each on its own


def rl_steps(pipe, batches: list) -> tuple:
    """RL_STEPS timed steps, then RL_STEPS // 2 profiled ones: per step
    (the critic step's parity before it, ms) and (parity, device busy ms,
    launches); and the largest device events, per step."""
    times, prof_steps, total = [], [], collections.Counter()
    for i in range(RL_STEPS):
        parity = pipe.critic_step % 2
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        pipe.train_step(batches[i % len(batches)])
        end.record()
        end.synchronize()
        times.append((parity, start.elapsed_time(end)))
    n = RL_STEPS // 2
    for i in range(n):
        parity = pipe.critic_step % 2
        line = profiled(lambda: pipe.train_step(batches[i % len(batches)]), 1)
        prof_steps.append((parity, line["device_busy_ms"], line["kernel_launches"]))
        for ms, ev in line["top_all"]:
            total[ev] += ms / n
    top = sorted(((ms, ev) for ev, ms in total.items()), reverse=True)[:10]
    return times, prof_steps, top


def rl_step_line(times: list, prof_steps: list) -> dict:
    """Means of step time, device busy time and launches, and the idle
    share they give."""
    mean = statistics.fmean(ms for _, ms in times)
    busy = statistics.fmean(b for _, b, _ in prof_steps)
    return {"step_ms": [ms for _, ms in times], "mean_step_ms": mean, "device_busy_ms": busy,
            "kernel_launches": statistics.fmean(n for _, _, n in prof_steps),
            "idle_share": 1 - busy / mean}


def profile_rl(name: str, dev) -> dict:
    """One RL pipeline at its shipped config: step and request."""
    cli = RL_CLIS[name]
    args = load_config(cli.CONFIG_DIR, "mujoco")
    dataset, pipe = cli.build(args, dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    batches = [dataset.sample_batch(gen, args.batch_size) for _ in range(4)]
    pipe.train_step(batches[0])  # warm-up
    times, prof_steps, top = rl_steps(pipe, batches)
    step = {**rl_step_line(times, prof_steps), "top": top}
    if name == "idql":  # critic steps (even) and frozen steps (odd) apart
        for parity, key in ((0, "critic_steps"), (1, "frozen_steps")):
            step[key] = rl_step_line([t for t in times if t[0] == parity],
                                     [s for s in prof_steps if s[0] == parity])
    wt = args.weight_temperature if name == "idql" else args.task.weight_temperature
    obs = dataset.obs[:args.num_envs]
    act = lambda: pipe.act(obs, num_candidates=args.num_candidates, weight_temperature=wt,
                           use_ema=args.use_ema, temperature=args.temperature)
    lat = []
    for _ in range(6):  # the first one warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act().cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    req = profiled(act, 3)
    del req["top_all"]
    med = statistics.median(lat[1:])
    req.update(latency_ms=lat[1:], median_latency_ms=med, idle_share=1 - req["device_busy_ms"] / med,
               rows=args.num_envs * args.num_candidates, sampling_steps=args.sampling_steps)
    return {"step": step, "request": req}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--pipelines", nargs="+", default=["dd", "diffuser", "dql", "idql", "edp"])
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
    for name in args.pipelines:
        if name in RL_CLIS:
            result[name] = profile_rl(name, dev)
            for part, line in result[name].items():
                print(name, part, json.dumps(line), flush=True)
            torch.cuda.empty_cache()
            continue
        block = {"dd": "dit_block_kernel", "diffuser": "film_resblock"}[name]
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

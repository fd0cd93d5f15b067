"""Where a DD plan's time goes on the card, in the PyTorch port: plan
latency, device time, idle share and the fused DiT block's part, through
the kernel and through the plain block.

    python tools/profile_dd_plan.py [--out DIR]

Builds DD planning as `chip_smoke.py` does (configs/dd/mujoco,
halfcheetah-medium-v2, 50 envs, seeded weights), then:
- plan latency: the median of 6 `act` requests per path, in turns kernel,
  plain, plain, kernel, after a warm-up (host clock around `act` and a
  synchronise);
- `torch.profiler` over 3 plans per path: device busy time per plan (the sum
  of every device event: one stream, so they do not overlap), the DiT
  block kernel's device time and launches, and every kernel launch;
- the idle share: 1 - device busy / unprofiled median latency;
- K1 alone at the plan's shape (100, 32, 320), weights hot in L2, for the
  in-plan time against 40 x the isolated time.
Needs a CUDA device; writes the numbers to DIR/profile_dd_plan.json.
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
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cleandiffuser_tpu_torch.ops.dit_block import fused_dit_block  # noqa: E402
from cleandiffuser_tpu_torch.pipelines import DDPipeline  # noqa: E402
from cleandiffuser_tpu_torch.utils.config import load_config  # noqa: E402
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, jax_params_of  # noqa: E402


def device_events(prof):
    """(name, device ms, count) of every device event, summed by name. A
    user annotation's device span (e.g. `Optimizer.step#AdamW.step`) covers
    kernels counted on their own, and is left out."""
    out = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((e.key, us / 1e3, e.count))
    return out


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
    cfg = load_config(ROOT / "configs/dd/mujoco", "mujoco")
    E, H, O = cfg.num_envs, cfg.task.horizon, cfg.task.obs_dim
    rng = np.random.default_rng(cs.SEED + 1)
    probe = DDPipeline(obs_dim=O, act_dim=cfg.task.act_dim, horizon=H, emb_dim=cfg.emb_dim,
                       d_model=cfg.d_model, n_heads=cfg.n_heads, depth=cfg.depth, device="cpu")
    weights = {
        "params": cs.seeded_tree(agent_params_of(probe.agent.params), rng),
        "ema_params": cs.seeded_tree(agent_params_of(probe.agent.ema_params), rng),
        "invdyn": {"params": cs.seeded_tree(jax_params_of(probe.invdyn.net), rng)},
    }
    pipes = {"kernel": cs.build_pipeline(cfg, dev, True, weights),
             "plain": cs.build_pipeline(cfg, dev, False, weights)}
    obs = torch.from_numpy(rng.standard_normal((E, O)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for pipe in pipes.values():
        cs.serve(pipe, [obs, obs], gen)  # warm-up

    lat = {k: [] for k in pipes}
    for _ in range(3):
        for k in ("kernel", "plain", "plain", "kernel"):
            lat[k] += cs.serve(pipes[k], [obs], gen)
    result = {"device": smi, "envs": E, "paths": {}}
    for k, pipe in pipes.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cs.serve(pipe, [obs] * 3, gen)
        events = device_events(prof)
        busy = sum(ms for _, ms, _ in events) / 3
        k1 = [(ms, n) for name, ms, n in events if "dit_block_kernel" in name]
        launches = sum(n for name, _, n in events if not name.startswith("Memcpy")
                       and not name.startswith("Memset")) / 3
        median = statistics.median(lat[k])
        line = {"latency_ms": lat[k], "median_latency_ms": median, "device_busy_ms": busy,
                "idle_share": 1 - busy / median, "kernel_launches_per_plan": launches,
                "k1_device_ms_per_plan": sum(ms for ms, _ in k1) / 3,
                "k1_launches_per_plan": sum(n for _, n in k1) / 3,
                "top": sorted(((ms / 3, name) for name, ms, _ in events), reverse=True)[:8]}
        result["paths"][k] = line
        print(k, json.dumps(line), flush=True)

    # K1 alone at the plan's shape, on the first block's weights
    B, D = 2 * E, cfg.d_model
    block = pipes["kernel"].agent.ema_params["diffusion"].blocks[0]
    x = torch.randn(B, H, D, device=dev)
    with torch.no_grad():
        mod = F.silu(torch.randn(B, D, device=dev)) @ block.wmod + block.bmod
        ws = (block.wqkv, block.bqkv, block.wo, block.bo, block.w1, block.b1, block.w2, block.b2)
        ms = cs.cuda_ms(lambda: fused_dit_block(x, mod, *ws, n_heads=block.n_heads), 50)
    result["k1_isolated_ms"] = ms
    k1_plan = result["paths"]["kernel"]["k1_device_ms_per_plan"]
    n = result["paths"]["kernel"]["k1_launches_per_plan"]
    print(f"K1 alone at ({B}, {H}, {D}): {ms:.4f} ms per block; "
          f"in the plan {k1_plan:.3f} ms over {n:.0f} launches against {n:.0f} x {ms:.4f} = "
          f"{n * ms:.3f} ms", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_dd_plan.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

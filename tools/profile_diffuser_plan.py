"""Where a Diffuser plan's time goes on the card, in the PyTorch port: plan
latency, device busy time and idle share, the fused FiLM residual block's
(K3) part and the classifier gradient's part.

    python tools/profile_diffuser_plan.py [--config antmaze] [--requests 3] [--out DIR]

Builds Diffuser planning as `chip_smoke.py` does (configs/diffuser/<config>
with its default task, seeded weights in the JAX layout, the U-Net's blocks
through K3), 50 envs x 64 candidates, then:
- plan latency: the median of `--requests` `act` requests after a warm-up
  (host clock around `act` and a synchronise);
- `torch.profiler` over one plan: device busy time (the sum of every device
  event: one stream, so they do not overlap), K3's device time and
  launches;
- the classifier's input gradient (`classifier.gradients`, one call per
  sampling step): its part of the plan is the plan's busy time less that
  of the same plan profiled with the gradient replaced by zeros (its
  backward runs on autograd's own thread, outside any range the sampler's
  thread could mark); beside it the gradient alone at the plan's shape,
  times the sampling steps (CUDA events);
- the idle share: 1 - device busy / the median latency.
Needs a CUDA device; writes the numbers to DIR/profile_diffuser_plan_<config>.json
(DIR: `--out`, by default the ignored `results/`).
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
from tools.profile_dd_plan import device_events  # noqa: E402

def profiled_busy(pipe, obs, K, gen):
    """Device events of one profiled plan, and their busy ms."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cs.serve_diffuser(pipe, [obs], K, gen)
    events = device_events(prof)
    return events, sum(ms for _, ms, _ in events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="antmaze", choices=["mujoco", "antmaze", "kitchen"])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cfg = load_config(ROOT / "configs/diffuser" / args.config, args.config)
    E, K, O = cfg.num_envs, cfg.num_candidates, cfg.task.obs_dim
    rng = np.random.default_rng(cs.SEED + 4)
    kw, weights = cs.diffuser_setup(cfg, rng)
    pipe = DiffuserPipeline(**kw, use_pallas_block=True, device=dev)
    pipe.load_jax_params(**weights)
    gradients = pipe.classifier.gradients
    obs = torch.from_numpy(rng.standard_normal((E, O)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cs.serve_diffuser(pipe, [obs], K, gen)  # warm-up
    lat = cs.serve_diffuser(pipe, [obs] * args.requests, K, gen)
    events, busy = profiled_busy(pipe, obs, K, gen)
    k3 = [(ms, n) for name, ms, n in events if "film_resblock" in name]
    k3_ms = sum(ms for ms, _ in k3)
    pipe.classifier.gradients = lambda params, x, t, c=None: (
        torch.zeros((x.shape[0], 1), device=x.device), torch.zeros_like(x))
    _, busy_without = profiled_busy(pipe, obs, K, gen)
    pipe.classifier.gradients = gradients
    cls_ms = busy - busy_without
    launches = sum(n for name, _, n in events if not name.startswith(("Memcpy", "Memset")))
    median = statistics.median(lat)
    # the classifier's input gradient alone at the plan's shape, once per step
    x = torch.randn((K * E, cfg.task.horizon, O + cfg.task.act_dim), device=dev)
    t = torch.full((K * E,), cfg.sampling_steps - 1, dtype=torch.long, device=dev)
    alone_ms = cfg.sampling_steps * cs.cuda_ms(
        lambda: gradients(pipe.classifier.inference_params, x, t), 5)
    result = {
        "device": smi, "config": args.config, "envs": E, "candidates": K,
        "horizon": cfg.task.horizon, "model_dim": cfg.model_dim, "latency_ms": lat,
        "median_latency_ms": median, "device_busy_ms": busy, "idle_share": 1 - busy / median,
        "kernel_launches_per_plan": launches, "k3_device_ms": k3_ms,
        "k3_launches": sum(n for _, n in k3), "k3_share_of_busy": k3_ms / busy,
        "busy_without_classifier_gradient_ms": busy_without,
        "classifier_gradient_device_ms": cls_ms, "classifier_gradient_share_of_busy": cls_ms / busy,
        "classifier_gradient_alone_ms": alone_ms,
        "top": sorted(((ms, name) for name, ms, _ in events), reverse=True)[:10]}
    print(json.dumps(result), flush=True)
    print(f"Diffuser plan ({args.config}, {E} x {K}, horizon {cfg.task.horizon}, model_dim "
          f"{cfg.model_dim}): latency median {median:.1f} ms; device busy {busy:.1f} ms (idle "
          f"{1 - busy / median:.1%}); K3 {k3_ms:.1f} ms over {result['k3_launches']} launches "
          f"({k3_ms / busy:.1%} of busy); classifier gradient {cls_ms:.1f} ms "
          f"({cls_ms / busy:.1%} of busy; alone, {cfg.sampling_steps} calls at the plan's shape: "
          f"{alone_ms:.1f} ms)", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_diffuser_plan_{args.config}.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

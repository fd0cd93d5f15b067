"""Smoke run of the PyTorch port on one NVIDIA GPU: Decision Diffuser
planning at the shipped width, through the hand-written Hopper kernel.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device  - a CUDA device must be present (there is no CPU path); prints
             the `nvidia-smi` name and power limit.
2. build   - builds the fused DiT block kernel (csrc/dit_block.cu) with nvcc
             from the sources in this checkout; prints the seconds it took
             and the compiler's register / shared-memory report.
3. kernel  - the kernel against its plain PyTorch version at the plan's
             shape (B=100, H=32, D=320, 10 heads, f32), on seeded non-zero
             weights and modulation; prints the error and both times.
4. slice   - builds DDPipeline on the GPU from configs/dd/mujoco (task
             halfcheetah-medium-v2), loads seeded non-zero weights through
             the JAX-layout converter, serves 5 `act` requests for 50 envs,
             checks the actions, the inpainted first state and the kernel's
             launch count (40 per request: 20 steps x 2 blocks), and holds
             one plan through the kernel against the same plan through the
             plain version, with the same explicit noise.

The line before the last is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}. TF32 is off for every
comparison (matmul and cuDNN), so both sides compute in full float32.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from cleandiffuser_tpu_torch.ops import build  # noqa: E402
from cleandiffuser_tpu_torch.ops.dit_block import (  # noqa: E402
    dit_block_reference,
    fused_dit_block,
    load_dit_block_library,
)
from cleandiffuser_tpu_torch.pipelines import DDPipeline  # noqa: E402
from cleandiffuser_tpu_torch.utils.config import load_config  # noqa: E402
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, jax_params_of  # noqa: E402

SEED = 0
N_REQUESTS = 5
# Kernel vs plain version, one block, f32 on both sides: they differ only in
# the order of f32 sums (K up to 4*D = 1280 terms) and in expf/tanhf/rsqrtf
# against PyTorch's versions, a few 1e-6 relative; 1e-4 leaves margin.
BLOCK_ATOL = BLOCK_RTOL = 1e-4
# One 20-step plan, kernel vs plain with the same noise: the per-block
# differences above pass through 20 x 2 blocks and the sampler.
PLAN_ATOL = 1e-3


def phase(name):
    print(f"[chip_smoke] --- {name}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back calls. The device
    first spins for ~0.5 s, so the host has enqueued every call before
    the device reaches them: the events then time the device alone, not
    the host's launch rate (the plain block is ~25 launches, and the host
    of a one-card machine is shared and slow)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def seeded_tree(tree: dict, rng: np.random.Generator) -> dict:
    """Same structure, every leaf refilled with seeded normals: matrices at
    std 1/sqrt(fan_in), vectors at 0.1. Fresh adaLN-Zero weights are zero,
    which would make every block the identity and the net output 0."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = seeded_tree(v, rng)
        else:
            std = 1.0 / np.sqrt(v.shape[0]) if v.ndim == 2 else 0.1
            out[k] = (rng.standard_normal(v.shape) * std).astype(np.float32)
    return out


def check_device() -> str:
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0)


def build_kernels():
    phase("build")
    t0 = time.perf_counter()
    load_dit_block_library()
    print(f"dit_block built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in build.build_log("dit_block").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())


def check_kernel(dev) -> dict:
    phase("kernel vs plain version")
    B, H, D, NH = 100, 32, 320, 10
    rng = np.random.default_rng(SEED)

    def t(*shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)

    x, mod = t(B, H, D, std=1.0), t(B, 6 * D, std=0.5)
    ws = [t(D, 3 * D, std=D ** -0.5), t(3 * D, std=0.1), t(D, D, std=D ** -0.5), t(D, std=0.1),
          t(D, 4 * D, std=D ** -0.5), t(4 * D, std=0.1), t(4 * D, D, std=(4 * D) ** -0.5),
          t(D, std=0.1)]
    out = fused_dit_block(x, mod, *ws, n_heads=NH)
    ref = dit_block_reference(x, mod, *ws, n_heads=NH)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_abs = err.max().item()
    max_rel = (err / ref.abs().clamp_min(1e-3)).max().item()
    print(f"shape (B={B}, H={H}, D={D}, heads={NH}) f32: max_abs_err {max_abs:.3e} "
          f"max_rel_err {max_rel:.3e} (max |ref| {ref.abs().max().item():.3f})")
    torch.testing.assert_close(out, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)

    kern = lambda: fused_dit_block(x, mod, *ws, n_heads=NH)
    plain = lambda: dit_block_reference(x, mod, *ws, n_heads=NH)
    for f in (kern, plain):  # warm-up
        cuda_ms(f, 5)
    # in turns: plain, kernel, kernel, plain
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(cuda_ms(kern if name == "kernel" else plain, 50))
    ms, plain_ms = statistics.mean(times["kernel"]), statistics.mean(times["plain"])
    print(f"device time per block (weights hot in L2): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(runs {times['kernel']} / {times['plain']})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def build_pipeline(args, dev, use_kernel: bool, weights: dict) -> DDPipeline:
    pipe = DDPipeline(
        obs_dim=args.task.obs_dim, act_dim=args.task.act_dim, horizon=args.task.horizon,
        emb_dim=args.emb_dim, d_model=args.d_model, n_heads=args.n_heads,
        depth=args.depth, label_dropout=args.label_dropout,
        predict_noise=args.predict_noise, next_obs_loss_weight=args.next_obs_loss_weight,
        solver=args.solver, sampling_steps=args.sampling_steps,
        w_cfg=args.task.w_cfg, target_return=args.task.target_return,
        temperature=args.temperature, use_pallas_block=use_kernel, rng=args.seed,
        device=dev,
    )
    pipe.load_jax_params(weights["params"], weights["ema_params"], weights["invdyn"])
    return pipe


def serve(pipe: DDPipeline, obs_batches, generator) -> list:
    """Serve one `act` request per batch; returns per-request ms."""
    lat = []
    for obs in obs_batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act, info = pipe.act(obs, generator=generator)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        traj = info["traj"]
        if tuple(act.shape) != (obs.shape[0], pipe.act_dim):
            raise AssertionError(f"actions {tuple(act.shape)}")
        if not (torch.isfinite(act).all() and torch.isfinite(traj).all()):
            raise AssertionError("non-finite actions or plan")
        if act.abs().max().item() > 1.0:
            raise AssertionError("actions outside [-1, 1]")
        if not torch.equal(traj[:, 0], obs):
            raise AssertionError("plan's first state is not the observation")
    return lat


def check_slice(dev) -> int:
    phase("slice: DD planning")
    args = load_config(ROOT / "configs/dd/mujoco", "mujoco")
    E, H, O = args.num_envs, args.task.horizon, args.task.obs_dim
    rng = np.random.default_rng(SEED + 1)

    # seeded weights in the JAX package's layout (shapes taken from a CPU
    # build of the same config), carried in by the converter
    probe = DDPipeline(obs_dim=O, act_dim=args.task.act_dim, horizon=H, emb_dim=args.emb_dim,
                       d_model=args.d_model, n_heads=args.n_heads, depth=args.depth)
    weights = {
        "params": seeded_tree(agent_params_of(probe.agent.params), rng),
        "ema_params": seeded_tree(agent_params_of(probe.agent.ema_params), rng),
        "invdyn": {"params": seeded_tree(jax_params_of(probe.invdyn.net), rng)},
    }
    del probe
    pipe = build_pipeline(args, dev, args.use_pallas_block, weights)
    plain = build_pipeline(args, dev, False, weights)
    print(f"config: obs {O} act {args.task.act_dim} horizon {H} d_model {args.d_model} "
          f"heads {args.n_heads} depth {args.depth} {args.solver} x {args.sampling_steps} "
          f"w_cfg {args.task.w_cfg} target_return {args.task.target_return} envs {E} "
          f"(CFG batch {2 * E}) use_pallas_block {args.use_pallas_block}")
    if not args.use_pallas_block:
        raise AssertionError("the shipped config must turn the fused block on")

    obs = [torch.from_numpy(rng.standard_normal((E, O)).astype(np.float32)).to(dev)
           for _ in range(N_REQUESTS + 1)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cold = serve(pipe, obs[:1], gen)  # first request: allocator and library warm-up

    fused_dit_block.launches = 0
    lat = serve(pipe, obs[1:], gen)
    launches = fused_dit_block.launches
    expected = N_REQUESTS * args.sampling_steps * args.depth
    print(f"{N_REQUESTS} requests x {E} envs: latency ms {[round(v, 3) for v in lat]} "
          f"(median {statistics.median(lat):.3f}; cold first request {cold[0]:.3f}); "
          f"dit_block launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"dit_block launched {launches} times, expected {expected}")

    plain_lat = serve(plain, obs[1:], gen)
    print(f"same requests through the plain block: latency ms "
          f"{[round(v, 3) for v in plain_lat]} (median {statistics.median(plain_lat):.3f})")

    # one plan, kernel vs plain version, same explicit noise
    shape = (E, H, O)
    noise = (torch.randn(shape, generator=gen, device=dev),
             torch.randn((args.sampling_steps,) + shape, generator=gen, device=dev))
    act_k, info_k = pipe.act(obs[1], noise=noise)
    act_p, info_p = plain.act(obs[1], noise=noise)
    d_traj = (info_k["traj"] - info_p["traj"]).abs().max().item()
    d_act = (act_k - act_p).abs().max().item()
    print(f"plan kernel vs plain: max |traj diff| {d_traj:.3e}, max |act diff| {d_act:.3e} "
          f"(max |traj| {info_p['traj'].abs().max().item():.3f}; atol {PLAN_ATOL})")
    if not (d_traj <= PLAN_ATOL and d_act <= PLAN_ATOL):
        raise AssertionError("plan through the kernel disagrees with the plain version")
    return launches


def main() -> int:
    kind = check_device()
    dev = torch.device("cuda", 0)
    build_kernels()
    k = check_kernel(dev)
    launches = check_slice(dev)
    print(json.dumps({"kernels": [{
        "name": "dit_block", "route": "cuda",
        "source": "cleandiffuser_tpu_torch/csrc/dit_block.cu",
        "replaces": "cleandiffuser_tpu/ops/dit_block.py:125",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

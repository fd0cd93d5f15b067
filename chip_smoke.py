"""Smoke run of the PyTorch port on one NVIDIA GPU: Decision Diffuser (DD)
planning and Diffuser planning at the shipped widths, through the
hand-written Hopper kernels.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device    - a CUDA device must be present (there is no CPU path); prints
               the `nvidia-smi` name and power limit.
2. build     - builds the CUDA kernels (csrc/dit_block.cu, csrc/film_resblock.cu)
               with nvcc from the sources in this checkout, one nvcc each, in
               parallel; prints the seconds and the compiler's register /
               shared-memory report; counts the tensor-core instructions
               (HMMA / HGMMA) in the SASS of both and fails if either has
               none; compiles the Triton solver-update kernel.
3. dit_block - K1 against its plain PyTorch version at the DD plan's shape
               (B=100, H=32, D=320, 10 heads, f32), at the 3200-trajectory
               candidate batch and at the antmaze horizon H=64 (a cluster of
               two thread blocks per trajectory): error, both times, TFLOP/s
               (flops from the shape) and the kernel's share of its bound.
4. film_resblock - K3 against its plain version at every distinct block
               shape of the shipped Diffuser U-Net (B=3200 candidate
               trajectories, K=5, 8 groups, eps 1e-6): error, both times
               and both TFLOP/s per shape (flops from the shape), and their
               sums over the 16 blocks of one U-Net call.
5. solver_update - K2 against its plain version at the plan's state shape
               (3200, 32, 23) with a real ddpm step's coefficients: exact
               without noise, N(0, 1) moments of the in-kernel noise over
               2.4 M draws, seeded; both times.
6. DD slice  - builds DDPipeline on the GPU from configs/dd/mujoco (task
               halfcheetah-medium-v2), loads seeded non-zero weights through
               the JAX-layout converter, serves 5 `act` requests for 50 envs,
               checks the actions, the inpainted first state and K1's launch
               count (40 per request: 20 steps x 2 blocks), and holds one plan
               through K1 against the same plan through the plain version,
               with the same explicit noise. Then the same for one request
               at the antmaze configs' horizon of 64 (antmaze-medium-play-v2).
7. Diffuser slice - builds DiffuserPipeline on the GPU from
               configs/diffuser/mujoco (halfcheetah-medium-v2) with the fused
               block on, loads seeded non-zero weights (U-Net, classifier and
               both EMAs), serves 5 `act` requests for 50 envs x 64
               candidates with classifier guidance, checks the actions, the
               inpainted first state and K3's launch count (5 x 20 steps x 16
               blocks), holds one plan through K3 against the same plan
               through the plain block (every candidate and its log p; the
               chosen index wherever the top two are apart; the actions),
               and serves one request with the fused solver update (20 K2
               launches).
8. dit_block autograd - K1 through its autograd Function at DD's training
               shape (B=64, H=32, D=320): the forward against the plain
               version, the gradients (its backward is autograd through the
               plain version, as the JAX custom VJP's), and forward and
               forward + backward times against plain, with TFLOP/s and the
               forward's share of its bound.
9. DD training - DDPipeline from configs/dd/mujoco at full width (batch 64)
               with the fused block on and seeded weights: the first step's
               gradients through K1 against the plain block, 20 `train_step`s
               with K1's launch count (2 per step), finite losses and grad
               norms and the inverse-dynamics loss, the same 20 steps through
               the plain block with the same batches and explicit noise
               (per-step losses within LOSS_RTOL, grad norms within
               GRAD_NORM_RTOL; the params' final drift printed), ms per step on both paths (median of 12, CUDA
               events, in turns), then one `act` from the trained EMA.
10. Diffuser training - first K3 through its autograd Function at every
               distinct U-Net block shape at the training batch 64: forward
               and the gradients of every input against the plain version.
               Then DiffuserPipeline from configs/diffuser/mujoco at full
               width (batch 64) with the block on: 10 `train_step`s
               (diffusion and classifier updates) with K3's launch count (16
               per step), against the plain block as for DD, ms per step.
11. checkpoint - DD saved after 10 steps and loaded into a fresh pipeline:
               step 11 on both agrees within CKPT_ATOL.

Each slice resets every launch count just before its requests (or training
steps) and reads the counts just after. The line before the last is a JSON
object with one record per kernel: its launches in the planning requests
(`launches`) and in the training steps (`train_launches`), error and times
at the plan's shape, and its bound there: the larger of its bytes over 3.35
TB/s and its operations over the H100 SXM's peak for their type. K1 and K3
do each multiply-add of a product as three TF32 MMAs (3xTF32), so their
operations are 3x the flops at the 495 TFLOP/s TF32 peak; K2's are f32 at
67 TFLOP/s. The last line is {"ok": true, "device": {...}}. TF32 is
off for every comparison (matmul and cuDNN), so both sides compute in full
float32.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from cleandiffuser_tpu_torch.diffusion.vp_solvers import ddpm_coefficients  # noqa: E402
from cleandiffuser_tpu_torch.ops import build  # noqa: E402
from cleandiffuser_tpu_torch.ops.dit_block import (  # noqa: E402
    dit_block_op,
    dit_block_reference,
    fused_dit_block,
    load_dit_block_library,
)
from cleandiffuser_tpu_torch.ops.film_resblock import (  # noqa: E402
    film_resblock_op,
    film_resblock_reference,
    fused_film_resblock,
    load_film_resblock_library,
)
from cleandiffuser_tpu_torch.ops.solver_update import (  # noqa: E402
    fused_solver_update,
    solver_update_reference,
)
from cleandiffuser_tpu_torch.pipelines import DDPipeline, DiffuserPipeline  # noqa: E402
from cleandiffuser_tpu_torch.utils.config import load_config  # noqa: E402
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, jax_params_of  # noqa: E402

SEED = 0
N_REQUESTS = 5
# Kernel vs plain version, one block, f32 on both sides: they differ only in
# the order of f32 sums (K up to 4*D = 1280 terms) and in expf/tanhf/rsqrtf
# against PyTorch's versions, a few 1e-6 relative; 1e-4 leaves margin.
BLOCK_ATOL = BLOCK_RTOL = 1e-4
# One 20-step plan, kernel vs plain with the same noise: the per-block
# differences above pass through 20 x 2 (DD) or 20 x 16 (Diffuser) blocks,
# the classifier's guidance and the sampler.
PLAN_ATOL = 1e-3
# K2 without noise: c_xt*xt + c_eps*eps on both sides, at most an FMA's
# rounding apart; with noise, the N(0, 1) moments over >= 2 M draws (the
# standard error of the mean is 7e-4, of the std 5e-4).
SOLVER_ATOL = 1e-6
MOMENT_TOL = 5e-3
# Training, kernel path against plain with the same batches and noise: each
# step's forward differs by the blocks' ~1e-5 relative; Adam then moves every
# param by ~lr whatever its gradient's size, so the two runs' params drift
# apart by up to ~lr per step where a gradient is rounding noise (the DiT's
# key bias, which the loss does not see). The loss sees those params only
# through rounding: on the H100 the per-step losses of 20 DD and 10 Diffuser
# steps differed by at most 3.8e-7 relative (invdyn 0, DD 9.4e-8, Diffuser
# 3.6e-7, its classifier 3.8e-7), the grad norms by at most 1.8e-6, which
# sum every squared gradient, the drifting ones too. Limits ~25x and ~50x
# over those readings.
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
# The port's own checkpoint: the resumed step runs the same kernels on the
# same inputs as the uninterrupted one
CKPT_ATOL = 1e-6
DD_TRAIN_STEPS, DIFFUSER_TRAIN_STEPS, TIMED_STEPS = 20, 10, 12
# (H, Cin, Cout) of the 16 residual blocks of the shipped Diffuser U-Net
# (obs 17 + act 6 = 23 channels in, model_dim 32, dim_mult (1, 2, 2, 2),
# horizon 32), in the order the net runs them
UNET_BLOCKS = [(32, 23, 32), (32, 32, 32), (16, 32, 64), (16, 64, 64), (8, 64, 128),
               (8, 128, 128), (4, 128, 256), (4, 256, 256), (4, 256, 256), (4, 256, 256),
               (4, 512, 128), (4, 128, 128), (8, 256, 64), (8, 64, 64), (16, 128, 32),
               (16, 32, 32)]
KERNELS = (fused_dit_block, fused_film_resblock, fused_solver_update)
# NVIDIA H100 SXM peaks (data sheet, dense): f32 outside the tensor cores,
# TF32 on them, and HBM3 bandwidth
F32_TFLOPS, TF32_TFLOPS, HBM_TBPS = 67.0, 495.0, 3.35
# K1 and K3 compute each f32 product as three TF32 MMAs: their peak for it
TF32X3_TFLOPS = TF32_TFLOPS / 3


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
    """Same structure, every leaf refilled with seeded normals: dense and
    conv kernels (flax layout, fan-in first) at std 1/sqrt(fan_in), norm
    scales at 1 + 0.1 N, other vectors at 0.1 N. Fresh adaLN-Zero weights
    are zero, which would make every block the identity and the net output 0."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = seeded_tree(v, rng)
            continue
        z = rng.standard_normal(v.shape)
        if v.ndim >= 2:
            z = z / np.sqrt(np.prod(v.shape[:-1]))
        else:
            z = z * 0.1 + (1.0 if k == "scale" else 0.0)
        out[k] = z.astype(np.float32)
    return out


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def time_in_turns(kern, plain, iters: int, rounds: int = 1):
    """Device ms of kern() and plain(), each the median of 2 x `rounds`
    runs of `iters` calls, in turns plain, kernel, kernel, plain, after a
    warm-up."""
    for f in (kern, plain):
        cuda_ms(f, 3)
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain") * rounds:
        times[name].append(cuda_ms(kern if name == "kernel" else plain, iters))
    return statistics.median(times["kernel"]), statistics.median(times["plain"]), times


def errors(out, ref):
    err = (out - ref).abs()
    return err.max().item(), (err / ref.abs().clamp_min(1e-3)).max().item()


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


def build_kernels(dev):
    phase("build")
    seconds = build.build_libraries(["dit_block", "film_resblock"])
    load_dit_block_library()
    load_film_resblock_library()
    for name in ("dit_block", "film_resblock"):
        print(f"{name}.cu built in {seconds[name]:.2f} s (nvcc processes run in parallel)")
        for line in build.build_log(name).splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "smem")):
                print("  ptxas:", line.strip())
    for name in ("dit_block", "film_resblock"):
        mma = [ln for ln in build.sass(name).splitlines() if "HMMA" in ln or "HGMMA" in ln]
        print(f"{name} SASS: {len(mma)} tensor-core instructions (HMMA/HGMMA), e.g. "
              f"{mma[0].split(';')[0].split('*/')[-1].strip() if mma else '-'}")
        if not mma:
            raise AssertionError(f"{name}'s SASS has no tensor-core instruction")
    x = torch.zeros(1024, device=dev)
    for c_noise in (0.0, 1.0):  # two specialisations: with and without noise
        t0 = time.perf_counter()
        fused_solver_update(x, x, (1.0, 0.0, c_noise), 0)
        torch.cuda.synchronize()
        print(f"solver_update Triton kernel (noise={c_noise != 0}) compiled and run in "
              f"{time.perf_counter() - t0:.2f} s")


def bound(gflop: float, gbytes: float, tflops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the flops over `tflops`, the peak of the route that does
    them (ms)."""
    ops_ms, bytes_ms = gflop / tflops, gbytes / HBM_TBPS
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def dit_gflop(B, H, D) -> float:
    """Flops of one block: the four weight products (24 D^2 per row) and
    attention's two products (4 H D per row)."""
    return B * H * (24 * D * D + 4 * H * D) / 1e9


def dit_gbytes(B, H, D) -> float:
    """x and mod read, out written, the weights and biases read, once each."""
    return 4 * (2 * B * H * D + 6 * B * D + 12 * D * D + 9 * D) / 1e9


def check_kernel(dev) -> dict:
    phase("dit_block vs plain version")
    D, NH = 320, 10
    rng = np.random.default_rng(SEED)
    record = None
    # the DD plan's CFG batch; candidate evaluation; the antmaze configs' horizon
    for B, H, iters in ((100, 32, 50), (3200, 32, 5), (100, 64, 25)):
        def t(*shape, std):
            return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)

        x, mod = t(B, H, D, std=1.0), t(B, 6 * D, std=0.5)
        ws = [t(D, 3 * D, std=D ** -0.5), t(3 * D, std=0.1), t(D, D, std=D ** -0.5),
              t(D, std=0.1), t(D, 4 * D, std=D ** -0.5), t(4 * D, std=0.1),
              t(4 * D, D, std=(4 * D) ** -0.5), t(D, std=0.1)]
        out = fused_dit_block(x, mod, *ws, n_heads=NH)
        ref = dit_block_reference(x, mod, *ws, n_heads=NH)
        torch.cuda.synchronize()
        max_abs, max_rel = errors(out, ref)
        print(f"shape (B={B}, H={H}, D={D}, heads={NH}) f32: max_abs_err {max_abs:.3e} "
              f"max_rel_err {max_rel:.3e} (max |ref| {ref.abs().max().item():.3f})", flush=True)
        torch.testing.assert_close(out, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)

        ms, plain_ms, times = time_in_turns(lambda: fused_dit_block(x, mod, *ws, n_heads=NH),
                                            lambda: dit_block_reference(x, mod, *ws, n_heads=NH),
                                            iters)
        gf, gb = dit_gflop(B, H, D), dit_gbytes(B, H, D)
        b = bound(gf, gb, TF32X3_TFLOPS)
        print(f"  device time per block (weights hot in L2): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms ({gf:.3f} GFLOP, {gb * 1e3:.2f} MB: kernel {gf / ms:.2f}, plain "
              f"{gf / plain_ms:.2f} TFLOP/s); bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"(3xTF32 at {TF32X3_TFLOPS:.0f} TFLOP/s): kernel at {b['bound_ms'] / ms:.1%} of "
              f"it (for reference, the flops' time at the f32 FFMA peak is "
              f"{gf / F32_TFLOPS / ms:.1%} of the kernel's, at the TF32 peak "
              f"{gf / TF32_TFLOPS / ms:.1%}) (runs {times['kernel']} / {times['plain']})",
              flush=True)
        if record is None:
            record = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **b}
    return record


def film_gflop(B, H, Cin, Cout, K) -> float:
    """Multiply-adds x 2 of one block: conv1, conv2 and the 1x1 skip conv."""
    skip = Cin if Cin != Cout else 0
    return 2 * B * H * Cout * (K * Cin + K * Cout + skip) / 1e9


def film_args(rng, dev, B, H, Cin, Cout, K, requires_grad=False) -> list:
    """Seeded inputs of one U-Net block: x, emb, the two convs and norms,
    and the skip conv where Cin != Cout."""
    def t(*shape, std=1.0, mean=0.0):
        z = mean + rng.standard_normal(shape) * std
        return torch.from_numpy(z.astype(np.float32)).to(dev).requires_grad_(requires_grad)

    args = [t(B, H, Cin), t(B, Cout, std=0.5),
            t(K, Cin, Cout, std=(K * Cin) ** -0.5), t(Cout, std=0.1),
            t(Cout, std=0.1, mean=1.0), t(Cout, std=0.1),
            t(K, Cout, Cout, std=(K * Cout) ** -0.5), t(Cout, std=0.1),
            t(Cout, std=0.1, mean=1.0), t(Cout, std=0.1)]
    if Cin != Cout:
        args += [t(Cin, Cout, std=Cin ** -0.5), t(Cout, std=0.1)]
    return args


def check_film_kernel(dev) -> dict:
    phase("film_resblock vs plain version")
    B, K, G = 3200, 5, 8
    rng = np.random.default_rng(SEED + 2)
    worst, timed = 0.0, {}
    shapes = list(dict.fromkeys(UNET_BLOCKS))
    most_frequent = max(shapes, key=UNET_BLOCKS.count)
    for H, Cin, Cout in shapes:
        args = film_args(rng, dev, B, H, Cin, Cout, K)
        kw = dict(K=K, groups=G, eps=1e-6)
        out = fused_film_resblock(*args, **kw)
        ref = film_resblock_reference(*args, **kw)
        torch.cuda.synchronize()
        max_abs, max_rel = errors(out, ref)
        worst = max(worst, max_abs)
        print(f"(B={B}, H={H}, Cin={Cin}, Cout={Cout}{', skip' if Cin != Cout else ''}) "
              f"x{UNET_BLOCKS.count((H, Cin, Cout))}: max_abs_err {max_abs:.3e} "
              f"max_rel_err {max_rel:.3e} (max |ref| {ref.abs().max().item():.3f})", flush=True)
        torch.testing.assert_close(out, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
        ms, plain_ms, times = timed[(H, Cin, Cout)] = time_in_turns(
            lambda: fused_film_resblock(*args, **kw),
            lambda: film_resblock_reference(*args, **kw), 20)
        gf = film_gflop(B, H, Cin, Cout, K)
        print(f"  device time per block: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({gf:.3f} GFLOP: kernel {gf / ms:.2f}, plain {gf / plain_ms:.2f} TFLOP/s) "
              f"(runs {times['kernel']} / {times['plain']})", flush=True)
    total = {k: sum(timed[s][i] for s in UNET_BLOCKS) for i, k in enumerate(("kernel", "plain"))}
    gf = sum(film_gflop(B, *s, K) for s in UNET_BLOCKS)
    print(f"sum over the {len(UNET_BLOCKS)} blocks of one U-Net call ({gf:.2f} GFLOP): kernel "
          f"{total['kernel']:.4f} ms ({gf / total['kernel']:.2f} TFLOP/s, "
          f"{gf / TF32X3_TFLOPS / total['kernel']:.1%} of the 3xTF32 bound), plain "
          f"{total['plain']:.4f} ms ({gf / total['plain']:.2f} TFLOP/s); most frequent shape "
          f"{most_frequent}")
    ms, plain_ms, _ = timed[most_frequent]
    H, Cin, Cout = most_frequent
    gbytes = 4 * (B * H * Cin + B * Cout + K * Cin * Cout + K * Cout * Cout
                  + (Cin + 1) * Cout * (Cin != Cout) + 6 * Cout + B * H * Cout) / 1e9
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **bound(film_gflop(B, H, Cin, Cout, K), gbytes, TF32X3_TFLOPS)}


def check_solver_kernel(dev) -> dict:
    phase("solver_update vs plain version")
    shape = (3200, 32, 23)
    rng = np.random.default_rng(SEED + 3)
    xt, eps = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
               for _ in range(2))
    # a real step: level 10 of 20 of the shipped Diffuser's ddpm sampler
    probe = DiffuserPipeline(17, 6, device="cpu")
    _, alphas, sigmas = probe.agent._sample_tables("uniform", 20)
    stds = torch.cat([torch.zeros(1), sigmas[:-1] / sigmas[1:]
                      * torch.sqrt(1 - (alphas[1:] / alphas[:-1]) ** 2)])
    coefs = ddpm_coefficients(10, alphas, sigmas, stds)
    print(f"coefficients (c_xt, c_eps, c_noise) = {coefs}")

    quiet = (coefs[0], coefs[1], 0.0)
    max_abs, _ = errors(fused_solver_update(xt, eps, quiet, 1),
                        solver_update_reference(xt, eps, quiet))
    print(f"c_noise = 0: max_abs_err {max_abs:.3e} (limit {SOLVER_ATOL})")
    if not max_abs <= SOLVER_ATOL:
        raise AssertionError("solver_update without noise disagrees with its plain version")

    out = fused_solver_update(xt, eps, coefs, 7)
    z = (out.double() - coefs[0] * xt.double() - coefs[1] * eps.double()) / coefs[2]
    mean, std = z.mean().item(), z.std().item()
    print(f"noise over {z.numel()} draws: mean {mean:.3e}, std {std:.6f} (limit {MOMENT_TOL})")
    if not (abs(mean) < MOMENT_TOL and abs(std - 1) < MOMENT_TOL):
        raise AssertionError("solver_update noise is not standard normal")
    same = torch.equal(out, fused_solver_update(xt, eps, coefs, 7))
    other = not torch.equal(out, fused_solver_update(xt, eps, coefs, 8))
    print(f"same seed, same output: {same}; another seed, another output: {other}")
    if not (same and other):
        raise AssertionError("solver_update noise is not a function of the seed")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    ms, plain_ms, times = time_in_turns(lambda: fused_solver_update(xt, eps, coefs, 7),
                                        lambda: solver_update_reference(xt, eps, coefs, gen), 200)
    print(f"device time per step at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(runs {times['kernel']} / {times['plain']})")
    # xt and eps read, out written; ~6 flops per element besides the noise
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **bound(6 * xt.numel() / 1e9, 3 * 4 * xt.numel() / 1e9, F32_TFLOPS)}


def build_pipeline(args, dev, use_kernel: bool, weights: dict) -> DDPipeline:
    pipe = DDPipeline(
        obs_dim=args.task.obs_dim, act_dim=args.task.act_dim, horizon=args.task.horizon,
        emb_dim=args.emb_dim, d_model=args.d_model, n_heads=args.n_heads,
        depth=args.depth, label_dropout=args.label_dropout,
        predict_noise=args.predict_noise, next_obs_loss_weight=args.next_obs_loss_weight,
        ema_rate=args.ema_rate, diffusion_gradient_steps=args.diffusion_gradient_steps,
        invdyn_gradient_steps=args.invdyn_gradient_steps,
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


def dd_weights(args, rng) -> dict:
    """Seeded weights in the JAX package's layout (shapes taken from a CPU
    build of the same config), for the converter to carry in."""
    probe = DDPipeline(obs_dim=args.task.obs_dim, act_dim=args.task.act_dim,
                       horizon=args.task.horizon, emb_dim=args.emb_dim, d_model=args.d_model,
                       n_heads=args.n_heads, depth=args.depth, device="cpu")
    return {
        "params": seeded_tree(agent_params_of(probe.agent.params), rng),
        "ema_params": seeded_tree(agent_params_of(probe.agent.ema_params), rng),
        "invdyn": {"params": seeded_tree(jax_params_of(probe.invdyn.net), rng)},
    }


def check_slice(dev, bench: str = "mujoco", n_requests: int = N_REQUESTS) -> int:
    phase(f"slice: DD planning ({bench})")
    args = load_config(ROOT / "configs/dd" / bench, bench)
    E, H, O = args.num_envs, args.task.horizon, args.task.obs_dim
    rng = np.random.default_rng(SEED + 1)
    weights = dd_weights(args, rng)
    pipe = build_pipeline(args, dev, args.use_pallas_block, weights)
    plain = build_pipeline(args, dev, False, weights)
    print(f"config: obs {O} act {args.task.act_dim} horizon {H} d_model {args.d_model} "
          f"heads {args.n_heads} depth {args.depth} {args.solver} x {args.sampling_steps} "
          f"w_cfg {args.task.w_cfg} target_return {args.task.target_return} envs {E} "
          f"(CFG batch {2 * E}) use_pallas_block {args.use_pallas_block}")
    if not args.use_pallas_block:
        raise AssertionError("the shipped config must turn the fused block on")

    obs = [torch.from_numpy(rng.standard_normal((E, O)).astype(np.float32)).to(dev)
           for _ in range(n_requests + 1)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cold = serve(pipe, obs[:1], gen)  # first request: allocator and library warm-up

    reset_counts()
    lat = serve(pipe, obs[1:], gen)
    launches = fused_dit_block.launches
    expected = n_requests * args.sampling_steps * args.depth
    print(f"{n_requests} requests x {E} envs: latency ms {[round(v, 3) for v in lat]} "
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
    # seeded weights can take a plan far out of the data's range (antmaze's
    # ddim plan reaches |x| ~ 600, where an f32 ulp is 6e-5): beyond 100 the
    # plan is held to 1e-5 of its scale
    scale = info_p["traj"].abs().max().item()
    tol = PLAN_ATOL * max(1.0, scale / 100)
    print(f"plan kernel vs plain: max |traj diff| {d_traj:.3e}, max |act diff| {d_act:.3e} "
          f"(max |traj| {scale:.3f}; atol {tol:.3g})")
    if not (d_traj <= tol and d_act <= PLAN_ATOL):
        raise AssertionError("plan through the kernel disagrees with the plain version")
    return launches


def serve_diffuser(pipe: DiffuserPipeline, obs_batches, K: int, generator) -> list:
    """Serve one Diffuser `act` request per batch (K candidates per env);
    returns per-request ms."""
    lat = []
    for obs in obs_batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act, info = pipe.act(obs, num_candidates=K, generator=generator)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if tuple(act.shape) != (obs.shape[0], pipe.act_dim):
            raise AssertionError(f"actions {tuple(act.shape)}")
        if not (torch.isfinite(act).all() and torch.isfinite(info["candidates"]).all()
                and torch.isfinite(info["candidate_logp"]).all()):
            raise AssertionError("non-finite actions, plans or log p")
        if act.abs().max().item() > 1.0:
            raise AssertionError("actions outside [-1, 1]")
        if not torch.equal(info["traj"][:, 0, :pipe.obs_dim], obs):
            raise AssertionError("plan's first state is not the observation")
    return lat


def diffuser_setup(args, rng):
    """The Diffuser pipeline's keyword arguments from its config, and seeded
    weights in the JAX package's layout (shapes taken from a CPU build of
    the same config), for the converter to carry in."""
    kw = dict(obs_dim=args.task.obs_dim, act_dim=args.task.act_dim, horizon=args.task.horizon,
              model_dim=args.model_dim, dim_mult=tuple(args.task.dim_mult),
              diffusion_steps=args.diffusion_steps, sampling_steps=args.sampling_steps,
              solver=args.solver, predict_noise=args.predict_noise,
              action_loss_weight=args.action_loss_weight,
              terminal_penalty=args.terminal_penalty, discount=args.discount,
              ema_rate=args.ema_rate, diffusion_gradient_steps=args.diffusion_gradient_steps,
              classifier_gradient_steps=args.classifier_gradient_steps,
              w_cg=args.task.w_cg, temperature=args.temperature, rng=args.seed)
    probe = DiffuserPipeline(**kw, device="cpu")
    weights = {
        "params": seeded_tree(agent_params_of(probe.agent.params), rng),
        "ema_params": seeded_tree(agent_params_of(probe.agent.ema_params), rng),
        "cls_params": {"params": seeded_tree(jax_params_of(probe.classifier.params), rng)},
        "cls_ema_params": {"params": seeded_tree(jax_params_of(probe.classifier.ema_params),
                                                 rng)},
    }
    return kw, weights


def check_diffuser_slice(dev):
    """Returns (K3 launches in the 5 served requests, K2 launches in the
    fused-update request)."""
    phase("slice: Diffuser planning")
    args = load_config(ROOT / "configs/diffuser/mujoco", "mujoco")
    E, K, O, A = args.num_envs, args.num_candidates, args.task.obs_dim, args.task.act_dim
    rng = np.random.default_rng(SEED + 4)
    kw, weights = diffuser_setup(args, rng)
    pipe = DiffuserPipeline(**kw, use_pallas_block=True, device=dev)
    plain = DiffuserPipeline(**kw, use_pallas_block=False, device=dev)
    for p in (pipe, plain):
        p.load_jax_params(**weights)
    print(f"config: obs {O} act {A} horizon {args.task.horizon} model_dim {args.model_dim} "
          f"dim_mult {tuple(args.task.dim_mult)} {args.solver} x {args.sampling_steps} "
          f"(T={args.diffusion_steps}) predict_noise {args.predict_noise} w_cg {args.task.w_cg} "
          f"temperature {args.temperature} envs {E} x candidates {K} = {E * K} trajectories")

    # the block shapes the main path gives K3, seen on the way in
    seen = []
    hooks = [b.register_forward_pre_hook(lambda m, a: seen.append(tuple(a[0].shape[1:]) + (
        m.conv1.kernel.shape[-1],))) for b in pipe.agent.ema_params["diffusion"].blocks]
    obs = [torch.from_numpy(rng.standard_normal((E, O)).astype(np.float32)).to(dev)
           for _ in range(N_REQUESTS + 1)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cold = serve_diffuser(pipe, obs[:1], K, gen)  # first request: warm-up
    for h in hooks:
        h.remove()
    if seen[:len(UNET_BLOCKS)] != UNET_BLOCKS:
        raise AssertionError(f"U-Net block shapes {seen[:16]} are not {UNET_BLOCKS}")

    reset_counts()
    lat = serve_diffuser(pipe, obs[1:], K, gen)
    k3 = fused_film_resblock.launches
    expected = N_REQUESTS * args.sampling_steps * len(UNET_BLOCKS)
    print(f"{N_REQUESTS} requests x {E} envs x {K} candidates: latency ms "
          f"{[round(v, 3) for v in lat]} (median {statistics.median(lat):.3f}; cold first "
          f"request {cold[0]:.3f}); film_resblock launches {k3} (expected {expected})")
    if k3 != expected:
        raise AssertionError(f"film_resblock launched {k3} times, expected {expected}")

    plain_lat = serve_diffuser(plain, obs[1:], K, gen)
    print(f"same requests through the plain block: latency ms "
          f"{[round(v, 3) for v in plain_lat]} (median {statistics.median(plain_lat):.3f})")

    # one plan, kernel vs plain block, same explicit noise
    shape = (K * E, args.task.horizon, O + A)
    noise = (torch.randn(shape, generator=gen, device=dev),
             torch.randn((args.sampling_steps,) + shape, generator=gen, device=dev))
    act_k, info_k = pipe.act(obs[1], num_candidates=K, noise=noise)
    act_p, info_p = plain.act(obs[1], num_candidates=K, noise=noise)
    d_traj = (info_k["candidates"] - info_p["candidates"]).abs().max().item()
    d_logp = (info_k["candidate_logp"] - info_p["candidate_logp"]).abs().max().item()
    top2 = info_p["candidate_logp"].topk(2, dim=0).values
    clear = (top2[0] - top2[1]) > PLAN_ATOL  # envs whose best candidate is not a near-tie
    same_idx = info_k["idx"] == info_p["idx"]
    d_act = (act_k - act_p).abs()[same_idx].max().item() if same_idx.any() else 0.0
    print(f"plan kernel vs plain: max |candidate diff| {d_traj:.3e}, max |logp diff| "
          f"{d_logp:.3e}, chosen index equal in {int(same_idx.sum())}/{E} envs "
          f"({int(clear.sum())} with a top-two gap > {PLAN_ATOL}), max |act diff| where equal "
          f"{d_act:.3e} (max |traj| {info_p['candidates'].abs().max().item():.3f}; "
          f"atol {PLAN_ATOL})")
    if not (d_traj <= PLAN_ATOL and d_logp <= PLAN_ATOL and d_act <= PLAN_ATOL
            and bool(same_idx[clear].all())):
        raise AssertionError("plan through the kernel disagrees with the plain version")

    # one request through the fused solver update too
    pipe.fused_update = True
    reset_counts()
    fused_lat = serve_diffuser(pipe, obs[1:2], K, gen)
    k2 = fused_solver_update.launches
    print(f"1 request with fused_update: latency {fused_lat[0]:.3f} ms (first, includes plan "
          f"setup); solver_update launches {k2} (expected {args.sampling_steps}), "
          f"film_resblock launches {fused_film_resblock.launches}")
    if k2 != args.sampling_steps:
        raise AssertionError(f"solver_update launched {k2} times, expected {args.sampling_steps}")
    return k3, k2


def check_kernel_autograd(dev) -> dict:
    """K1 through its autograd Function at DD's training shape: forward
    against the plain version, gradients, and times."""
    phase("dit_block under autograd at DD's training shape")
    B, H, D, NH = 64, 32, 320, 10
    rng = np.random.default_rng(SEED + 5)

    def t(*shape, std):
        z = torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)
        return z.requires_grad_(True)

    x, mod = t(B, H, D, std=1.0), t(B, 6 * D, std=0.5)
    ws = [t(D, 3 * D, std=D ** -0.5), t(3 * D, std=0.1), t(D, D, std=D ** -0.5),
          t(D, std=0.1), t(D, 4 * D, std=D ** -0.5), t(4 * D, std=0.1),
          t(4 * D, D, std=(4 * D) ** -0.5), t(D, std=0.1)]
    inputs = [x, mod, *ws]
    g = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32)).to(dev)
    out = dit_block_op(*inputs, n_heads=NH)
    ref = dit_block_reference(*inputs, n_heads=NH)
    grads = torch.autograd.grad(out, inputs, g)
    ref_grads = torch.autograd.grad(ref, inputs, g)
    torch.cuda.synchronize()
    max_abs, max_rel = errors(out.detach(), ref.detach())
    g_err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(grads, ref_grads))
    print(f"(B={B}, H={H}, D={D}, heads={NH}) forward through the Function: max_abs_err "
          f"{max_abs:.3e} max_rel_err {max_rel:.3e}; gradients of all 10 inputs against the "
          f"plain version's: max error {g_err:.3e} of max |grad| (the backward recomputes the "
          f"plain version from the same inputs)", flush=True)
    torch.testing.assert_close(out, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
    if g_err > BLOCK_RTOL:
        raise AssertionError("the Function's gradients disagree with the plain version's")

    with torch.no_grad():
        ms, plain_ms, times = time_in_turns(lambda: fused_dit_block(x, mod, *ws, n_heads=NH),
                                            lambda: dit_block_reference(x, mod, *ws, n_heads=NH),
                                            50, rounds=3)
    fb_ms, fb_plain_ms, fb_times = time_in_turns(
        lambda: torch.autograd.grad(dit_block_op(*inputs, n_heads=NH), inputs, g),
        lambda: torch.autograd.grad(dit_block_reference(*inputs, n_heads=NH), inputs, g), 20,
        rounds=3)
    gf, gb = dit_gflop(B, H, D), dit_gbytes(B, H, D)
    b = bound(gf, gb, TF32X3_TFLOPS)
    print(f"  forward ({gf:.3f} GFLOP, {gb * 1e3:.2f} MB): kernel {ms:.4f} ms ({gf / ms:.2f} "
          f"TFLOP/s), plain {plain_ms:.4f} ms ({gf / plain_ms:.2f}); bound {b['bound_ms']:.4f} ms "
          f"by {b['bound_by']} (3xTF32): kernel at {b['bound_ms'] / ms:.1%} of it (runs "
          f"{times['kernel']} / {times['plain']})", flush=True)
    print(f"  forward + backward (the backward ~2x the forward's {gf:.3f} GFLOP, plain f32; the "
          f"kernel path recomputes the forward in it): kernel path {fb_ms:.4f} ms, plain "
          f"{fb_plain_ms:.4f} ms (runs {fb_times['kernel']} / {fb_times['plain']})", flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "fb_ms": fb_ms,
            "fb_plain_ms": fb_plain_ms, **b}


def check_film_autograd(dev, B: int):
    """K3 through its autograd Function at every distinct U-Net block shape
    at the training batch B: the forward against the plain version
    (BLOCK_ATOL / BLOCK_RTOL) and the gradients of every input."""
    rng = np.random.default_rng(SEED + 9)
    kw = dict(K=5, groups=8, eps=1e-6)
    worst = worst_g = 0.0
    for H, Cin, Cout in dict.fromkeys(UNET_BLOCKS):
        inputs = film_args(rng, dev, B, H, Cin, Cout, kw["K"], requires_grad=True)
        g = torch.from_numpy(rng.standard_normal((B, H, Cout)).astype(np.float32)).to(dev)
        out = film_resblock_op(*inputs, **kw)
        ref = film_resblock_reference(*inputs, **kw)
        grads = torch.autograd.grad(out, inputs, g)
        ref_grads = torch.autograd.grad(ref, inputs, g)
        max_abs, max_rel = errors(out.detach(), ref.detach())
        g_err = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(grads, ref_grads))
        print(f"  film_resblock_op (B={B}, H={H}, Cin={Cin}, Cout={Cout}): forward max_abs_err "
              f"{max_abs:.3e} max_rel_err {max_rel:.3e}; gradients of all {len(inputs)} inputs: "
              f"max error {g_err:.3e} of max |grad|", flush=True)
        torch.testing.assert_close(out, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
        if g_err > BLOCK_RTOL:
            raise AssertionError("K3's Function's gradients disagree with the plain version's")
        worst, worst_g = max(worst, max_abs), max(worst_g, g_err)
    print(f"K3 under autograd at B={B}, all {len(set(UNET_BLOCKS))} shapes: forward max_abs_err "
          f"{worst:.3e}, gradients {worst_g:.3e} (limit {BLOCK_RTOL})", flush=True)


def train_batches(rng, n: int, B: int, H: int, O: int, A: int, dev, val_scale: float) -> list:
    """n seeded synthetic batches on the device: states N(0, 1), actions
    U(-1, 1), values U(0, val_scale) (DD) or N(0, 1) (Diffuser, val_scale 0)."""
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return [{"obs": {"state": f(rng.standard_normal((B, H, O)))},
             "act": f(rng.uniform(-1, 1, (B, H, A))),
             "val": f(rng.uniform(0, val_scale, (B, 1)) if val_scale
                      else rng.standard_normal((B, 1)))} for _ in range(n)]


def step_ms(pipes: dict, batches: list) -> dict:
    """Per-step time of `train_step` (CUDA events around each step, host
    enqueue included), TIMED_STEPS per path in turns kernel, plain, plain,
    kernel, after one warm-up step each; draws from the engines'
    generators."""
    for p in pipes.values():
        p.train_step(batches[0])
    times = {k: [] for k in pipes}
    n = TIMED_STEPS // 2
    for k in ("kernel", "plain", "plain", "kernel"):
        for i in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            pipes[k].train_step(batches[i % len(batches)])
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return times


def compare_training(logs_k: list, logs_p: list, keys):
    """Per-step logs, kernel path against plain: finite, losses within
    LOSS_RTOL and grad norms within GRAD_NORM_RTOL."""
    for k in keys:
        a = torch.stack([lg[k] for lg in logs_k])
        b = torch.stack([lg[k] for lg in logs_p])
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"non-finite {k} in training")
        rel = ((a - b).abs() / b.abs()).max().item()
        limit = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        print(f"  {k}: kernel path {[round(v, 5) for v in a.tolist()]}; max relative "
              f"difference to plain {rel:.3e} (limit {limit})", flush=True)
        if rel > limit:
            raise AssertionError(f"training through the kernel disagrees with the plain "
                                 f"version in {k}")


def max_drift(a: torch.nn.Module, b: torch.nn.Module) -> float:
    return max((x - y).abs().max().item() for x, y in zip(a.parameters(), b.parameters()))


def check_dd_training(dev):
    """Returns (K1 and K2 launches in the 20 training steps, ms per step by
    path)."""
    phase("DD training")
    args = load_config(ROOT / "configs/dd/mujoco", "mujoco")
    H, O, A, B = args.task.horizon, args.task.obs_dim, args.task.act_dim, args.batch_size
    rng = np.random.default_rng(SEED + 6)
    weights = dd_weights(args, rng)
    pipes = {"kernel": build_pipeline(args, dev, True, weights),
             "plain": build_pipeline(args, dev, False, weights)}
    pipe, plain = pipes["kernel"], pipes["plain"]
    n = DD_TRAIN_STEPS
    batches = train_batches(rng, n, B, H, O, A, dev, pipe.return_scale)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lo, hi = pipe.agent.t_diffusion
    noise = [(torch.rand(B, generator=gen, device=dev) * (hi - lo) + lo,
              torch.randn((B, H, O), generator=gen, device=dev),
              (torch.rand(B, generator=gen, device=dev) > args.label_dropout).float())
             for _ in range(n)]
    print(f"config: obs {O} act {A} horizon {H} d_model {args.d_model} heads {args.n_heads} "
          f"depth {args.depth} batch {B} (B*H = {B * H} tokens) ema_rate {args.ema_rate} "
          f"cosine over {args.diffusion_gradient_steps} steps; {n} steps per path")

    # the first step's gradients, through K1 and through the plain block
    grads = []
    for p in (pipe, plain):
        val = batches[0]["val"] / p.return_scale + p.val_shift
        p.agent.loss_fn(p.agent.params, batches[0]["obs"]["state"], val,
                        noise=noise[0]).backward()
        grads.append([q.grad.clone() for q in p.agent.params.parameters()])
        p.agent.params.zero_grad(set_to_none=True)
    scale = max(g.abs().max().item() for g in grads[1])
    g_err = max((a - b).abs().max().item() for a, b in zip(*grads))
    print(f"first step's gradients, kernel path against plain: max |diff| {g_err:.3e} (max "
          f"|grad| {scale:.3f})", flush=True)

    reset_counts()
    logs_k = [pipe.train_step(b, noise=z) for b, z in zip(batches, noise)]
    torch.cuda.synchronize()
    k1, k2 = fused_dit_block.launches, fused_solver_update.launches
    expected = n * args.depth
    print(f"{n} train_steps through K1: dit_block launches {k1} (expected {expected}), "
          f"solver_update launches {k2} (expected 0: a sampler step)", flush=True)
    if k1 != expected:
        raise AssertionError(f"dit_block launched {k1} times in training, expected {expected}")
    if k2:
        raise AssertionError(f"solver_update launched {k2} times in training, expected 0")
    if any("invdyn_loss" not in lg for lg in logs_k):
        raise AssertionError("train_step logged no invdyn_loss")
    logs_p = [plain.train_step(b, noise=z) for b, z in zip(batches, noise)]
    compare_training(logs_k, logs_p, ("loss", "grad_norm", "invdyn_loss"))
    print(f"  params' final drift, kernel path against plain: max |diff| "
          f"{max_drift(pipe.agent.params, plain.agent.params):.3e} (EMA "
          f"{max_drift(pipe.agent.ema_params, plain.agent.ema_params):.3e}; lr "
          f"{args.get('lr', 2e-4)} per Adam step)", flush=True)

    times = step_ms(pipes, batches)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"ms per train_step (median of {TIMED_STEPS}): kernel {med['kernel']:.3f}, plain "
          f"{med['plain']:.3f} (runs {[round(v, 3) for v in times['kernel']]} / "
          f"{[round(v, 3) for v in times['plain']]})", flush=True)

    # the trained EMA plans
    obs = torch.from_numpy(rng.standard_normal((args.num_envs, O)).astype(np.float32)).to(dev)
    lat = serve(pipe, [obs], gen)
    print(f"one act from the trained EMA ({args.num_envs} envs): {lat[0]:.3f} ms", flush=True)
    return k1, k2, med


def check_diffuser_training(dev):
    """Returns (K3 and K2 launches in the 10 training steps, ms per step by
    path)."""
    phase("Diffuser training")
    args = load_config(ROOT / "configs/diffuser/mujoco", "mujoco")
    H, O, A, B = args.task.horizon, args.task.obs_dim, args.task.act_dim, args.batch_size
    rng = np.random.default_rng(SEED + 7)
    kw, weights = diffuser_setup(args, rng)
    pipes = {k: DiffuserPipeline(**kw, use_pallas_block=k == "kernel", device=dev)
             for k in ("kernel", "plain")}
    for p in pipes.values():
        p.load_jax_params(**weights)
    pipe, plain = pipes["kernel"], pipes["plain"]
    n = DIFFUSER_TRAIN_STEPS
    batches = train_batches(rng, n, B, H, O, A, dev, 0.0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    T, shape = args.diffusion_steps, (B, H, O + A)
    draw = lambda: (torch.randint(T, (B,), generator=gen, device=dev),
                    torch.randn(shape, generator=gen, device=dev))
    noise = [((*draw(), None), draw()) for _ in range(n)]
    print(f"config: obs {O} act {A} horizon {H} model_dim {args.model_dim} dim_mult "
          f"{tuple(args.task.dim_mult)} T {T} batch {B}; {n} steps per path (diffusion and "
          f"classifier updates)")
    check_film_autograd(dev, B)

    reset_counts()
    logs_k = [pipe.train_step(b, noise=z, classifier_noise=c) for b, (z, c) in zip(batches, noise)]
    torch.cuda.synchronize()
    k3, k2 = fused_film_resblock.launches, fused_solver_update.launches
    expected = n * len(UNET_BLOCKS)
    print(f"{n} train_steps through K3: film_resblock launches {k3} (expected {expected}), "
          f"solver_update launches {k2} (expected 0: a sampler step)", flush=True)
    if k3 != expected:
        raise AssertionError(f"film_resblock launched {k3} times in training, expected {expected}")
    if k2:
        raise AssertionError(f"solver_update launched {k2} times in training, expected 0")
    logs_p = [plain.train_step(b, noise=z, classifier_noise=c)
              for b, (z, c) in zip(batches, noise)]
    compare_training(logs_k, logs_p, ("loss", "grad_norm", "classifier_loss"))
    print(f"  params' final drift, kernel path against plain: U-Net "
          f"{max_drift(pipe.agent.params, plain.agent.params):.3e}, classifier "
          f"{max_drift(pipe.classifier.params, plain.classifier.params):.3e}", flush=True)

    times = step_ms(pipes, batches)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"ms per train_step (median of {TIMED_STEPS}): kernel {med['kernel']:.3f}, plain "
          f"{med['plain']:.3f} (runs {[round(v, 3) for v in times['kernel']]} / "
          f"{[round(v, 3) for v in times['plain']]})", flush=True)
    return k3, k2, med


def check_checkpoint(dev):
    """DD saved after 10 steps and loaded into a fresh pipeline: step 11 on
    both agrees within CKPT_ATOL."""
    phase("checkpoint round trip")
    args = load_config(ROOT / "configs/dd/mujoco", "mujoco")
    rng = np.random.default_rng(SEED + 8)
    weights = dd_weights(args, rng)
    batches = train_batches(rng, 11, args.batch_size, args.task.horizon, args.task.obs_dim,
                            args.task.act_dim, dev, 1000.0)
    first = build_pipeline(args, dev, True, weights)
    for b in batches[:10]:
        first.train_step(b)
    with tempfile.TemporaryDirectory() as tmp:
        first.save(str(Path(tmp) / "dd"))
        second = build_pipeline(args, dev, True, dd_weights(args, np.random.default_rng(1)))
        second.load(str(Path(tmp) / "dd"))
    la, lb = first.train_step(batches[10]), second.train_step(batches[10])
    diffs = {k: (la[k] - lb[k]).abs().item() for k in la}
    for name in ("params", "ema_params"):
        diffs[name] = max_drift(getattr(first.agent, name), getattr(second.agent, name))
    diffs["invdyn"] = max_drift(first.invdyn.net, second.invdyn.net)
    print(f"step 11 after save / load, max |diff|: {diffs} (limit {CKPT_ATOL})", flush=True)
    if max(diffs.values()) > CKPT_ATOL:
        raise AssertionError("a resumed DD run disagrees with the uninterrupted one")


def main() -> int:
    kind = check_device()
    dev = torch.device("cuda", 0)
    build_kernels(dev)
    k1 = check_kernel(dev)
    k3 = check_film_kernel(dev)
    k2 = check_solver_kernel(dev)
    k1_launches = check_slice(dev)
    check_slice(dev, "antmaze", 1)  # horizon 64: K1 on clusters of two thread blocks
    k3_launches, k2_launches = check_diffuser_slice(dev)
    check_kernel_autograd(dev)
    k1_train, k2_dd_train, _ = check_dd_training(dev)
    k3_train, k2_diffuser_train, _ = check_diffuser_training(dev)
    check_checkpoint(dev)
    record = lambda name, route, source, replaces, launches, train_launches, k: {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": launches, "train_launches": train_launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        # no single PyTorch call computes any of these blocks or steps
        "library_ms": None}
    print(json.dumps({"kernels": [
        record("dit_block", "cuda", "cleandiffuser_tpu_torch/csrc/dit_block.cu",
               "cleandiffuser_tpu/ops/dit_block.py:125", k1_launches, k1_train, k1),
        record("film_resblock", "cuda", "cleandiffuser_tpu_torch/csrc/film_resblock.cu",
               "cleandiffuser_tpu/ops/film_resblock.py:159", k3_launches, k3_train, k3),
        # a sampler step: the training steps read 0 (and fail otherwise)
        record("solver_update", "triton", "cleandiffuser_tpu_torch/ops/solver_update.py",
               "cleandiffuser_tpu/ops/solver_update.py:75", k2_launches,
               k2_dd_train + k2_diffuser_train, k2),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

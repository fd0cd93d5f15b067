"""What bounds the PyTorch port's fused DiT block kernel on the card: build
edited copies of `cleandiffuser_tpu_torch/csrc/dit_block.cu`, check each
against the plain version (f32) and a float64 reference, and time them in
turns at the DD plan's shape, at the 3200-trajectory candidate batch and at
the antmaze configs' horizon of 64.

    python tools/dit_block_variants.py [--variants a,b] [--out DIR]

A variant is a list of exact text replacements in the source. Some keep the
kernel correct (another warp layout, split of a trajectory, accumulation);
others remove a part (the MMAs, the copies, a barrier, attention, every
product), so that their output is wrong and only their time counts: the time
a part saves when removed is what it costs. Every copy is built with its own
nvcc, all started together. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cleandiffuser_tpu_torch.ops import build  # noqa: E402
from cleandiffuser_tpu_torch.ops.dit_block import dit_block_reference  # noqa: E402

# (the kernel source defines `mma_bf16`, the m16n8k16 BF16 MMA of its BF16 route)
BF16_HELPERS = """// two f32 (given as bits) rounded to BF16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(uint32_t first, uint32_t second) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(__uint_as_float(first), __uint_as_float(second));
  return *reinterpret_cast<const uint32_t*>(&v);
}

"""
BF16_STEP = """  {
    // k indices of the BF16 step: 2q, 2q + 1 carry the lo parts of A (the
    // TF32 step's k q, q + 4) against the hi parts of B; 2q + 8, 2q + 9 the
    // hi parts of A against the lo parts of B
    uint32_t bhi[NT][2], bcor[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t lo0, lo1;
      split_tf32(W[j * 8], bhi[j][0], lo0);
      split_tf32(W[j * 8 + ldw], bhi[j][1], lo1);
      bcor[j][0] = pack_bf16(bhi[j][0], bhi[j][1]);
      bcor[j][1] = pack_bf16(lo0, lo1);
    }
    uint32_t ahi[4], alo[4], acor[4];
    split_a(*reinterpret_cast<const float2*>(A + aoff[0]),
            *reinterpret_cast<const float2*>(A + aoff[1]), ahi, alo);
    acor[0] = pack_bf16(alo[0], alo[2]);
    acor[1] = pack_bf16(alo[1], alo[3]);
    acor[2] = pack_bf16(ahi[0], ahi[2]);
    acor[3] = pack_bf16(ahi[1], ahi[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[j], acor, bcor[j][0], bcor[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ahi, bhi[j][0], bhi[j][1]);
    return;
  }
"""
# a trajectory on blocks of 16 rows and 8 warps (a cluster of two at H = 32)
CLUSTER16 = [("constexpr int kWarpsM = 2;", "constexpr int kWarpsM = 1;")]

VARIANTS = {
    "shipped": [],
    # the tensor cores accumulate over the whole K, no f32 sum per stage
    "no_promote": [("ldw, ldw, part);", "ldw, ldw, acc);"),
                   ("acc[j][v] += part[j][v];", "(void)part[j][v];")],
    # 8-row weight stages: 109.5 KB of shared memory, two blocks per SM
    "cluster16": CLUSTER16 + [
        ("constexpr int kCK = 16;", "constexpr int kCK = 8;"),
        ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 2)")],
    # 16-row weight stages: 129.8 KB, one block per SM
    "cluster16_one_per_sm": CLUSTER16,
    "warps_n10": [("constexpr int kWarpsN = 8;", "constexpr int kWarpsN = 10;")],
    # a_lo*b_hi + a_hi*b_lo as one BF16 m16n8k16 MMA (the tensor time of one
    # TF32 m16n8k8) beside the TF32 a_hi*b_hi: 2 MMA-times per product, not 3
    "bf16_corrections": [
        ("#include <cuda_runtime.h>\n", "#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n"),
        ("// d += a * b in 3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi",
         BF16_HELPERS + "// d += a * b in 3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi"),
        ("                                         int ldw, float (&acc)[NT][4]) {\n",
         "                                         int ldw, float (&acc)[NT][4]) {\n"
         + BF16_STEP)],
    "split_truncate": [("  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
                        "  hi = __float_as_uint(v) & 0xffffe000u;")],
    # parts removed: wrong outputs, times only
    "products_1xtf32": [
        ("#pragma unroll\n  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], alo, bhi[j][0], bhi[j][1]);\n",
         ""),
        ("#pragma unroll\n  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ahi, blo[j][0], blo[j][1]);\n",
         "")],
    "no_weight_copies": [("    const bool full = c < ncols;\n",
                          "    const bool full = c < ncols;\n    if (e >= 0) continue;\n")],
    "no_stage_barrier": [("    __syncthreads();  // stage st landed for every thread; stage"
                          " st - 1's slot is free\n", "")],
    "no_attention": [("  attention(p, sa, skr, svr);\n", "")],
    "no_products": [("  for (int st = 0; st < nst; ++st) {\n",
                     "  for (int st = 0; st < 0 * nst; ++st) {\n"),
                    ("  issue_stage<NT>(p.wqkv + D, 3 * D, D, 0, ring, p.ldw);", "")],
}
CORRECT = ("shipped", "no_promote", "cluster16", "cluster16_one_per_sm", "warps_n10",
           "split_truncate", "bf16_corrections")
# (B, H, timed launches per run)
TIMED = ((100, 32, 50), (3200, 32, 4), (100, 64, 25))


def build_variants(names, out: Path) -> dict:
    src = (build.CSRC_DIR / "dit_block.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} found {text.count(old)} times")
            text = text.replace(old, new)
        cu = out / f"dit_block_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        jobs[name] = (so, subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                                            str(cu)], stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs = [ln.split("Used")[1].strip() for ln in log.splitlines() if "Used" in ln]
        print(f"variant {name}: ptxas {sorted(set(regs))}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.dit_block_forward_f32.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.dit_block_forward_f32.restype = ctypes.c_int
        lib.dit_block_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def launch(lib, x, mod, ws, n_heads):
    B, H, D = x.shape
    out = torch.empty_like(x)
    err = lib.dit_block_forward_f32(x.data_ptr(), mod.data_ptr(), *(w.data_ptr() for w in ws),
                                    out.data_ptr(), B, H, D, n_heads, (D // n_heads) ** -0.5,
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {lib.dit_block_error_string(err).decode()} ({err})")
    return out


def inputs(B, H, D, seed=0, x_offset=0.0, w_mean=0.0):
    """Seeded block inputs: weights at std fan_in^-0.5 plus w_mean, biases
    and mod at std 0.1 and 0.5, x at std 1 plus x_offset."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std, mean=0.0: torch.from_numpy(
        (mean + rng.standard_normal(s) * std).astype(np.float32)).cuda()
    x = f(B, H, D, std=1.0) + x_offset
    mod = f(B, 6 * D, std=0.5)
    ws = [f(D, 3 * D, std=D ** -0.5, mean=w_mean), f(3 * D, std=0.1),
          f(D, D, std=D ** -0.5, mean=w_mean), f(D, std=0.1),
          f(D, 4 * D, std=D ** -0.5, mean=w_mean), f(4 * D, std=0.1),
          f(4 * D, D, std=(4 * D) ** -0.5, mean=w_mean), f(D, std=0.1)]
    return x, mod, ws


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls, after a device spin so the
    host has enqueued every call before the device reaches them."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default="chiprun_out/dit_block_variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.variants.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = build_variants(names, Path(args.out))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    NH = 10
    result = {"device": smi, "errors": {}, "ms": {}}

    # accuracy: kernel and plain f32 against float64
    for case, H, kw in (("normal", 32, {}), ("precision", 32, dict(x_offset=10.0, w_mean=0.05)),
                        ("normal_h64", 64, {})):
        x, mod, ws = inputs(100, H, 320, **kw)
        ref64 = dit_block_reference(x.double(), mod.double(), *(w.double() for w in ws),
                                    n_heads=NH)
        plain = dit_block_reference(x, mod, *ws, n_heads=NH)
        line = {"plain_vs_f64": (plain.double() - ref64).abs().max().item(),
                "max_abs_ref": ref64.abs().max().item()}
        for name in names:
            if name in CORRECT:
                out = launch(libs[name], x, mod, ws, NH).double()
                line[name] = {"vs_plain": (out - plain.double()).abs().max().item(),
                              "vs_f64": (out - ref64).abs().max().item()}
        result["errors"][case] = line
        print(case, json.dumps(line), flush=True)

    # times, in turns: plain, variants..., variants reversed, plain
    for B, H, iters in TIMED:
        x, mod, ws = inputs(B, H, 320)
        fns = {"plain": lambda: dit_block_reference(x, mod, *ws, n_heads=NH)}
        for name in names:
            fns[name] = lambda lib=libs[name]: launch(lib, x, mod, ws, NH)
        for f in fns.values():
            cuda_ms(f, 2)
        order = list(fns) + list(reversed(fns))
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(cuda_ms(fns[k], iters))
        gflop = B * H * (24 * 320 ** 2 + 4 * H * 320) / 1e9
        result["ms"][f"B={B},H={H}"] = times
        for k, v in times.items():
            ms = sum(v) / len(v)
            print(f"B={B} H={H} {k}: {ms:.4f} ms ({gflop / ms:.2f} TFLOP/s) runs {v}", flush=True)
    out = Path(args.out) / "result.json"
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

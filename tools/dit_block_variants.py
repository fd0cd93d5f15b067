"""What bounds the PyTorch port's fused DiT block kernel on the card: build
edited copies of one of its routes' sources, check them against the plain
version, and time them in turns with it.

    python tools/dit_block_variants.py [--route f32|bf16] [--variants a,b] [--out DIR]

`--route f32` (the default) edits `cleandiffuser_tpu_torch/csrc/dit_block.cu`
(3xTF32 `mma.sync`): each copy that stays correct is checked against the
plain version (f32) and a float64 reference, at the DD plan's shape, and
every copy is timed at that shape, at the 3200-trajectory candidate batch
and at the antmaze configs' horizon of 64. `--route bf16` edits
`csrc/dit_block_bf16.cu` (`wgmma` BF16, a TMA weight ring) and times its
copies at the same three shapes, mixed (f32 x and mod, BF16 weights), the
shipped source's error against the plain version beside them.

A variant is a list of exact text replacements in the source. Some keep the
kernel correct (another warp layout, split of a trajectory, accumulation);
others remove a part (the MMAs, the copies, a barrier, attention, every
product; for the BF16 route LN, attention, the epilogues, the wgmmas), so
that their output is wrong and only their time counts: the time a part
saves when removed is what it costs. The BF16 route's `*_ns4` caps its ring
at 4 stages and `*_b128` brings the weights in 128-byte rows (64-column
atoms) instead of 64-byte ones. Every copy is built with its own nvcc, all
started together, and timed as one CUDA graph of its calls behind a device
spin (`chip_smoke.py`'s `cuda_ms`); the results go to `--out` as JSON. Needs
a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
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

BF16_HELPERS = """// d += a (16x16, row) * b (16x8, col), BF16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 (given as bits) rounded to BF16, the first in the low half
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

# K1's BF16 route (csrc/dit_block_bf16.cu): parts removed (wrong outputs,
# times only) and settings changed
ATTENTION = """    if (p.H <= 32)
      p.hd <= 32 ? attention<4, 4>(p, Hb, K, V, A, nS, gw, lane)
                 : attention<4, 8>(p, Hb, K, V, A, nS, gw, lane);
    else
      p.hd <= 32 ? attention<8, 4>(p, Hb, K, V, A, nS, gw, lane)
                 : attention<8, 8>(p, Hb, K, V, A, nS, gw, lane);
"""
NO_ATTENTION = [(ATTENTION, "")]
NO_LN = [("  const int D = p.D, nf = D / 4;\n  for (int r0 = gw;",
          "  const int D = p.D, nf = D / 4;\n  if (D > 0) return;\n  for (int r0 = gw;")]
NO_EPILOGUE = [("  auto each = [&](auto f) {\n", "  auto each = [&](auto f) {\n    if (p.D > 0) return;\n")]
NO_MMA = [("    wgmma<N>(acc, a_desc(a_addr), b_desc(ring + slot * p.stage_bytes + wg_off), "
           "first ? 0 : 1);\n", "")]
NS4 = [("constexpr int kMinStages = 4, kMaxStages = 8;",
        "constexpr int kMinStages = 4, kMaxStages = 4;")]
B128 = [("  const cuuint64_t dims[3] = {(cuuint64_t)kAtom, (cuuint64_t)rows, "
         "(cuuint64_t)(cols / kAtom)};\n  const cuuint64_t strides[2] = {2ull * cols, 2ull * "
         "kAtom};\n  const cuuint32_t box[3] = {(cuuint32_t)kAtom, (cuuint32_t)kCK, "
         "(cuuint32_t)atoms};",
         "  const cuuint64_t dims[3] = {64, (cuuint64_t)rows, (cuuint64_t)(cols / 64)};\n"
         "  const cuuint64_t strides[2] = {2ull * cols, 128};\n"
         "  const cuuint32_t box[3] = {64, (cuuint32_t)kCK, (cuuint32_t)atoms / 2};"),
        ("CU_TENSOR_MAP_SWIZZLE_64B", "CU_TENSOR_MAP_SWIZZLE_128B"),
        ("tma_load_3d(ring + slot * p.stage_bytes, tm, full, 0, row0 + kCK * step, atom);",
         "tma_load_3d(ring + slot * p.stage_bytes, tm, full, 0, row0 + kCK * step, atom / 2);")]
PRODUCTS_ONLY = NO_ATTENTION + NO_LN + NO_EPILOGUE
BF16_VARIANTS = {
    "shipped": [],
    "no_mma": NO_MMA,
    "no_attention": NO_ATTENTION,
    "no_ln": NO_LN,
    "no_epilogue": NO_EPILOGUE,
    "products_only": PRODUCTS_ONLY,
    "po_no_mma": PRODUCTS_ONLY + NO_MMA,
    "po_ns4": PRODUCTS_ONLY + NS4,
    "po_no_mma_ns4": PRODUCTS_ONLY + NO_MMA + NS4,
    "po_no_mma_b128": PRODUCTS_ONLY + NO_MMA + B128,
}
BF16_TIMED = ((100, 32, 40), (3200, 32, 4), (100, 64, 20))
ROUTES = {
    "f32": dict(source=build.CSRC_DIR / "dit_block.cu", variants=VARIANTS, timed=TIMED,
                entry="dit_block_forward_f32", error="dit_block_error_string"),
    "bf16": dict(source=build.CSRC_DIR / "dit_block_bf16.cu", variants=BF16_VARIANTS,
                 timed=BF16_TIMED, entry="dit_block_forward_bf16",
                 error="dit_block_bf16_error_string"),
}


def edited(route: str, name: str, src: str) -> str:
    """`src` with variant `name`'s replacements of `route`, each of which
    must find its text once."""
    for old, new in ROUTES[route]["variants"][name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} found {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variants(route: str, names, out: Path) -> dict:
    r = ROUTES[route]
    src = r["source"].read_text()
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        cu = out / f"{r['source'].stem}_{name}.cu"
        cu.write_text(edited(route, name, src))
        so = cu.with_suffix(".so")
        jobs[name] = (so, subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                                            str(build.CSRC_DIR), "-o", str(so), str(cu)],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs = [ln.split("Used")[1].strip() for ln in log.splitlines() if "Used" in ln]
        print(f"variant {name}: ptxas {sorted(set(regs))}", flush=True)
        lib = ctypes.CDLL(str(so))
        entry = getattr(lib, r["entry"])
        # the BF16 entry takes x's type (0: f32) after the head count
        entry.argtypes = [vp] * 11 + [ci] * (5 if route == "bf16" else 4) + [ctypes.c_float, vp]
        entry.restype = ci
        getattr(lib, r["error"]).argtypes = [ci]
        getattr(lib, r["error"]).restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def launch(route: str, lib, x, mod, ws, n_heads):
    r = ROUTES[route]
    B, H, D = x.shape
    out = torch.empty_like(x)
    ints = (B, H, D, n_heads, 0) if route == "bf16" else (B, H, D, n_heads)
    err = getattr(lib, r["entry"])(x.data_ptr(), mod.data_ptr(), *(w.data_ptr() for w in ws),
                                   out.data_ptr(), *ints, (D // n_heads) ** -0.5,
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {getattr(lib, r['error'])(err).decode()} ({err})")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", choices=sorted(ROUTES), default="f32")
    ap.add_argument("--variants", default=None, help="comma-separated; default: all")
    ap.add_argument("--out", default=None,
                    help="default: chiprun_out/dit_block_variants (f32) or "
                         "chiprun_out/dit_block_bf16_variants (bf16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    from chip_smoke import cuda_ms  # the repo's device timer (imports the port)

    torch.backends.cuda.matmul.allow_tf32 = False
    route, r = args.route, ROUTES[args.route]
    names = args.variants.split(",") if args.variants else list(r["variants"])
    if "shipped" not in names:
        names.insert(0, "shipped")
    out_dir = Path(args.out or ("chiprun_out/dit_block_variants" if route == "f32" else
                                "chiprun_out/dit_block_bf16_variants"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = build_variants(route, names, out_dir)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    NH = 10
    result = {"device": smi, "route": route, "errors": {}, "ms": {}}
    cast = (lambda ws: [w.to(torch.bfloat16) for w in ws]) if route == "bf16" else (lambda ws: ws)

    # accuracy: the f32 route's correct variants and plain f32 against
    # float64; the BF16 route's shipped source against the plain version
    for case, H, kw in (("normal", 32, {}), ("precision", 32, dict(x_offset=10.0, w_mean=0.05)),
                        ("normal_h64", 64, {})):
        x, mod, ws = inputs(100, H, 320, **kw)
        ws = cast(ws)
        plain = dit_block_reference(x, mod, *ws, n_heads=NH)
        if route == "bf16":
            line = {"shipped": {"vs_plain": (launch(route, libs["shipped"], x, mod, ws, NH)
                                             - plain).abs().max().item()},
                    "max_abs_ref": plain.abs().max().item()}
        else:
            ref64 = dit_block_reference(x.double(), mod.double(), *(w.double() for w in ws),
                                        n_heads=NH)
            line = {"plain_vs_f64": (plain.double() - ref64).abs().max().item(),
                    "max_abs_ref": ref64.abs().max().item()}
            for name in names:
                if name in CORRECT:
                    out = launch(route, libs[name], x, mod, ws, NH).double()
                    line[name] = {"vs_plain": (out - plain.double()).abs().max().item(),
                                  "vs_f64": (out - ref64).abs().max().item()}
        result["errors"][case] = line
        print(case, json.dumps(line), flush=True)

    # times, in turns: plain, variants..., variants reversed, plain
    for B, H, iters in r["timed"]:
        x, mod, ws = inputs(B, H, 320)
        ws = cast(ws)
        fns = {"plain": lambda: dit_block_reference(x, mod, *ws, n_heads=NH)}
        for name in names:
            fns[name] = lambda lib=libs[name]: launch(route, lib, x, mod, ws, NH)
        order = list(fns) + list(reversed(fns))
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(cuda_ms(fns[k], iters))
        gflop = B * H * (24 * 320 ** 2 + 4 * H * 320) / 1e9
        result["ms"][f"B={B},H={H}"] = times
        for k, v in times.items():
            ms = statistics.median(v)
            print(f"B={B} H={H} {k}: {ms:.4f} ms ({gflop / ms:.2f} TFLOP/s) runs {v}", flush=True)
    out = out_dir / "result.json"
    out.write_text(json.dumps(result, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

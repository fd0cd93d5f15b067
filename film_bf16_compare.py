"""K3's BF16 route (`fused_film_resblock_bf16`, csrc/film_resblock_bf16.cu)
of this checkout on one card, against the same route of another checkout
(`--other`) or of an edited copy of this one (`--variants`): every distinct
block shape of the shipped MuJoCo U-Net at B = 3200 with the operands the
bf16 U-Net hands the route, each pair timed in turns (other, this, this,
other), one CUDA graph of `--iters` calls each. The shapes, the operands
and the timer are `chip_smoke.py`'s (UNET_BLOCKS, film_bf16_args,
time_in_turns).

    git archive <commit> | tar -x -C results/parent
    python film_bf16_compare.py --other results/parent --variants nomma,nogn,nox

The other checkout's package is imported under another name, so it shares
no module with this one and builds its kernels into its own _build. A
variant is a copy of this checkout's package with exact text replacements
in the kernel source (VARIANTS) that remove a part, so its output is wrong
and only its time counts: the time a part saves when removed is what it
costs. Prints per shape both medians and this route over the other, and
the sums over the net's 16 blocks; writes them as JSON to `--out`. Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "csrc/film_resblock_bf16.cu"  # in the package
B, K, GROUPS = 3200, 5, 8
VARIANTS = {
    # the wgmmas (the stage protocol and the weight ring stay)
    "nomma": [("      wgmma<N>(acc, a[ks], b_desc<N, NWG>(b + ks * C::kKStepBytes), "
               "ks > 0 || !first);", "      (void)b;")],
    # GroupNorm's statistics: both passes, their barriers and tables
    "nogn": [("  col_sums<N>(biased, fr, mean, p.ldb, p.H, p.lgH, Cout);",
              "  return {mean, rstd, p.ldb};\n"
              "  col_sums<N>(biased, fr, mean, p.ldb, p.H, p.lgH, Cout);")],
    # x's loads from device memory (zeros are staged)
    "nox": [("        v[u] = *reinterpret_cast<const Raw*>(x + ((size_t)(b0 + s) * p.H + h) * "
             "p.Cin + c0 + k);", "        v[u] = Raw{};")],
}


def variant_package(name: str) -> Path:
    """A copy of this checkout's package under results/, with the kernel
    source edited by VARIANTS[name]. Raises if an edit's text is not in
    the source exactly once."""
    src = (ROOT / "cleandiffuser_tpu_torch" / SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {SOURCE} once")
        src = src.replace(old, new)
    pkg = ROOT / "results" / f"film_bf16_{name}" / "cleandiffuser_tpu_torch"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(ROOT / "cleandiffuser_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (pkg / SOURCE).write_text(src)
    return pkg


def import_package(pkg: Path, name: str):
    """The package at `pkg`, imported as `name`."""
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--variants", default="", help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "results" / "film_bf16_compare.json"))
    args = ap.parse_args()
    variants = [v for v in args.variants.split(",") if v]
    if args.other is None and not variants:
        ap.error("give --other, --variants or both")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import numpy as np
    import torch

    from cleandiffuser_tpu_torch.ops.film_resblock import fused_film_resblock_bf16

    pkgs = {v: variant_package(v) for v in variants}
    if args.other:
        pkgs = {"other": Path(args.other).resolve() / "cleandiffuser_tpu_torch", **pkgs}
    mods = {side: import_package(pkg, f"film_bf16_{side}") for side, pkg in pkgs.items()}
    # every route's library at once, one nvcc each (an older checkout's BF16
    # route sits in film_resblock.cu)
    builds = [(cs.build, "film_resblock_bf16")] + [
        (importlib.import_module(f"{m.__name__}.ops.build"),
         "film_resblock_bf16" if (pkg / SOURCE).exists() else "film_resblock")
        for m, pkg in zip(mods.values(), pkgs.values())]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: b[0].build_libraries([b[1]]), builds))
    routes = {side: importlib.import_module(f"{m.__name__}.ops.film_resblock")
              .fused_film_resblock_bf16 for side, m in mods.items()}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED + 12)
    kw = dict(K=K, groups=GROUPS, eps=1e-6)
    med = {side: {} for side in routes}
    runs = {side: {} for side in routes}
    with torch.no_grad():
        for i, shape in enumerate(dict.fromkeys(cs.UNET_BLOCKS)):
            f32, x, wb = cs.film_bf16_args(rng, dev, B, *shape, K, i == 0)
            this = lambda: fused_film_resblock_bf16(x, f32[1], *wb, **kw)
            for side, route in routes.items():
                m, times = cs.time_in_turns({side: lambda: route(x, f32[1], *wb, **kw),
                                             "this": this}, args.iters)
                med[side][str(shape)] = (m["this"], m[side])
                runs[side][str(shape)] = times
                print(f"{shape}: this {m['this']:.4f} ms, {side} {m[side]:.4f} ms, this / "
                      f"{side} {m['this'] / m[side]:.3f} (runs {times})", flush=True)
    total = {}
    for side in routes:
        this, other = (sum(med[side][str(s)][j] for s in cs.UNET_BLOCKS) for j in (0, 1))
        total[side] = (this, other)
        print(f"one U-Net call ({len(cs.UNET_BLOCKS)} blocks) against {side}: this "
              f"{this:.4f} ms, {side} {other:.4f} ms, this / {side} {this / other:.3f}, "
              f"this - {side} {this - other:.4f} ms ({(this - other) / this:.1%} of this)",
              flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": smi, "B": B, "median_this_other": med, "runs": runs,
                               "total_this_other": total}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

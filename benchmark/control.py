"""The control of `correct`: the plain reference put in the program's place
and computed one precision below the configuration's (TF32 for float32 with
TF32 off), judged by the cell's own comparison against the reference in
the configuration's precision. Every cell's numbers have to read it as not
correct; its readings set the upper end of each limit.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 [--plans N]

reads, on the card, each seed's requests 0..N-1 (the mix's `check_plans`
by default) at the cell's own size and prints the numbers compared, each
the worst over the seed's requests, beside the limits. The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def _tf32(on: bool):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def readings(config: dict, traffic: dict, seeds, device, plans=None):
    """For each seed, the cell's numbers with the TF32 reference as the
    program's outputs (a dict per seed)."""
    import torch

    from benchmark import run

    family = run.load_family(config)
    out = []
    for seed in seeds:
        cell = family.Cell(config, traffic, seed, device)
        cases = []
        with torch.no_grad():
            for i in range(plans or traffic["check_plans"]):
                req = cell.request(i)
                _tf32(True)
                low = cell.reference(req)
                _tf32(config["tf32"])
                cases.append((req, low, cell.reference(req)))
            out.append(cell.judge(cases))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--plans", type=int)
    args = ap.parse_args(argv)
    import torch

    from benchmark import run

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _, config, traffic = run.find_cell(run.load_manifest(), args.workload)
    limits = config["limits"]
    for seed, numbers in zip(args.seeds, readings(config, traffic, args.seeds,
                                                  torch.device("cuda", 0), args.plans)):
        over = [k for k, v in numbers.items() if v > limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed, "control": numbers,
                          "limits": limits, "fails": over}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

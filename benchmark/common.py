"""What every family shares: weights and request inputs drawn from the seed
on the device, handing them to the program, and the gaps the comparisons
read. Imports nothing of the program."""

from __future__ import annotations

import torch

# request i of a run with seed s draws from the generator seeded with
# (s * MIX + i) mod 2**63: distinct streams for every request of every seed
MIX = 0x4F1BBCDCBFA53E0B


def request_seed(seed: int, index: int) -> int:
    return (seed * MIX + index) % 2 ** 63


def make_weights(spec: dict, seed: int, device) -> dict:
    """Every weight of `spec` (name -> (shape, std, mean)) drawn from one
    standard normal of their total size on `device`, then scaled and
    shifted in place: a few large calls, whatever the number of leaves.
    Returns name -> float32 tensor (views of one buffer)."""
    gen = torch.Generator(device=device).manual_seed(request_seed(seed, -1))
    names = sorted(spec)
    sizes = [torch.Size(spec[n][0]).numel() for n in names]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    views = [v.view(spec[n][0]) for n, v in zip(names, flat.split(sizes))]
    torch._foreach_mul_(views, [float(spec[n][1]) for n in names])
    torch._foreach_add_(views, [float(spec[n][2]) for n in names])
    return dict(zip(names, views))


@torch.no_grad()
def load_weights(modules: dict, weights: dict):
    """Copy `weights` into the parameters of `modules` (prefix -> module):
    the parameter named p of modules[prefix] takes weights[prefix + "." + p].
    Raises unless the program's parameters and the weights match one to one
    in names and shapes."""
    dst, src, names = [], [], set()
    for prefix, module in modules.items():
        for name, param in module.named_parameters():
            key = f"{prefix}.{name}"
            names.add(key)
            if key not in weights or weights[key].shape != param.shape:
                got = None if key not in weights else tuple(weights[key].shape)
                raise ValueError(f"the program's {key} {tuple(param.shape)} has no weight of "
                                 f"its shape in the benchmark's ({got})")
            dst.append(param)
            src.append(weights[key])
    missing = set(weights) - names
    if missing:
        raise ValueError(f"weights the program does not hold: {sorted(missing)}")
    torch._foreach_copy_(dst, src)


def rel_gap(got, want) -> float:
    """max |got - want| over max |want|: a gap relative to the scale."""
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / max(scale, 1e-30)

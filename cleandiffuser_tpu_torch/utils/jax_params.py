"""Carry parameters between the JAX package's layout and the port's modules.

The JAX package keeps parameters as flax trees: nested dicts whose leaves
are arrays, named by flax's module numbering (`Dense_0`, `FourierEmbedding_0`,
`PallasDiTBlock_1`, ...). This module reads such trees, given as nested
dicts of numpy arrays, into the port's `nn.Module`s, and writes them back
out. Nothing here imports JAX.

Naming. Each port module that names its children differently from flax
carries a `JAX_NAMES` table (child attribute -> flax name); an
`nn.ModuleList` child maps through a format string (`"PallasDiTBlock_{}"`).
Leaves keep their names, except for two torch layers:

- an `nn.Linear` weight is flax's Dense `kernel`, stored transposed: flax
  keeps `(in, out)`, torch `(out, in)`;
- an `nn.ConvTranspose1d` weight is flax's `ConvTranspose` kernel: flax
  keeps `(K, Cin, Cout)` and, with `transpose_kernel=False`, correlates
  where torch convolves, so torch's `(Cin, Cout, K)` weight is the kernel
  flipped along K: `w = kernel[::-1].transpose(1, 2, 0)`;
- an `nn.Conv2d` weight (the image encoders, nn_condition/images.py) is
  flax's 2-D `Conv` kernel: flax keeps `(KH, KW, Cin, Cout)`, torch
  `(Cout, Cin, KH, KW)`: `w = kernel.transpose(3, 2, 0, 1)`.

- a `DenseGeneral` (utils/blocks.py; flax's `MultiHeadDotProductAttention`
  projections) keeps its flax kernel and bias shapes in `jax_shapes`: the
  query, key and value kernels are (D, heads, head_dim), the output's
  (heads, head_dim, D), both row-major flattenings of the torch `(in, out)`
  matrix's transpose, and the biases (heads, head_dim) or (D,).

flax `Conv`, `GroupNorm` and `LayerNorm` map onto the port's channels-last
`Conv1d`, `GroupNorm` and `LayerNorm` (utils/blocks.py), which keep flax's
names and layouts (`kernel` (K, Cin, Cout), `bias`, `scale`), so their
leaves copy unchanged, as do the fused DiT block's flat weights, kept in
the flax `(in, out)` orientation, and a module's own flax params (the Chi
transformer's `pos_emb`, the Pearce token BatchNorm's `scale` / `bias`).
The imitation backbones name their children as flax numbers them: the Chi
U-Net's `ChiResidualBlock_i` (`Conv_*`, `GroupNorm_*`, `Dense_0`),
`Downsample1d_i`, `Upsample1d_i`; the Chi transformer's
`_PreNormDecoderLayer_i` with their `MultiHeadDotProductAttention_*`
(DenseGeneral kernels (D, heads, head_dim)); the Pearce nets' `FCBlock_i`,
`TimeSiren_0` (its first Dense without bias) and `_PearceEncoderBlock_i`;
the image encoder's `ResNet18_i` (`Conv_*`, `GroupNorm_*`, `_ResBlock2d_i`,
`SpatialSoftmax_0`, `Dense_*`).

Block layouts. A DiT1d built with `use_pallas_block=True` stores each block
flat (`PallasDiTBlock_i`: wmod, bmod, wqkv, ...); one built without stores
it nested (`DiTBlock_i`: Dense_0, MultiHeadDotProductAttention_0, Dense_1,
Dense_2). Both load: a nested block is flattened first (`flat_from_nested`).
flax keeps the q/k/v kernels as (D, heads, head_dim), head-major, which is
exactly the column order of the flat `wqkv`.

Optimizer state. optax's Adam moments are trees shaped as the params; they
carry across by the same mapping into `torch.optim` state (`exp_avg`,
`exp_avg_sq`, `step`), so a JAX checkpoint resumes in the port.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from .blocks import DenseGeneral

__all__ = [
    "flat_from_nested",
    "load_jax_params",
    "load_adam_moments",
    "jax_params_of",
    "load_agent_params",
    "load_agent_moments",
    "agent_params_of",
]

_NESTED_BLOCK = re.compile(r"^DiTBlock_(\d+)$")


def flat_from_nested(p: dict) -> Dict[str, np.ndarray]:
    """flax `DiTBlock` param subtree -> `PallasDiTBlock` flat subtree."""
    attn = p["MultiHeadDotProductAttention_0"]
    D = np.asarray(p["Dense_0"]["kernel"]).shape[0]

    def cat(key):
        parts = [np.asarray(attn[nm][key]).reshape((D, D) if key == "kernel" else (D,))
                 for nm in ("query", "key", "value")]
        return np.concatenate(parts, axis=-1 if key == "kernel" else 0)

    return {
        "wmod": np.asarray(p["Dense_0"]["kernel"]),
        "bmod": np.asarray(p["Dense_0"]["bias"]),
        "wqkv": cat("kernel"),
        "bqkv": cat("bias"),
        "wo": np.asarray(attn["out"]["kernel"]).reshape(D, D),
        "bo": np.asarray(attn["out"]["bias"]).reshape(D),
        "w1": np.asarray(p["Dense_1"]["kernel"]),
        "b1": np.asarray(p["Dense_1"]["bias"]),
        "w2": np.asarray(p["Dense_2"]["kernel"]),
        "b2": np.asarray(p["Dense_2"]["bias"]),
    }


def _flatten_blocks(tree: dict) -> dict:
    """Rewrite every nested `DiTBlock_i` subtree as a flat `PallasDiTBlock_i`."""
    out = {}
    for k, v in tree.items():
        m = _NESTED_BLOCK.match(k)
        if m:
            out[f"PallasDiTBlock_{m.group(1)}"] = flat_from_nested(v)
        elif isinstance(v, dict):
            out[k] = _flatten_blocks(v)
        else:
            out[k] = v
    return out


def _leaves(tree: dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch(arr: np.ndarray, layout, shape=None) -> np.ndarray:
    if isinstance(layout, tuple):  # DenseGeneral: (flax shape, torch shape)
        torch_shape = layout[1]
        if len(torch_shape) == 2:  # weight (out, in) from a kernel (..in.., ..out..)
            return arr.reshape(torch_shape[1], torch_shape[0]).T
        return arr.reshape(torch_shape)
    if layout == "dense":
        return arr.T
    if layout == "conv_transpose":
        return arr[::-1].transpose(1, 2, 0)
    if layout == "conv2d":
        return arr.transpose(3, 2, 0, 1)
    return arr


def _to_jax(arr: np.ndarray, layout) -> np.ndarray:
    if isinstance(layout, tuple):
        return (arr.T if arr.ndim == 2 else arr).reshape(layout[0])
    if layout == "dense":
        return arr.T
    if layout == "conv_transpose":
        return arr.transpose(2, 0, 1)[::-1]
    if layout == "conv2d":
        return arr.transpose(2, 3, 1, 0)
    return arr


def _jax_path(model: nn.Module, key: str) -> Tuple[Tuple[str, ...], str]:
    """flax path of the port's state_dict entry `key`, and how the array's
    layout differs between the two: "dense" (an nn.Linear weight),
    "conv_transpose" (an nn.ConvTranspose1d weight), "conv2d" (an
    nn.Conv2d weight), a (flax shape, torch shape) pair (a DenseGeneral's weight or bias) or "" (the same)."""
    *names, leaf = key.split(".")
    path, m, i = [], model, 0
    while i < len(names):
        table = getattr(m, "JAX_NAMES", {})
        child = m._modules[names[i]]
        if isinstance(child, nn.ModuleList):
            path.append(table[names[i]].format(names[i + 1]))
            m = child[int(names[i + 1])]
            i += 2
        else:
            path.append(table.get(names[i], names[i]))
            m = child
            i += 1
    if isinstance(m, DenseGeneral):
        layout = (m.jax_shapes[leaf], tuple(getattr(m, leaf).shape))
        return tuple(path) + ("kernel" if leaf == "weight" else leaf,), layout
    layout = ("dense" if isinstance(m, nn.Linear) else
              "conv_transpose" if isinstance(m, nn.ConvTranspose1d) else
              "conv2d" if isinstance(m, nn.Conv2d) else "")
    if layout and leaf == "weight":
        return tuple(path) + ("kernel",), layout
    return tuple(path) + (leaf,), ""


def _state_from_jax(model: nn.Module, tree: dict) -> Dict[str, torch.Tensor]:
    """A flax param tree (or a tree shaped like one, e.g. Adam's moments)
    as the model's state_dict, on the CPU. Every entry of the model's state
    must be found and every leaf of the tree used, with matching shapes."""
    leaves = dict(_leaves(_flatten_blocks(tree)))
    state = {}
    for key, ref in model.state_dict().items():
        path, layout = _jax_path(model, key)
        if path not in leaves:
            raise KeyError(f"JAX params have no {'/'.join(path)} for {key}")
        arr = _to_torch(np.asarray(leaves.pop(path), dtype=np.float32), layout)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} does not fit {key} "
                             f"{tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if leaves:
        raise KeyError(f"JAX params left unused: {sorted('/'.join(p) for p in leaves)}")
    return state


def load_jax_params(model: nn.Module, tree: dict) -> None:
    """Load a flax param tree (the dict under "params") into `model`, in
    place, on the model's device."""
    model.load_state_dict(_state_from_jax(model, tree))


def load_adam_moments(optimizer: torch.optim.Optimizer, model: nn.Module, mu: dict,
                      nu: dict, count: int) -> None:
    """Carry optax Adam moments (`mu`, `nu`: trees shaped as the flax params
    of `model`) and its count into `optimizer`'s state for the parameters of
    `model`, laid out as the parameters are (Dense kernels transposed, DiT
    blocks flat or nested)."""
    m, v = _state_from_jax(model, mu), _state_from_jax(model, nu)
    for key, p in model.named_parameters():
        optimizer.state[p] = {"step": torch.tensor(float(count)),
                              "exp_avg": m[key].to(p.device),
                              "exp_avg_sq": v[key].to(p.device)}


def jax_params_of(model: nn.Module) -> dict:
    """The model's parameters as a flax param tree of numpy arrays (blocks
    in the flat `PallasDiTBlock_i` layout), copies that later updates of the
    model leave as they are."""
    tree: dict = {}
    for key, t in model.state_dict().items():
        path, layout = _jax_path(model, key)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(_to_jax(t.detach().cpu().numpy(), layout), order="C")
    return tree


def load_agent_params(params: nn.ModuleDict, tree: dict) -> None:
    """Load an engine's `state.params` / `state.ema_params` tree
    ({"diffusion": {"params": ...}, "condition": {"params": ...}})."""
    for name, module in params.items():
        load_jax_params(module, tree.get(name, {}).get("params", {}))


def load_agent_moments(optimizer: torch.optim.Optimizer, params: nn.ModuleDict, mu: dict,
                       nu: dict, count: int) -> None:
    """`load_adam_moments` for an engine's moments, shaped as its
    `state.params` tree."""
    for name, module in params.items():
        load_adam_moments(optimizer, module, mu.get(name, {}).get("params", {}),
                          nu.get(name, {}).get("params", {}), count)


def agent_params_of(params: nn.ModuleDict) -> dict:
    return {name: {"params": jax_params_of(module)} for name, module in params.items()}

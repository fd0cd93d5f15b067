"""Fused FiLM Conv1d residual block: the Hopper kernel, its wrapper and its
plain PyTorch version.

Counterpart of cleandiffuser_tpu/ops/film_resblock.py, whose Pallas TPU
kernel `film_resblock` is replaced by two CUDA C++ kernels, one per route:
`csrc/film_resblock.cu` (float32) and `csrc/film_resblock_bf16.cu` (BF16
weights), each built for sm_90a as a library of its own and bound with
ctypes. The math of
`ResidualBlock1d` (nn_diffusion/jannerunet.py), channels-last:

    h   = mish(GN(conv1(x)))                    conv: K taps, SAME padding
    h   = h + emb   (or emb[:C] * h + emb[C:] with `film_scale`)
    h   = mish(GN(conv2(h)))
    out = h + (x @ wskip + bskip  or  x)

GroupNorm takes its statistics per sample over (H, C/groups), two-pass.
Its eps is an argument: the TPU kernel hard-codes 1e-5, while the flax
`nn.GroupNorm` of the U-Net uses 1e-6. The FiLM projection
`Dense(mish(t_emb))` is computed outside, as in the reference. Weights keep
the JAX layouts, conv (K, Cin, Cout) and skip (Cin, Cout): the kernels
stage them into shared memory as they are stored.

Two routes, each with its wrapper and launch count, chosen by the weights'
type (`kernel_route` admits exactly these):

- `fused_film_resblock`: everything float32. Both convs and the skip run
  as implicit GEMMs on the tensor cores (`mma.sync` TF32) in 3xTF32: every
  operand is split inside the kernel into a TF32 high part and a TF32
  remainder, and the three leading cross products are summed in f32, which
  keeps f32-class accuracy.
- `fused_film_resblock_bf16`: BF16 weights, biases and GroupNorm affine
  (the U-Net's copy under `bf16_sampling` / `bf16_training`), with x and
  emb each f32 or BF16; the products in BF16 on `wgmma` with f32
  accumulation (x and the hidden layer held in BF16 in shared memory, the
  weights brought by TMA), GroupNorm statistics from the f32 accumulators,
  Mish, FiLM and the residual in f32. The output is BF16 when x and emb
  both are, else f32: the promoted type of the operands, which the flax
  block returns.

A thread block owns the output rows of whole samples (f32 route: 64 rows,
32 when Cout > 256; BF16 route: 64 rows, one `wgmma` M) and every output
channel; the sources' notes say what bounds each on the card and how the
design answers that. So both take Cout a multiple of 8 and of groups, at
most 512, and H dividing the block's rows; a shape whose block does not
fit the device's shared memory is refused.

The plain version `film_resblock_reference` takes the same types and
promotes as flax's `ResidualBlock1d` does (utils/blocks.py `promote`,
`conv1d`, `group_norm`; utils/embeddings.py `mish`): with f32 x and emb and
BF16 weights it is f32 math on the BF16-rounded weights, as the reference
computes on a CPU; with BF16 x (the U-Net's first block under the bf16
flags) the first conv, its norm and Mish and the skip run in BF16 as
flax's layers do, each rounding its result.

Dispatch (`film_resblock_op`): a CPU tensor takes `film_resblock_reference`;
a CUDA tensor launches the kernel or raises. The kernel has no backward, as
the TPU kernel has none: `film_resblock_op` differentiates through
`_FusedFiLMResBlock` (kernel forward, plain-version backward, so a
`bf16_training` step differentiates the BF16 plain version), while a direct
kernel call with grad mode on and an input that requires grad raises rather
than fall back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from ..utils.blocks import conv1d, group_norm, promote
from ..utils.embeddings import mish
from .build import load_library
from .vjp import plain_vjp

__all__ = ["fused_film_resblock", "fused_film_resblock_bf16", "film_resblock_op",
           "film_resblock_reference", "kernel_route", "load_film_resblock_library",
           "load_film_resblock_bf16_library", "bf16_plan", "BF16_PLAN_FIELDS"]

_LIB_NAME, _LIB_NAME_BF16 = "film_resblock", "film_resblock_bf16"
# the fields of film_resblock_bf16_plan, in its order
BF16_PLAN_FIELDS = ("channels", "warpgroups", "samples", "tile_rows", "row_stride", "fill_width",
                    "fills", "stages", "stage_channels", "smem", "blocks_per_sm")


def film_resblock_reference(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip=None, bskip=None,
                            *, K: int, groups: int, film_scale: bool = False,
                            eps: float = 1e-5):
    """Plain PyTorch version of the kernel's math (test oracle, CPU path).
    x (B, H, Cin); emb (B, Cout) or (B, 2 Cout) with `film_scale`. Each
    operation promotes its operands as flax's does (module note)."""
    if w1.shape[0] != K or K % 2 == 0:
        raise ValueError(f"w1 {tuple(w1.shape)} must have an odd number K={K} of taps")
    pad = (K // 2, K // 2)
    cout = w1.shape[-1]
    h = mish(group_norm(conv1d(x, w1, b1, padding=pad), groups, g1s, g1b, eps))
    if film_scale:
        h = emb[:, None, :cout] * h + emb[:, None, cout:]
    else:
        h = h + emb[:, None, :]
    h = mish(group_norm(conv1d(h, w2, b2, padding=pad), groups, g2s, g2b, eps))
    if wskip is None:
        return h + x
    xs, wskip, bskip = promote(x, wskip, bskip)
    if xs.dtype == torch.bfloat16:  # flax's conv rounds the product, then adds the bias
        return h + ((xs @ wskip) + bskip)
    return h + (xs @ wskip + bskip)


# ---------------------------------------------------------------------------
# The kernel
@functools.lru_cache(maxsize=None)
def load_film_resblock_library() -> ctypes.CDLL:
    """Build (at first use) and load the f32 route's library; set its C
    types. Cached: a launch must not re-read and re-hash the source."""
    lib = load_library(_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.film_resblock_forward_f32.argtypes = [vp] * 13 + [ci] * 7 + [ctypes.c_float, vp]
    lib.film_resblock_forward_f32.restype = ci
    lib.film_resblock_block_rows.argtypes = [ci]
    lib.film_resblock_block_rows.restype = ci
    lib.film_resblock_smem_bytes.argtypes = [ci] * 6
    lib.film_resblock_smem_bytes.restype = ctypes.c_longlong
    lib.film_resblock_max_smem_optin.argtypes = [ci]
    lib.film_resblock_max_smem_optin.restype = ci
    lib.film_resblock_error_string.argtypes = [ci]
    lib.film_resblock_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_film_resblock_bf16_library() -> ctypes.CDLL:
    """The same for the BF16 route's library."""
    lib = load_library(_LIB_NAME_BF16)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.film_resblock_forward_bf16.argtypes = [vp] * 13 + [ci] * 9 + [ctypes.c_float, vp]
    lib.film_resblock_forward_bf16.restype = ci
    lib.film_resblock_bf16_block_rows.argtypes = [ci]
    lib.film_resblock_bf16_block_rows.restype = ci
    lib.film_resblock_bf16_plan.argtypes = [ci] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.film_resblock_bf16_plan.restype = ci
    lib.film_resblock_bf16_max_smem_optin.argtypes = [ci]
    lib.film_resblock_bf16_max_smem_optin.restype = ci
    lib.film_resblock_bf16_error_string.argtypes = [ci]
    lib.film_resblock_bf16_error_string.restype = ctypes.c_char_p
    return lib


def bf16_plan(B: int, H: int, Cin: int, Cout: int, K: int, groups: int):
    """The BF16 route's tile plan for a shape (BF16_PLAN_FIELDS: output
    channels of a tile, consumer warpgroups, samples per tile, tile rows,
    x fill width and count, ring stages, shared memory bytes, blocks per
    SM), or None if the kernel does not take the shape."""
    out = (ctypes.c_longlong * len(BF16_PLAN_FIELDS))()
    if load_film_resblock_bf16_library().film_resblock_bf16_plan(B, H, Cin, Cout, K, groups,
                                                                 out) != 0:
        return None
    return dict(zip(BF16_PLAN_FIELDS, out))


class _Route(NamedTuple):
    """What the wrapper needs of a route's library: the one place that
    knows how the two libraries' C interfaces differ."""
    block_rows: Callable[[int], int]  # output rows of a thread block at Cout
    smem_bytes: Callable[..., int]  # (B, H, Cin, Cout, K, groups) -> bytes, < 0 if not taken
    max_smem_optin: Callable[[int], int]  # device index -> bytes
    forward: Callable[..., int]  # (args, x, emb, eps, stream) -> error code
    error_string: Callable[[int], bytes]


def _bf16_smem_bytes(*shape) -> int:
    plan = bf16_plan(*shape)
    return -1 if plan is None else plan["smem"]


@functools.lru_cache(maxsize=None)
def _route(route: str) -> _Route:
    if route == "f32":
        lib = load_film_resblock_library()
        return _Route(lib.film_resblock_block_rows, lib.film_resblock_smem_bytes,
                      lib.film_resblock_max_smem_optin,
                      lambda args, x, emb, eps, stream: lib.film_resblock_forward_f32(
                          *args, eps, stream),
                      lib.film_resblock_error_string)
    lib = load_film_resblock_bf16_library()
    return _Route(lib.film_resblock_bf16_block_rows, _bf16_smem_bytes,
                  lib.film_resblock_bf16_max_smem_optin,
                  lambda args, x, emb, eps, stream: lib.film_resblock_forward_bf16(
                      *args, int(x.dtype == torch.bfloat16), int(emb.dtype == torch.bfloat16),
                      eps, stream),
                  lib.film_resblock_bf16_error_string)


@functools.lru_cache(maxsize=None)
def _max_smem_optin(route: str, device_index: int) -> int:
    return _route(route).max_smem_optin(device_index)


def kernel_route(x, emb, ws) -> str:
    """"f32" (every input float32) or "bf16" (BF16 weights, biases and
    affine; x and emb each float32 or BF16): the types the kernel takes.
    Raises TypeError on any other."""
    w_types = {t.dtype for t in ws}
    act = {x.dtype, emb.dtype}
    if w_types == {torch.float32} and act == {torch.float32}:
        return "f32"
    if w_types == {torch.bfloat16} and act <= {torch.float32, torch.bfloat16}:
        return "bf16"
    raise TypeError(
        "fused_film_resblock takes all float32, or bfloat16 weights, biases and affine with "
        f"x and emb each float32 or bfloat16; got x {x.dtype}, emb {emb.dtype}, weights "
        f"{sorted(str(t) for t in w_types)}")


def _check_kernel_args(x, emb, ws, skip, K, groups, film_scale) -> str:
    """Raises on what the kernel does not take; returns the route."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, H, Cin), got {tuple(x.shape)}")
    B, H, Cin = x.shape
    if B == 0 or H == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    Cout = ws[0].shape[-1]
    if K % 2 == 0:
        raise ValueError(f"K={K}: the kernel takes an odd number of taps (SAME padding)")
    if Cout % 8 or Cout > 512 or Cout % groups:
        raise ValueError(f"Cout {Cout} must be a multiple of 8 (the MMA's n) and of groups "
                         f"{groups}, at most 512 (a thread block holds every channel)")
    shapes = {"emb": (B, 2 * Cout if film_scale else Cout), "w1": (K, Cin, Cout),
              "b1": (Cout,), "g1s": (Cout,), "g1b": (Cout,), "w2": (K, Cout, Cout),
              "b2": (Cout,), "g2s": (Cout,), "g2b": (Cout,)}
    named = dict(zip(shapes, (emb, *ws)))
    if skip[0] is None:
        if Cin != Cout or skip[1] is not None:
            raise ValueError(f"without a skip conv Cin ({Cin}) must equal Cout ({Cout})")
    else:
        shapes.update(wskip=(Cin, Cout), bskip=(Cout,))
        named.update(wskip=skip[0], bskip=skip[1])
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(named[name].shape)}")
    route = kernel_route(x, emb, [t for k, t in named.items() if k != "emb"])
    for name, t in (("x", x), *named.items()):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *named.values())):
        raise RuntimeError("fused_film_resblock has no backward: call it under "
                           "torch.no_grad(), or use film_resblock_reference to differentiate")
    rows = _route(route).block_rows(Cout)
    if rows % H:
        raise ValueError(f"H={H} must divide the {rows} output rows of a thread block at "
                         f"Cout={Cout}: a block owns whole samples")
    smem = _route(route).smem_bytes(B, H, Cin, Cout, K, groups)
    if smem < 0:
        raise ValueError(f"the kernel does not take (H={H}, Cin={Cin}, Cout={Cout}, K={K}, "
                         f"groups={groups})")
    limit = _max_smem_optin(route, x.device.index)
    if smem > limit:
        raise ValueError(f"(H={H}, Cin={Cin}, Cout={Cout}) needs {smem} bytes of shared "
                         f"memory per block; the device allows {limit}")
    return route


def _launch(route_wanted, x, emb, ws, wskip, bskip, K, groups, film_scale, eps):
    if x.device.type != "cuda":
        raise ValueError(f"fused_film_resblock runs on CUDA tensors, got {x.device}")
    route = _check_kernel_args(x, emb, ws, (wskip, bskip), K, groups, film_scale)
    if route != route_wanted:
        other = "fused_film_resblock_bf16" if route == "bf16" else "fused_film_resblock"
        raise TypeError(f"{route} inputs go to {other}")
    B, H, Cin = x.shape
    Cout = ws[0].shape[-1]
    out_dtype = torch.promote_types(x.dtype, emb.dtype)
    out = torch.empty((B, H, Cout), device=x.device, dtype=out_dtype)
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (x.data_ptr(), emb.data_ptr(), *(w.data_ptr() for w in ws), ptr(wskip), ptr(bskip),
            out.data_ptr(), B, H, Cin, Cout, K, groups, int(film_scale))
    with torch.cuda.device(x.device):
        err = _route(route).forward(args, x, emb, eps,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        message = _route(route).error_string(err).decode()
        raise RuntimeError(f"film_resblock kernel launch failed: {message} ({err})")
    return out


def fused_film_resblock(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip=None, bskip=None,
                        *, K: int, groups: int, film_scale: bool = False, eps: float = 1e-5):
    """Launch the f32 route on the current stream. Returns a new (B, H, Cout)
    tensor. Raises on any input the kernel does not take (a BF16 call goes
    to `fused_film_resblock_bf16`), if an input needs a gradient, and if the
    launch fails."""
    out = _launch("f32", x, emb, (w1, b1, g1s, g1b, w2, b2, g2s, g2b), wskip, bskip, K, groups,
                  film_scale, eps)
    fused_film_resblock.launches += 1
    return out


fused_film_resblock.launches = 0


def fused_film_resblock_bf16(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip=None,
                             bskip=None, *, K: int, groups: int, film_scale: bool = False,
                             eps: float = 1e-5):
    """Launch the BF16 route on the current stream: BF16 weights, biases and
    affine; x and emb each f32 or BF16. Returns a new (B, H, Cout) tensor,
    BF16 when x and emb both are, else f32. Raises as `fused_film_resblock`
    does (an all-f32 call goes there)."""
    out = _launch("bf16", x, emb, (w1, b1, g1s, g1b, w2, b2, g2s, g2b), wskip, bskip, K,
                  groups, film_scale, eps)
    fused_film_resblock_bf16.launches += 1
    return out


fused_film_resblock_bf16.launches = 0


class _FusedFiLMResBlock(torch.autograd.Function):
    """Kernel forward (the route the weights' type names); backward by
    autograd through the plain version, recomputed from the saved inputs
    (ops/vjp.py: the split K1 takes, as the JAX custom VJP of the DiT block
    does). The kernel itself runs on detached inputs, so a U-Net built with
    the fused block trains, in f32 or on a bf16 copy of its weights (a BF16
    input's gradient comes back BF16, for the caller's cast to carry to an
    f32 master); a direct kernel call on an input that needs a gradient
    still raises."""

    @staticmethod
    def forward(ctx, x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip, config):
        ctx.save_for_backward(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip)
        ctx.config = config
        args = [None if t is None else t.detach()
                for t in (x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip)]
        kernel = fused_film_resblock if w1.dtype == torch.float32 else fused_film_resblock_bf16
        return kernel(*args, **config)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(film_resblock_reference, ctx.saved_tensors,
                           ctx.needs_input_grad[:12], g, **ctx.config), None)


def film_resblock_op(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip=None, bskip=None,
                     *, K: int, groups: int, film_scale: bool = False, eps: float = 1e-5):
    """The block as the model calls it: a CPU tensor takes the plain version;
    any other device goes to the kernel (through `_FusedFiLMResBlock`, so it
    differentiates), which launches or raises."""
    config = dict(K=K, groups=groups, film_scale=film_scale, eps=eps)
    args = (x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip)
    if x.device.type == "cpu":
        return film_resblock_reference(*args, **config)
    return _FusedFiLMResBlock.apply(*args, config)

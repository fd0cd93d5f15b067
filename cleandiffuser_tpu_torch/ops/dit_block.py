"""Fused adaLN-Zero DiT block: the Hopper kernel, its wrappers and its plain
PyTorch version.

Counterpart of cleandiffuser_tpu/ops/dit_block.py, whose Pallas TPU kernel
`fused_dit_block` is replaced by the CUDA C++ kernel in
`csrc/dit_block.cu` (built for sm_90a, bound with ctypes; the source note
there says what bounds it on the card and how the design answers that). The
kernel runs the four weight products and attention on the tensor cores, one
thread block per 32 rows of a trajectory: a trajectory of H > 32 rows runs
on a cluster of two blocks, which read each other's keys and values.

    h  = modulate(LN(x), shift1, scale1)
    x  = x + gate1 * MHA(h)
    h2 = modulate(LN(x), shift2, scale2)
    out= x + gate2 * W2 @ gelu(W1 @ h2)

Two routes, each with its wrapper and launch count, chosen by the types
(`_check_kernel_args` admits exactly these three):

- `fused_dit_block`: everything float32; the products in 3xTF32 on
  `mma.sync` (f32-class results).
- `fused_dit_block_bf16`: BF16 weights and biases with float32 x and mod
  (the bf16 sampler's and trainer's call: `DiT1d` keeps the residual
  stream f32) or with BF16 x and mod; the products in BF16 on `mma.sync`,
  f32 accumulation, LN / softmax / GELU / residual in f32.

The output has x's type. The per-trajectory modulation `mod` (B, 6D) =
Dense(silu(t_emb)) is computed outside the kernel, as in the reference.
Weights keep the JAX `(in, out)` orientation, so the kernel reads them as
they are stored: no copy of them is prepared on the host. The kernel takes
H <= 64, d_model a multiple of 32 up to 320 and a head dim a multiple of 8
up to 64.

Dispatch (`dit_block_op`): a CPU tensor takes `dit_block_reference`; a CUDA
tensor launches the route its types name or raises. There is no fallback
from the kernel to the plain version, nor from one route to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.jax_params import flat_from_nested
from .build import load_library
from .vjp import plain_vjp

__all__ = ["fused_dit_block", "fused_dit_block_bf16", "dit_block_op", "dit_block_reference",
           "pack_dit_block_params", "load_dit_block_library"]

_LIB_NAME = "dit_block"


def _layernorm(x, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps)


def dit_block_reference(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads: int = 10):
    """Plain PyTorch version of the kernel's math (test oracle, CPU path).
    Promotes as `jnp` does: every operation here meets x or a product of it,
    so all of it runs in the common type of the inputs. With f32 x and mod
    and BF16 weights that is f32 math on the BF16-rounded weights; with all
    inputs BF16 it is BF16 math. The cast is differentiable: a BF16 input's
    gradient comes back BF16."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in (x, mod, wqkv, bqkv, wo, bo,
                                                                 w1, b1, w2, b2)))
    x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2 = (
        t.to(dt) for t in (x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2))
    B, H, D = x.shape
    hd = D // n_heads
    shift1, scale1, gate1, shift2, scale2, gate2 = mod.chunk(6, dim=-1)

    h = _layernorm(x) * (1 + scale1[:, None]) + shift1[:, None]
    qkv = h @ wqkv + bqkv
    q, k, v = qkv.chunk(3, dim=-1)
    q = q.reshape(B, H, n_heads, hd) * (hd ** -0.5)
    k = k.reshape(B, H, n_heads, hd)
    v = v.reshape(B, H, n_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, H, D)
    x = x + gate1[:, None] * (o @ wo + bo)

    h2 = _layernorm(x) * (1 + scale2[:, None]) + shift2[:, None]
    h2 = F.gelu(h2 @ w1 + b1, approximate="tanh")
    return x + gate2[:, None] * (h2 @ w2 + b2)


def pack_dit_block_params(block_params, d_model: int, n_heads: int):
    """Flatten a flax `DiTBlock` param subtree (nested dicts of numpy arrays)
    into the kernel's weight list [wqkv, bqkv, wo, bo, w1, b1, w2, b2]."""
    flat = flat_from_nested(block_params)
    assert flat["wqkv"].shape == (d_model, 3 * d_model) and d_model % n_heads == 0
    return [torch.as_tensor(np.asarray(flat[k])) for k in
            ("wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2")]


# ---------------------------------------------------------------------------
# The kernel
@functools.lru_cache(maxsize=None)
def load_dit_block_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; set its C types.
    Cached: a launch must not re-read and re-hash the source."""
    lib = load_library(_LIB_NAME)
    vp = ctypes.c_void_p
    lib.dit_block_forward_f32.argtypes = [vp] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float, vp]
    lib.dit_block_forward_f32.restype = ctypes.c_int
    lib.dit_block_forward_bf16.argtypes = [vp] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, vp]
    lib.dit_block_forward_bf16.restype = ctypes.c_int
    lib.dit_block_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dit_block_smem_bytes.restype = ctypes.c_longlong
    lib.device_max_smem_optin.argtypes = [ctypes.c_int]
    lib.device_max_smem_optin.restype = ctypes.c_int
    lib.dit_block_error_string.argtypes = [ctypes.c_int]
    lib.dit_block_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _max_smem_optin(lib, device_index: int) -> int:
    return lib.device_max_smem_optin(device_index)


# (x and mod, weights and biases) -> the route
_ROUTES = {(torch.float32, torch.float32): "f32", (torch.float32, torch.bfloat16): "mixed",
           (torch.bfloat16, torch.bfloat16): "bf16"}


def kernel_route(x, mod, ws) -> str:
    """"f32", "mixed" (f32 x and mod, BF16 weights and biases) or "bf16"
    (all BF16): the three type combinations the kernel takes. Raises
    TypeError on any other."""
    types = {t.dtype for t in (x, mod)}, {t.dtype for t in ws}
    if len(types[0]) == 1 and len(types[1]) == 1:
        route = _ROUTES.get((types[0].pop(), types[1].pop()))
        if route is not None:
            return route
    raise TypeError(
        "fused_dit_block takes all float32, float32 x and mod with bfloat16 weights and "
        f"biases, or all bfloat16; got x {x.dtype}, mod {mod.dtype}, weights "
        f"{[str(t.dtype) for t in ws]}")


def _check_kernel_args(lib, x, mod, ws, n_heads) -> str:
    """Raises on what the kernel does not take; returns the route."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, H, D), got {tuple(x.shape)}")
    B, H, D = x.shape
    if B == 0 or H == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if D % 32 or D > 320 or D % n_heads:
        # 8 warps cover the columns of every product in n8 tiles of up to 5
        # per warp; the k steps of the staged weight tiles are 16 rows deep
        raise ValueError(f"d_model {D} must be a multiple of 32, at most 320, and a "
                         f"multiple of n_heads {n_heads}")
    hd = D // n_heads
    if hd % 8 or hd > 64:
        # attention runs on m16n8k8 MMAs: the head dim is whole k8 steps
        raise ValueError(f"head dim {hd} (d_model {D} / n_heads {n_heads}) must be a "
                         f"multiple of 8, at most 64")
    shapes = {"mod": (B, 6 * D), "wqkv": (D, 3 * D), "bqkv": (3 * D,), "wo": (D, D),
              "bo": (D,), "w1": (D, 4 * D), "b1": (4 * D,), "w2": (4 * D, D), "b2": (D,)}
    for (name, shape), t in zip(shapes.items(), (mod, *ws)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    route = kernel_route(x, mod, ws)
    for name, t in zip(("x",) + tuple(shapes), (x, mod, *ws)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if H > 64:
        # at most two thread blocks of 32 rows; attention holds 8 key tiles
        raise ValueError(f"horizon H={H} must be at most 64")
    smem = lib.dit_block_smem_bytes(D, int(route != "f32"))
    limit = _max_smem_optin(lib, x.device.index)
    if smem > limit:
        raise ValueError(f"d_model {D} needs {smem} bytes of shared memory per "
                         f"thread block; the device allows {limit}")
    return route


def _launch(route_wanted: str, x, mod, ws, n_heads: int):
    if x.device.type != "cuda":
        raise ValueError(f"fused_dit_block runs on CUDA tensors, got {x.device}")
    lib = load_dit_block_library()
    route = _check_kernel_args(lib, x, mod, ws, n_heads)
    if (route == "f32") != (route_wanted == "f32"):
        other = "fused_dit_block_bf16" if route != "f32" else "fused_dit_block"
        raise TypeError(f"{route} inputs go to {other}")
    B, H, D = x.shape
    out = torch.empty_like(x)
    q_scale = (D // n_heads) ** -0.5
    ptrs = (x.data_ptr(), mod.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "f32":
            err = lib.dit_block_forward_f32(*ptrs, B, H, D, n_heads, q_scale, stream)
        else:
            err = lib.dit_block_forward_bf16(*ptrs, B, H, D, n_heads, int(route == "bf16"),
                                             q_scale, stream)
    if err != 0:
        raise RuntimeError(f"dit_block kernel launch failed: "
                           f"{lib.dit_block_error_string(err).decode()} ({err})")
    return out


def fused_dit_block(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads: int = 10):
    """Launch the f32 route on the current stream. x: (B, H, D) f32 CUDA;
    mod: (B, 6D); every input f32. Returns a new (B, H, D) tensor. Raises on
    any input the kernel does not take, and if the launch fails."""
    out = _launch("f32", x, mod, (wqkv, bqkv, wo, bo, w1, b1, w2, b2), n_heads)
    fused_dit_block.launches += 1
    return out


fused_dit_block.launches = 0


def fused_dit_block_bf16(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads: int = 10):
    """Launch the BF16 route on the current stream: BF16 weights and biases,
    x and mod both f32 or both BF16. Returns a new tensor of x's shape and
    type. Raises on any input the kernel does not take (an f32 call goes to
    `fused_dit_block`), and if the launch fails."""
    out = _launch("bf16", x, mod, (wqkv, bqkv, wo, bo, w1, b1, w2, b2), n_heads)
    fused_dit_block_bf16.launches += 1
    return out


fused_dit_block_bf16.launches = 0


class _FusedDiTBlock(torch.autograd.Function):
    """Kernel forward (the route the weights' type names); backward by
    autograd through the plain version, recomputed from the saved inputs
    (ops/vjp.py): the same split as the reference's custom VJP
    (`cleandiffuser_tpu/ops/dit_block.py` `_dit_fwd`/`_dit_bwd`), whose
    backward is XLA code. A BF16 input's gradient comes back BF16 (the
    plain version's cast), for the caller's cast to carry to an f32
    master. The saved tensors
    are the inputs themselves (x, mod and the parameters): an optimizer
    that updates the parameters in place after `backward` leaves this
    step's graph behind it; before `backward`, autograd's version check
    raises."""

    @staticmethod
    def forward(ctx, x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads):
        ctx.save_for_backward(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2)
        ctx.n_heads = n_heads
        kernel = fused_dit_block if wqkv.dtype == torch.float32 else fused_dit_block_bf16
        return kernel(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads=n_heads)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(dit_block_reference, ctx.saved_tensors, ctx.needs_input_grad[:10], g,
                           n_heads=ctx.n_heads), None)


def dit_block_op(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads: int = 10):
    """The block as the model calls it: a CPU tensor takes the plain version;
    any other device goes to the kernel, which launches or raises."""
    if x.device.type == "cpu":
        return dit_block_reference(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2,
                                   n_heads=n_heads)
    return _FusedDiTBlock.apply(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads)

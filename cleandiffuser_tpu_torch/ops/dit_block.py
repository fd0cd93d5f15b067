"""Fused adaLN-Zero DiT block: the Hopper kernel, its wrapper and its plain
PyTorch version.

Counterpart of cleandiffuser_tpu/ops/dit_block.py, whose Pallas TPU kernel
`fused_dit_block` is replaced by the CUDA C++ kernel in
`csrc/dit_block.cu` (built for sm_90a, bound with ctypes; the source note
there says what bounds it on the card and how the design answers that).

    h  = modulate(LN(x), shift1, scale1)
    x  = x + gate1 * MHA(h)
    h2 = modulate(LN(x), shift2, scale2)
    out= x + gate2 * W2 @ gelu(W1 @ h2)

The per-trajectory modulation `mod` (B, 6D) = Dense(silu(t_emb)) is
computed outside the kernel, as in the reference. Weights keep the JAX
`(in, out)` orientation, so the kernel reads them as they are stored.

Dispatch (`dit_block_op`): a CPU tensor takes `dit_block_reference`; a CUDA
tensor launches the kernel, at every shape, or raises. There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.jax_params import flat_from_nested
from .build import load_library

__all__ = ["fused_dit_block", "dit_block_op", "dit_block_reference",
           "pack_dit_block_params", "load_dit_block_library"]

_LIB_NAME = "dit_block"


def _layernorm(x, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps)


def dit_block_reference(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads: int = 10):
    """Plain PyTorch version of the kernel's math (test oracle, CPU path)."""
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


def _check_kernel_args(lib, x, mod, ws, n_heads):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, H, D), got {tuple(x.shape)}")
    B, H, D = x.shape
    if B == 0 or H == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if D % 32 or D > 384 or D % n_heads:
        # one thread per 4 columns in each of 4 row groups: D threads, whole
        # warps, at most 384 of them (the kernel's register budget)
        raise ValueError(f"d_model {D} must be a multiple of 32, at most 384, and a "
                         f"multiple of n_heads {n_heads}")
    shapes = {"mod": (B, 6 * D), "wqkv": (D, 3 * D), "bqkv": (3 * D,), "wo": (D, D),
              "bo": (D,), "w1": (D, 4 * D), "b1": (4 * D,), "w2": (4 * D, D), "b2": (D,)}
    for (name, shape), t in zip(shapes.items(), (mod, *ws)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in zip(("x",) + tuple(shapes), (x, mod, *ws)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_dit_block takes float32 only; {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    smem = lib.dit_block_smem_bytes(H, D)
    limit = _max_smem_optin(lib, x.device.index)
    if smem > limit:
        raise ValueError(f"(H={H}, D={D}) needs {smem} bytes of shared memory per "
                         f"block; the device allows {limit}")


def fused_dit_block(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads: int = 10):
    """Launch the CUDA kernel on the current stream. x: (B, H, D) f32 CUDA;
    mod: (B, 6D). Returns a new (B, H, D) tensor. Raises on any input the
    kernel does not take, and if the launch fails."""
    ws = (wqkv, bqkv, wo, bo, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dit_block runs on CUDA tensors, got {x.device}")
    lib = load_dit_block_library()
    _check_kernel_args(lib, x, mod, ws, n_heads)
    B, H, D = x.shape
    out = torch.empty_like(x)
    q_scale = (D // n_heads) ** -0.5
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dit_block_forward_f32(
            x.data_ptr(), mod.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(),
            B, H, D, n_heads, q_scale, stream)
    if err != 0:
        raise RuntimeError(f"dit_block kernel launch failed: "
                           f"{lib.dit_block_error_string(err).decode()} ({err})")
    fused_dit_block.launches += 1
    return out


fused_dit_block.launches = 0


class _FusedDiTBlock(torch.autograd.Function):
    """Kernel forward, autograd-through-the-plain-version backward (the same
    split as the reference's custom VJP; a backward kernel comes with the
    training path)."""

    @staticmethod
    def forward(ctx, x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads):
        ctx.save_for_backward(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2)
        ctx.n_heads = n_heads
        return fused_dit_block(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads=n_heads)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = dit_block_reference(*inputs, n_heads=ctx.n_heads)
        grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None)


def dit_block_op(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads: int = 10):
    """The block as the model calls it: a CPU tensor takes the plain version;
    any other device goes to the kernel, which launches or raises."""
    if x.device.type == "cpu":
        return dit_block_reference(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2,
                                   n_heads=n_heads)
    return _FusedDiTBlock.apply(x, mod, wqkv, bqkv, wo, bo, w1, b1, w2, b2, n_heads)

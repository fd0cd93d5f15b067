"""The FiLM Conv1d residual block differentiated with respect to x alone:
two Hopper kernels, their wrappers and their plain PyTorch versions.

Classifier guidance differentiates the classifier's half U-Net with respect
to its input at every sampler step; nothing else of the block needs a
gradient there. `csrc/film_resblock_vjp.cu` (a library of its own, built
for sm_90a and bound with ctypes) holds the two kernels of that product:

- `fused_film_resblock_vjp_forward`: the block's forward (the math of
  `film_resblock_reference` in ops/film_resblock.py with the FiLM add),
  which with `residuals=True` also returns what the input gradient needs:
  both GroupNorms' normalised values n1, n2 (B, H, Cout) and their
  per-(sample, group) 1 / sqrt(var + eps) r1, r2 (B, groups).
- `fused_film_resblock_input_grad`: d logp / d x from d logp / d out and
  those residuals: Mish' and GroupNorm's backward at each norm, conv2 and
  conv1 transposed, plus the skip transposed (or the gradient itself where
  there is no skip). The FiLM add passes the gradient through unchanged; no
  gradient is formed for emb or for any weight.

Both run every product in 3xTF32 (`mma.sync` TF32, f32-class accuracy) and
take Cout a multiple of 8 and of groups, Cin and Cout at most 512, K odd, H
dividing a thread block's rows (`film_vjp_block_rows`), in float32; a
shape whose block does not fit the device's shared memory is refused. The
source's note says what bounds them and how their design answers that.

The plain versions, `film_resblock_vjp_forward_reference` and
`film_resblock_input_grad_reference`, are the same closed-form math in
PyTorch: a CPU tensor takes them, and the tests hold them against autograd
through `film_resblock_reference`.

Dispatch (`film_resblock_vjp_op`), chosen from the inputs:

- only x needs a gradient: `_FiLMResBlockVJP`, the forward with residuals
  and, in the backward, the input gradient (kernels on a CUDA tensor, the
  plain versions on a CPU tensor);
- nothing needs one: the forward without residuals;
- emb, a weight, a bias or a norm parameter needs one (the classifier's own
  training): the caller's plain block, `plain()`, differentiated by
  autograd as before. `film_resblock_vjp_op.plain_backward` counts the
  times it was taken while x needed a gradient too.

A CUDA tensor the kernels do not take raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils.embeddings import mish
from .build import load_library

__all__ = ["film_resblock_vjp_forward_reference", "film_resblock_input_grad_reference",
           "fused_film_resblock_vjp_forward", "fused_film_resblock_input_grad",
           "film_resblock_vjp_op", "load_film_resblock_vjp_library"]

_LIB_NAME = "film_resblock_vjp"


# ---------------------------------------------------------------------------
# The plain versions
def _normalise(a, groups: int, eps: float):
    """GroupNorm's normalised values of a (B, H, C) per (sample, group) over
    (H, C/groups), two-pass, and 1 / sqrt(var + eps) (B, groups)."""
    B, H, C = a.shape
    v = a.reshape(B, H, groups, C // groups)
    d = v - v.mean(dim=(1, 3), keepdim=True)
    r = torch.rsqrt((d * d).mean(dim=(1, 3), keepdim=True) + eps)
    return (d * r).reshape(B, H, C), r.reshape(B, groups)


def _conv_same(x, w, b, K: int):
    """SAME conv of x (B, H, Cin) with w (K, Cin, Cout)."""
    return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding=K // 2).transpose(1, 2)


def film_resblock_vjp_forward_reference(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip=None,
                                        bskip=None, *, K: int, groups: int, eps: float = 1e-5,
                                        residuals: bool = True):
    """The kernel's forward in plain PyTorch: (out, (n1, r1, n2, r2)), or
    (out, None) without `residuals`. x (B, H, Cin), emb (B, Cout)."""
    n1, r1 = _normalise(_conv_same(x, w1, b1, K), groups, eps)
    h = mish(n1 * g1s + g1b) + emb[:, None, :]
    n2, r2 = _normalise(_conv_same(h, w2, b2, K), groups, eps)
    out = mish(n2 * g2s + g2b) + (x if wskip is None else x @ wskip + bskip)
    return out, ((n1, r1, n2, r2) if residuals else None)


def _mish_grad(y):
    t = torch.tanh(F.softplus(y))
    return t + y * torch.sigmoid(y) * (1 - t * t)


def _gn_input_grad(d, n, r, groups: int):
    """GroupNorm's backward to its input from the gradient d at its
    normalised values n: r * (d - mean(d) - n * mean(d * n)) per group."""
    B, H, C = d.shape
    dv, nv = d.reshape(B, H, groups, C // groups), n.reshape(B, H, groups, C // groups)
    m1 = dv.mean(dim=(1, 3), keepdim=True)
    m2 = (dv * nv).mean(dim=(1, 3), keepdim=True)
    return (r[:, None, :, None] * (dv - m1 - nv * m2)).reshape(B, H, C)


def _conv_same_transposed(d, w, K: int):
    """The adjoint of `_conv_same` with w (K, Cin, Cout) on d (B, H, Cout):
    (B, H, Cin)."""
    return F.conv_transpose1d(d.transpose(1, 2), w.permute(2, 1, 0),
                              padding=K // 2).transpose(1, 2)


def film_resblock_input_grad_reference(gout, n1, r1, n2, r2, w1, g1s, g1b, w2, g2s, g2b,
                                       wskip=None, *, K: int, groups: int):
    """The kernel's input gradient in plain PyTorch: d logp / d x (B, H, Cin)
    from gout = d logp / d out (B, H, Cout) and the forward's residuals."""
    da2 = _gn_input_grad(gout * _mish_grad(n2 * g2s + g2b) * g2s, n2, r2, groups)
    dh = _conv_same_transposed(da2, w2, K)
    da1 = _gn_input_grad(dh * _mish_grad(n1 * g1s + g1b) * g1s, n1, r1, groups)
    return _conv_same_transposed(da1, w1, K) + (gout if wskip is None else gout @ wskip.T)


# ---------------------------------------------------------------------------
# The kernels
@functools.lru_cache(maxsize=None)
def load_film_resblock_vjp_library() -> ctypes.CDLL:
    """Build (at first use) and load the library; set its C types. Cached:
    a launch must not re-read and re-hash the source."""
    lib = load_library(_LIB_NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.film_vjp_forward_f32.argtypes = [vp] * 17 + [ci] * 6 + [ctypes.c_float, vp]
    lib.film_vjp_forward_f32.restype = ci
    lib.film_vjp_input_grad_f32.argtypes = [vp] * 13 + [ci] * 6 + [vp]
    lib.film_vjp_input_grad_f32.restype = ci
    lib.film_vjp_block_rows.argtypes = [ci] * 3
    lib.film_vjp_block_rows.restype = ci
    lib.film_vjp_smem_bytes.argtypes = [ci] * 7
    lib.film_vjp_smem_bytes.restype = ctypes.c_longlong
    lib.film_vjp_max_smem_optin.argtypes = [ci]
    lib.film_vjp_max_smem_optin.restype = ci
    lib.film_vjp_error_string.argtypes = [ci]
    lib.film_vjp_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _max_smem_optin(device_index: int) -> int:
    return load_film_resblock_vjp_library().film_vjp_max_smem_optin(device_index)


def _check(backward: bool, named: dict, B: int, H: int, Cin: int, Cout: int, K: int,
           groups: int):
    """Raises on what the kernel does not take; `named` maps each tensor
    argument (None for an absent skip) to (tensor, shape)."""
    kernel = "input gradient" if backward else "forward"
    if B == 0 or H == 0:
        raise ValueError(f"empty input ({B}, {H}, {Cin})")
    if K % 2 == 0:
        raise ValueError(f"K={K}: the kernels take an odd number of taps (SAME padding)")
    if Cout % 8 or Cout > 512 or Cout % groups or Cin > 512:
        raise ValueError(f"Cout {Cout} must be a multiple of 8 (the MMA's n) and of groups "
                         f"{groups}, and Cin {Cin} and Cout at most 512 (a thread block holds "
                         "every channel)")
    device = named["x" if "x" in named else "gout"][0].device
    if device.type != "cuda":
        raise ValueError(f"the film_resblock_vjp {kernel} runs on CUDA tensors, got {device}")
    for name, (t, shape) in named.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"the film_resblock_vjp kernels take float32; {name} is {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t, _ in named.values()):
        raise RuntimeError(f"the film_resblock_vjp {kernel} forms no gradient of its own inputs: "
                           "call it under torch.no_grad(), or through film_resblock_vjp_op")
    lib = load_film_resblock_vjp_library()
    rows = lib.film_vjp_block_rows(int(backward), Cin, Cout)
    if rows % H:
        raise ValueError(f"H={H} must divide the {rows} output rows of a thread block of the "
                         f"{kernel} at (Cin={Cin}, Cout={Cout}): a block owns whole samples")
    smem = lib.film_vjp_smem_bytes(int(backward), B, H, Cin, Cout, K, groups)
    if smem < 0:
        raise ValueError(f"the {kernel} kernel does not take (H={H}, Cin={Cin}, Cout={Cout}, "
                         f"K={K}, groups={groups})")
    limit = _max_smem_optin(device.index)
    if smem > limit:
        raise ValueError(f"(H={H}, Cin={Cin}, Cout={Cout}) needs {smem} bytes of shared memory "
                         f"per block of the {kernel}; the device allows {limit}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err: int):
    if err != 0:
        message = load_film_resblock_vjp_library().film_vjp_error_string(err).decode()
        raise RuntimeError(f"film_resblock_vjp kernel launch failed: {message} ({err})")


def fused_film_resblock_vjp_forward(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip=None,
                                    bskip=None, *, K: int, groups: int, eps: float = 1e-5,
                                    residuals: bool = True):
    """Launch the forward on the current stream: (out, (n1, r1, n2, r2)), or
    (out, None) without `residuals`. Raises on any input the kernel does
    not take, if an input needs a gradient, and if the launch fails."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, H, Cin), got {tuple(x.shape)}")
    B, H, Cin = x.shape
    Cout = w1.shape[-1]
    if (wskip is None) != (bskip is None):
        raise ValueError("wskip and bskip come together")
    if wskip is None and Cin != Cout:
        raise ValueError(f"without a skip conv Cin ({Cin}) must equal Cout ({Cout})")
    vec = (Cout,)
    _check(False, {"x": (x, (B, H, Cin)), "emb": (emb, (B, Cout)), "w1": (w1, (K, Cin, Cout)),
                   "b1": (b1, vec), "g1s": (g1s, vec), "g1b": (g1b, vec),
                   "w2": (w2, (K, Cout, Cout)), "b2": (b2, vec), "g2s": (g2s, vec),
                   "g2b": (g2b, vec), "wskip": (wskip, (Cin, Cout)), "bskip": (bskip, vec)},
           B, H, Cin, Cout, K, groups)
    new = lambda *shape: torch.empty(shape, device=x.device, dtype=torch.float32)
    out = new(B, H, Cout)
    res = (new(B, H, Cout), new(B, groups), new(B, H, Cout), new(B, groups)) if residuals else None
    with torch.cuda.device(x.device):
        err = load_film_resblock_vjp_library().film_vjp_forward_f32(
            *map(_ptr, (x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip, out)),
            *(map(_ptr, res) if residuals else (None,) * 4), B, H, Cin, Cout, K, groups, eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err)
    fused_film_resblock_vjp_forward.launches += 1
    return out, res


fused_film_resblock_vjp_forward.launches = 0


def fused_film_resblock_input_grad(gout, n1, r1, n2, r2, w1, g1s, g1b, w2, g2s, g2b,
                                   wskip=None, *, K: int, groups: int):
    """Launch the input gradient on the current stream: d logp / d x
    (B, H, Cin), a new tensor. Raises as the forward does."""
    if gout.dim() != 3:
        raise ValueError(f"gout must be (B, H, Cout), got {tuple(gout.shape)}")
    B, H, Cout = gout.shape
    Cin = w1.shape[1]
    if wskip is None and Cin != Cout:
        raise ValueError(f"without a skip conv Cin ({Cin}) must equal Cout ({Cout})")
    vec, act, stat = (Cout,), (B, H, Cout), (B, groups)
    _check(True, {"gout": (gout, act), "n1": (n1, act), "r1": (r1, stat), "n2": (n2, act),
                  "r2": (r2, stat), "w1": (w1, (K, Cin, Cout)), "g1s": (g1s, vec),
                  "g1b": (g1b, vec), "w2": (w2, (K, Cout, Cout)), "g2s": (g2s, vec),
                  "g2b": (g2b, vec), "wskip": (wskip, (Cin, Cout))},
           B, H, Cin, Cout, K, groups)
    dx = torch.empty((B, H, Cin), device=gout.device, dtype=torch.float32)
    with torch.cuda.device(gout.device):
        err = load_film_resblock_vjp_library().film_vjp_input_grad_f32(
            *map(_ptr, (gout, n1, r1, n2, r2, w1, g1s, g1b, w2, g2s, g2b, wskip, dx)),
            B, H, Cin, Cout, K, groups, torch.cuda.current_stream(gout.device).cuda_stream)
    _raise_on(err)
    fused_film_resblock_input_grad.launches += 1
    return dx


fused_film_resblock_input_grad.launches = 0


# ---------------------------------------------------------------------------
# Dispatch
class _FiLMResBlockVJP(torch.autograd.Function):
    """Only x needs a gradient: the forward keeps its residuals, the
    backward is the input gradient (the kernels on a CUDA tensor, the
    plain versions on a CPU tensor), and every other input gets None."""

    @staticmethod
    def forward(ctx, x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip, config):
        forward = (film_resblock_vjp_forward_reference if x.device.type == "cpu"
                   else fused_film_resblock_vjp_forward)
        out, res = forward(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip,
                           residuals=True, **config)
        ctx.save_for_backward(*res, w1, g1s, g1b, w2, g2s, g2b, wskip)
        ctx.config = config
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        grad = (film_resblock_input_grad_reference if gout.device.type == "cpu"
                else fused_film_resblock_input_grad)
        dx = grad(gout.contiguous(), *ctx.saved_tensors, K=ctx.config["K"],
                  groups=ctx.config["groups"])
        return (dx,) + (None,) * 12


def film_resblock_vjp_op(x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip=None, bskip=None,
                         *, K: int, groups: int, eps: float = 1e-5, plain):
    """The block as the classifier calls it, its path chosen from which
    inputs need a gradient (module note); `plain` is the caller's plain
    block, a callable of no arguments."""
    args = (x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip)
    config = dict(K=K, groups=groups, eps=eps)
    grad = torch.is_grad_enabled()
    if grad and any(t is not None and t.requires_grad for t in args[1:]):
        if x.requires_grad:
            film_resblock_vjp_op.plain_backward += 1
        return plain()
    if grad and x.requires_grad:
        return _FiLMResBlockVJP.apply(*args, config)
    forward = (film_resblock_vjp_forward_reference if x.device.type == "cpu"
               else fused_film_resblock_vjp_forward)
    return forward(*args, residuals=False, **config)[0]


film_resblock_vjp_op.plain_backward = 0

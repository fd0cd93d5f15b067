"""The algorithm's operations and bytes, from shapes alone.

Operations count 2 per multiply-add, once, whatever implements them (K1's
and K3's 3xTF32 products triple their own work, which is not counted);
elementwise work, norms and softmax are left out. Bytes count each input of
a launch read once and each output written once, in float32. A roofline
bound is the larger of the operations over the peak rate and the bytes over
the peak bandwidth (`peaks.json`).
"""

from __future__ import annotations

import json
from pathlib import Path

F32 = 4
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def dense(rows: int, n_in: int, n_out: int) -> int:
    return 2 * rows * n_in * n_out


def conv1d(batch: int, length_out: int, k: int, c_in: int, c_out: int) -> int:
    return 2 * batch * length_out * k * c_in * c_out


def conv_transpose1d(batch: int, length_in: int, k: int, c_in: int, c_out: int) -> int:
    return 2 * batch * length_in * k * c_in * c_out


def dit_block(B: int, H: int, D: int, n_heads: int):
    """K1, the fused adaLN-Zero DiT block, on x (B, H, D): (operations,
    bytes). The products qkv, out, and the MLP's two, then attention's two
    batched products; reads x, mod (B, 6D), the weights and biases, writes
    the output."""
    rows, hd = B * H, D // n_heads
    ops = dense(rows, D, 3 * D) + dense(rows, D, D) + dense(rows, D, 4 * D) + dense(rows, 4 * D, D)
    ops += 2 * (2 * B * n_heads * H * H * hd)
    weights = 3 * D * D + D * D + 4 * D * D + 4 * D * D + 3 * D + D + 4 * D + D
    return ops, F32 * (2 * rows * D + B * 6 * D + weights)


def film_resblock(B: int, H: int, c_in: int, c_out: int, k: int):
    """K3, the fused FiLM residual block, on x (B, H, c_in): (operations,
    bytes). Two "same" convs of k taps, and the 1x1 skip where the widths
    differ; reads x, the FiLM embedding (B, c_out), the convs, norms and
    skip, writes the output."""
    skip = c_in != c_out
    ops = conv1d(B, H, k, c_in, c_out) + conv1d(B, H, k, c_out, c_out)
    ops += conv1d(B, H, 1, c_in, c_out) if skip else 0
    weights = k * c_in * c_out + k * c_out * c_out + 6 * c_out
    weights += c_in * c_out + c_out if skip else 0
    return ops, F32 * (B * H * c_in + B * c_out + weights + B * H * c_out)


def film_vjp_forward(B: int, H: int, c_in: int, c_out: int, k: int, groups: int,
                     residuals: bool = True):
    """The classifier VJP pair's forward, the FiLM residual block of
    `film_resblock` (same operations, reads and output): (operations,
    bytes). With `residuals` it also writes what the input gradient reads:
    both GroupNorms' normalised values n1, n2 (B, H, c_out) and their
    1 / sqrt(var + eps) r1, r2 (B, groups)."""
    ops, nbytes = film_resblock(B, H, c_in, c_out, k)
    kept = 2 * B * H * c_out + 2 * B * groups if residuals else 0
    return ops, nbytes + F32 * kept


def film_vjp_input_grad(B: int, H: int, c_in: int, c_out: int, k: int, groups: int):
    """The pair's input gradient, d/dx of the block: (operations, bytes).
    The adjoints of the two convs and the skip, the forward's
    multiply-adds again; reads the gradient at the output (B, H, c_out),
    n1, n2, r1, r2, both convs, the norms' scales and shifts and the skip's
    kernel, writes dx (B, H, c_in)."""
    skip = c_in != c_out
    ops = film_resblock(B, H, c_in, c_out, k)[0]
    weights = k * c_in * c_out + k * c_out * c_out + 4 * c_out
    weights += c_in * c_out if skip else 0
    reads = 3 * B * H * c_out + 2 * B * groups + weights
    return ops, F32 * (reads + B * H * c_in)


def peaks(device_kind: str):
    """The peak table's entry for a device name, or None for a device the
    table does not hold."""
    table = json.loads(PEAKS.read_text())
    return table.get(device_kind)


def bound_s(ops: float, nbytes: float, peak_ops: float, peak_bytes: float) -> float:
    return max(ops / peak_ops, nbytes / peak_bytes)


def roofline_pct(ctx, kernel: str):
    """A kernel's roofline share in a traced window: the bound of the
    launches it ran (the family's launch shapes, one cycle of them in call
    order, times the cycles run) over their device time; None where the
    cell runs no such kernel."""
    entry = ctx.work["kernels"].get(kernel)
    if entry is None or ctx.peaks is None:
        return None
    launches, seconds = ctx.trace.kernel_time_s(entry["match"])
    if launches == 0:
        return None
    peak_ops, peak_bytes = ctx.peaks[ctx.config["peak"]], ctx.peaks["bytes_per_s"]
    cycle = entry["launches"]
    bound = sum(bound_s(ops, nbytes, peak_ops, peak_bytes) for ops, nbytes in cycle)
    return 100.0 * bound * launches / len(cycle) / seconds

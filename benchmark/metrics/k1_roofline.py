"""k1_roofline: K1's (the fused DiT block's) roofline share in the traced
window: its launches' bound (the algorithm's operations over the TF32 peak
or its bytes over the bandwidth, whichever is larger) over their device
time. Nothing to read where the cell runs no K1."""

from benchmark import work


def read(ctx):
    return work.roofline_pct(ctx, "k1")

"""k3_roofline: K3's (the fused FiLM residual block's) roofline share in the
traced window, over the U-Net's launch shapes in call order. Nothing to
read where the cell runs no K3."""

from benchmark import work


def read(ctx):
    return work.roofline_pct(ctx, "k3")

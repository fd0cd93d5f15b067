"""vjp_roofline: the classifier VJP pair's (`film_vjp_forward` and
`film_vjp_input_grad`) roofline share in the traced window, over a plan's
launch shapes in call order. Nothing to read where the cell runs neither."""

from benchmark import work


def read(ctx):
    return work.roofline_pct(ctx, "vjp")

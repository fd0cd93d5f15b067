"""The backward of the port's fused forward blocks (K1 and K3): autograd
through their plain versions, recomputed from the saved inputs. The JAX
package's custom VJP of its fused DiT block does the same (`jax.vjp` of the
XLA reference); no TPU kernel has a backward kernel. The one backward
kernel of the port is the classifier's input gradient
(ops/film_resblock_vjp.py), which needs no weight's gradient."""

from __future__ import annotations

import torch

__all__ = ["plain_vjp"]


def plain_vjp(reference, saved, needs, g, **kwargs):
    """Gradients of `reference(*saved, **kwargs)` against cotangent `g`, one
    per entry of `saved`: None where `needs` is False (or the entry is
    None), else the plain version's gradient."""
    inputs = [None if t is None else t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
    wanted = [t for t, n in zip(inputs, needs) if n]
    with torch.enable_grad():
        out = reference(*inputs, **kwargs)
    grads = iter(torch.autograd.grad(out, wanted, g))
    return [next(grads) if n else None for n in needs]

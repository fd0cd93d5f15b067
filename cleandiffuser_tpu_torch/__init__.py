"""cleandiffuser_tpu_torch — the PyTorch / CUDA port of cleandiffuser_tpu.

The JAX package `cleandiffuser_tpu` is the reference; this package mirrors
its sub-package and module names so each part has an obvious counterpart.
It imports torch and numpy only. Every Pallas kernel of the reference that
the port runs becomes a hand-written kernel for NVIDIA Hopper (`csrc/`),
with a plain PyTorch version of the same math beside it in `ops/`.

Ported so far: Decision Diffuser planning (`pipelines/dd.py`), i.e. the
DiT1d backbone with the fused adaLN-Zero block kernel, the MLP condition,
the MLP inverse dynamics, and the continuous VP-SDE sampler.
"""

__version__ = "0.1.0"

"""cleandiffuser_tpu_torch — the PyTorch / CUDA port of cleandiffuser_tpu.

The JAX package `cleandiffuser_tpu` is the reference; this package mirrors
its sub-package and module names so each part has an obvious counterpart.
It imports torch and numpy only. Every Pallas kernel of the reference that
the port runs becomes a hand-written kernel for NVIDIA Hopper (`csrc/`),
with a plain PyTorch version of the same math beside it in `ops/`.

Ported so far:
- Decision Diffuser planning (`pipelines/dd.py`): the DiT1d backbone with
  the fused adaLN-Zero block kernel, the MLP condition, the MLP inverse
  dynamics, and the continuous VP-SDE sampler.
- Diffuser planning (`pipelines/diffuser.py`): the Janner U-Net with the
  fused FiLM residual-block kernel, the half-U-Net classifier for guidance,
  and the discrete VP-SDE sampler, whose ddpm step can run the fused
  solver-update kernel.
- The training of both, the D4RL-MuJoCo datasets and the Goal2D task, and
  their command-line entry points (`cli/`): the windowed trainer and the
  training and evaluation loops of `pipelines/runner.py`.
- Then the diffusion policies, the planners of the D4RL suites and their
  CLIs (ROADMAP.md lists them), and Diffusion Policy and DiffusionBC on
  PushT (the env and its MPC expert batched on the device) and Kitchen.
"""

__version__ = "0.1.0"

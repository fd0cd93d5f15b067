"""The config keys that set up a run's devices and precision (counterpart of
cleandiffuser_tpu/parallel/integrate.py).

    setup_mesh(args)   # None: one device

Every CLI of the reference passes its config through `setup_mesh` before
its first device use. Ported so far: one device, and the two precision keys
the reference reads there:

    bf16_sampling: true   samplers cast their params once per call and run
                          the network forward in bf16; solver math stays f32
    bf16_training: true   the network forward and backward in bf16; loss,
                          master weights, optimizer state and EMA stay f32

Each sets the class attribute on `DiffusionModel` (as the reference does;
a key left out or false leaves the flag as it was), so it reaches every
engine. `n_devices > 1` raises: the multi-device path is ROADMAP queue 1,
item 10.
"""

from __future__ import annotations

from typing import Optional

from ..diffusion.basic import DiffusionModel

__all__ = ["setup_mesh"]


def setup_mesh(args=None, n_devices: Optional[int] = None):
    """Apply the config's device and precision keys. Returns None (no mesh:
    one device)."""
    if args is not None:
        if n_devices is None:
            n_devices = int(args.get("n_devices", 1) or 1)
        if bool(args.get("bf16_sampling", False)):
            DiffusionModel.bf16_sampling = True
        if bool(args.get("bf16_training", False)):
            DiffusionModel.bf16_training = True
    if (n_devices or 1) > 1:
        raise NotImplementedError(
            f"n_devices={n_devices}: the multi-device path is not ported yet "
            "(ROADMAP queue 1, item 10)")
    return None

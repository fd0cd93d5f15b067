"""Dataset acquisition for the pipelines (counterpart of
cleandiffuser_tpu/pipelines/data_loading.py; the PushT demos, the
gymnasium eval envs and the d4rl score ranges come with their slices).

Nothing is downloaded. The resolution order is:

1. a local .npz snapshot at `$CLEANDIFFUSER_DATA/<env_name>[.qlearning].npz`
   (default directory `dev/d4rl`) with the d4rl key schema;
2. the synthetic generator (dataset/fake.py), with a printed warning.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import numpy as np

from ..dataset.fake import fake_d4rl_dataset, fake_d4rl_qlearning_dataset

__all__ = ["load_d4rl_dataset", "load_d4rl_qlearning_dataset", "data_dir"]

def data_dir() -> Path:
    """Where snapshots are looked for: `$CLEANDIFFUSER_DATA`, else dev/d4rl."""
    return Path(os.environ.get("CLEANDIFFUSER_DATA", "dev/d4rl"))


def _try_npz(path: Path):
    if path.exists():
        arrs = np.load(path)
        return {k: arrs[k] for k in arrs.files}
    return None


def load_d4rl_dataset(env_name: str) -> Dict[str, np.ndarray]:
    """`env.get_dataset()`'s dict: the snapshot, else synthetic data."""
    path = data_dir() / f"{env_name}.npz"
    data = _try_npz(path)
    if data is not None:
        return data
    print(f"[data] no snapshot at {path}; using SYNTHETIC data (hermetic mode)")
    return fake_d4rl_dataset(env_name, n_steps=100_000, ep_len=1000)


def load_d4rl_qlearning_dataset(env_name: str) -> Dict[str, np.ndarray]:
    """`d4rl.qlearning_dataset(env)`'s dict: the snapshot, else synthetic."""
    path = data_dir() / f"{env_name}.qlearning.npz"
    data = _try_npz(path)
    if data is not None:
        return data
    print(f"[data] no snapshot at {path}; using SYNTHETIC data (hermetic mode)")
    return fake_d4rl_qlearning_dataset(env_name, n_steps=100_000, ep_len=1000)

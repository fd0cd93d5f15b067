"""Kitchen imitation datasets over relay-policy-learning demos (counterpart
of cleandiffuser_tpu/dataset/kitchen.py): `KitchenDataset`,
`KitchenDatasetV2` and `KitchenMjlDataset`.

The same windows, min-max normalisers and device gather as the PushT
family (dataset/pusht.py). Sources: a directory of the .npy archive
(`observations_seq.npy`, `actions_seq.npy`, `existence_mask.npy`) or a
`ReplayBuffer`; `KitchenMjlDataset` parses the raw MuJoCo .mjl logs
(dataset/mjl.py) under `<dir>/*/*.mjl`.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..utils.normalizers import DatasetMinMaxNormalizer
from .pusht import _normalized, _PushTBase
from .replay_buffer import ReplayBuffer

__all__ = ["KitchenDataset", "KitchenDatasetV2", "KitchenMjlDataset"]


def _load_kitchen_buffer(dataset_dir) -> ReplayBuffer:
    if isinstance(dataset_dir, ReplayBuffer):
        return dataset_dir
    d = pathlib.Path(dataset_dir)
    observations = np.load(d / "observations_seq.npy")
    actions = np.load(d / "actions_seq.npy")
    masks = np.load(d / "existence_mask.npy")
    rb = ReplayBuffer.create_empty_numpy()
    for i in range(len(masks)):
        n = int(masks[i].sum())
        rb.add_episode({"state": observations[i, :n].astype(np.float32),
                        "action": actions[i, :n].astype(np.float32)})
    return rb


class KitchenDataset(_PushTBase):
    """State / action windows over relay-policy-learning episodes."""

    obs_keys = ("state", "action")

    def __init__(self, dataset_dir, horizon: int = 1, pad_before: int = 0, pad_after: int = 0,
                 abs_action: bool = False, device=None):
        super().__init__(_load_kitchen_buffer(dataset_dir), obs_keys=["state", "action"],
                         horizon=horizon, pad_before=pad_before, pad_after=pad_after,
                         device=device)

    def get_normalizer(self):
        return {"obs": {"state": DatasetMinMaxNormalizer(self.replay_buffer["state"][:])},
                "action": DatasetMinMaxNormalizer(self.replay_buffer["action"][:])}

    def _device_arrays(self):
        return {"state": _normalized(self.normalizer["obs"]["state"], self.replay_buffer["state"]),
                "action": _normalized(self.normalizer["action"], self.replay_buffer["action"])}

    def __getitem__(self, idx):
        sample = self.sampler.sample_sequence(idx)
        return {"obs": {"state": _normalized(self.normalizer["obs"]["state"], sample["state"])},
                "action": _normalized(self.normalizer["action"], sample["action"])}


class KitchenDatasetV2(KitchenDataset):
    """The data normalised once at load time instead of per sample; the
    buffer holds the normalised arrays."""

    def __init__(self, dataset_dir, horizon: int = 1, pad_before: int = 0, pad_after: int = 0,
                 abs_action: bool = False, device=None):
        rb = _load_kitchen_buffer(dataset_dir)
        state_norm = DatasetMinMaxNormalizer(rb["state"][:])
        action_norm = DatasetMinMaxNormalizer(rb["action"][:])
        self._prebuilt_normalizer = {"obs": {"state": state_norm}, "action": action_norm}
        normed = ReplayBuffer.create_from_data(
            {"state": _normalized(state_norm, rb["state"]),
             "action": _normalized(action_norm, rb["action"])}, rb.episode_ends)
        _PushTBase.__init__(self, normed, obs_keys=["state", "action"], horizon=horizon,
                            pad_before=pad_before, pad_after=pad_after, device=device)

    def get_normalizer(self):
        return self._prebuilt_normalizer

    def _device_arrays(self):
        return {"state": self.replay_buffer["state"].astype(np.float32),
                "action": self.replay_buffer["action"].astype(np.float32)}

    def __getitem__(self, idx):
        sample = self.sampler.sample_sequence(idx)
        return {"obs": {"state": sample["state"].astype(np.float32)},
                "action": sample["action"].astype(np.float32)}


class KitchenMjlDataset(KitchenDataset):
    """Kitchen demos parsed from raw MuJoCo .mjl logs: obs = [robot qpos 9
    | object qpos 21 | zero goal 30], with uniform observation noise on the
    first 30 dims (`robot_noise_ratio` times per-dim amplitudes, numpy
    seed 42), action = the raw ctrl (the absolute-action layout); every
    `skip`-th record. Unparseable logs are skipped with a message."""

    _NOISE_AMP = np.array([0.1] * 9 + [0.005] * 2 + [0.0005] * 6 + [0.005] * 3
                          + [0.1] * 3 + [0.005] * 3 + [0.1] * 3 + [0.005], dtype=np.float32)

    def __init__(self, dataset_dir, horizon: int = 1, pad_before: int = 0, pad_after: int = 0,
                 abs_action: bool = True, robot_noise_ratio: float = 0.1, skip: int = 40,
                 device=None):
        from .mjl import parse_mjl_log

        rng = np.random.default_rng(seed=42)
        rb = ReplayBuffer.create_empty_numpy()
        root = pathlib.Path(dataset_dir)
        for p in sorted(root.glob("*/*.mjl")) if root.exists() else []:
            try:
                log = parse_mjl_log(str(p), skip=skip)
                qpos = log["qpos"].astype(np.float32)
                obs = np.concatenate([qpos[:, :9], qpos[:, -21:],
                                      np.zeros((len(qpos), 30), np.float32)], axis=-1)
                if robot_noise_ratio > 0:
                    obs[:, :30] += robot_noise_ratio * self._NOISE_AMP * rng.uniform(
                        -1.0, 1.0, size=(obs.shape[0], 30))
                rb.add_episode({"state": obs, "action": log["ctrl"].astype(np.float32)})
            except Exception as e:  # a corrupt log is skipped, as the reference does
                print(f"[KitchenMjlDataset] skipping {p}: {e}")
        if rb.n_episodes == 0:
            raise FileNotFoundError(f"no parseable .mjl logs under {dataset_dir} (expected the "
                                    "relay-policy-learning kitchen_demos_multitask layout)")
        _PushTBase.__init__(self, rb, obs_keys=["state", "action"], horizon=horizon,
                            pad_before=pad_before, pad_after=pad_after, device=device)

"""BlockPush dataset (counterpart of cleandiffuser_tpu/dataset/block_push.py):
block-push demos (a zarr path, an .npz archive or a `ReplayBuffer`, e.g.
the oracle demos of env/block_pushing.py) as windows of the 16-dim "obs"
and the 2-dim "action", each min-max normalised to [-1, 1]. The PushT
datasets' base (dataset/pusht.py) serves them: `__getitem__` on the host,
`sample_batch(generator, batch_size)` as one gather on the device. No
pipeline uses it.
"""

from __future__ import annotations

from ..utils.normalizers import DatasetMinMaxNormalizer
from .pusht import _normalized, _PushTBase

__all__ = ["BlockPushDataset"]


class BlockPushDataset(_PushTBase):
    obs_keys = ("obs", "action")

    def get_normalizer(self):
        return {"obs": {"state": DatasetMinMaxNormalizer(self.replay_buffer["obs"][:])},
                "action": DatasetMinMaxNormalizer(self.replay_buffer["action"][:])}

    def _device_arrays(self):
        return {"state": _normalized(self.normalizer["obs"]["state"], self.replay_buffer["obs"]),
                "action": _normalized(self.normalizer["action"], self.replay_buffer["action"])}

    def __getitem__(self, idx):
        sample = self.sampler.sample_sequence(idx)
        return {"obs": {"state": _normalized(self.normalizer["obs"]["state"], sample["obs"])},
                "action": _normalized(self.normalizer["action"], sample["action"])}

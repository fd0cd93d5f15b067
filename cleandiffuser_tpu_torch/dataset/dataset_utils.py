"""Sequence windowing (counterpart of the windowing half of
cleandiffuser_tpu/dataset/dataset_utils.py; its rotation transforms come
with the imitation datasets).

- `create_indices`: vectorized numpy, the same indices as the reference's
  numpy path and its native helper (`_native/indexing.c`, host C that the
  port does not need: the indices are built once per dataset).
- `SequenceSampler`: windowed sequence access with edge-replication (or
  zero) padding over an episodic buffer: anything with `episode_ends`,
  `keys()` and `buffer[key]` (the reference's ReplayBuffer).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["create_indices", "SequenceSampler"]


def create_indices(episode_ends: np.ndarray, sequence_length: int, pad_before: int = 0,
                   pad_after: int = 0, debug: bool = True) -> np.ndarray:
    """(N, 4) [buffer_start, buffer_end, sample_start, sample_end]; `debug`
    checks the offsets."""
    pad_before = min(max(pad_before, 0), sequence_length - 1)
    pad_after = min(max(pad_after, 0), sequence_length - 1)

    out = []
    starts = np.concatenate([[0], episode_ends[:-1]])
    for start_idx, end_idx in zip(starts, episode_ends):
        ep_len = end_idx - start_idx
        idx = np.arange(-pad_before, ep_len - sequence_length + pad_after + 1)
        buffer_start = np.maximum(idx, 0) + start_idx
        buffer_end = np.minimum(idx + sequence_length, ep_len) + start_idx
        start_offset = buffer_start - (idx + start_idx)
        end_offset = (idx + sequence_length + start_idx) - buffer_end
        sample_start = start_offset
        sample_end = sequence_length - end_offset
        if debug:
            assert np.all(start_offset >= 0) and np.all(end_offset >= 0)
            assert np.all((sample_end - sample_start) == (buffer_end - buffer_start))
        out.append(np.stack([buffer_start, buffer_end, sample_start, sample_end], -1))
    return np.concatenate(out, 0) if out else np.zeros((0, 4), np.int64)


class SequenceSampler:
    """Windowed sampler with replication (or zero) padding."""

    def __init__(self, replay_buffer, sequence_length: int, pad_before: int = 0,
                 pad_after: int = 0, keys: Optional[Sequence[str]] = None,
                 key_first_k: Optional[Dict[str, int]] = None, zero_padding: bool = False):
        assert sequence_length >= 1
        self.keys = list(keys) if keys is not None else list(replay_buffer.keys())
        self.indices = create_indices(replay_buffer.episode_ends, sequence_length, pad_before,
                                      pad_after)
        self.sequence_length = sequence_length
        self.replay_buffer = replay_buffer
        self.zero_padding = zero_padding
        self.key_first_k = key_first_k or {}

    def __len__(self):
        return len(self.indices)

    def sample_sequence(self, idx: int) -> Dict[str, np.ndarray]:
        b_start, b_end, s_start, s_end = self.indices[idx]
        result = {}
        for key in self.keys:
            arr = self.replay_buffer[key]
            if key in self.key_first_k:
                n_data = b_end - b_start
                k_data = min(self.key_first_k[key], n_data)
                sample = np.full((n_data,) + arr.shape[1:], np.nan, arr.dtype)
                sample[:k_data] = arr[b_start: b_start + k_data]
            else:
                sample = arr[b_start:b_end]
            data = sample
            if s_start > 0 or s_end < self.sequence_length:
                data = np.zeros((self.sequence_length,) + arr.shape[1:], arr.dtype)
                if not self.zero_padding:
                    if s_start > 0:
                        data[:s_start] = sample[0]
                    if s_end < self.sequence_length:
                        data[s_end:] = sample[-1]
                data[s_start:s_end] = sample
            result[key] = data
        return result

"""Sequence windowing and rotation transforms (counterpart of
cleandiffuser_tpu/dataset/dataset_utils.py).

- `create_indices`: vectorized numpy, the same indices as the reference's
  numpy path and its native helper (`_native/indexing.c`, host C that the
  port does not need: the indices are built once per dataset).
- `SequenceSampler`: windowed sequence access with edge-replication (or
  zero) padding over an episodic buffer: anything with `episode_ends`,
  `keys()` and `buffer[key]` (the reference's ReplayBuffer).
- `RotationTransformer`: axis_angle / euler_angles (XYZ) / quaternion /
  rotation_6d / matrix conversions in numpy through the rotation matrix,
  the reference's own numpy code (robomimic's `abs_action` turns
  axis-angle actions into rotation_6d with it).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["create_indices", "SequenceSampler", "RotationTransformer"]


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


# ---------------------------------------------------------------------------
# Rotation conversions (numpy, matrix as intermediate representation)
# ---------------------------------------------------------------------------
def axis_angle_to_matrix(a: np.ndarray) -> np.ndarray:
    """Rodrigues' formula; a: (..., 3)."""
    theta = np.linalg.norm(a, axis=-1, keepdims=True)
    small = theta[..., 0] < 1e-8
    k = np.where(theta > 1e-8, a / np.maximum(theta, 1e-30), 0.0)
    K = np.zeros(a.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    st = np.sin(theta)[..., None]
    ct = np.cos(theta)[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    R = eye + st * K + (1 - ct) * (K @ K)
    return np.where(small[..., None, None], eye, R)


def matrix_to_axis_angle(R: np.ndarray) -> np.ndarray:
    return quaternion_to_axis_angle(matrix_to_quaternion(R))


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """q = (w, x, y, z), (..., 4)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack(
        [
            1 - 2 * (y**2 + z**2), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x**2 + z**2), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x**2 + y**2),
        ],
        -1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Shepperd's method, vectorized; returns (w, x, y, z)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return np.sqrt(np.maximum(x, 0.0))

    q_by_tr = np.stack(
        [safe_sqrt(1 + tr), m21 - m12, m02 - m20, m10 - m01], -1
    )
    q_by_x = np.stack(
        [m21 - m12, safe_sqrt(1 + m00 - m11 - m22), m01 + m10, m02 + m20], -1
    )
    q_by_y = np.stack(
        [m02 - m20, m01 + m10, safe_sqrt(1 - m00 + m11 - m22), m12 + m21], -1
    )
    q_by_z = np.stack(
        [m10 - m01, m02 + m20, m12 + m21, safe_sqrt(1 - m00 - m11 + m22)], -1
    )
    # choose the most numerically stable decomposition per element
    choice = np.argmax(np.stack([tr, m00, m11, m22], -1), -1)[..., None]
    q = np.select(
        [choice == 0, choice == 1, choice == 2, choice == 3],
        [q_by_tr, q_by_x, q_by_y, q_by_z],
    )
    # standard scaling: with S = 2*sqrt-term, the chosen component is S/4
    # and the others divide by S; equivalently square the sqrt-term then
    # scale everything by 1/(2*sqrt-term).
    comp = np.take_along_axis(q, choice, -1)[..., 0]
    np.put_along_axis(q, choice, (comp**2)[..., None], -1)
    q = q * (0.5 / np.maximum(np.abs(comp), 1e-12))[..., None]
    # enforce w >= 0
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quaternion_to_axis_angle(q: np.ndarray) -> np.ndarray:
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w = np.clip(q[..., :1], -1.0, 1.0)
    angle = 2 * np.arccos(w)
    s = np.sqrt(np.maximum(1 - w**2, 1e-30))
    axis = q[..., 1:] / s
    small = (angle < 1e-7)
    return np.where(small, q[..., 1:] * 2, axis * angle)


def axis_angle_to_quaternion(a: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(a, axis=-1, keepdims=True)
    half = theta / 2
    k = np.where(theta > 1e-8, a / np.maximum(theta, 1e-30), 0.0)
    w = np.cos(half)
    xyz = np.where(theta > 1e-8, k * np.sin(half), a / 2)
    return np.concatenate([w, xyz], -1)


def matrix_to_rotation_6d(R: np.ndarray) -> np.ndarray:
    """First two rows flattened (PyTorch3D convention)."""
    return R[..., :2, :].reshape(R.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: np.ndarray) -> np.ndarray:
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / np.linalg.norm(a1, axis=-1, keepdims=True)
    a2p = a2 - (b1 * a2).sum(-1, keepdims=True) * b1
    b2 = a2p / np.linalg.norm(a2p, axis=-1, keepdims=True)
    b3 = np.cross(b1, b2)
    return np.stack([b1, b2, b3], -2)


def _euler_axis_matrix(axis: str, angle: np.ndarray) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    one, zero = np.ones_like(c), np.zeros_like(c)
    if axis == "X":
        rows = [one, zero, zero, zero, c, -s, zero, s, c]
    elif axis == "Y":
        rows = [c, zero, s, zero, one, zero, -s, zero, c]
    else:
        rows = [c, -s, zero, s, c, zero, zero, zero, one]
    return np.stack(rows, -1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(e: np.ndarray, convention: str = "XYZ") -> np.ndarray:
    mats = [_euler_axis_matrix(c, e[..., i]) for i, c in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def matrix_to_euler_angles(R: np.ndarray, convention: str = "XYZ") -> np.ndarray:
    """Only XYZ convention implemented (the one used by robomimic abs_action)."""
    assert convention == "XYZ", "only XYZ euler convention supported"
    sy = np.clip(R[..., 0, 2], -1.0, 1.0)
    y = np.arcsin(sy)
    x = np.arctan2(-R[..., 1, 2], R[..., 2, 2])
    z = np.arctan2(-R[..., 0, 1], R[..., 0, 0])
    return np.stack([x, y, z], -1)


_TO_MATRIX = {
    "axis_angle": axis_angle_to_matrix,
    "quaternion": quaternion_to_matrix,
    "rotation_6d": rotation_6d_to_matrix,
    "euler_angles": euler_angles_to_matrix,
}
_FROM_MATRIX = {
    "axis_angle": matrix_to_axis_angle,
    "quaternion": matrix_to_quaternion,
    "rotation_6d": matrix_to_rotation_6d,
    "euler_angles": matrix_to_euler_angles,
}


class RotationTransformer:
    """Rotation representation converter with matrix intermediate
    (reference dataset_utils.py:148-243)."""

    valid_reps = ["axis_angle", "euler_angles", "quaternion", "rotation_6d", "matrix"]

    def __init__(self, from_rep="axis_angle", to_rep="rotation_6d",
                 from_convention=None, to_convention=None):
        assert from_rep != to_rep
        assert from_rep in self.valid_reps and to_rep in self.valid_reps
        self.from_rep, self.to_rep = from_rep, to_rep
        self.from_convention, self.to_convention = from_convention, to_convention

    def _to_matrix(self, x):
        if self.from_rep == "matrix":
            return x
        fn = _TO_MATRIX[self.from_rep]
        if self.from_rep == "euler_angles":
            return fn(x, self.from_convention or "XYZ")
        return fn(x)

    def _from_matrix(self, R):
        if self.to_rep == "matrix":
            return R
        fn = _FROM_MATRIX[self.to_rep]
        if self.to_rep == "euler_angles":
            return fn(R, self.to_convention or "XYZ")
        return fn(R)

    def forward(self, x: np.ndarray) -> np.ndarray:
        return self._from_matrix(self._to_matrix(np.asarray(x)))

    def inverse(self, x: np.ndarray) -> np.ndarray:
        inv = RotationTransformer(
            from_rep=self.to_rep,
            to_rep=self.from_rep,
            from_convention=self.to_convention,
            to_convention=self.from_convention,
        )
        return inv.forward(x)

"""MuJoCo .mjl binary log reader (counterpart of
cleandiffuser_tpu/dataset/mjl.py), numpy only.

The relay-policy-learning kitchen demos ship as MuJoCo log files: a
7-int32 header (nq, nv, nu, nmocap, nsensordata, nuserdata, name_len), a
name blob, then float32 records of width 1 + nq + nv + nu + 7*nmocap +
nsensordata + nuserdata laid out [time | qpos | qvel | ctrl | mocap_pos |
mocap_quat | sensordata | userdata].
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["parse_mjl_log"]


def parse_mjl_log(path: str, skip: int = 1) -> Dict[str, np.ndarray]:
    """Read a .mjl log into named float32 arrays, subsampled by `skip`."""
    raw = np.fromfile(path, dtype=np.uint8)
    header = raw[:28].view(np.int32)
    nq, nv, nu, nmocap, nsensordata, nuserdata, name_len = (int(x) for x in header)
    name = raw[28 : 28 + name_len].tobytes().rstrip(b"\x00").decode(errors="replace")
    floats = raw[28 + name_len :].view(np.float32)
    width = 1 + nq + nv + nu + 7 * nmocap + nsensordata + nuserdata
    if floats.size % width != 0:
        raise ValueError(
            f"{path}: payload of {floats.size} floats is not a multiple of "
            f"record width {width}"
        )
    rec = floats.reshape(-1, width)[::skip]

    fields = {}
    cursor = 0
    for key, n in [("time", 1), ("qpos", nq), ("qvel", nv), ("ctrl", nu),
                   ("mocap_pos", 3 * nmocap), ("mocap_quat", 4 * nmocap),
                   ("sensordata", nsensordata), ("userdata", nuserdata)]:
        fields[key] = rec[:, cursor : cursor + n]
        cursor += n
    fields["time"] = fields["time"][:, 0]
    fields.update(nq=nq, nv=nv, nu=nu, nmocap=nmocap,
                  nsensordata=nsensordata, name=name)
    return fields

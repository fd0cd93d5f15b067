"""Pure-numpy reader of the zarr-v2 DIRECTORY store format (counterpart of
cleandiffuser_tpu/dataset/zarr_compat.py).

The reference ships its PushT and kitchen replay buffers as zarr stores,
and the zarr package is not a dependency. The v2 format is JSON metadata
(`.zgroup` / `.zarray`) plus one binary file per chunk, so this reads it
directly: null / zlib / gzip compressors (python stdlib), C or F order
inside a chunk, edge chunks, missing chunks as fill_value, "." or "/"
dimension separators. A blosc-compressed store needs the zarr package, and
the error says so. `open_zarr` takes the zarr package whenever it is
importable.
"""

import itertools
import json
import zlib
from pathlib import Path

import numpy as np

__all__ = ["PureZarrArray", "PureZarrGroup", "open_zarr"]


class PureZarrArray:
    """Minimal zarr-v2 array reader (see module docstring for coverage)."""

    def __init__(self, path):
        self.path = Path(path)
        meta = json.loads((self.path / ".zarray").read_text())
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{self.path}: not a zarr-v2 array")
        if meta.get("filters"):
            raise ValueError(
                f"{self.path}: filter pipeline unsupported — install zarr")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.order = meta.get("order", "C")
        self.fill = meta.get("fill_value", 0)
        comp = meta.get("compressor")
        self.comp_id = comp["id"] if comp else None
        if self.comp_id not in (None, "zlib", "gzip"):
            raise ValueError(
                f"{self.path}: compressor {self.comp_id!r} needs the zarr "
                "package (convert with tools/convert_pusht_zarr.py where "
                "zarr is installed, then point the CLI at the .npz)")

    def read(self) -> np.ndarray:
        fill = 0 if self.fill is None else self.fill
        out = np.full(self.shape, fill, self.dtype)
        grid = [range((s + c - 1) // c) for s, c in
                zip(self.shape, self.chunks)]
        for idx in itertools.product(*grid):
            fn = self.path / ".".join(map(str, idx))
            if not fn.exists():
                fn = self.path.joinpath(*map(str, idx))  # "/" separator
                if not fn.exists():
                    continue  # missing chunk = fill_value
            raw = fn.read_bytes()
            if self.comp_id in ("zlib", "gzip"):
                raw = zlib.decompress(
                    raw, zlib.MAX_WBITS | 32 if self.comp_id == "gzip"
                    else zlib.MAX_WBITS)
            chunk = np.frombuffer(raw, self.dtype).reshape(
                self.chunks, order=self.order)
            sl = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, self.chunks, self.shape))
            out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
        return out

    def __array__(self, dtype=None):
        a = self.read()
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, key):
        return self.read()[key]

    def __len__(self):
        return self.shape[0]


class PureZarrGroup:
    """Minimal zarr-v2 group reader over a directory tree."""

    def __init__(self, path):
        self.path = Path(path)
        if not (self.path / ".zgroup").exists():
            raise FileNotFoundError(
                f"{self.path}: no .zgroup — not a zarr-v2 directory store")

    def __getitem__(self, name):
        sub = self.path
        for part in str(name).split("/"):
            sub = sub / part
        if (sub / ".zarray").exists():
            return PureZarrArray(sub)
        if (sub / ".zgroup").exists():
            return PureZarrGroup(sub)
        raise KeyError(name)

    def __contains__(self, name):
        try:
            self[name]
            return True
        except (KeyError, FileNotFoundError):
            return False

    def keys(self):
        return [p.name for p in sorted(self.path.iterdir())
                if (p / ".zarray").exists() or (p / ".zgroup").exists()]


def open_zarr(path):
    """zarr.open(path, 'r') when the package exists, else the pure reader."""
    try:
        import zarr
    except ImportError:
        return PureZarrGroup(path)
    return zarr.open(str(path), "r")

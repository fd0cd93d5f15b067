"""Jpeg2k zarr codec registration, import-gated (counterpart of
cleandiffuser_tpu/dataset/imagecodecs_compat.py).

The reference's robomimic image datasets store camera frames
Jpeg2k-compressed in zarr. `register_codecs()` delegates to the
`imagecodecs` package when it is installed; without it, it raises with the
JAX package's message (the port's datasets store frames as raw uint8, so
the codec is needed only to read stores the reference wrote). No pipeline
uses it.
"""

from __future__ import annotations

__all__ = ["Jpeg2k", "register_codecs"]

try:
    from imagecodecs.numcodecs import Jpeg2k, register_codecs  # type: ignore
except Exception:  # imagecodecs not installed
    Jpeg2k = None

    def register_codecs(*a, **k):
        raise ImportError(
            "imagecodecs is not installed; Jpeg2k-compressed zarr stores "
            "(reference robomimic image datasets) cannot be decoded. "
            "Re-encode with raw uint8 chunks or install imagecodecs."
        )

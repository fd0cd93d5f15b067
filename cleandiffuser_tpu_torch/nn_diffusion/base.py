"""Base contract for diffusion backbones (counterpart of
cleandiffuser_tpu/nn_diffusion/base.py).

A backbone maps (noisy data `x`, timesteps `t`, condition embedding `emb`)
-> prediction with the same shape as `x`. `t` is a (b,) tensor; `emb` is
the output of an `nn_condition` module or None.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..utils.embeddings import SUPPORTED_TIMESTEP_EMBEDDING

__all__ = ["BaseNNDiffusion", "timestep_embedding_module"]


class BaseNNDiffusion(nn.Module):
    """forward(x, t, emb=None) -> prediction of x's shape."""

    def forward(self, x, t, emb=None):
        raise NotImplementedError


def timestep_embedding_module(emb_dim: int, kind: str = "positional",
                              params: Optional[dict] = None,
                              generator: Optional[torch.Generator] = None):
    if kind not in SUPPORTED_TIMESTEP_EMBEDDING:
        raise ValueError(f"unknown timestep_emb_type {kind}")
    return SUPPORTED_TIMESTEP_EMBEDDING[kind](dim=emb_dim, generator=generator,
                                              **(params or {}))

"""Classifier heads' base (counterpart of
cleandiffuser_tpu/nn_classifier/mlp.py). Contract:
`forward(x, t, y=None) -> (b, out_dim)` where t is (b,). `MLPNNClassifier`
and `QGPONNClassifier` come with the pipelines that use them.
"""

from __future__ import annotations

import torch.nn as nn

__all__ = ["BaseNNClassifier"]


class BaseNNClassifier(nn.Module):
    """(x, t, y) -> logp(y|x,t)+C scalar head base."""

    def forward(self, x, t, y=None):
        raise NotImplementedError

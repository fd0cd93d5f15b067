from .half_nets import HalfJannerUNet1d
from .mlp import BaseNNClassifier, QGPONNClassifier

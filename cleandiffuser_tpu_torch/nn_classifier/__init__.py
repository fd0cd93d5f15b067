from .half_nets import HalfDiT1d, HalfJannerUNet1d
from .mlp import BaseNNClassifier, MLPNNClassifier, QGPONNClassifier

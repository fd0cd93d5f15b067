from .base import BaseNNCondition, IdentityCondition, MLPCondition, PearceObsCondition
from .images import (
    CROP_KEY,
    MultiImageObsCondition,
    ResNet18,
    SpatialSoftmax,
    center_crop,
    random_crop,
)

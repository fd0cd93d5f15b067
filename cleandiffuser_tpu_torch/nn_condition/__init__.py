from .base import (
    BaseNNCondition,
    FourierCondition,
    IdentityCondition,
    LinearCondition,
    MLPCondition,
    MLPSieveObsCondition,
    PearceObsCondition,
    PositionalCondition,
)
from .images import (
    CROP_KEY,
    EarlyConvViTMultiViewImageCondition,
    MultiImageObsCondition,
    ResNet18,
    ResNet18ImageCondition,
    ResNet18MultiViewImageCondition,
    SmallStem,
    SpatialSoftmax,
    center_crop,
    random_crop,
)

from .base import BaseNNCondition, IdentityCondition, MLPCondition, PearceObsCondition

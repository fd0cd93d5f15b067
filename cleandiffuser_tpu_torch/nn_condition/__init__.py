from .base import BaseNNCondition, IdentityCondition, MLPCondition

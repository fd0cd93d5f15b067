from .basic import DiffusionModel
from .diffusionsde import BaseDiffusionSDE, ContinuousDiffusionSDE
from .vp_solvers import SUPPORTED_SOLVERS

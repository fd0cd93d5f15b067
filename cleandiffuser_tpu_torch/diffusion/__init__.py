from .basic import DiffusionModel
from .diffusionsde import BaseDiffusionSDE, ContinuousDiffusionSDE, DiscreteDiffusionSDE
from .vp_solvers import SUPPORTED_SOLVERS
from .rectifiedflow import ContinuousRectifiedFlow, DiscreteRectifiedFlow

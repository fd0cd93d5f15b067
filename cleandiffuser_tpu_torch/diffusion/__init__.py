from .basic import DiffusionModel
from .consistency_model import CMCurriculumLogger, ContinuousConsistencyModel
from .diffusionsde import BaseDiffusionSDE, ContinuousDiffusionSDE, DiscreteDiffusionSDE
from .edm import ContinuousEDM
from .karras_ode import EDMDDIM, VEODE, VPODE, KarrasODE
from .rectifiedflow import ContinuousRectifiedFlow, DiscreteRectifiedFlow
from .vp_solvers import SUPPORTED_SOLVERS

# The legacy engine names, as the reference exports them: one engine family
# whose solver set covers them all. DDIM is the discrete engine sampled with
# solver="ddim"; the DPM-Solver variants are the engines' ode_/sde_dpmsolver
# solver strings.
DDPM = DiscreteDiffusionSDE
EDM = ContinuousEDM
DDIM = DiscreteDiffusionSDE
DPMSolver = ContinuousDiffusionSDE
DPMSolverDiscrete = DiscreteDiffusionSDE

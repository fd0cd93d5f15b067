from .adaptdiffuser import AdaptDiffuserPipeline
from .dd import DDPipeline
from .diffuser import DiffuserPipeline
from .diffuserlite import DiffuserLitePipeline, compute_temporal_horizons
from .dql import DQLPipeline
from .edp import EDPPipeline
from .idql import IDQLPipeline
from .runner import make_rl_train_scan, rl_window_fn
from .veteran import VeteranPipeline

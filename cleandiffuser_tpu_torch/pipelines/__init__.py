from .adaptdiffuser import AdaptDiffuserPipeline
from .consistency_policy import ConsistencyPolicyPipeline, goal2d_gate
from .dbc import DBCPipeline
from .dbc_image import DBCImagePipeline
from .dd import DDPipeline
from .diffuser import DiffuserPipeline
from .diffuserlite import DiffuserLitePipeline, compute_temporal_horizons
from .dp import DPPipeline
from .dp_image import DPImagePipeline
from .dql import DQLPipeline
from .edp import EDPPipeline
from .idql import IDQLPipeline
from .qgpo import QGPOPipeline
from .runner import make_rl_train_scan, rl_window_fn
from .sfbc import SfBCPipeline
from .synther import SynthERPipeline, TD3BC
from .veteran import VeteranPipeline

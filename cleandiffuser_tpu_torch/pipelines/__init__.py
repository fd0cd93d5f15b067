from .dd import DDPipeline
from .diffuser import DiffuserPipeline

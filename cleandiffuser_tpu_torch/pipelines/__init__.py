from .dd import DDPipeline

from .mlp import MlpInvDynamic

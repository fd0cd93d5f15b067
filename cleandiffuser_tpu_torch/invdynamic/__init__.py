from .mlp import FancyMlpInvDynamic, MlpInvDynamic

from .mlp import EnsembleMlpInvDynamic, FancyMlpInvDynamic, MlpInvDynamic, ResInvDynamic

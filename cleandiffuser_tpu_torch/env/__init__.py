from .goal2d import Goal2DEnv, evaluate_policy, normalized_score_fn, optimal_return
from .wrapper import DuckSyncVectorEnv

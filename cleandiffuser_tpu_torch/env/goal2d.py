"""Goal2D: a hermetic offline-RL task with an analytic optimum (counterpart
of cleandiffuser_tpu/env/goal2d.py).

    state  s in [-2, 2]^2, obs = s
    action a in [-1, 1]^2 (clipped), s' = clip(s + DT * a)
    reward r = -||s'||            (dense distance to the goal at 0)
    horizon T = 40, reset s0 ~ U([-1, 1]^2)

The optimal policy saturates both action axes (the action set is a box):
each axis decays as max(|x_i| - t*DT, 0), so the optimal return is
-sum_t ||(max(|x| - t*DT, 0), max(|y| - t*DT, 0))|| (`optimal_return`).
`normalized_score_fn` maps the uniform-random policy's expected return to 0
and the expected optimum to 1, both by a seeded Monte-Carlo on the device.

Everything runs in torch on one device (the CUDA device unless the caller
names another): batched reset and step, the analytic return, and the
episode loop of `evaluate_policy`. Random draws come from an explicit
`torch.Generator`: from one seed they differ from the reference's JAX
draws, so the anchors agree with the reference's within Monte-Carlo error.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..utils.tensors import default_device

__all__ = [
    "Goal2DEnv", "Goal2DState", "optimal_return", "random_return", "expected_optimal_return",
    "evaluate_policy", "normalized_score_fn", "DT", "HORIZON", "BOUND",
]

DT = 0.1
HORIZON = 40
BOUND = 2.0


class Goal2DState(NamedTuple):
    pos: torch.Tensor  # (..., 2)


def _uniform(shape, generator: torch.Generator, lo: float = -1.0, hi: float = 1.0):
    return torch.rand(shape, generator=generator, device=generator.device) * (hi - lo) + lo


class Goal2DEnv:
    obs_dim = 2
    act_dim = 2
    horizon = HORIZON

    def reset(self, generator: torch.Generator, batch: int = 1):
        state = Goal2DState(_uniform((batch, 2), generator))
        return state, self.get_obs(state)

    def get_obs(self, state: Goal2DState):
        return state.pos

    def step(self, state: Goal2DState, action: torch.Tensor
             ) -> Tuple[Goal2DState, torch.Tensor, torch.Tensor, torch.Tensor]:
        a = torch.clamp(action, -1.0, 1.0)
        pos = torch.clamp(state.pos + DT * a, -BOUND, BOUND)
        rew = -torch.linalg.vector_norm(pos, dim=-1)
        done = torch.zeros(rew.shape, dtype=torch.bool, device=rew.device)  # fixed horizon
        state = Goal2DState(pos)
        return state, self.get_obs(state), rew, done


def optimal_return(s0: torch.Tensor, horizon: int = HORIZON) -> torch.Tensor:
    """Closed-form optimal return from start position(s) s0 (..., 2)."""
    ax = s0.abs()
    t = torch.arange(1, horizon + 1, dtype=s0.dtype, device=s0.device)
    rem = torch.clamp(ax[..., None, :] - t[:, None] * DT, min=0.0)  # (..., T, 2)
    return -torch.linalg.vector_norm(rem, dim=-1).sum(-1)


def expected_optimal_return(n_mc: int = 100_000, seed: int = 0, device=None) -> float:
    """E[optimal return] under the reset distribution (seeded Monte-Carlo)."""
    gen = torch.Generator(device=default_device(device)).manual_seed(seed)
    return float(optimal_return(_uniform((n_mc, 2), gen)).mean())


def evaluate_policy(act_fn: Callable[[torch.Generator, torch.Tensor], torch.Tensor],
                    num_envs: int = 64, seed: int = 0, device=None) -> float:
    """Mean episode return of `act_fn(generator, obs) -> action` over
    `num_envs` episodes; the env loop runs on the device, one policy call
    per control step."""
    env = Goal2DEnv()
    gen = torch.Generator(device=default_device(device)).manual_seed(seed)
    state, obs = env.reset(gen, num_envs)
    total = torch.zeros(num_envs, device=gen.device)
    for _ in range(HORIZON):
        act = torch.as_tensor(act_fn(gen, obs), dtype=torch.float32, device=gen.device)
        state, obs, rew, _ = env.step(state, act)
        total = total + rew
    return float(total.mean())


def random_return(num_envs: int = 4096, seed: int = 0, device=None) -> float:
    """The uniform-random policy's mean return over `num_envs` episodes."""
    env = Goal2DEnv()
    gen = torch.Generator(device=default_device(device)).manual_seed(seed)
    state, _ = env.reset(gen, num_envs)
    total = torch.zeros(num_envs, device=gen.device)
    for _ in range(HORIZON):
        state, _, rew, _ = env.step(state, _uniform((num_envs, 2), gen))
        total = total + rew
    return float(total.mean())


def normalized_score_fn(n_mc: int = 100_000, seed: int = 0, device=None):
    """score(ret) mapping the random anchor to 0.0 and the optimum to 1.0."""
    lo = random_return(seed=seed, device=device)
    hi = expected_optimal_return(n_mc=n_mc, seed=seed, device=device)

    def score(ret: float) -> float:
        return (ret - lo) / (hi - lo)

    score.anchors = (lo, hi)
    return score

"""Behavior data for the Goal2D hermetic benchmark (env/goal2d.py);
counterpart of cleandiffuser_tpu/dataset/hermetic.py, the same arrays from
the same seed.

Gaussian-mixture behavior policy over episodes: a fraction of episodes is
driven by the noisy optimal controller (straight to the goal + Gaussian
action noise), the rest by a uniform random policy. Offline-RL algorithms
(DQL/EDP/IDQL/planners) must stitch the good half and filter the noise, so
a score near the ANALYTIC optimum makes silent algorithm regressions
falsifiable without d4rl.

Emitted schemas match d4rl exactly:
- `goal2d_qlearning_dataset`: {observations, actions, next_observations,
  rewards, terminals} — consumable by D4RLMuJoCoTDDataset.
- `goal2d_sequence_dataset`: {observations, actions, rewards, terminals,
  timeouts} — consumable by the episode-chunked sequence datasets.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..env.goal2d import BOUND, DT, HORIZON

__all__ = ["goal2d_qlearning_dataset", "goal2d_sequence_dataset"]


def _behavior_rollouts(n_episodes: int, seed: int, expert_frac: float,
                       noise: float):
    """Numpy rollouts of the mixture behavior policy (host-side: the MDP is
    trivially cheap; no reason to involve the device)."""
    rs = np.random.RandomState(seed)
    obs = np.empty((n_episodes, HORIZON, 2), np.float32)
    act = np.empty((n_episodes, HORIZON, 2), np.float32)
    rew = np.empty((n_episodes, HORIZON), np.float32)
    nobs = np.empty((n_episodes, HORIZON, 2), np.float32)
    is_expert = rs.rand(n_episodes) < expert_frac
    pos = rs.uniform(-1.0, 1.0, (n_episodes, 2)).astype(np.float32)
    for t in range(HORIZON):
        d = np.linalg.norm(pos, axis=-1, keepdims=True)
        a_exp = -pos / np.maximum(d, DT)  # full speed toward goal; slow near it
        a_exp = a_exp + rs.randn(n_episodes, 2).astype(np.float32) * noise
        a_rnd = rs.uniform(-1.0, 1.0, (n_episodes, 2)).astype(np.float32)
        a = np.where(is_expert[:, None], a_exp, a_rnd)
        a = np.clip(a, -1.0, 1.0).astype(np.float32)
        new_pos = np.clip(pos + DT * a, -BOUND, BOUND)
        obs[:, t] = pos
        act[:, t] = a
        nobs[:, t] = new_pos
        rew[:, t] = -np.linalg.norm(new_pos, axis=-1)
        pos = new_pos
    return obs, act, rew, nobs


def goal2d_qlearning_dataset(n_episodes: int = 2000, seed: int = 0,
                             expert_frac: float = 0.5,
                             noise: float = 0.3) -> Dict[str, np.ndarray]:
    obs, act, rew, nobs = _behavior_rollouts(n_episodes, seed, expert_frac, noise)
    flat = lambda x: x.reshape(-1, *x.shape[2:])
    return {
        "observations": flat(obs),
        "actions": flat(act),
        "next_observations": flat(nobs),
        "rewards": flat(rew),
        "terminals": np.zeros(n_episodes * HORIZON, np.float32),
    }


def goal2d_sequence_dataset(n_episodes: int = 2000, seed: int = 0,
                            expert_frac: float = 0.5,
                            noise: float = 0.3) -> Dict[str, np.ndarray]:
    obs, act, rew, _ = _behavior_rollouts(n_episodes, seed, expert_frac, noise)
    flat = lambda x: x.reshape(-1, *x.shape[2:])
    timeouts = np.zeros((n_episodes, HORIZON), np.float32)
    timeouts[:, -1] = 1.0  # fixed-horizon episodes end by timeout
    return {
        "observations": flat(obs),
        "actions": flat(act),
        "rewards": flat(rew),
        "terminals": np.zeros(n_episodes * HORIZON, np.float32),
        "timeouts": flat(timeouts),
    }

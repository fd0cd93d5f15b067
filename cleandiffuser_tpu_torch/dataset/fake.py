"""Synthetic D4RL-format datasets for hermetic tests and offline
development (counterpart of cleandiffuser_tpu/dataset/fake.py; the
robomimic buffer comes with the imitation datasets).

The generators produce dictionaries with the schema of `env.get_dataset()`
/ `d4rl.qlearning_dataset(env)`, so every dataset class and pipeline runs
without network or MuJoCo. The same seed gives the reference's arrays.

The synthetic MDP is a controllable linear system with reward shaped so
that higher action alignment with a goal direction yields higher return —
enough signal for smoke-training RL pipelines end-to-end.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["fake_d4rl_dataset", "fake_d4rl_qlearning_dataset", "FAKE_ENV_SPECS"]

FAKE_ENV_SPECS = {
    # env_name: (obs_dim, act_dim)
    "halfcheetah-medium-v2": (17, 6),
    "halfcheetah-medium-expert-v2": (17, 6),
    "halfcheetah-medium-replay-v2": (17, 6),
    "hopper-medium-v2": (11, 3),
    "hopper-medium-expert-v2": (11, 3),
    "hopper-medium-replay-v2": (11, 3),
    "walker2d-medium-v2": (17, 6),
    "walker2d-medium-expert-v2": (17, 6),
    "walker2d-medium-replay-v2": (17, 6),
    "antmaze-umaze-v2": (29, 8),
    "antmaze-umaze-diverse-v2": (29, 8),
    "antmaze-medium-play-v2": (29, 8),
    "antmaze-medium-diverse-v2": (29, 8),
    "antmaze-large-play-v2": (29, 8),
    "antmaze-large-diverse-v2": (29, 8),
    "kitchen-partial-v0": (60, 9),
    "kitchen-mixed-v0": (60, 9),
    "maze2d-umaze-v1": (4, 2),
    "maze2d-medium-v1": (4, 2),
    "maze2d-large-v1": (4, 2),
}


def _spec_by_prefix(env_name):
    """Dims for task tiers not explicitly listed (e.g. a new -expert-v2):
    hermetic data must match the EVAL env's obs/act dims or inference
    breaks on the normalizer (antmaze-umaze once fell back to 17/6)."""
    for prefix, spec in (("antmaze", (29, 8)), ("kitchen", (60, 9)),
                         ("maze2d", (4, 2)), ("hopper", (11, 3))):
        if env_name.startswith(prefix):
            return spec
    return (17, 6)


def _rollout(rng, o_dim, a_dim, n_steps, ep_len):
    A = np.eye(o_dim) * 0.95
    B = rng.standard_normal((o_dim, a_dim)).astype(np.float32) * 0.1
    goal = rng.standard_normal((o_dim,)).astype(np.float32)
    goal /= np.linalg.norm(goal)

    obs = np.zeros((n_steps, o_dim), np.float32)
    act = np.zeros((n_steps, a_dim), np.float32)
    rew = np.zeros((n_steps,), np.float32)
    timeouts = np.zeros((n_steps,), bool)
    terminals = np.zeros((n_steps,), bool)

    o = rng.standard_normal(o_dim).astype(np.float32)
    t_in_ep = 0
    for i in range(n_steps):
        a = np.clip(rng.standard_normal(a_dim).astype(np.float32) * 0.5, -1, 1)
        obs[i], act[i] = o, a
        o = A @ o + B @ a + rng.standard_normal(o_dim).astype(np.float32) * 0.01
        rew[i] = float(goal @ o)
        t_in_ep += 1
        if t_in_ep >= ep_len:
            timeouts[i] = True
            t_in_ep = 0
            o = rng.standard_normal(o_dim).astype(np.float32)
        elif rng.random() < 0.002:
            terminals[i] = True
            t_in_ep = 0
            o = rng.standard_normal(o_dim).astype(np.float32)
    return obs, act, rew, timeouts, terminals


def fake_d4rl_dataset(
    env_name: str = "halfcheetah-medium-v2",
    n_steps: int = 5000,
    ep_len: int = 250,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Schema of `env.get_dataset()`."""
    o_dim, a_dim = FAKE_ENV_SPECS.get(env_name, _spec_by_prefix(env_name))
    # respect the benchmark's max episode length (kitchen datasets assume
    # paths <= 280, maze2d <= 300; see dataset/d4rl_kitchen.py:69)
    if env_name.startswith("kitchen"):
        ep_len = min(ep_len, 250)
    elif env_name.startswith("maze2d"):
        ep_len = min(ep_len, 280)
    rng = np.random.default_rng(seed)
    obs, act, rew, timeouts, terminals = _rollout(rng, o_dim, a_dim, n_steps, ep_len)
    if env_name.startswith(("antmaze", "maze2d")):
        # sparse goal-reaching reward in {0, 1} like the real datasets
        rew = (rew >= np.quantile(rew, 0.99)).astype(np.float32)
    return {
        "observations": obs,
        "actions": act,
        "rewards": rew,
        "timeouts": timeouts,
        "terminals": terminals,
    }


def fake_d4rl_qlearning_dataset(
    env_name: str = "halfcheetah-medium-v2",
    n_steps: int = 5000,
    ep_len: int = 250,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Schema of `d4rl.qlearning_dataset(env)`."""
    d = fake_d4rl_dataset(env_name, n_steps + 1, ep_len, seed)
    return {
        "observations": d["observations"][:-1],
        "actions": d["actions"][:-1],
        "next_observations": d["observations"][1:],
        "rewards": d["rewards"][:-1],
        "terminals": d["terminals"][:-1].astype(np.float32),
    }

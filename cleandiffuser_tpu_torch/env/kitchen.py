"""Franka Kitchen eval env in the d4rl low-dim layout (counterpart of
cleandiffuser_tpu/env/kitchen.py; numpy only, the env steps on the host).

The d4rl kitchen env needs mujoco_py; gymnasium_robotics' FrankaKitchen-v1
(MuJoCo 3) is the same multitask kitchen, derived from the same
relay-policy-learning source, with dict observations. `KitchenLowdimWrapper`
flattens them to d4rl's 60 dims and scores with d4rl's completion rule.
The element indices, goals and the 0.3 threshold below are d4rl's; they
equal gymnasium_robotics' `OBS_ELEMENT_INDICES`, `OBS_ELEMENT_GOALS` and
`BONUS_THRESH` (tests/test_torch_d4rl_eval_envs.py pins both), so the
flattening needs gymnasium_robotics only to make the env.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["KitchenLowdimWrapper", "make_kitchen_env", "ALL_KITCHEN_TASKS"]

ALL_KITCHEN_TASKS = [
    "bottom burner", "top burner", "light switch", "slide cabinet",
    "hinge cabinet", "microwave", "kettle",
]

# d4rl/relay-policy task-completion constants. Indices address the 30-dim
# [robot qpos 9 | object qpos 21] vector, which is obs[:30] of the
# flattened layout below.
D4RL_ELEMENT_INDICES = {
    "bottom burner": np.array([11, 12]),
    "top burner": np.array([15, 16]),
    "light switch": np.array([17, 18]),
    "slide cabinet": np.array([19]),
    "hinge cabinet": np.array([20, 21]),
    "microwave": np.array([22]),
    "kettle": np.array([23, 24, 25, 26, 27, 28, 29]),
}
D4RL_ELEMENT_GOALS = {
    "bottom burner": np.array([-0.88, -0.01]),
    "top burner": np.array([-0.92, -0.01]),
    "light switch": np.array([-0.69, -0.05]),
    "slide cabinet": np.array([0.37]),
    "hinge cabinet": np.array([0.0, 1.45]),
    "microwave": np.array([-0.75]),
    "kettle": np.array([-0.23, 0.75, 1.62, 0.99, 0.0, 0.0, -0.06]),
}
D4RL_BONUS_THRESH = 0.3


try:  # a gymnasium.Env where gymnasium is installed (its wrappers assert it)
    import gymnasium as _gym

    _EnvBase = _gym.Env
except ImportError:  # pragma: no cover
    _EnvBase = object


class KitchenLowdimWrapper(_EnvBase):
    """Flattens FrankaKitchen dict obs to the d4rl/relay-policy layout:
    [robot qpos (9) | object qpos (21) | full goal qpos (30)] = 60 dims.

    gymnasium's `observation` is [robot qpos 9 | robot qvel 9 | obj qpos 21
    | obj qvel 20]; the velocities are dropped and the per-task
    `desired_goal` dict is scattered into a 30-dim goal vector (zero for the
    untargeted elements).

    Reward and termination follow d4rl's rule, computed from the
    observation, not gymnasium's reward: an element completes when
    ||obs[element_idx] - goal|| < 0.3 (in any order), pays +1 once and
    leaves the open set; the episode terminates when the set is empty."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, env, tasks: Optional[Sequence[str]] = None):
        self.env = env
        self.tasks = list(tasks) if tasks is not None else list(ALL_KITCHEN_TASKS)
        self.tasks_to_complete: List[str] = list(self.tasks)

    @staticmethod
    def _flatten(obs_dict) -> np.ndarray:
        o = np.ravel(obs_dict["observation"])
        qp, obj_qp = o[:9], o[18:39]
        goal = np.zeros(30, np.float32)
        desired = obs_dict.get("desired_goal", {})
        if isinstance(desired, dict):
            for task, val in desired.items():
                goal[D4RL_ELEMENT_INDICES[task]] = np.ravel(val)
        return np.concatenate([qp, obj_qp, goal]).astype(np.float32)

    def _d4rl_completions(self, flat_obs) -> List[str]:
        return [element for element in self.tasks_to_complete
                if np.linalg.norm(flat_obs[D4RL_ELEMENT_INDICES[element]]
                                  - D4RL_ELEMENT_GOALS[element]) < D4RL_BONUS_THRESH]

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        self.tasks_to_complete = list(self.tasks)
        return self._flatten(obs), info

    def step(self, action):
        obs, _, term, trunc, info = self.env.step(action)
        flat = self._flatten(obs)
        completions = self._d4rl_completions(flat)
        for element in completions:
            self.tasks_to_complete.remove(element)
        rew = float(len(completions))  # d4rl's bonus: the newly completed tasks
        term = bool(term) or not self.tasks_to_complete
        info = dict(info)
        info["completed_tasks"] = set(self.tasks) - set(self.tasks_to_complete)
        return flat, rew, term, trunc, info

    def render(self):
        return self.env.render()

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def observation_space(self):
        import gymnasium as gym

        example, _ = self.reset()
        return gym.spaces.Box(-np.inf, np.inf, shape=example.shape, dtype=np.float32)

    def close(self):
        self.env.close()


def make_kitchen_env(tasks: Optional[Sequence[str]] = None, render_mode=None):
    """A wrapped FrankaKitchen-v1 (needs gymnasium_robotics) with `tasks`
    to complete (microwave and kettle by default)."""
    import gymnasium as gym
    import gymnasium_robotics  # noqa: F401  (registers FrankaKitchen-v1)

    tasks = list(tasks) if tasks is not None else ["microwave", "kettle"]
    env = gym.make("FrankaKitchen-v1", tasks_to_complete=tasks, render_mode=render_mode)
    return KitchenLowdimWrapper(env, tasks)

"""d4rl-layout eval envs over gymnasium_robotics (counterpart of
cleandiffuser_tpu/env/d4rl_eval.py; numpy only, the envs step on the host).

The d4rl antmaze and maze2d envs need mujoco_py, which is not installed;
gymnasium_robotics ships MuJoCo-3 reimplementations (AntMaze_*-v5,
PointMaze_*-v3) with *dict* observations. These wrappers flatten the dict
back to the d4rl observation layout, so that the trained normalisers and
policies apply unchanged:

- antmaze: d4rl obs = [xy (2) | qpos[2:] + qvel (27)] = 29 dims; the
  gymnasium dict gives `achieved_goal` = xy and `observation` = the 27.
- maze2d: d4rl obs = [qpos (2) | qvel (2)] = 4 dims = the gymnasium
  `observation` vector directly.
- kitchen: env/kitchen.py `KitchenLowdimWrapper`.

Rewards follow d4rl's sparse convention (1 at the goal). gymnasium and
gymnasium_robotics are imported where an env is made, so the package
imports without them, and making an env without them raises ImportError.
"""

from __future__ import annotations

import numpy as np

__all__ = ["AntMazeD4RLWrapper", "PointMazeD4RLWrapper",
           "make_antmaze_env", "make_maze2d_env",
           "ANTMAZE_GYM_IDS", "ANTMAZE_EVAL_CELLS", "MAZE2D_GYM_IDS"]

# d4rl env-name -> gymnasium_robotics id. "play" maps to the fixed-goal
# layout, "diverse" to the diverse-goal (`Diverse_G`) layout. No
# UMaze_Diverse variant ships with gymnasium_robotics: umaze-diverse runs on
# the UMaze layout, and its eval task is pinned (ANTMAZE_EVAL_CELLS) as every
# antmaze task's is.
ANTMAZE_GYM_IDS = {
    "antmaze-umaze-v2": "AntMaze_UMaze-v5",
    "antmaze-umaze-diverse-v2": "AntMaze_UMaze-v5",
    "antmaze-medium-play-v2": "AntMaze_Medium-v5",
    "antmaze-medium-diverse-v2": "AntMaze_Medium_Diverse_G-v5",
    "antmaze-large-play-v2": "AntMaze_Large-v5",
    "antmaze-large-diverse-v2": "AntMaze_Large_Diverse_G-v5",
}

# d4rl antmaze evaluation is a FIXED task: the ant starts at one end of
# the maze and must reach a fixed target at the other end; dataset rewards
# are relabeled against that same target (d4rl locomotion/__init__.py
# registers eval=True envs with a fixed target_goal; `diverse`/`play` only
# change the DATA distribution, never the eval goal). gymnasium_robotics'
# AntMaze-v5 maps instead mark every open cell as a combined reset/goal
# cell and resample a goal per reset, unlearnable under the d4rl 29-dim
# obs layout, which carries no goal. Pin (goal_cell, reset_cell) per task
# at every reset, with position noise zeroed so the goal is exactly the
# cell center the dataset rewards were relabeled against (episode variety
# still comes from the ant's own qpos/qvel reset noise).
ANTMAZE_EVAL_CELLS = {
    "antmaze-umaze-v2": ((1, 1), (3, 1)),
    "antmaze-umaze-diverse-v2": ((1, 1), (3, 1)),
    "antmaze-medium-play-v2": ((6, 6), (1, 1)),
    "antmaze-medium-diverse-v2": ((6, 6), (1, 1)),
    "antmaze-large-play-v2": ((7, 9), (1, 1)),
    "antmaze-large-diverse-v2": ((7, 9), (1, 1)),
}

MAZE2D_GYM_IDS = {
    "maze2d-umaze-v1": "PointMaze_UMaze-v3",
    "maze2d-medium-v1": "PointMaze_Medium-v3",
    "maze2d-large-v1": "PointMaze_Large-v3",
}

# d4rl maze2d episode lengths (d4rl pointmaze registrations;
# configs/veteran/maze2d/task/*.yaml carry the same max_path_length values)
MAZE2D_EVAL_MAX_STEPS = {
    "maze2d-umaze-v1": 300,
    "maze2d-medium-v1": 600,
    "maze2d-large-v1": 800,
}

# d4rl maze2d eval targets are FIXED per layout (d4rl pointmaze
# maze_model.py registrations: umaze (1,1), medium (6,6), large (7,9) in
# cell coordinates); reset location is random. gymnasium's open maps
# sample the goal randomly, so the wrapper pins it via reset options.
MAZE2D_EVAL_GOAL_CELL = {
    "maze2d-umaze-v1": (1, 1),
    "maze2d-medium-v1": (6, 6),
    "maze2d-large-v1": (7, 9),
}


class _FlattenGoalEnv:
    """Common plumbing: flatten a goal-env dict obs to a d4rl vector."""

    def __init__(self, env):
        self.env = env

    def _flatten(self, obs_dict) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self._flatten(obs), info

    def step(self, action):
        obs, rew, term, trunc, info = self.env.step(action)
        return self._flatten(obs), float(rew), term, trunc, info

    def render(self):
        return self.env.render()

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def observation_space(self):
        import gymnasium as gym

        space = self.env.observation_space
        dims = sum(int(np.prod(space[k].shape)) for k in self._obs_keys)
        return gym.spaces.Box(-np.inf, np.inf, shape=(dims,), dtype=np.float32)

    def close(self):
        self.env.close()


class AntMazeD4RLWrapper(_FlattenGoalEnv):
    """obs = [achieved_goal (xy, 2) | observation[:27] (qpos[2:] + qvel)]
    = d4rl's 29 dims. gymnasium's Ant-v5 observation appends 78 cfrc_ext
    contact-force dims that the d4rl layout (and the trained normalizers)
    never had: sliced off here. `eval_cells=(goal_cell, reset_cell)` pins
    the fixed d4rl task on every reset (see ANTMAZE_EVAL_CELLS)."""

    _obs_keys = ("achieved_goal", "observation")

    def __init__(self, env, eval_cells=None):
        super().__init__(env)
        self._reset_options = None
        if eval_cells is not None:
            goal_cell, reset_cell = eval_cells
            self._reset_options = {
                "goal_cell": np.asarray(goal_cell, dtype=np.int64),
                "reset_cell": np.asarray(reset_cell, dtype=np.int64),
            }

    def reset(self, **kwargs):
        # vector envs pass options=None explicitly: replace None too
        if self._reset_options is not None and kwargs.get("options") is None:
            kwargs["options"] = self._reset_options
        return super().reset(**kwargs)

    def _flatten(self, obs_dict) -> np.ndarray:
        return np.concatenate(
            [np.ravel(obs_dict["achieved_goal"]),
             np.ravel(obs_dict["observation"])[:27]]
        ).astype(np.float32)

    @property
    def observation_space(self):
        import gymnasium as gym

        return gym.spaces.Box(-np.inf, np.inf, shape=(29,), dtype=np.float32)


class PointMazeD4RLWrapper(_FlattenGoalEnv):
    """obs = observation (4: qpos, qvel) = d4rl's maze2d layout; the goal
    xy (needed by goal-reaching planners) is exposed via `.goal`. If
    `goal_cell` is given, every reset pins the goal there (d4rl's fixed
    per-layout eval target); the reset location stays random."""

    _obs_keys = ("observation",)

    def __init__(self, env, goal_cell=None):
        super().__init__(env)
        self.goal = np.zeros(2, dtype=np.float32)
        self._goal_cell = (None if goal_cell is None
                           else np.asarray(goal_cell, dtype=np.int64))

    def reset(self, **kwargs):
        if self._goal_cell is not None and "options" not in kwargs:
            kwargs["options"] = {"goal_cell": self._goal_cell}
        return super().reset(**kwargs)

    def _flatten(self, obs_dict) -> np.ndarray:
        self.goal = np.asarray(obs_dict["desired_goal"], dtype=np.float32)
        return np.ravel(obs_dict["observation"]).astype(np.float32)


def make_antmaze_env(env_name: str, render_mode=None):
    import gymnasium as gym
    import gymnasium_robotics  # noqa: F401

    gym.register_envs(gymnasium_robotics)
    gid = ANTMAZE_GYM_IDS.get(env_name)
    if gid is None:
        raise ValueError(f"no gymnasium mapping for {env_name}")
    # eval always runs the standard map with the fixed d4rl task pinned:
    # the diverse maps/goal-sets only describe DATA collection. Zero the
    # maze-level position noise so the goal sits exactly on the cell center
    # the dataset rewards were relabeled against (the Ant's own reset noise
    # keeps episodes stochastic); the kwarg isn't plumbed through AntMaze's
    # constructor, so set the attribute post-construction.
    env = gym.make(gid, continuing_task=False, render_mode=render_mode)
    env.unwrapped.position_noise_range = 0.0
    return AntMazeD4RLWrapper(env, eval_cells=ANTMAZE_EVAL_CELLS[env_name])


def make_maze2d_env(env_name: str, render_mode=None):
    """d4rl maze2d eval semantics: the goal is d4rl's FIXED per-layout
    target on every reset (reset location random), reward is 1 per step
    within the goal radius with no termination, and the episode runs the
    full d4rl path length (the evaluation latches
    `finished |= rew == 1; ep_reward += finished` in
    pipelines/runner.py `d4rl_eval_loop`)."""
    import gymnasium as gym
    import gymnasium_robotics  # noqa: F401

    gym.register_envs(gymnasium_robotics)
    gid = MAZE2D_GYM_IDS.get(env_name)
    if gid is None:
        raise ValueError(f"no gymnasium mapping for {env_name}")
    return PointMazeD4RLWrapper(
        gym.make(gid, continuing_task=True, reset_target=False,
                 max_episode_steps=MAZE2D_EVAL_MAX_STEPS[env_name],
                 render_mode=render_mode),
        goal_cell=MAZE2D_EVAL_GOAL_CELL[env_name],
    )

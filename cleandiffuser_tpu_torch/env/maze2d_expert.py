"""Waypoint-expert data for the maze2d (PointMaze) suites (counterpart of
cleandiffuser_tpu/env/maze2d_expert.py).

d4rl generated its maze2d datasets with a scripted waypoint controller:
the point mass drives to randomly drawn goals along a grid shortest path
under PD control, the goal redrawn each time it is reached, and the log is
one continuous stream whose reward == 1 events mark the goal reaches. This
module re-creates that procedure on gymnasium_robotics' MuJoCo-3 PointMaze,
in numpy on the host:

- `_open_cells` and `_bfs_path`: the maze grid's free cells and the
  4-connected shortest path between two of them;
- `WaypointController`: BFS over the grid, then PD control toward the next
  waypoint (d4rl's gains);
- `generate_maze2d_dataset`: runs the controller with
  `continuing_task=True, reset_target=True` and returns the d4rl schema
  {observations, actions, rewards, terminals, timeouts} that
  `DV_D4RLMaze2DSeqDataset` reads. It needs gymnasium_robotics and raises
  ImportError without it.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np

__all__ = ["WaypointController", "generate_maze2d_dataset"]


def _open_cells(maze_map):
    cells = set()
    for r, row in enumerate(maze_map):
        for c, v in enumerate(row):
            if v != 1:
                cells.add((r, c))
    return cells


def _bfs_path(maze_map, start, goal):
    """Shortest 4-connected path start->goal over non-wall cells."""
    open_cells = _open_cells(maze_map)
    if start not in open_cells or goal not in open_cells:
        return [goal]
    prev = {start: None}
    q = deque([start])
    while q:
        cur = q.popleft()
        if cur == goal:
            break
        r, c = cur
        for nxt in ((r + 1, c), (r - 1, c), (r, c + 1), (r, c - 1)):
            if nxt in open_cells and nxt not in prev:
                prev[nxt] = cur
                q.append(nxt)
    if goal not in prev:
        return [goal]
    path, cur = [], goal
    while cur is not None:
        path.append(cur)
        cur = prev[cur]
    return path[::-1]


class WaypointController:
    """Grid-BFS waypoint follower with PD control (d4rl's gains). Like
    d4rl's, it cuts corners at a waypoint hand-off and overshoots at speed,
    which gives the maze2d data its smooth, varied trajectories."""

    def __init__(self, maze, p_gain: float = 10.0, d_gain: float = -1.0,
                 waypoint_threshold: float = 0.25):
        self.maze = maze
        self.p_gain, self.d_gain = p_gain, d_gain
        self.waypoint_threshold = waypoint_threshold
        self._path_xy: list = []
        self._goal_xy: Optional[np.ndarray] = None

    def _replan(self, pos_xy: np.ndarray, goal_xy: np.ndarray) -> None:
        start = tuple(int(v) for v in self.maze.cell_xy_to_rowcol(pos_xy))
        goal = tuple(int(v) for v in self.maze.cell_xy_to_rowcol(goal_xy))
        cells = _bfs_path(self.maze.maze_map, start, goal)
        # waypoints = cell centers along the path, final exact goal xy last
        self._path_xy = [np.asarray(self.maze.cell_rowcol_to_xy(np.array(rc)),
                                    dtype=np.float64) for rc in cells[1:]]
        self._path_xy.append(np.asarray(goal_xy, dtype=np.float64))
        self._goal_xy = np.asarray(goal_xy, dtype=np.float64)

    def act(self, obs4: np.ndarray, goal_xy: np.ndarray) -> np.ndarray:
        pos, vel = obs4[:2].astype(np.float64), obs4[2:4].astype(np.float64)
        goal_xy = np.asarray(goal_xy, dtype=np.float64)
        if self._goal_xy is None or not np.allclose(goal_xy, self._goal_xy):
            self._replan(pos, goal_xy)
        # advance waypoints we are already close to (never drop the last)
        while len(self._path_xy) > 1 and (
            np.linalg.norm(self._path_xy[0] - pos) < self.waypoint_threshold
        ):
            self._path_xy.pop(0)
        target = self._path_xy[0]
        act = self.p_gain * (target - pos) + self.d_gain * vel
        return np.clip(act, -1.0, 1.0).astype(np.float32)


def generate_maze2d_dataset(
    env_name: str,
    n_steps: int = 1_000_000,
    seed: int = 0,
    noise_scale: float = 0.0,
    log_every: int = 0,
) -> Dict[str, np.ndarray]:
    """Roll the waypoint expert on PointMaze's physics for `n_steps` steps
    (d4rl schema out); `noise_scale` adds Gaussian action noise."""
    try:
        import gymnasium as gym
        import gymnasium_robotics
    except ImportError as e:
        raise ImportError(f"generating {env_name} needs gymnasium_robotics, which is not "
                          "installed") from e

    from .d4rl_eval import MAZE2D_GYM_IDS

    gym.register_envs(gymnasium_robotics)
    gid = MAZE2D_GYM_IDS[env_name]
    env = gym.make(gid, continuing_task=True, reset_target=True,
                   max_episode_steps=n_steps + 1)
    rng = np.random.default_rng(seed)
    obs_dict, _ = env.reset(seed=seed)
    ctrl = WaypointController(env.unwrapped.maze)

    obs = np.empty((n_steps, 4), np.float32)
    act = np.empty((n_steps, 2), np.float32)
    rew = np.empty((n_steps,), np.float32)
    for t in range(n_steps):
        o = obs_dict["observation"].astype(np.float32)
        a = ctrl.act(o, obs_dict["desired_goal"])
        if noise_scale > 0:
            a = np.clip(a + rng.normal(0, noise_scale, 2), -1, 1).astype(
                np.float32)
        obs_dict, r, _, _, _ = env.step(a)
        obs[t], act[t], rew[t] = o, a, float(r)
        if log_every and (t + 1) % log_every == 0:
            print(f"[maze2d-expert] {t + 1}/{n_steps} steps, "
                  f"{int(rew[: t + 1].sum())} goals reached", flush=True)
    env.close()
    terminals = np.zeros((n_steps,), np.float32)
    timeouts = np.zeros((n_steps,), np.float32)
    timeouts[-1] = 1.0
    return {"observations": obs, "actions": act, "rewards": rew,
            "terminals": terminals, "timeouts": timeouts}

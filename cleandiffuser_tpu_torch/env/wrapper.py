"""Host env wrappers (counterpart of cleandiffuser_tpu/env/wrapper.py):
`DuckSyncVectorEnv` and the imitation pipelines' `MultiStepWrapper`, with
`repeated_space` and `stack_last_n_obs`, and the video wrappers and
`make_sync_vector_env`, which no pipeline uses. numpy only: the envs step
on the host, and gymnasium is imported only to build a space or a vector
env.

`VideoWrapper` keeps the rendered frames of an episode (every
`steps_per_render` steps, the reset's frame first); `VideoRecordingWrapper`
streams them into a `VideoRecorder`, which writes them through imageio
when it stops (an mp4 needs imageio's ffmpeg backend; a gif does not). Both wrap any env with reset / step / render and pass every
other attribute through.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["DuckSyncVectorEnv", "MultiStepWrapper", "repeated_space", "stack_last_n_obs",
           "VideoRecorder", "VideoWrapper", "VideoRecordingWrapper", "make_sync_vector_env"]


def repeated_space(space, n: int):
    """A Box space stacked n times along a new leading axis."""
    from gymnasium import spaces

    if isinstance(space, spaces.Box):
        return spaces.Box(low=np.repeat(space.low[None], n, axis=0),
                          high=np.repeat(space.high[None], n, axis=0), dtype=space.dtype)
    raise NotImplementedError(type(space))


def stack_last_n_obs(all_obs: Sequence[np.ndarray], n_steps: int) -> np.ndarray:
    """The last n observations stacked, front-padded by repeating the
    oldest one."""
    all_obs = list(all_obs)
    result = np.zeros((n_steps,) + np.shape(all_obs[-1]), dtype=np.asarray(all_obs[-1]).dtype)
    start_idx = -min(n_steps, len(all_obs))
    result[start_idx:] = np.asarray(all_obs[start_idx:])
    if n_steps > len(all_obs):
        result[:start_idx] = result[start_idx]
    return result


class MultiStepWrapper:
    """The receding-horizon interface of the imitation pipelines over any
    env with reset / step / close: the observation is the last
    `n_obs_steps` observations stacked; `step(action_chunk)` runs up to
    `n_action_steps` low-level steps (stopping at a done), with the rewards
    aggregated ("max" by default, or "sum", "mean"). `max_episode_steps`
    ends the episode as truncated. Its spaces are the wrapped env's
    repeated (built on first access)."""

    def __init__(self, env, n_obs_steps: int = 2, n_action_steps: int = 8,
                 max_episode_steps: Optional[int] = None, reward_agg_method: str = "max"):
        self.env = env
        self.max_episode_steps = max_episode_steps
        self.n_obs_steps, self.n_action_steps = n_obs_steps, n_action_steps
        self.reward_agg_method = reward_agg_method
        self.obs: deque = deque(maxlen=n_obs_steps + 1)
        self.reward: List[float] = []
        self.done: List[bool] = []
        self.info = defaultdict(lambda: deque(maxlen=n_obs_steps + 1))

    @property
    def action_space(self):
        return repeated_space(self.env.action_space, self.n_action_steps)

    @property
    def observation_space(self):
        return repeated_space(self.env.observation_space, self.n_obs_steps)

    def reset(self, **kwargs):
        out = self.env.reset(**kwargs)
        obs = out[0] if isinstance(out, tuple) else out
        self.obs = deque([obs], maxlen=self.n_obs_steps + 1)
        self.reward, self.done = [], []
        self.info = defaultdict(lambda: deque(maxlen=self.n_obs_steps + 1))
        return self._get_obs(), {}

    def step(self, action_chunk):
        """action_chunk: (n_action_steps, act_dim)."""
        truncated = False
        for act in action_chunk:
            if self.done and self.done[-1]:
                break
            out = self.env.step(act)
            if len(out) == 5:
                observation, reward, terminated, trunc, info = out
                done = terminated or trunc
            else:
                observation, reward, done, info = out
            self.obs.append(observation)
            self.reward.append(float(reward))
            if self.max_episode_steps is not None and len(self.reward) >= self.max_episode_steps:
                done = truncated = True
            self.done.append(bool(done))
            for k, v in (info or {}).items():
                self.info[k].append(v)
        reward = self._aggregate(self.reward[-len(action_chunk):])
        done = bool(np.any(self.done[-len(action_chunk):])) if self.done else False
        return self._get_obs(), reward, done, truncated, dict(self.info)

    def _get_obs(self):
        return stack_last_n_obs(self.obs, self.n_obs_steps)

    def _aggregate(self, rewards):
        if not rewards:
            return 0.0
        agg = {"max": np.max, "sum": np.sum, "mean": np.mean}.get(self.reward_agg_method)
        if agg is None:
            raise NotImplementedError(self.reward_agg_method)
        return float(agg(rewards))

    def close(self):
        self.env.close()


class DuckSyncVectorEnv:
    """Synchronous vector env over any envs with reset / step / close.

    gymnasium's SyncVectorEnv takes `gym.Env` subclasses only; this one
    takes any object with that interface and keeps the semantics the eval
    loops rely on: batched obs / rew / term / trunc, a reset with an int
    seed seeds sub-env i with seed + i, and a sub-env resets itself (no
    seed) when its episode ends."""

    def __init__(self, env_fns: Sequence[Callable]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.action_space = self.envs[0].action_space
        self.observation_space = self.envs[0].observation_space

    def reset(self, seed=None, **kwargs):
        obs, infos = [], []
        for i, env in enumerate(self.envs):
            o, info = env.reset(seed=None if seed is None else seed + i, **kwargs)
            obs.append(o)
            infos.append(info)
        return np.stack(obs), infos

    def step(self, actions):
        obs, rews, terms, truncs, infos = [], [], [], [], []
        for env, act in zip(self.envs, np.asarray(actions)):
            o, r, te, tr, info = env.step(act)
            if te or tr:
                o, _ = env.reset()
            obs.append(o)
            rews.append(r)
            terms.append(te)
            truncs.append(tr)
            infos.append(info)
        return (np.stack(obs), np.asarray(rews, dtype=np.float64),
                np.asarray(terms), np.asarray(truncs), infos)

    def close(self):
        for env in self.envs:
            env.close()


class VideoRecorder:
    """Video writer through imageio (the format from the path's extension):
    `start(path)`, `add_frame` per frame, `stop()` writes the file."""

    def __init__(self, fps: int = 10):
        self.fps = fps
        self.frames: List[np.ndarray] = []
        self.path: Optional[str] = None

    def start(self, path: str):
        self.path, self.frames = path, []

    def add_frame(self, frame: np.ndarray):
        if self.path is not None:
            self.frames.append(np.asarray(frame, np.uint8))

    def stop(self):
        if self.path is not None and self.frames:
            import imageio

            imageio.mimsave(self.path, self.frames, fps=self.fps)
        self.path, self.frames = None, []


class _Wrapper:
    """Passes every attribute it does not define through to the env."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        if name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()


class VideoWrapper(_Wrapper):
    """The episode's rendered frames: after the reset and every
    `steps_per_render` steps; `get_video()` stacks them (None if none)."""

    def __init__(self, env, mode: str = "rgb_array", enabled: bool = True,
                 steps_per_render: int = 1):
        super().__init__(env)
        self.mode, self.enabled, self.steps_per_render = mode, enabled, steps_per_render
        self.frames: List[np.ndarray] = []
        self.step_count = 0

    def reset(self, **kwargs):
        self.frames, self.step_count = [], 1
        out = self.env.reset(**kwargs)
        if self.enabled:
            self._append_frame()
        return out

    def step(self, action):
        out = self.env.step(action)
        self.step_count += 1
        if self.enabled and self.step_count % self.steps_per_render == 0:
            self._append_frame()
        return out

    def _append_frame(self):
        frame = self.env.render()
        if frame is not None:
            self.frames.append(np.asarray(frame))

    def get_video(self):
        return np.stack(self.frames) if self.frames else None


class VideoRecordingWrapper(_Wrapper):
    """Streams the rendered frames into `video_recorder` (a new
    `VideoRecorder` by default) while `file_path` is set: the frame before
    the reset, then every `steps_per_render` steps; `stop()` writes it."""

    def __init__(self, env, video_recorder: Optional[VideoRecorder] = None,
                 mode: str = "rgb_array", file_path: Optional[str] = None,
                 steps_per_render: int = 1):
        super().__init__(env)
        self.video_recorder = video_recorder or VideoRecorder()
        self.file_path, self.steps_per_render = file_path, steps_per_render
        self.step_count = 0

    def reset(self, **kwargs):
        self.step_count = 1
        self.video_recorder.stop()
        if self.file_path is not None:
            self.video_recorder.start(self.file_path)
            self._record()
        return self.env.reset(**kwargs)

    def step(self, action):
        out = self.env.step(action)
        self.step_count += 1
        if self.file_path is not None and self.step_count % self.steps_per_render == 0:
            self._record()
        return out

    def _record(self):
        frame = self.env.render()
        if frame is not None:
            self.video_recorder.add_frame(frame)

    def stop(self):
        self.video_recorder.stop()


def make_sync_vector_env(env_fns: Sequence[Callable]):
    """gymnasium's SyncVectorEnv over `env_fns` (gymnasium envs)."""
    import gymnasium as gym

    return gym.vector.SyncVectorEnv(list(env_fns))

"""Vector env over duck-typed envs (counterpart of
cleandiffuser_tpu/env/wrapper.py `DuckSyncVectorEnv`; the reference's
`MultiStepWrapper` and video wrappers come with the imitation slice, ROADMAP
queue 1, item 7). numpy only: the envs step on the host."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = ["DuckSyncVectorEnv"]


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

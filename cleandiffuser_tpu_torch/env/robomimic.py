"""Robomimic environment wrappers (counterpart of
cleandiffuser_tpu/env/robomimic.py), import-gated.

robomimic and robosuite are optional: `create_robomimic_env` raises an
ImportError that names them when they are missing (the reference's own
gate on the dependency); the wrappers take any env with robomimic's
`EnvRobosuite` contract (`reset() -> obs dict`, `step(a) -> (obs dict,
reward, done, info)`).

- `RobomimicLowdimWrapper`: `reset() -> (obs, {})` and `step(a) -> (obs,
  reward, done, False, info)`, obs the low-dim keys concatenated (float32).
- `RobomimicImageWrapper`: obs = {"state": the low-dim keys concatenated,
  <image key>: (C, H, W) float in [0, 1]}.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["RobomimicLowdimWrapper", "RobomimicImageWrapper", "create_robomimic_env"]


def _require_robomimic():
    try:
        import robomimic.utils.env_utils  # noqa: F401
        import robomimic.utils.obs_utils  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "robomimic/robosuite are not installed in this environment; "
            "RobomimicDataset (hdf5) works standalone, but live env eval "
            "requires `pip install robomimic robosuite`") from e


def create_robomimic_env(env_meta: Dict, obs_keys: Optional[List[str]] = None,
                         use_image_obs: bool = False, render: bool = False):
    """robomimic's `EnvUtils.create_env_from_metadata` for the hdf5's
    `env_args`."""
    _require_robomimic()
    import robomimic.utils.env_utils as EnvUtils

    return EnvUtils.create_env_from_metadata(env_meta=env_meta, render=render,
                                             render_offscreen=use_image_obs,
                                             use_image_obs=use_image_obs)


class RobomimicLowdimWrapper:
    """A robomimic env in the gymnasium API, its obs keys concatenated."""

    def __init__(self, env, obs_keys=("object", "robot0_eef_pos", "robot0_eef_quat",
                                      "robot0_gripper_qpos")):
        self.env = env
        self.obs_keys = list(obs_keys)

    def _flatten(self, raw_obs) -> np.ndarray:
        return np.concatenate([np.ravel(raw_obs[k]) for k in self.obs_keys]).astype(np.float32)

    def reset(self, **kwargs):
        return self._flatten(self.env.reset()), {}

    def step(self, action):
        raw, reward, done, info = self.env.step(action)
        return self._flatten(raw), float(reward), bool(done), False, info

    def render(self, mode="rgb_array"):
        return self.env.render(mode=mode, height=256, width=256)

    def close(self):
        pass


class RobomimicImageWrapper(RobomimicLowdimWrapper):
    """Adds the camera frames to the observation, as (C, H, W) in [0, 1]."""

    def __init__(self, env, obs_keys=("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos"),
                 image_keys=("agentview_image",)):
        super().__init__(env, obs_keys)
        self.image_keys = list(image_keys)

    def _pack(self, raw_obs):
        obs = {"state": self._flatten(raw_obs)}
        for k in self.image_keys:
            img = np.asarray(raw_obs[k], np.float32)
            if img.max() > 1.0:
                img = img / 255.0
            obs[k] = np.moveaxis(img, -1, 0)
        return obs

    def reset(self, **kwargs):
        return self._pack(self.env.reset()), {}

    def step(self, action):
        raw, reward, done, info = self.env.step(action)
        return self._pack(raw), float(reward), bool(done), False, info

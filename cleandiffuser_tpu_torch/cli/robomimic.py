"""What the four robomimic CLIs share (counterpart of the data and
evaluation parts of pipelines/{dp,dbc}_robomimic{,_image}.py).

- `robomimic_source(args, ...)`: the task's hdf5 (`dataset_path`) when it
  exists, else `fake_robomimic_buffer` demos of the task's dimensions, as
  the JAX CLIs fall back. With `abs_action` the synthetic actions take the
  hdf5 path's rotation_6d transform too, so the stand-in has the shape the
  real demos would give (lift: 10 dims); the JAX CLIs hand the synthetic
  7-dim actions on untransformed.
- `image_shape_meta(args)`: the image pipelines' shape_meta: each camera's
  rgb key and one low_dim "state", the low_dim keys concatenated in the
  config's order, as the datasets serve them.
- `evaluate_lowdim` / `evaluate_image`: `eval_episodes` episodes of at
  most `max_episode_steps` env steps in robomimic's env through the port's
  wrappers, which follow the gymnasium contract (`reset() -> (obs, {})`,
  `step(a) -> (obs, reward, done, truncated, info)`); a chunk (DP) or one
  action (DBC) per call, the rotation_6d actions turned back to axis-angle
  with `abs_action`. Without robomimic and robosuite the env's creation
  raises ImportError, as the reference's does.

Checkpoints: `ckpt_latest` on the save grid, in
`results/torch/<pipeline_name>/<task_name>/`. The task's keys sit under
`task` (robomimic.yaml with `task=<name>`) or at the top (the backbones'
`*_abs.yaml`).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..dataset.dataset_utils import RotationTransformer
from ..dataset.fake import fake_robomimic_buffer
from ..dataset.robomimic import abs_action_transform
from .imitation import task_of

__all__ = ["robomimic_source", "image_shape_meta", "evaluate_lowdim", "evaluate_image"]


def robomimic_source(args, obs_dim: int, image_keys=(), image_size: int = 84):
    """The hdf5 path, or the synthetic demos (module note)."""
    task = task_of(args)
    if Path(task.dataset_path).exists():
        return task.dataset_path
    print(f"[data] no robomimic hdf5 at {task.dataset_path}; synthetic demos", flush=True)
    rb = fake_robomimic_buffer(obs_dim, task.action_dim, image_keys=image_keys,
                               image_size=image_size)
    if args.abs_action:
        rb.data["action"] = abs_action_transform(rb.data["action"], RotationTransformer())
    return rb


def image_shape_meta(args):
    """(the pipeline's shape_meta, the rgb keys sorted, the low_dim keys in
    the config's order)."""
    obs = args.shape_meta.to_dict()["obs"]
    image_keys = sorted(k for k, v in obs.items() if v["type"] == "rgb")
    lowdim_keys = [k for k, v in obs.items() if v["type"] == "low_dim"]
    meta = {"obs": {"state": {"shape": [sum(obs[k]["shape"][0] for k in lowdim_keys)],
                              "type": "low_dim"}}}
    meta["obs"].update({k: obs[k] for k in image_keys})
    return meta, image_keys, lowdim_keys


def _env(args, use_image_obs: bool):
    """robomimic's env from the hdf5's `env_args` (robomimic checked for
    first: without it there is nothing to evaluate on, file or not)."""
    from ..env.robomimic import _require_robomimic, create_robomimic_env

    _require_robomimic()
    import h5py

    with h5py.File(task_of(args).dataset_path) as f:
        env_meta = json.loads(f["data"].attrs["env_args"])
    return create_robomimic_env(env_meta, use_image_obs=use_image_obs)


def _episodes(args, env, dataset, act) -> dict:
    """`eval_episodes` episodes: `act(window) -> (n, act_dim)` normalised
    actions for the window of the last To observations (the first
    repeated at the start)."""
    task, To = task_of(args), args.obs_steps
    norm_a = dataset.normalizer["action"]
    rewards = []
    for ep in range(args.eval_episodes):
        obs, _ = env.reset()
        hist, total, t, done = [obs], 0.0, 0, False
        while t < task.max_episode_steps and not done:
            window = ([hist[0]] * (To - len(hist)) + hist)[-To:]
            actions = norm_a.unnormalize(act(window))
            if args.abs_action:
                actions = dataset.undo_transform_action(actions)
            for a in actions:
                obs, rew, done, _, _ = env.step(a)
                hist.append(obs)
                total += rew
                t += 1
                if done or t >= task.max_episode_steps:
                    break
        rewards.append(total)
        print(f"episode {ep}: reward {total}", flush=True)
    return {"mean_reward": float(np.mean(rewards))}


def _actions(pipe, nobs):
    """A DP chunk (Ta, act) or a DBC action (1, act) for one window."""
    out = pipe.act_chunk(nobs) if hasattr(pipe, "act_chunk") else pipe.act(nobs)[:, None]
    return out[0].cpu().numpy()


def evaluate_lowdim(pipe, dataset, args) -> dict:
    from ..env.robomimic import RobomimicLowdimWrapper

    env = RobomimicLowdimWrapper(_env(args, False))
    norm_o = dataset.normalizer["obs"]["state"]
    return _episodes(args, env, dataset,
                     lambda w: _actions(pipe, norm_o.normalize(np.stack(w)[None])))


def evaluate_image(pipe, dataset, args) -> dict:
    from ..env.robomimic import RobomimicImageWrapper

    _, image_keys, lowdim_keys = image_shape_meta(args)
    env = RobomimicImageWrapper(_env(args, True), obs_keys=lowdim_keys, image_keys=image_keys)
    norm_o = dataset.normalizer["obs"]["state"]

    def act(window):
        obs = {k: np.stack([w[k] for w in window])[None] for k in image_keys}
        obs["state"] = norm_o.normalize(np.stack([w["state"] for w in window])[None])
        return _actions(pipe, obs)

    return _episodes(args, env, dataset, act)

"""The CLIs' training and evaluation loops (counterpart of
cleandiffuser_tpu/pipelines/runner.py).

- `train_loop(step_fn, ...)`: `step_fn(generator) -> log` per step, or,
  when a window trainer is given and the schedule aligns with it,
  `window_fn(generator) -> log` per log window; logs per window (with
  steps/s), saves `ckpt_<step>` and `ckpt_latest` on the save grid, resumes
  from `resume_fn`'s step and realigns an off-grid resume with per-step
  updates first.
- `planner_window_fn(pipe, dataset, args, mesh)`: the pipeline's
  `make_train_scan` window when the config's intervals allow it (and, on a
  mesh, the batch divides its dp size), else None with the reason printed.
- `make_rl_train_scan(pipe, dataset, batch_size, n_steps)`: the window of
  the RL pipelines (DQL, EDP, IDQL): `n_steps` x `pipe.train_step` on device
  gathers, the logs of `pipe.LOG_KEYS` as window means on the device;
  `rl_window_fn(pipe, dataset, args, mesh)` builds it for a CLI, or returns
  None with the reason printed.
- `d4rl_eval_loop(act_fn, env_name, ...)`: vectorised evaluation on the
  gymnasium envs with the reference's per-benchmark reward bookkeeping.

The reference's window is one compiled `lax.scan` program; the port's
(`train_window`) is a host loop over the same steps that keeps every log on
the device, so the host reads the device once per window, not once per
step. The random stream is an explicit `torch.Generator` on the device the
data lives on; a resumed run draws from a fresh stream seeded by the seed
and the resume step, as the reference's `fold_in(PRNGKey(seed), step)`.
"""

from __future__ import annotations

import inspect
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.logger import Logger
from ..utils.ranks import is_writer, rows_of
from ..utils.tensors import default_device

__all__ = ["train_loop", "step_window", "train_window", "planner_window_fn", "make_rl_train_scan",
           "rl_window_fn", "d4rl_eval_loop", "step_generator"]


def step_window(step_fn: Callable[[torch.Generator], Dict[str, torch.Tensor]], n_steps: int,
                keys: Sequence[str], device) -> Callable:
    """`run(generator) -> log`: `n_steps` x `step_fn(generator)`, the logs'
    `keys` summed on the device (a key a step does not log, such as a
    budget-gated second model's loss past its budget, enters as 0) and
    returned as window means, device scalars. No host sync inside the
    window."""
    def run(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        acc = {k: torch.zeros((), device=device) for k in keys}
        for _ in range(n_steps):
            for k, v in step_fn(generator).items():
                acc[k] = acc[k] + v
        return {k: v / n_steps for k, v in acc.items()}

    return run


def train_window(step_fn: Callable, dataset, batch_size: int, n_steps: int,
                 keys: Sequence[str], device) -> Callable:
    """`step_window` of `step_fn(dataset.sample_batch(generator,
    batch_size))`: a step on one batch gathered on the device. A dataset
    placed on a mesh must hand the step its batch tagged as the rank's rows
    (utils/ranks.py), which is what makes the step data-parallel."""
    rows = getattr(dataset, "_mesh_rows", None)

    def step(g):
        batch = dataset.sample_batch(g, batch_size)
        assert rows is None or rows_of(batch) == rows, (
            f"{type(dataset).__name__}.sample_batch lost the rank's rows tag on a mesh")
        return step_fn(batch)

    return step_window(step, n_steps, keys, device)


def _mesh_window_ok(args, mesh) -> bool:
    """Windows run on a mesh too (the placed dataset gathers each rank's
    rows): the batch must divide the mesh's "dp" size, else the reason is
    printed and the per-step path runs, as the reference's runner does."""
    if mesh is None:
        return True
    from ..parallel.mesh import axis_size

    dp = axis_size(mesh, "dp")
    if args.batch_size % dp != 0:
        print(f"[runner] WARNING: batch_size={args.batch_size} does not divide dp={dp} — "
              "falling back to per-step dispatch", flush=True)
        return False
    return True


def _on_log_grid(args, steps_key: str) -> bool:
    """Whether the save interval and the step count are multiples of the log
    interval; prints which is not."""
    for name, value in (("save_interval", args.save_interval),
                        (steps_key, getattr(args, steps_key))):
        if value % args.log_interval != 0:
            print(f"[runner] WARNING: {name}={value} is not a multiple of "
                  f"log_interval={args.log_interval} — falling back to per-step dispatch",
                  flush=True)
            return False
    return True


def planner_window_fn(pipe, dataset, args, mesh,
                      steps_key: str = "diffusion_gradient_steps"):
    """The pipeline's `make_train_scan` window of `log_interval` steps, or
    None (per-step path, with the reason printed) when the pipeline has none
    or the save interval or the step count is off the log grid."""
    if not hasattr(pipe, "make_train_scan"):
        print(f"[runner] WARNING: {type(pipe).__name__} has no make_train_scan — "
              "falling back to per-step dispatch", flush=True)
        return None
    if not _mesh_window_ok(args, mesh) or not _on_log_grid(args, steps_key):
        return None
    return pipe.make_train_scan(dataset, args.batch_size, args.log_interval)


def make_rl_train_scan(pipe, dataset, batch_size: int, n_steps: int) -> Callable:
    """The RL pipelines' window: `run(generator) -> log` takes the `n_steps`
    steps `pipe.train_step(dataset.sample_batch(generator, batch_size))`
    takes one by one, and returns the means of `pipe.LOG_KEYS` as device
    scalars, with no host sync inside the window."""
    return train_window(pipe.train_step, dataset, batch_size, n_steps, pipe.LOG_KEYS,
                        pipe.device)


def rl_window_fn(pipe, dataset, args, mesh):
    """`make_rl_train_scan` of `log_interval` steps for an RL CLI, or None
    (per-step path, with the reason printed) when the save interval or
    `gradient_steps` is off the log grid, or the batch does not divide the
    mesh's dp size."""
    if not _mesh_window_ok(args, mesh) or not _on_log_grid(args, "gradient_steps"):
        return None
    return make_rl_train_scan(pipe, dataset, args.batch_size, args.log_interval)


def step_generator(seed: int, start_step: int, device) -> torch.Generator:
    """The training stream of a run that starts at `start_step`: a generator
    on `device` seeded from (seed, start_step), so a resumed run draws
    afresh."""
    s = int(np.random.SeedSequence([seed, start_step]).generate_state(1, np.uint32)[0])
    return torch.Generator(device=device).manual_seed(s)


def train_loop(
    step_fn: Callable[[torch.Generator], Dict[str, torch.Tensor]],
    gradient_steps: int,
    log_interval: int,
    save_interval: int,
    save_fn: Callable[[str], None],
    logger: Optional[Logger] = None,
    seed: int = 0,
    resume_fn: Optional[Callable[[], int]] = None,
    window_fn: Optional[Callable[[torch.Generator], Dict[str, torch.Tensor]]] = None,
    device=None,
    eval_fn: Optional[Callable[[int], None]] = None,
    eval_interval: int = 0,
    step_key: str = "gradient_steps",
    log_tail: bool = False,
):
    """Generic training loop: `step_fn(generator) -> log` of device scalars.

    Logs window means with the window's steps/s and the step under
    `step_key`, saves `save_fn(str(step))` and `save_fn("latest")` every
    `save_interval` steps, then calls `eval_fn(step)` every `eval_interval`
    steps (0: never), and resumes from `resume_fn()`'s step (on a mesh only
    rank 0 calls `save_fn`). With `log_tail`
    the per-step path also logs the last, shorter window of a step count
    off the log grid (the imitation CLIs log it; the others do not). With `window_fn` (a `make_train_scan` window of
    `log_interval` steps) and a schedule on the window grid, it runs window
    by window; a resume off the grid first realigns with per-step updates
    (then saves "latest", and the numbered checkpoint if the realign ended
    on a save boundary). `device` is where the generator draws (the data's
    device; the CUDA device when None).
    """
    device = default_device(device)
    if not is_writer():  # on a mesh rank 0 saves; every rank reads at resume
        save_fn = lambda tag: None  # noqa: E731
    start_step = 0
    if resume_fn is not None:
        start_step = int(resume_fn())
        if start_step > 0:
            print(f"[train_loop] resuming from step {start_step}")
    generator = step_generator(seed, start_step, device)
    aligned = all(v % log_interval == 0 for v in (save_interval, eval_interval, gradient_steps))

    if (window_fn is not None and start_step % log_interval != 0
            and start_step < gradient_steps and aligned):
        # realign to the window grid with per-step dispatch, then switch
        realign = min(log_interval - start_step % log_interval, gradient_steps - start_step)
        print(f"[train_loop] resume step {start_step} off the {log_interval}-step window "
              f"grid: realigning with {realign} per-step updates", flush=True)
        for _ in range(realign):
            step_fn(generator)
        start_step += realign
        # a crash before the next save would otherwise resume off the grid
        save_fn("latest")
        if start_step % save_interval == 0:
            save_fn(str(start_step))

    if window_fn is not None and start_step % log_interval == 0 and aligned:
        t_window = time.time()
        step = start_step
        while step < gradient_steps:
            log = window_fn(generator)
            step += log_interval
            out = {k: float(v) for k, v in log.items()}
            out[step_key] = step
            now = time.time()
            out["steps_per_sec"] = round(log_interval / max(now - t_window, 1e-9), 2)
            t_window = now
            print(out, flush=True)
            if logger is not None:
                logger.log(out, "train")
            if step % save_interval == 0:
                save_fn(str(step))
                save_fn("latest")
            if eval_fn is not None and eval_interval and step % eval_interval == 0:
                eval_fn(step)
        return
    if window_fn is not None:
        print(f"[train_loop] WARNING: start step {start_step}, save_interval {save_interval}, "
              f"eval_interval {eval_interval} and gradient_steps {gradient_steps} are not all "
              f"on the {log_interval}-step "
              "window grid — running per-step dispatch", flush=True)
    # logs accumulate on the device: one read per key per log window
    log_acc: Dict[str, torch.Tensor] = {}
    t_window = time.time()
    for step in range(start_step, gradient_steps):
        log = step_fn(generator)
        for key, v in log.items():
            log_acc[key] = log_acc.get(key, 0.0) + v
        if (step + 1) % log_interval == 0 or (log_tail and step + 1 == gradient_steps):
            n = (step + 1) % log_interval or log_interval
            out = {k: float(v) / n for k, v in log_acc.items()}
            out[step_key] = step + 1
            now = time.time()
            out["steps_per_sec"] = round(n / max(now - t_window, 1e-9), 2)
            t_window = now
            print(out, flush=True)
            if logger is not None:
                logger.log(out, "train")
            log_acc = {}
        if (step + 1) % save_interval == 0:
            save_fn(str(step + 1))
            save_fn("latest")
        if eval_fn is not None and eval_interval and (step + 1) % eval_interval == 0:
            eval_fn(step + 1)


def d4rl_eval_loop(
    act_fn: Callable[[np.ndarray], np.ndarray],
    env_name: str,
    normalizer,
    num_envs: int,
    num_episodes: int,
    seed: int = 0,
    max_steps: int = 1000,
    logger: Optional[Logger] = None,
    reward_mode: str = "mujoco",
):
    """Vectorised evaluation with the reference's per-benchmark reward
    bookkeeping (numpy, on the host; `act_fn` maps normalised observations
    to actions as a numpy array):

    - "mujoco":  ep_reward += rew * (1 - cum_done) if t < max_steps else rew
    - "antmaze": ep_reward += rew, clipped to [0, 1]
    - "kitchen": ep_reward += rew, clipped to [0, 4], 280-step horizon
    - "maze2d":  finished |= (rew == 1); ep_reward += finished (steps since
                 the goal was first reached)

    An `act_fn` declaring `ep_reward` receives the running per-env episode
    reward; one declaring `goal_normed` the per-env goal xy normalised with
    the state normaliser's first two dims. Returns the normalised scores,
    (num_episodes, num_envs). The envs come from `make_eval_env_fns`
    (gymnasium's MuJoCo envs for the locomotion tasks so far).
    """
    from ..env.wrapper import DuckSyncVectorEnv
    from .data_loading import get_normalized_score_fn, make_eval_env_fns

    if reward_mode == "kitchen":
        max_steps = min(max_steps, 280)
    sig_params = inspect.signature(act_fn).parameters
    wants_rew = "ep_reward" in sig_params
    wants_goal = "goal_normed" in sig_params
    envs = DuckSyncVectorEnv(make_eval_env_fns(env_name, num_envs))
    score_fn = get_normalized_score_fn(env_name)
    clip_hi = {"antmaze": 1.0, "kitchen": 4.0}.get(reward_mode)
    episode_rewards = []
    for ep in range(num_episodes):
        # a block of seeds per episode: sub-env i of episode ep gets
        # seed + ep * num_envs + i, distinct across episodes
        obs, _ = envs.reset(seed=seed + ep * num_envs)
        ep_reward = np.zeros(num_envs)
        cum_done = np.zeros(num_envs)
        finished = np.zeros(num_envs, dtype=bool)
        goal_normed = None
        if wants_goal:
            if not all(hasattr(e, "goal") for e in envs.envs):
                raise ValueError(
                    f"act_fn declares goal_normed but env {env_name} exposes "
                    "no per-env .goal (only maze2d eval wrappers do)")
            goals = np.stack([np.asarray(e.goal, np.float32) for e in envs.envs])
            pad = np.zeros((num_envs, obs.shape[-1] - 2), np.float32)
            goal_normed = normalizer.normalize(np.concatenate([goals, pad], -1))[:, :2]
        t = 0
        while not np.all(cum_done) and t < max_steps + 1:
            nobs = normalizer.normalize(obs)
            kw = {}
            if wants_rew:
                kw["ep_reward"] = ep_reward
            if wants_goal:
                kw["goal_normed"] = goal_normed
            act = np.asarray(act_fn(nobs, **kw))
            obs, rew, term, trunc, _ = envs.step(act)
            done = np.logical_or(term, trunc)
            t += 1
            cum_done = np.logical_or(cum_done, done)
            if reward_mode == "mujoco":
                ep_reward += rew * (1 - cum_done) if t < max_steps else rew
            elif reward_mode == "maze2d":
                finished |= rew == 1.0
                ep_reward += finished
            else:
                ep_reward += rew
        if clip_hi is not None:
            ep_reward = np.clip(ep_reward, 0.0, clip_hi)
        episode_rewards.append([score_fn(r) for r in ep_reward])
        print(f"episode {ep}: {np.mean(episode_rewards[-1]):.3f}")
    episode_rewards = np.array(episode_rewards)
    mean, std = np.mean(episode_rewards, -1), np.std(episode_rewards, -1)
    print(mean, std)
    if logger is not None:
        logger.log({"normalized_score_mean": float(np.mean(episode_rewards)),
                    "normalized_score_std": float(np.std(episode_rewards))}, "inference")
    return episode_rewards

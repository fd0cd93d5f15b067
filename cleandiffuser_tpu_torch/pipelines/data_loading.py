"""Dataset acquisition for the pipelines (counterpart of
cleandiffuser_tpu/pipelines/data_loading.py).

Nothing is downloaded. The resolution order is:

1. a local .npz snapshot at `$CLEANDIFFUSER_DATA/<env_name>[.qlearning].npz`
   (default directory `dev/d4rl`) with the d4rl key schema;
2. the synthetic generator (dataset/fake.py), with a printed warning.

`resolve_pusht_demos(args, device, with_images=False)` gives the PushT
imitation CLIs their demos: the file at `args.dataset_path` when it
exists, else demos made by the on-device MPC expert (or, with
`demo_expert=false`, the scripted pusher), rendered at `image_size` with
`with_images`, cached to that path when it ends in .npz; a cache written
by the JAX package loads here, and the other way round.

`get_normalized_score_fn(env_name)` is d4rl's normalized score, and
`make_eval_env_fns(env_name, n)` the gymnasium eval envs of a d4rl task:
gymnasium's MuJoCo envs for the locomotion tasks (`HalfCheetah-v5`,
`Hopper-v5`, `Walker2d-v5`), the gymnasium_robotics envs in the d4rl
layouts for antmaze, maze2d and kitchen (env/d4rl_eval.py, env/kitchen.py).
gymnasium and gymnasium_robotics are imported only there, so the package
imports where they are not installed.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import numpy as np

from ..dataset.fake import fake_d4rl_dataset, fake_d4rl_qlearning_dataset
from ..utils.ranks import is_writer

__all__ = ["load_d4rl_dataset", "load_d4rl_qlearning_dataset", "data_dir", "resolve_pusht_demos",
           "D4RL_SCORE_RANGES", "get_normalized_score_fn", "make_eval_env_fns"]

# d4rl's (random, expert) returns per task prefix; the sparse-reward suites
# score a (clipped) task-completion count
D4RL_SCORE_RANGES = {
    "halfcheetah": (-280.178953, 12135.0),
    "hopper": (-20.272305, 3234.3),
    "walker2d": (1.629008, 4592.3),
    "antmaze": (0.0, 1.0),
    "kitchen": (0.0, 4.0),
    "maze2d-umaze": (23.85, 161.86),
    "maze2d-medium": (13.13, 277.39),
    "maze2d-large": (6.7, 273.99),
}
# gymnasium's MuJoCo envs standing in for the d4rl locomotion tasks
GYM_LOCOMOTION = {"halfcheetah": "HalfCheetah-v5", "hopper": "Hopper-v5",
                  "walker2d": "Walker2d-v5"}
KITCHEN_EVAL_TASKS = ["microwave", "kettle", "bottom burner", "light switch"]


def data_dir() -> Path:
    """Where snapshots are looked for: `$CLEANDIFFUSER_DATA`, else dev/d4rl."""
    return Path(os.environ.get("CLEANDIFFUSER_DATA", "dev/d4rl"))


def _try_npz(path: Path):
    if path.exists():
        arrs = np.load(path)
        return {k: arrs[k] for k in arrs.files}
    return None


def load_d4rl_dataset(env_name: str) -> Dict[str, np.ndarray]:
    """`env.get_dataset()`'s dict: the snapshot, else synthetic data."""
    path = data_dir() / f"{env_name}.npz"
    data = _try_npz(path)
    if data is not None:
        return data
    print(f"[data] no snapshot at {path}; using SYNTHETIC data (hermetic mode)")
    return fake_d4rl_dataset(env_name, n_steps=100_000, ep_len=1000)


def load_d4rl_qlearning_dataset(env_name: str) -> Dict[str, np.ndarray]:
    """`d4rl.qlearning_dataset(env)`'s dict: the snapshot, else synthetic."""
    path = data_dir() / f"{env_name}.qlearning.npz"
    data = _try_npz(path)
    if data is not None:
        return data
    print(f"[data] no snapshot at {path}; using SYNTHETIC data (hermetic mode)")
    return fake_d4rl_qlearning_dataset(env_name, n_steps=100_000, ep_len=1000)


def get_normalized_score_fn(env_name: str):
    """d4rl's normalized score of a return: the longest matching prefix of
    `D4RL_SCORE_RANGES`, else the identity."""
    best = None
    for prefix, rng in D4RL_SCORE_RANGES.items():
        if env_name.startswith(prefix) and (best is None or len(prefix) > len(best[0])):
            best = (prefix, rng)
    if best is not None:
        lo, hi = best[1]
        return lambda ret: (ret - lo) / (hi - lo)
    return lambda ret: ret


def make_eval_env_fns(env_name: str, num_envs: int):
    """`num_envs` thunks of the gymnasium eval env of a d4rl task. The
    antmaze, maze2d and kitchen envs need gymnasium_robotics: without it
    the call raises ImportError; no other env stands in."""
    if env_name.startswith(("antmaze", "maze2d", "kitchen")):
        try:
            import gymnasium_robotics  # noqa: F401
        except ImportError as e:
            raise ImportError(f"the {env_name} eval env needs gymnasium_robotics, which is "
                              "not installed") from e
    if env_name.startswith("antmaze"):
        from ..env.d4rl_eval import make_antmaze_env

        return [(lambda: make_antmaze_env(env_name)) for _ in range(num_envs)]
    if env_name.startswith("maze2d"):
        from ..env.d4rl_eval import make_maze2d_env

        return [(lambda: make_maze2d_env(env_name)) for _ in range(num_envs)]
    if env_name.startswith("kitchen"):
        from ..env.kitchen import make_kitchen_env

        # the mixed and partial datasets both evaluate on this 4-task goal set
        return [(lambda: make_kitchen_env(KITCHEN_EVAL_TASKS)) for _ in range(num_envs)]
    import gymnasium as gym

    for prefix, gid in GYM_LOCOMOTION.items():
        if env_name.startswith(prefix):
            return [lambda: gym.make(gid) for _ in range(num_envs)]
    raise ValueError(f"no gymnasium mapping for {env_name}")


def resolve_pusht_demos(args, device=None, with_images: bool = False, image_size: int = 96):
    """The PushT demos of a dp / dbc CLI: the path `args.dataset_path` if it
    exists (a reference zarr store or an .npz export of one: drop in
    pusht_cchi_v7_replay to train on the human demos), else a fresh
    ReplayBuffer of `demo_episodes` episodes of at most `demo_max_steps`
    steps from the MPC expert on `device` (`demo_expert`, the default; all
    episodes in one rollout unless `demo_batch` is set; `demo_noise` > 0 adds
    DART execution noise) or from the scripted pusher, with `with_images`
    each state rendered at `image_size` ("img"), saved to the path when it
    ends in .npz."""
    path = Path(args.dataset_path)
    if path.exists():
        return str(path)
    from ..dataset.pusht import generate_pusht_demos

    expert = bool(args.get("demo_expert", True))
    n_episodes = int(args.get("demo_episodes", 64))
    max_steps = int(args.get("demo_max_steps", 300 if expert else 200))
    kind = "MPC-expert" if expert else "scripted"
    cache_note = (f"cached to {path}" if path.suffix == ".npz" else
                  f"NOT cached: {path} is not .npz, regenerated every run")
    print(f"[data] no dataset at {path}; generating {n_episodes} {kind} demos ({cache_note})",
          flush=True)
    noise = float(args.get("demo_noise", 0.0))
    batch = args.get("demo_batch")
    rb = generate_pusht_demos(n_episodes=n_episodes, max_steps=max_steps, seed=args.seed,
                              expert=expert,
                              mpc_kwargs={"exec_noise_prob": noise} if noise > 0.0 else None,
                              batch=None if batch is None else int(batch), device=device,
                              with_images=with_images, image_size=image_size)
    if path.suffix == ".npz" and is_writer():  # on a mesh every rank made the same demos
        path.parent.mkdir(parents=True, exist_ok=True)
        rb.save_npz(str(path))
    return rb

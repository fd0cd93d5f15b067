"""Diffusion Policy on Franka Kitchen: the port's CLI (counterpart of
pipelines/dp_kitchen.py), reading the same `configs/dp/kitchen` tree.

    python -m cleandiffuser_tpu_torch.cli.dp_kitchen mode=train nn=chi_unet
    python -m cleandiffuser_tpu_torch.cli.dp_kitchen mode=train --config-name=kitchen_abs
    python -m cleandiffuser_tpu_torch.cli.dp_kitchen mode=inference

`nn=<chi_unet|chi_transformer|dit>` picks the backbone's directory (each
holds kitchen.yaml and kitchen_abs.yaml; the directory's kitchen.yaml is
the JAX CLI's top-level one). Data: the relay-policy-learning .npy archive
in `dataset_dir`, or with `abs_action` its raw .mjl logs; without either,
8 synthetic episodes of 200 steps (numpy, from `seed`), as the JAX CLI
makes them. Evaluation steps gymnasium_robotics' FrankaKitchen through
`MultiStepWrapper` on the host, `eval_episodes` episodes of at most
`max_episode_steps` steps, one `act_chunk` per `action_steps`; it needs
gymnasium_robotics and raises ImportError without it. Runs on the CUDA
device unless `platform=cpu`.
"""

import sys
from pathlib import Path

import numpy as np

from ..dataset import KitchenDataset, KitchenMjlDataset, ReplayBuffer
from ..pipelines import DPPipeline
from ..utils.config import resolve_config_cli
from .imitation import run_imitation_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dp/kitchen/chi_unet"


def load_or_fake(dataset_dir, obs_dim: int, act_dim: int):
    """The archive directory, or 8 synthetic episodes of 200 steps."""
    p = Path(dataset_dir)
    if (p / "observations_seq.npy").exists():
        return p
    print(f"[data] no kitchen archive at {p}; using synthetic demos", flush=True)
    rb = ReplayBuffer.create_empty_numpy()
    for _ in range(8):
        rb.add_episode({"state": np.random.randn(200, obs_dim).astype(np.float32),
                        "action": np.random.uniform(-1, 1, (200, act_dim)).astype(np.float32)})
    return rb


def kitchen_dataset(args, device, pad_after: int):
    """The .mjl demos with `abs_action` where the directory has them, else
    the archive (or the synthetic demos)."""
    kw = dict(horizon=args.horizon, pad_before=args.obs_steps - 1, pad_after=pad_after,
              device=device)
    if args.abs_action and any(Path(args.dataset_dir).glob("*/*.mjl")):
        return KitchenMjlDataset(args.dataset_dir, abs_action=True, **kw)
    return KitchenDataset(load_or_fake(args.dataset_dir, args.obs_dim, args.action_dim),
                          abs_action=args.abs_action, **kw)


def build(args, device, dataset=None):
    if dataset is None:
        dataset = kitchen_dataset(args, device, args.action_steps - 1)
    pipe = DPPipeline(obs_dim=args.obs_dim, action_dim=args.action_dim, horizon=args.horizon,
                      obs_steps=args.obs_steps, action_steps=args.action_steps, nn=args.nn,
                      diffusion=args.diffusion, sample_steps=args.sample_steps, lr=args.lr,
                      gradient_steps=args.gradient_steps, ema_rate=args.ema_rate, rng=args.seed,
                      device=device)
    return dataset, pipe


def kitchen_episodes(args, act, n_action_steps: int, steps_per_act: int) -> dict:
    """`eval_episodes` FrankaKitchen episodes through MultiStepWrapper:
    `act(nobs (1, To, obs)) -> (n_action_steps, act)` actions per call."""
    from ..env.kitchen import make_kitchen_env
    from ..env.wrapper import MultiStepWrapper

    rewards, steps = [], []
    for ep in range(args.eval_episodes):
        env = MultiStepWrapper(make_kitchen_env(list(args.kitchen_tasks)),
                               n_obs_steps=args.obs_steps, n_action_steps=n_action_steps,
                               max_episode_steps=args.max_episode_steps)
        obs, _ = env.reset(seed=args.seed + ep)
        total, t = 0.0, 0
        while t < args.max_episode_steps:
            obs, rew, done, _, _ = env.step(act(obs[None].astype(np.float32)))
            total += rew
            t += steps_per_act
            if done:
                break
        env.close()
        rewards.append(total)
        steps.append(t)
    return {"mean_reward": float(np.mean(rewards)), "mean_steps": float(np.mean(steps))}


def evaluate(pipe, dataset, args):
    norm_o, norm_a = dataset.normalizer["obs"]["state"], dataset.normalizer["action"]
    act = lambda o: norm_a.unnormalize(pipe.act_chunk(norm_o.normalize(o)).cpu().numpy())[0]
    return kitchen_episodes(args, act, args.action_steps, args.action_steps)


def pipeline(args):
    run_imitation_cli(args, build, evaluate)


if __name__ == "__main__":
    pipeline(resolve_config_cli(CONFIG_DIR, "kitchen", sys.argv[1:], nn_key="nn"))

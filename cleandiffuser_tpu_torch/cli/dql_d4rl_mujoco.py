"""Diffusion-QL on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/dql_d4rl_mujoco.py), reading the same `configs/dql/mujoco` tree.

    python -m cleandiffuser_tpu_torch.cli.dql_d4rl_mujoco mode=train task=halfcheetah-medium-v2
    python -m cleandiffuser_tpu_torch.cli.dql_d4rl_mujoco mode=inference num_envs=10

Set-up, training and checkpoints as in cli/rl.py `run_rl_cli`; with
`resume=true` training resumes from `ckpt_latest`. `mode=inference` is the
reference CLI's own loop over gymnasium's MuJoCo envs (episodes of at most
`MAX_STEPS` steps), `num_candidates` actions per env per step scored by the
critic. `eta` and `weight_temperature` come from the task file.
"""

import sys
from pathlib import Path

import numpy as np

from ..dataset import D4RLMuJoCoTDDataset
from ..pipelines import DQLPipeline
from ..pipelines.data_loading import (
    get_normalized_score_fn,
    load_d4rl_qlearning_dataset,
    make_eval_env_fns,
)
from ..utils.config import load_config, parse_cli
from .rl import run_rl_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dql/mujoco"
MAX_STEPS = 1000  # d4rl's locomotion episode length


def build(args, device, pipeline_cls=None, dataset=None, **pipe_kw):
    """The config's dataset and pipeline (DQL's, or EDP's, which takes the
    same keys; DQL's by default) on `device`. Another suite's CLI passes its
    `dataset` and pipeline arguments (`max_q_backup`); a config without
    `predict_noise` leaves it to the pipeline's default (EDP's antmaze and
    kitchen configs)."""
    if dataset is None:
        dataset = D4RLMuJoCoTDDataset(load_d4rl_qlearning_dataset(args.task.env_name),
                                      args.normalize_reward, device=device)
    if args.get("predict_noise") is not None:
        pipe_kw["predict_noise"] = args.predict_noise
    pipe = (pipeline_cls or DQLPipeline)(
        obs_dim=dataset.o_dim, act_dim=dataset.a_dim,
        diffusion_steps=args.diffusion_steps, sampling_steps=args.sampling_steps,
        solver=args.solver, hidden_dim=args.hidden_dim,
        actor_lr=args.actor_learning_rate, critic_lr=args.critic_learning_rate,
        gradient_steps=args.gradient_steps, discount=args.discount, eta=args.task.eta,
        ema_rate=args.ema_rate, ema_update_interval=args.ema_update_interval,
        rng=args.seed, device=device, **pipe_kw,
    )
    return dataset, pipe


def inference(act, dataset, args, logger):
    normalizer = dataset.get_normalizer()
    score_fn = get_normalized_score_fn(args.task.env_name)
    import gymnasium as gym

    envs = gym.vector.SyncVectorEnv(make_eval_env_fns(args.task.env_name, args.num_envs))
    episode_rewards = []
    for ep in range(args.num_episodes):
        # per-episode seed block (vector reset seeds sub-envs [s..s+n-1])
        obs, _ = envs.reset(seed=args.seed + ep * args.num_envs)
        ep_reward, cum_done, t = np.zeros(args.num_envs), np.zeros(args.num_envs), 0
        while not np.all(cum_done) and t < MAX_STEPS + 1:
            obs, rew, term, trunc, _ = envs.step(act(normalizer.normalize(obs)).cpu().numpy())
            done = np.logical_or(term, trunc)
            t += 1
            cum_done = np.logical_or(cum_done, done)
            ep_reward += rew * (1 - cum_done) if t < MAX_STEPS else rew
        episode_rewards.append([score_fn(r) for r in ep_reward])
        print(f"episode {ep}: {np.mean(episode_rewards[-1]):.3f}")
    episode_rewards = np.array(episode_rewards)
    print(np.mean(episode_rewards, -1), np.std(episode_rewards, -1))
    logger.log({"normalized_score_mean": float(np.mean(episode_rewards))}, "inference")


def pipeline(args):
    run_rl_cli(args, build, args.task.weight_temperature, inference=inference, resume=True)


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

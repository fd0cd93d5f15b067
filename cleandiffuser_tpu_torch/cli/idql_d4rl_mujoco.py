"""IDQL on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/idql_d4rl_mujoco.py), reading the same `configs/idql/mujoco` tree.

    python -m cleandiffuser_tpu_torch.cli.idql_d4rl_mujoco mode=train task=halfcheetah-medium-v2
    python -m cleandiffuser_tpu_torch.cli.idql_d4rl_mujoco mode=inference ckpt=latest

Set-up, training, checkpoints and `mode=inference` (`d4rl_eval_loop` over
gymnasium's MuJoCo envs) as in cli/rl.py `run_rl_cli`; `num_candidates`
actions per env per step (256 shipped) scored by the advantage min-Q - V.
"""

import sys
from pathlib import Path

from ..dataset import D4RLMuJoCoTDDataset
from ..pipelines import IDQLPipeline
from ..pipelines.data_loading import load_d4rl_qlearning_dataset
from ..utils.config import load_config, parse_cli
from .rl import run_rl_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/idql/mujoco"


def build(args, device, dataset=None):
    """The config's dataset (or another suite's `dataset`) and pipeline on
    `device`."""
    if dataset is None:
        dataset = D4RLMuJoCoTDDataset(load_d4rl_qlearning_dataset(args.task.env_name),
                                      args.normalize_reward, device=device)
    pipe = IDQLPipeline(
        obs_dim=dataset.o_dim, act_dim=dataset.a_dim,
        diffusion_steps=args.diffusion_steps, sampling_steps=args.sampling_steps,
        solver=args.solver, actor_hidden_dim=args.actor_hidden_dim,
        actor_n_blocks=args.actor_n_blocks, actor_dropout=args.actor_dropout,
        critic_hidden_dim=args.critic_hidden_dim,
        actor_lr=args.actor_learning_rate, critic_lr=args.critic_learning_rate,
        gradient_steps=args.gradient_steps, discount=args.discount,
        iql_tau=args.iql_tau, ema_rate=args.ema_rate,
        predict_noise=args.predict_noise, rng=args.seed, device=device,
    )
    return dataset, pipe


def pipeline(args):
    run_rl_cli(args, build, args.weight_temperature)


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

"""Diffusion-QL on D4RL-Kitchen: the port's CLI (counterpart of
pipelines/dql_d4rl_kitchen.py), reading the same `configs/dql/kitchen` tree.

    python -m cleandiffuser_tpu_torch.cli.dql_d4rl_kitchen mode=train task=kitchen-mixed-v0
    python -m cleandiffuser_tpu_torch.cli.dql_d4rl_kitchen mode=inference ckpt=latest

As cli/dql_d4rl_mujoco.py on the suite's transitions (`D4RLKitchenTDDataset`,
the data's rewards), with `max_q_backup=0`; `resume=true` resumes training from
`ckpt_latest`. `mode=inference` is `d4rl_eval_loop` in its "kitchen"
reward mode on gymnasium_robotics' eval env.
"""

import sys
from pathlib import Path

from ..dataset import D4RLKitchenTDDataset
from ..pipelines.data_loading import load_d4rl_qlearning_dataset
from ..utils.config import load_config, parse_cli
from . import dql_d4rl_mujoco
from .rl import run_rl_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dql/kitchen"


def build(args, device, pipeline_cls=None):
    """The config's dataset and pipeline (DQL's, or EDP's) on `device`."""
    dataset = D4RLKitchenTDDataset(load_d4rl_qlearning_dataset(args.task.env_name), device=device)
    return dql_d4rl_mujoco.build(args, device, pipeline_cls, dataset, max_q_backup=0)


def pipeline(args):
    run_rl_cli(args, build, args.task.weight_temperature, resume=True, reward_mode="kitchen")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "kitchen", parse_cli(sys.argv[1:])))

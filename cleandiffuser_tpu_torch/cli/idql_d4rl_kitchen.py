"""IDQL on D4RL-Kitchen: the port's CLI (counterpart of
pipelines/idql_d4rl_kitchen.py), reading the same `configs/idql/kitchen` tree.

    python -m cleandiffuser_tpu_torch.cli.idql_d4rl_kitchen mode=train task=kitchen-mixed-v0
    python -m cleandiffuser_tpu_torch.cli.idql_d4rl_kitchen mode=inference ckpt=latest

As cli/idql_d4rl_mujoco.py on the suite's transitions (`D4RLKitchenTDDataset`,
the data's rewards), with the task file's `weight_temperature`.
`mode=inference` is `d4rl_eval_loop` in its "kitchen" reward mode.
"""

import sys
from pathlib import Path

from ..dataset import D4RLKitchenTDDataset
from ..pipelines.data_loading import load_d4rl_qlearning_dataset
from ..utils.config import load_config, parse_cli
from . import idql_d4rl_mujoco
from .rl import run_rl_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/idql/kitchen"


def build(args, device):
    dataset = D4RLKitchenTDDataset(load_d4rl_qlearning_dataset(args.task.env_name), device=device)
    return idql_d4rl_mujoco.build(args, device, dataset)


def pipeline(args):
    run_rl_cli(args, build, args.task.weight_temperature, reward_mode="kitchen")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "kitchen", parse_cli(sys.argv[1:])))

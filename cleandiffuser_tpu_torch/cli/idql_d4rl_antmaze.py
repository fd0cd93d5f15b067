"""IDQL on D4RL-Antmaze: the port's CLI (counterpart of
pipelines/idql_d4rl_antmaze.py), reading the same `configs/idql/antmaze` tree.

    python -m cleandiffuser_tpu_torch.cli.idql_d4rl_antmaze mode=train task=antmaze-medium-play-v2
    python -m cleandiffuser_tpu_torch.cli.idql_d4rl_antmaze mode=inference ckpt=latest

As cli/idql_d4rl_mujoco.py on the suite's transitions (`D4RLAntmazeTDDataset`,
the "iql" reward tune (reward - 1)), with the task file's `weight_temperature`.
`mode=inference` is `d4rl_eval_loop` in its "antmaze" reward mode.
"""

import sys
from pathlib import Path

from ..dataset import D4RLAntmazeTDDataset
from ..pipelines.data_loading import load_d4rl_qlearning_dataset
from ..utils.config import load_config, parse_cli
from . import idql_d4rl_mujoco
from .rl import run_rl_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/idql/antmaze"


def build(args, device):
    dataset = D4RLAntmazeTDDataset(load_d4rl_qlearning_dataset(args.task.env_name), device=device)
    return idql_d4rl_mujoco.build(args, device, dataset)


def pipeline(args):
    run_rl_cli(args, build, args.task.weight_temperature, reward_mode="antmaze")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "antmaze", parse_cli(sys.argv[1:])))

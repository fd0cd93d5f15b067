"""EDP on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/edp_d4rl_mujoco.py), reading the same `configs/edp/mujoco` tree.

    python -m cleandiffuser_tpu_torch.cli.edp_d4rl_mujoco mode=train task=halfcheetah-medium-v2
    python -m cleandiffuser_tpu_torch.cli.edp_d4rl_mujoco mode=inference ckpt=latest

Set-up, training, checkpoints and `mode=inference` (`d4rl_eval_loop` over
gymnasium's MuJoCo envs) as in cli/rl.py `run_rl_cli`; `num_candidates`
actions per env per step scored by the critic. The dataset and pipeline
are built as DQL's; `eta` and `weight_temperature` come from the task file.
"""

import sys
from pathlib import Path

from ..pipelines import EDPPipeline
from ..utils.config import load_config, parse_cli
from . import dql_d4rl_mujoco
from .rl import run_rl_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/edp/mujoco"


def build(args, device):
    return dql_d4rl_mujoco.build(args, device, EDPPipeline)


def pipeline(args):
    run_rl_cli(args, build, args.task.weight_temperature)


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

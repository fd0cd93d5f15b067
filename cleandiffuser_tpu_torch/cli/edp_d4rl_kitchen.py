"""EDP on D4RL-Kitchen: the port's CLI (counterpart of
pipelines/edp_d4rl_kitchen.py), reading the same `configs/edp/kitchen` tree.

    python -m cleandiffuser_tpu_torch.cli.edp_d4rl_kitchen mode=train task=kitchen-mixed-v0
    python -m cleandiffuser_tpu_torch.cli.edp_d4rl_kitchen mode=inference ckpt=latest

Built as DQL's kitchen CLI builds (cli/dql_d4rl_kitchen.py), with EDP's
pipeline and its default `predict_noise` (the config has no such key);
`resume=true` resumes training from `ckpt_latest`. `mode=inference` is
`d4rl_eval_loop` in its "kitchen" reward mode.
"""

import sys
from pathlib import Path

from ..pipelines import EDPPipeline
from ..utils.config import load_config, parse_cli
from . import dql_d4rl_kitchen
from .rl import run_rl_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/edp/kitchen"


def build(args, device):
    return dql_d4rl_kitchen.build(args, device, EDPPipeline)


def pipeline(args):
    run_rl_cli(args, build, args.task.weight_temperature, resume=True, reward_mode="kitchen")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "kitchen", parse_cli(sys.argv[1:])))

"""EDP on D4RL-Antmaze: the port's CLI (counterpart of
pipelines/edp_d4rl_antmaze.py), reading the same `configs/edp/antmaze` tree.

    python -m cleandiffuser_tpu_torch.cli.edp_d4rl_antmaze mode=train task=antmaze-medium-play-v2
    python -m cleandiffuser_tpu_torch.cli.edp_d4rl_antmaze mode=inference ckpt=latest

Built as DQL's antmaze CLI builds (cli/dql_d4rl_antmaze.py), with EDP's
pipeline and its default `predict_noise` (the config has no such key);
`resume=true` resumes training from `ckpt_latest`. `mode=inference` is
`d4rl_eval_loop` in its "antmaze" reward mode.
"""

import sys
from pathlib import Path

from ..pipelines import EDPPipeline
from ..utils.config import load_config, parse_cli
from . import dql_d4rl_antmaze
from .rl import run_rl_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/edp/antmaze"


def build(args, device):
    return dql_d4rl_antmaze.build(args, device, EDPPipeline)


def pipeline(args):
    run_rl_cli(args, build, args.task.weight_temperature, resume=True, reward_mode="antmaze")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "antmaze", parse_cli(sys.argv[1:])))

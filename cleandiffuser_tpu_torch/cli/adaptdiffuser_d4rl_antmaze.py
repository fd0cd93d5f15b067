"""AdaptDiffuser on D4RL-Antmaze: the port's CLI (counterpart of
pipelines/adaptdiffuser_d4rl_antmaze.py), reading the same
`configs/adaptdiffuser/antmaze` tree (whose default mode is inference).

    python -m cleandiffuser_tpu_torch.cli.adaptdiffuser_d4rl_antmaze mode=train task=antmaze-medium-play-v2
    python -m cleandiffuser_tpu_torch.cli.adaptdiffuser_d4rl_antmaze mode=finetune
    python -m cleandiffuser_tpu_torch.cli.adaptdiffuser_d4rl_antmaze mode=inference ckpt=finetuned_latest

The modes of cli/adaptdiffuser_d4rl_mujoco.py on the suite's dataset (as
cli/diffuser_d4rl_antmaze.py builds it), evaluated by `d4rl_eval_loop` in
its "antmaze" reward mode.
"""

import sys
from pathlib import Path

from ..pipelines import AdaptDiffuserPipeline
from ..utils.config import load_config, parse_cli
from . import adaptdiffuser_d4rl_mujoco, diffuser_d4rl_antmaze

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/adaptdiffuser/antmaze"


def build(args, device):
    return diffuser_d4rl_antmaze.build(args, device, AdaptDiffuserPipeline)


def pipeline(args):
    adaptdiffuser_d4rl_mujoco.pipeline(args, build, reward_mode="antmaze")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "antmaze", parse_cli(sys.argv[1:])))

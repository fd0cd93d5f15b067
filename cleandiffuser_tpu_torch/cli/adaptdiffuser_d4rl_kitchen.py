"""AdaptDiffuser on D4RL-Kitchen: the port's CLI (counterpart of
pipelines/adaptdiffuser_d4rl_kitchen.py), reading the same
`configs/adaptdiffuser/kitchen` tree (whose default mode is inference).

    python -m cleandiffuser_tpu_torch.cli.adaptdiffuser_d4rl_kitchen mode=train task=kitchen-mixed-v0
    python -m cleandiffuser_tpu_torch.cli.adaptdiffuser_d4rl_kitchen mode=finetune
    python -m cleandiffuser_tpu_torch.cli.adaptdiffuser_d4rl_kitchen mode=inference ckpt=finetuned_latest

The modes of cli/adaptdiffuser_d4rl_mujoco.py on the suite's dataset (as
cli/diffuser_d4rl_kitchen.py builds it), evaluated by `d4rl_eval_loop` in
its "kitchen" reward mode.
"""

import sys
from pathlib import Path

from ..pipelines import AdaptDiffuserPipeline
from ..utils.config import load_config, parse_cli
from . import adaptdiffuser_d4rl_mujoco, diffuser_d4rl_kitchen

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/adaptdiffuser/kitchen"


def build(args, device):
    return diffuser_d4rl_kitchen.build(args, device, AdaptDiffuserPipeline)


def pipeline(args):
    adaptdiffuser_d4rl_mujoco.pipeline(args, build, reward_mode="kitchen")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "kitchen", parse_cli(sys.argv[1:])))

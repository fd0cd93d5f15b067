"""SynthER on D4RL-Kitchen: the port's CLI (counterpart of
pipelines/synther_d4rl_kitchen.py), reading the same `configs/synther/kitchen`
tree.

    python -m cleandiffuser_tpu_torch.cli.synther_d4rl_kitchen mode=train_diffusion \
        task=kitchen-mixed-v0

As cli/synther_d4rl_mujoco.py (every mode) on the suite's transitions
(`D4RLKitchenTDDataset`); `mode=inference` is `d4rl_eval_loop` in its
"kitchen" reward mode.
"""

import sys
from pathlib import Path

from ..dataset import D4RLKitchenTDDataset
from ..utils.config import load_config, parse_cli
from . import synther_d4rl_mujoco

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/synther/kitchen"


def td_dataset(args, raw, device):
    return D4RLKitchenTDDataset(raw, device=device)


def build(args, device):
    return synther_d4rl_mujoco.build(args, device, td_dataset)


def pipeline(args):
    synther_d4rl_mujoco.pipeline(args, td_dataset, reward_mode="kitchen")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "kitchen", parse_cli(sys.argv[1:])))

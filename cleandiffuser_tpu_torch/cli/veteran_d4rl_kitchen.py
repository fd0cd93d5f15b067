"""Diffusion Veteran on D4RL-Kitchen: the port's CLI (counterpart of
pipelines/veteran_d4rl_kitchen.py), reading the same `configs/veteran/kitchen`
tree.

    python -m cleandiffuser_tpu_torch.cli.veteran_d4rl_kitchen mode=train task=kitchen-mixed-v0

The modes of cli/veteran_d4rl_mujoco.py on the suite's datasets
(`DV_D4RLKitchenSeqDataset`, `D4RLKitchenTDDataset`) and the "kitchen"
reward mode. `mode=inference` steps gymnasium_robotics' FrankaKitchen.
"""

import sys
from pathlib import Path

from ..dataset import D4RLKitchenTDDataset, DV_D4RLKitchenSeqDataset
from ..pipelines.data_loading import load_d4rl_dataset, load_d4rl_qlearning_dataset
from ..utils.config import load_config, parse_cli
from . import veteran_d4rl_mujoco

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/veteran/kitchen"


def build(args, device, dataset=None):
    """The suite's sequence dataset (unless given) and pipeline on `device`."""
    if dataset is None:
        dataset = DV_D4RLKitchenSeqDataset(
            load_d4rl_dataset(args.task.env_name), horizon=args.task.planner_horizon,
            discount=args.discount, center_mapping=(args.guidance_type != "cfg"),
            stride=args.task.stride, device=device,
        )
    return veteran_d4rl_mujoco.build(args, device, dataset)


def td_dataset(args, device):
    return D4RLKitchenTDDataset(load_d4rl_qlearning_dataset(args.task.env_name), device=device)


def pipeline(args):
    veteran_d4rl_mujoco.pipeline(args, build, td_dataset, reward_mode="kitchen",
                                 save_dir=args.pipeline_name)


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "kitchen", parse_cli(sys.argv[1:])))

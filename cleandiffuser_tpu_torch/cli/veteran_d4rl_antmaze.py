"""Diffusion Veteran on D4RL-Antmaze: the port's CLI (counterpart of
pipelines/veteran_d4rl_antmaze.py), reading the same `configs/veteran/antmaze`
tree.

    python -m cleandiffuser_tpu_torch.cli.veteran_d4rl_antmaze mode=train task=antmaze-medium-play-v2

The modes of cli/veteran_d4rl_mujoco.py on the suite's datasets
(`DV_D4RLAntmazeSeqDataset` with the config's reward tune and
`continous_reward_at_done`, `D4RLAntmazeTDDataset`) and the "antmaze"
reward mode; the config sets `rebase_policy`. `mode=inference` steps
gymnasium_robotics' AntMaze.
"""

import sys
from pathlib import Path

from ..dataset import D4RLAntmazeTDDataset, DV_D4RLAntmazeSeqDataset
from ..pipelines.data_loading import load_d4rl_dataset, load_d4rl_qlearning_dataset
from ..utils.config import load_config, parse_cli
from . import veteran_d4rl_mujoco

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/veteran/antmaze"


def build(args, device, dataset=None):
    """The suite's sequence dataset (unless given) and pipeline on `device`."""
    if dataset is None:
        dataset = DV_D4RLAntmazeSeqDataset(
            load_d4rl_dataset(args.task.env_name), horizon=args.task.planner_horizon,
            discount=args.discount, center_mapping=(args.guidance_type != "cfg"),
            reward_tune=args.reward_tune, continous_reward_at_done=args.continous_reward_at_done,
            stride=args.task.stride, device=device,
        )
    return veteran_d4rl_mujoco.build(args, device, dataset)


def td_dataset(args, device):
    return D4RLAntmazeTDDataset(load_d4rl_qlearning_dataset(args.task.env_name), device=device)


def pipeline(args):
    veteran_d4rl_mujoco.pipeline(args, build, td_dataset, reward_mode="antmaze",
                                 save_dir=args.pipeline_name)


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "antmaze", parse_cli(sys.argv[1:])))

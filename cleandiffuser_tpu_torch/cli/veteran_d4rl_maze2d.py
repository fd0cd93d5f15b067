"""Diffusion Veteran on D4RL-Maze2D: the port's CLI (counterpart of
pipelines/veteran_d4rl_maze2d.py), reading the same `configs/veteran/maze2d`
tree.

    python -m cleandiffuser_tpu_torch.cli.veteran_d4rl_maze2d mode=train task=maze2d-umaze-v1
    python -m cleandiffuser_tpu_torch.cli.veteran_d4rl_maze2d mode=inference goal_inpaint=true

The modes of cli/veteran_d4rl_mujoco.py on the suite's datasets
(`DV_D4RLMaze2DSeqDataset`, `D4RLMaze2DTDDataset`), with MCSS ranking by
the critic head trained beside the planner (`mcss_selector="critic"`, as
the reference's maze2d CLI does), `goal_inpaint` / `gi_pin_idx` from the
config (with `goal_inpaint=true` the act function takes the goal that
`d4rl_eval_loop` hands it), and the "maze2d" reward mode. `mode=inference`
steps gymnasium_robotics' PointMaze.
"""

import sys
from pathlib import Path

from ..dataset import D4RLMaze2DTDDataset, DV_D4RLMaze2DSeqDataset
from ..pipelines.data_loading import load_d4rl_dataset, load_d4rl_qlearning_dataset
from ..utils.config import load_config, parse_cli
from . import veteran_d4rl_mujoco

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/veteran/maze2d"


def build(args, device, dataset=None):
    """The suite's sequence dataset (unless given) and pipeline on `device`."""
    if dataset is None:
        dataset = DV_D4RLMaze2DSeqDataset(
            load_d4rl_dataset(args.task.env_name), horizon=args.task.planner_horizon,
            discount=args.discount, center_mapping=(args.guidance_type != "cfg"),
            reward_tune=args.reward_tune, continous_reward_at_done=args.continous_reward_at_done,
            stride=args.task.stride, device=device,
        )
    return veteran_d4rl_mujoco.build(
        args, device, dataset, mcss_selector="critic",
        goal_inpaint=bool(args.get("goal_inpaint", False)),
        gi_pin_idx=args.get("gi_pin_idx", None))


def td_dataset(args, device):
    return D4RLMaze2DTDDataset(load_d4rl_qlearning_dataset(args.task.env_name), device=device)


def pipeline(args):
    veteran_d4rl_mujoco.pipeline(args, build, td_dataset, reward_mode="maze2d",
                                 save_dir=args.pipeline_name)


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "maze2d", parse_cli(sys.argv[1:])))

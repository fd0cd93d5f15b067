"""Decision Diffuser on D4RL-Kitchen: the port's CLI (counterpart of
pipelines/dd_d4rl_kitchen.py), reading the same `configs/dd/kitchen` tree.

    python -m cleandiffuser_tpu_torch.cli.dd_d4rl_kitchen mode=train task=kitchen-mixed-v0
    python -m cleandiffuser_tpu_torch.cli.dd_d4rl_kitchen mode=inference diffusion_ckpt=latest

As cli/dd_d4rl_mujoco.py, with the suite's dataset (`D4RLKitchenDataset`),
a return scale of 100 for a task that `DD_RETURN_SCALE` does not list, and
the "kitchen" reward mode of `d4rl_eval_loop`; kitchen's returns count completed
subtasks, so no value shift.
The DiT blocks run the fused kernel when `use_pallas_block` is on (as
shipped). `mode=inference` steps gymnasium_robotics' eval env.
"""

import sys
from pathlib import Path

from ..dataset import D4RLKitchenDataset
from ..pipelines.data_loading import load_d4rl_dataset
from ..utils.config import load_config, parse_cli
from . import dd_d4rl_mujoco

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dd/kitchen"


def build(args, device):
    """The config's dataset and pipeline on `device`."""
    dataset = D4RLKitchenDataset(
        load_d4rl_dataset(args.task.env_name), horizon=args.task.horizon,
        discount=args.discount, device=device,
    )
    return dd_d4rl_mujoco.build(args, device, dataset, return_scale=100.0, val_shift=0.0)


def pipeline(args):
    dd_d4rl_mujoco.pipeline(args, build, reward_mode="kitchen")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "kitchen", parse_cli(sys.argv[1:])))

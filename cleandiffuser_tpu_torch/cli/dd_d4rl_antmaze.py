"""Decision Diffuser on D4RL-Antmaze: the port's CLI (counterpart of
pipelines/dd_d4rl_antmaze.py), reading the same `configs/dd/antmaze` tree.

    python -m cleandiffuser_tpu_torch.cli.dd_d4rl_antmaze mode=train task=antmaze-medium-play-v2
    python -m cleandiffuser_tpu_torch.cli.dd_d4rl_antmaze mode=inference diffusion_ckpt=latest

As cli/dd_d4rl_mujoco.py, with the suite's dataset (`D4RLAntmazeDataset`),
a return scale of 100 for a task that `DD_RETURN_SCALE` does not list, and
the "antmaze" reward mode of `d4rl_eval_loop`; antmaze's returns are at most 0, so
the scaled value is shifted by 1.0 (`val_shift`).
The DiT blocks run the fused kernel when `use_pallas_block` is on (as
shipped). `mode=inference` steps gymnasium_robotics' eval env.
"""

import sys
from pathlib import Path

from ..dataset import D4RLAntmazeDataset
from ..pipelines.data_loading import load_d4rl_dataset
from ..utils.config import load_config, parse_cli
from . import dd_d4rl_mujoco

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dd/antmaze"


def build(args, device):
    """The config's dataset and pipeline on `device`."""
    dataset = D4RLAntmazeDataset(
        load_d4rl_dataset(args.task.env_name), horizon=args.task.horizon,
        noreaching_penalty=args.noreaching_penalty, discount=args.discount, device=device,
    )
    return dd_d4rl_mujoco.build(args, device, dataset, return_scale=100.0, val_shift=1.0)


def pipeline(args):
    dd_d4rl_mujoco.pipeline(args, build, reward_mode="antmaze")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "antmaze", parse_cli(sys.argv[1:])))

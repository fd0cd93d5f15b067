"""Diffusion Policy on robomimic (low-dim): the port's CLI (counterpart of
pipelines/dp_robomimic.py), reading the same `configs/dp/robomimic` tree.

    python -m cleandiffuser_tpu_torch.cli.dp_robomimic mode=train task=lift
    python -m cleandiffuser_tpu_torch.cli.dp_robomimic mode=train nn=chi_unet --config-name=lift_abs
    python -m cleandiffuser_tpu_torch.cli.dp_robomimic mode=inference

robomimic.yaml with `task=<can|lift|square|tool_hang|transport>`, or a
backbone's `<task>_abs.yaml` (`nn=<chi_unet|chi_transformer|dit>`
`--config-name=<task>_abs`: absolute actions, pos + rotation_6d + gripper,
10 dims for one arm). Data and evaluation as cli/robomimic.py says (the
hdf5, else synthetic demos; `mode=inference` needs robomimic and
robosuite). Training as in cli/imitation.py, `ckpt_latest` on the save
grid. Runs on the CUDA device unless `platform=cpu`.
"""

import sys
from pathlib import Path

from ..dataset import RobomimicDataset
from ..pipelines import DPPipeline
from ..utils.config import resolve_config_cli
from .imitation import run_imitation_cli, task_of
from .robomimic import evaluate_lowdim, robomimic_source

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dp/robomimic"


def lowdim_dataset(args, device, pad_after: int):
    return RobomimicDataset(robomimic_source(args, task_of(args).obs_dim),
                            horizon=args.horizon, pad_before=args.obs_steps - 1,
                            pad_after=pad_after, abs_action=args.abs_action, device=device)


def dims(dataset) -> tuple:
    """(obs_dim, act_dim) of the demos (act_dim 10 with abs_action)."""
    rb = dataset.replay_buffer
    return rb["obs"].shape[-1], rb["action"].shape[-1]


def build(args, device, dataset=None):
    if dataset is None:
        dataset = lowdim_dataset(args, device, args.action_steps - 1)
    obs_dim, act_dim = dims(dataset)
    pipe = DPPipeline(obs_dim=obs_dim, action_dim=act_dim, horizon=args.horizon,
                      obs_steps=args.obs_steps, action_steps=args.action_steps, nn=args.nn,
                      diffusion=args.diffusion, sample_steps=args.sample_steps, lr=args.lr,
                      gradient_steps=args.gradient_steps, ema_rate=args.ema_rate, rng=args.seed,
                      device=device)
    return dataset, pipe


def config(argv):
    return resolve_config_cli(CONFIG_DIR, "robomimic", argv, nn_key="nn", nn_root=CONFIG_DIR)


def pipeline(args):
    run_imitation_cli(args, build, evaluate_lowdim)


if __name__ == "__main__":
    pipeline(config(sys.argv[1:]))

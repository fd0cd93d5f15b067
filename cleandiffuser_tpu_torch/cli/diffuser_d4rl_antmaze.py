"""Diffuser on D4RL-Antmaze: the port's CLI (counterpart of
pipelines/diffuser_d4rl_antmaze.py), reading the same
`configs/diffuser/antmaze` tree.

    python -m cleandiffuser_tpu_torch.cli.diffuser_d4rl_antmaze mode=train task=antmaze-medium-play-v2
    python -m cleandiffuser_tpu_torch.cli.diffuser_d4rl_antmaze mode=inference ckpt=latest

As cli/diffuser_d4rl_mujoco.py (the U-Net's residual blocks through the
fused kernel, K3, on the card), with the suite's dataset (`D4RLAntmazeDataset`);
`mode=inference` is `d4rl_eval_loop` in its "antmaze" reward mode on
gymnasium_robotics' eval env, `num_candidates` plans per env per step.
"""

import sys
from pathlib import Path

from ..dataset import D4RLAntmazeDataset
from ..pipelines.data_loading import load_d4rl_dataset
from ..utils.config import load_config, parse_cli
from . import diffuser_d4rl_mujoco

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/diffuser/antmaze"


def build(args, device, pipeline_cls=None):
    """The config's dataset and pipeline (Diffuser's, or AdaptDiffuser's,
    which takes the same keys) on `device`."""
    dataset = D4RLAntmazeDataset(
        load_d4rl_dataset(args.task.env_name), horizon=args.task.horizon,
        noreaching_penalty=args.noreaching_penalty, discount=args.discount, device=device,
    )
    return diffuser_d4rl_mujoco.build(args, device, dataset,
                                      pipeline_cls or diffuser_d4rl_mujoco.DiffuserPipeline)


def pipeline(args):
    diffuser_d4rl_mujoco.pipeline(args, build, diffuser_d4rl_mujoco.eval_loop("antmaze"))


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "antmaze", parse_cli(sys.argv[1:])))

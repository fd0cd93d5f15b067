"""SynthER on D4RL-Antmaze: the port's CLI (counterpart of
pipelines/synther_d4rl_antmaze.py), reading the same `configs/synther/antmaze`
tree.

    python -m cleandiffuser_tpu_torch.cli.synther_d4rl_antmaze mode=train_diffusion \
        task=antmaze-medium-play-v2

As cli/synther_d4rl_mujoco.py (every mode) on the suite's transitions
(`D4RLAntmazeTDDataset`); `mode=inference` is `d4rl_eval_loop` in its
"antmaze" reward mode.
"""

import sys
from pathlib import Path

from ..dataset import D4RLAntmazeTDDataset
from ..utils.config import load_config, parse_cli
from . import synther_d4rl_mujoco

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/synther/antmaze"


def td_dataset(args, raw, device):
    return D4RLAntmazeTDDataset(raw, device=device)


def build(args, device):
    return synther_d4rl_mujoco.build(args, device, td_dataset)


def pipeline(args):
    synther_d4rl_mujoco.pipeline(args, td_dataset, reward_mode="antmaze")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "antmaze", parse_cli(sys.argv[1:])))

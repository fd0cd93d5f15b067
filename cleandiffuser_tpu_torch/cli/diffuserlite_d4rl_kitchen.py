"""DiffuserLite on D4RL-Kitchen: the port's CLI (counterpart of
pipelines/diffuserlite_d4rl_kitchen.py), reading the same
`configs/diffuserlite/kitchen` tree.

    python -m cleandiffuser_tpu_torch.cli.diffuserlite_d4rl_kitchen mode=iql_training
    python -m cleandiffuser_tpu_torch.cli.diffuserlite_d4rl_kitchen mode=training
    python -m cleandiffuser_tpu_torch.cli.diffuserlite_d4rl_kitchen mode=inference

The modes of cli/diffuserlite_d4rl_antmaze.py (`run`) on the suite's data,
with the levels conditioned on `kitchen_level_values`, CFG weights (1, 1,
1), IQL ranking at the plan's last index, a CFG target that rises with the
number of subtasks an environment has completed (its running episode
reward), and the "kitchen" reward mode. `mode=inference` steps
gymnasium_robotics' FrankaKitchen.
"""

import sys
from pathlib import Path

import numpy as np

from ..dataset import D4RLKitchenTDDataset, MultiHorizonD4RLKitchenDataset
from ..pipelines import compute_temporal_horizons
from ..pipelines.data_loading import load_d4rl_dataset, load_d4rl_qlearning_dataset
from ..pipelines.diffuserlite_value import kitchen_level_values
from ..utils.config import load_config, parse_cli
from . import diffuserlite_d4rl_antmaze, diffuserlite_d4rl_mujoco as lite

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/diffuserlite/kitchen"
W_CFGS = [1.0, 1.0, 1.0]


def build(args, device, base=None):
    """The suite's multi-horizon dataset (unless given) and pipeline on
    `device`."""
    if base is None:
        base = MultiHorizonD4RLKitchenDataset(
            load_d4rl_dataset(args.task.env_name),
            horizons=compute_temporal_horizons(list(args.task.planning_horizons)),
            discount=args.discount, device=device)
    return base, lite.build_pipeline(args, device, base.o_dim, base.a_dim, 1.0)


def td_dataset(args, device):
    return D4RLKitchenTDDataset(load_d4rl_qlearning_dataset(args.task.env_name), device=device)


def kitchen_act_fn(args, plan_fn, normalizer, generator):
    """The CFG target per completed-subtask count (0, 1, 2, 3, then more)."""
    tgts = ([0.3, 0.35, 0.4, 0.5] if "mixed" in args.task.env_name
            else [0.25, 0.35, 0.45, 0.5])

    def act_fn(nobs, ep_reward=None):
        completed = np.zeros(args.num_envs) if ep_reward is None else ep_reward
        tgt = np.ones(args.num_envs, dtype=np.float32) * tgts[-1]
        for k in range(4):
            tgt[completed == k] = tgts[k]
        return plan_fn(generator, nobs, tgt[:, None])[0].cpu().numpy()

    return act_fn


def pipeline(args):
    diffuserlite_d4rl_antmaze.run(args, build, td_dataset, kitchen_level_values,
                                  kitchen_act_fn, W_CFGS, select_t=-1, reward_mode="kitchen")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "kitchen", parse_cli(sys.argv[1:])))

"""DiffusionBC on robomimic (low-dim): the port's CLI (counterpart of
pipelines/dbc_robomimic.py), reading the same `configs/dbc/robomimic`
tree.

    python -m cleandiffuser_tpu_torch.cli.dbc_robomimic mode=train task=lift
    python -m cleandiffuser_tpu_torch.cli.dbc_robomimic mode=train nn=dit --config-name=lift
    python -m cleandiffuser_tpu_torch.cli.dbc_robomimic mode=inference

robomimic.yaml (`nn: pearce_mlp`, 50 ddpm steps, 8 Diffusion-X steps) with
`task=<name>`, or a backbone's `<task>.yaml`. One action per control step;
data, evaluation and checkpoints as cli/robomimic.py and cli/dp_robomimic.py
say. Runs on the CUDA device unless `platform=cpu`.
"""

import sys
from pathlib import Path

from ..pipelines import DBCPipeline
from ..utils.config import resolve_config_cli
from .dp_robomimic import dims, lowdim_dataset
from .imitation import run_imitation_cli
from .robomimic import evaluate_lowdim

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dbc/robomimic"


def build(args, device, dataset=None):
    if dataset is None:
        dataset = lowdim_dataset(args, device, 0)
    obs_dim, act_dim = dims(dataset)
    pipe = DBCPipeline(obs_dim=obs_dim, action_dim=act_dim, obs_steps=args.obs_steps,
                       action_steps=int(args.get("action_steps", 1)), nn=args.nn,
                       diffusion=args.diffusion, sample_steps=args.sample_steps,
                       diffusion_x_sampling_steps=args.extra_sample_steps if args.diffusion_x
                       else 0, lr=args.lr, gradient_steps=args.gradient_steps,
                       ema_rate=args.ema_rate, rng=args.seed, device=device)
    return dataset, pipe


def config(argv):
    return resolve_config_cli(CONFIG_DIR, "robomimic", argv, nn_key="nn", nn_root=CONFIG_DIR)


def pipeline(args):
    run_imitation_cli(args, build, evaluate_lowdim)


if __name__ == "__main__":
    pipeline(config(sys.argv[1:]))

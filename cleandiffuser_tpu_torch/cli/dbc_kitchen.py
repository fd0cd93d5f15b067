"""DiffusionBC on Franka Kitchen: the port's CLI (counterpart of
pipelines/dbc_kitchen.py), reading the same `configs/dbc/kitchen` tree.

    python -m cleandiffuser_tpu_torch.cli.dbc_kitchen mode=train nn=pearce_mlp
    python -m cleandiffuser_tpu_torch.cli.dbc_kitchen mode=inference

`nn=<pearce_mlp|dit>` picks the backbone's directory (its kitchen.yaml is
the JAX CLI's top-level one). One action per control step, Diffusion-X
steps from `diffusion_x` / `extra_sample_steps` (on in the shipped
configs). Data and evaluation as in cli/dp_kitchen.py, with one action per
`act` (`MultiStepWrapper` with one action step). Runs on the CUDA device
unless `platform=cpu`.
"""

import sys
from pathlib import Path

from ..pipelines import DBCPipeline
from ..utils.config import resolve_config_cli
from .dbc_pusht import x_steps
from .dp_kitchen import kitchen_dataset, kitchen_episodes
from .imitation import run_imitation_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dbc/kitchen/pearce_mlp"


def build(args, device, dataset=None):
    if dataset is None:
        dataset = kitchen_dataset(args, device, 0)
    pipe = DBCPipeline(obs_dim=args.obs_dim, action_dim=args.action_dim,
                       obs_steps=args.obs_steps, action_steps=int(args.get("action_steps", 1)),
                       nn=args.nn, diffusion=args.diffusion, sample_steps=args.sample_steps,
                       diffusion_x_sampling_steps=x_steps(args), lr=args.lr,
                       gradient_steps=args.gradient_steps, ema_rate=args.ema_rate,
                       rng=args.seed, device=device)
    return dataset, pipe


def evaluate(pipe, dataset, args):
    norm_o, norm_a = dataset.normalizer["obs"]["state"], dataset.normalizer["action"]
    act = lambda o: norm_a.unnormalize(pipe.act(norm_o.normalize(o)).cpu().numpy())
    return kitchen_episodes(args, act, 1, 1)


def pipeline(args):
    run_imitation_cli(args, build, evaluate)


if __name__ == "__main__":
    pipeline(resolve_config_cli(CONFIG_DIR, "kitchen", sys.argv[1:], nn_key="nn"))

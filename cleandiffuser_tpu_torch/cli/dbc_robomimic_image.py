"""DiffusionBC on robomimic with camera images: the port's CLI
(counterpart of pipelines/dbc_robomimic_image.py), reading the same
`configs/dbc/robomimic_image` tree.

    python -m cleandiffuser_tpu_torch.cli.dbc_robomimic_image mode=train task=lift
    python -m cleandiffuser_tpu_torch.cli.dbc_robomimic_image mode=inference

The pipeline (pipelines/dbc_image.py, `nn: pearce_mlp` or
`pearce_transformer`, 50 ddpm steps and 8 Diffusion-X steps) on the
encoder of cli/dp_robomimic_image.py; one action per control step. Data,
evaluation and checkpoints as there. Runs on the CUDA device unless
`platform=cpu`.
"""

import sys
from pathlib import Path

from ..pipelines import DBCImagePipeline
from ..utils.config import resolve_config_cli
from .dp_robomimic_image import image_dataset
from .imitation import run_imitation_cli
from .robomimic import evaluate_image, image_shape_meta

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dbc/robomimic_image"


def build(args, device, dataset=None):
    if dataset is None:
        dataset = image_dataset(args, device, 0)
    pipe = DBCImagePipeline(
        shape_meta=image_shape_meta(args)[0], action_dim=dataset.replay_buffer["action"].shape[-1],
        obs_steps=args.obs_steps, nn=args.nn, diffusion=args.diffusion,
        sample_steps=args.sample_steps,
        diffusion_x_sampling_steps=args.extra_sample_steps if args.diffusion_x else 0,
        crop_shape=tuple(args.crop_shape), lr=args.lr, gradient_steps=args.gradient_steps,
        ema_rate=args.ema_rate, rng=args.seed, device=device)
    return dataset, pipe


def config(argv):
    return resolve_config_cli(CONFIG_DIR, "robomimic_image", argv)


def pipeline(args):
    run_imitation_cli(args, build, evaluate_image)


if __name__ == "__main__":
    pipeline(config(sys.argv[1:]))

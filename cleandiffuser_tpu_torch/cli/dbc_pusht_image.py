"""DiffusionBC on PushT with image observations: the port's CLI
(counterpart of pipelines/dbc_pusht_image.py), reading the same configs.

    python -m cleandiffuser_tpu_torch.cli.dbc_pusht_image mode=train
    python -m cleandiffuser_tpu_torch.cli.dbc_pusht_image mode=inference

configs/dbc/pusht_image/pusht_image.yaml (`nn: pearce_mlp`, 50 ddpm steps
and, with `diffusion_x`, `extra_sample_steps` Diffusion-X steps);
`nn=<backbone>` reads configs/dbc/pusht/<nn>/pusht_image.yaml. The
pipeline (pipelines/dbc_image.py) takes `pearce_mlp` or
`pearce_transformer`. Data as in cli/dp_pusht_image.py; windows of
`horizon` with To - 1 steps of padding before. `ckpt_latest` on the save
grid, as the JAX CLI saves; evaluation is the per-step rollout on the
device (`DBCImagePipeline.evaluate_on_device`). Runs on the CUDA device
unless `platform=cpu`.
"""

import sys
from pathlib import Path

from ..env.pusht import PushTImageEnv
from ..pipelines import DBCImagePipeline
from ..utils.config import resolve_config_cli
from .dp_pusht_image import image_dataset, image_size
from .imitation import run_imitation_cli

CONFIGS = Path(__file__).resolve().parents[2] / "configs/dbc"
CONFIG_DIR, BACKBONE_DIRS = CONFIGS / "pusht_image", CONFIGS / "pusht"


def build(args, device, dataset=None):
    if dataset is None:
        dataset = image_dataset(args, device, 0)
    pipe = DBCImagePipeline(
        shape_meta=args.shape_meta.to_dict(), action_dim=args.action_dim,
        obs_steps=args.obs_steps, nn=args.nn, diffusion=args.diffusion,
        sample_steps=args.sample_steps,
        diffusion_x_sampling_steps=args.extra_sample_steps if args.diffusion_x else 0,
        crop_shape=tuple(args.crop_shape), lr=args.lr, gradient_steps=args.gradient_steps,
        ema_rate=args.ema_rate, rng=args.seed, device=device)
    return dataset, pipe


def evaluate(pipe, dataset, args):
    mean_reward, mean_success = pipe.evaluate_on_device(
        PushTImageEnv(render_size=image_size(args), device=pipe.device), dataset.normalizer,
        num_envs=args.num_envs, max_episode_steps=args.max_episode_steps)
    return {"mean_reward": mean_reward, "mean_success": mean_success}


def config(argv):
    return resolve_config_cli(CONFIG_DIR, "pusht_image", argv, nn_key="nn",
                              nn_root=BACKBONE_DIRS)


def pipeline(args):
    run_imitation_cli(args, build, evaluate)


if __name__ == "__main__":
    pipeline(config(sys.argv[1:]))

"""Diffusion Policy on robomimic with camera images: the port's CLI
(counterpart of pipelines/dp_robomimic_image.py), reading the same
`configs/dp/robomimic_image` tree.

    python -m cleandiffuser_tpu_torch.cli.dp_robomimic_image mode=train task=lift
    python -m cleandiffuser_tpu_torch.cli.dp_robomimic_image mode=inference

The pipeline (pipelines/dp_image.py, `nn: chi_unet` or `dit`) encodes
each camera with its GN-ResNet18 and the low_dim keys as one "state"
(cli/robomimic.py `image_shape_meta`). Data: the task's image hdf5, else
synthetic demos with uint8 frames at the shape_meta's size; evaluation
needs robomimic and robosuite. `ckpt_latest` on the save grid. Runs on the
CUDA device unless `platform=cpu`.
"""

import sys
from pathlib import Path

from ..dataset import RobomimicImageDataset
from ..pipelines import DPImagePipeline
from ..utils.config import resolve_config_cli
from .imitation import run_imitation_cli
from .robomimic import evaluate_image, image_shape_meta, robomimic_source

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dp/robomimic_image"


def image_dataset(args, device, pad_after: int):
    meta, image_keys, lowdim_keys = image_shape_meta(args)
    source = robomimic_source(args, meta["obs"]["state"]["shape"][0], image_keys,
                              meta["obs"][image_keys[0]]["shape"][-1])
    return RobomimicImageDataset(source, horizon=args.horizon, pad_before=args.obs_steps - 1,
                                 pad_after=pad_after, obs_keys=lowdim_keys,
                                 image_keys=image_keys, abs_action=args.abs_action,
                                 device=device)


def build(args, device, dataset=None):
    if dataset is None:
        dataset = image_dataset(args, device, args.action_steps - 1)
    pipe = DPImagePipeline(shape_meta=image_shape_meta(args)[0],
                           action_dim=dataset.replay_buffer["action"].shape[-1],
                           horizon=args.horizon, obs_steps=args.obs_steps,
                           action_steps=args.action_steps, nn=args.nn, diffusion=args.diffusion,
                           sample_steps=args.sample_steps, crop_shape=tuple(args.crop_shape),
                           lr=args.lr, gradient_steps=args.gradient_steps,
                           ema_rate=args.ema_rate, rng=args.seed, device=device)
    return dataset, pipe


def config(argv):
    return resolve_config_cli(CONFIG_DIR, "robomimic_image", argv)


def pipeline(args):
    run_imitation_cli(args, build, evaluate_image)


if __name__ == "__main__":
    pipeline(config(sys.argv[1:]))

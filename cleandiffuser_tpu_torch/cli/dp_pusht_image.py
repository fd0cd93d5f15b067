"""Diffusion Policy on PushT with image observations: the port's CLI
(counterpart of pipelines/dp_pusht_image.py), reading the same configs.

    python -m cleandiffuser_tpu_torch.cli.dp_pusht_image mode=train
    python -m cleandiffuser_tpu_torch.cli.dp_pusht_image mode=train nn=chi_unet
    python -m cleandiffuser_tpu_torch.cli.dp_pusht_image mode=inference ckpt=latest

The default config is configs/dp/pusht_image/pusht_image.yaml (`nn: dit`,
horizon 10); `nn=<chi_unet|chi_transformer|dit>` reads the backbone's
configs/dp/pusht/<nn>/pusht_image.yaml (chi_unet: horizon 16, the
U-Net's power of 2). The pipeline (pipelines/dp_image.py) takes `chi_unet`
or `dit`. Data: the file at `dataset_path`, else the MPC expert's demos
rendered at the shape_meta's image size, cached there when it ends in .npz
(pipelines/data_loading.py `resolve_pusht_demos`). Training and
checkpoints as in cli/imitation.py (`ckpt_<step>` and `ckpt_latest`);
evaluation is the whole rollout on the device with the image env
rendering every step (`DPImagePipeline.evaluate_on_device`, `num_envs`
envs of `max_episode_steps` steps). Runs on the CUDA device unless
`platform=cpu`.
"""

import sys
from pathlib import Path

from ..dataset import PushTImageDataset
from ..env.pusht import PushTImageEnv
from ..pipelines import DPImagePipeline
from ..pipelines.data_loading import resolve_pusht_demos
from ..utils.config import resolve_config_cli
from .imitation import run_imitation_cli

CONFIGS = Path(__file__).resolve().parents[2] / "configs/dp"
CONFIG_DIR, BACKBONE_DIRS = CONFIGS / "pusht_image", CONFIGS / "pusht"


def image_size(args) -> int:
    """The rendered frames' size: the shape_meta's image width."""
    return int(args.shape_meta.obs.image.shape[-1])


def image_dataset(args, device, pad_after: int):
    """The demos with their frames (made once if missing) as windows."""
    source = resolve_pusht_demos(args, device, with_images=True, image_size=image_size(args))
    return PushTImageDataset(source, horizon=args.horizon, pad_before=args.obs_steps - 1,
                             pad_after=pad_after, device=device)


def build(args, device, dataset=None):
    if dataset is None:
        dataset = image_dataset(args, device, args.action_steps - 1)
    pipe = DPImagePipeline(shape_meta=args.shape_meta.to_dict(), action_dim=args.action_dim,
                           horizon=args.horizon, obs_steps=args.obs_steps,
                           action_steps=args.action_steps, nn=args.nn, diffusion=args.diffusion,
                           sample_steps=args.sample_steps, crop_shape=tuple(args.crop_shape),
                           lr=args.lr, gradient_steps=args.gradient_steps,
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
    run_imitation_cli(args, build, evaluate, numbered_ckpts=True)


if __name__ == "__main__":
    pipeline(config(sys.argv[1:]))

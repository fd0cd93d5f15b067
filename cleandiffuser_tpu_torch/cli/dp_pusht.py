"""Diffusion Policy on PushT: the port's CLI (counterpart of
pipelines/dp_pusht.py), reading the same `configs/dp/pusht` tree.

    python -m cleandiffuser_tpu_torch.cli.dp_pusht mode=train nn=chi_unet
    python -m cleandiffuser_tpu_torch.cli.dp_pusht mode=train nn=dit --config-name=pusht_keypoint
    python -m cleandiffuser_tpu_torch.cli.dp_pusht mode=inference ckpt=latest

`nn=<chi_unet|chi_transformer|dit>` picks the backbone's directory;
`env_name` picks the observation (pusht-v0: state, pusht-keypoints-v0: 9
keypoints and the agent). Data: the file at `dataset_path` (a reference
zarr store or an .npz of it), else demos from the on-device MPC expert,
cached there (pipelines/data_loading.py `resolve_pusht_demos`). Training
and checkpoints as in cli/imitation.py (`ckpt_<step>` and `ckpt_latest`);
evaluation is the whole receding-horizon rollout on the device
(`DPPipeline.evaluate_on_device`, `num_envs` envs of `max_episode_steps`
steps). Runs on the CUDA device unless `platform=cpu`.
"""

import sys
from pathlib import Path

from ..dataset import PushTKeypointDataset, PushTStateDataset
from ..env.pusht import PushTEnv, PushTKeypointEnv
from ..pipelines import DPPipeline
from ..pipelines.data_loading import resolve_pusht_demos
from ..utils.config import resolve_config_cli
from .imitation import run_imitation_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dp/pusht/chi_unet"


def pusht_env(args, device):
    return (PushTKeypointEnv if "keypoint" in args.env_name else PushTEnv)(device=device)


def build(args, device, dataset=None):
    """The config's dataset (the demos, made once if missing) and pipeline
    on `device`; a caller may pass the dataset."""
    if dataset is None:
        cls = PushTKeypointDataset if "keypoint" in args.env_name else PushTStateDataset
        dataset = cls(resolve_pusht_demos(args, device), horizon=args.horizon,
                      pad_before=args.obs_steps - 1, pad_after=args.action_steps - 1,
                      device=device)
    pipe = DPPipeline(obs_dim=args.obs_dim, action_dim=args.action_dim, horizon=args.horizon,
                      obs_steps=args.obs_steps, action_steps=args.action_steps, nn=args.nn,
                      diffusion=args.diffusion, sample_steps=args.sample_steps, lr=args.lr,
                      gradient_steps=args.gradient_steps, ema_rate=args.ema_rate, rng=args.seed,
                      device=device)
    return dataset, pipe


def evaluate(pipe, dataset, args):
    mean_reward, mean_success = pipe.evaluate_on_device(
        pusht_env(args, pipe.device), dataset.normalizer, num_envs=args.num_envs,
        max_episode_steps=args.max_episode_steps)
    return {"mean_reward": mean_reward, "mean_success": mean_success}


def pipeline(args):
    run_imitation_cli(args, build, evaluate, loss_key="avg_diffusion_loss", numbered_ckpts=True)


if __name__ == "__main__":
    pipeline(resolve_config_cli(CONFIG_DIR, "pusht", sys.argv[1:], nn_key="nn"))

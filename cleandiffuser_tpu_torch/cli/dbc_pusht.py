"""DiffusionBC on PushT: the port's CLI (counterpart of
pipelines/dbc_pusht.py), reading the same `configs/dbc/pusht` tree.

    python -m cleandiffuser_tpu_torch.cli.dbc_pusht mode=train nn=pearce_mlp
    python -m cleandiffuser_tpu_torch.cli.dbc_pusht mode=train nn=dit
    python -m cleandiffuser_tpu_torch.cli.dbc_pusht mode=inference

One action per control step (the `dit` backbone diffuses a chunk of
`action_steps` and executes its first action); Diffusion-X steps from
`diffusion_x_sampling_steps`, or the reference's `diffusion_x: true` with
`extra_sample_steps`. Data, the env variants and training as in
cli/dp_pusht.py (`ckpt_latest` only); evaluation is the per-step rollout on
the device (`DBCPipeline.evaluate_on_device`). Runs on the CUDA device
unless `platform=cpu`.
"""

import sys
from pathlib import Path

from ..dataset import PushTKeypointDataset, PushTStateDataset
from ..pipelines import DBCPipeline
from ..pipelines.data_loading import resolve_pusht_demos
from ..utils.config import resolve_config_cli
from .dp_pusht import pusht_env
from .imitation import run_imitation_cli

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dbc/pusht/pearce_mlp"


def x_steps(args) -> int:
    """The Diffusion-X steps: the reference's keys or the port's own."""
    if args.get("diffusion_x", False):
        return int(args.get("extra_sample_steps", 0))
    return int(args.get("diffusion_x_sampling_steps", 0))


def build(args, device, dataset=None):
    Ta = int(args.get("action_steps", 1))
    if dataset is None:
        cls = PushTKeypointDataset if "keypoint" in args.env_name else PushTStateDataset
        dataset = cls(resolve_pusht_demos(args, device), horizon=args.obs_steps - 1 + max(Ta, 2),
                      pad_before=args.obs_steps - 1, pad_after=max(Ta - 2, 0), device=device)
    pipe = DBCPipeline(obs_dim=args.obs_dim, action_dim=args.action_dim,
                       obs_steps=args.obs_steps, action_steps=Ta, nn=args.nn,
                       diffusion=args.diffusion, emb_dim=args.emb_dim,
                       sample_steps=args.sample_steps, diffusion_x_sampling_steps=x_steps(args),
                       lr=args.lr, gradient_steps=args.gradient_steps, ema_rate=args.ema_rate,
                       rng=args.seed, device=device)
    return dataset, pipe


def evaluate(pipe, dataset, args):
    mean_reward, mean_success = pipe.evaluate_on_device(
        pusht_env(args, pipe.device), dataset.normalizer, num_envs=args.num_envs,
        max_episode_steps=args.max_episode_steps)
    return {"mean_reward": mean_reward, "mean_success": mean_success}


def pipeline(args):
    run_imitation_cli(args, build, evaluate)


if __name__ == "__main__":
    pipeline(resolve_config_cli(CONFIG_DIR, "pusht", sys.argv[1:], nn_key="nn"))

"""DiffuserLite on D4RL-Antmaze: the port's CLI (counterpart of
pipelines/diffuserlite_d4rl_antmaze.py), reading the same
`configs/diffuserlite/antmaze` tree. Modes: iql_training, training, then
prepare_dataset and reflow (for R2), then inference (`test_model` R1: 5
Euler steps per level; R2: 2).

    python -m cleandiffuser_tpu_torch.cli.diffuserlite_d4rl_antmaze mode=iql_training
    python -m cleandiffuser_tpu_torch.cli.diffuserlite_d4rl_antmaze mode=training
    python -m cleandiffuser_tpu_torch.cli.diffuserlite_d4rl_antmaze mode=inference

The sparse-reward variant (pipelines/diffuserlite_value.py): `iql_training`
trains IQL (hidden 512, tau 0.7) for `iql_gradient_steps` steps on TD
batches of 256 and saves `iql_ckpt_latest.pkl` (a `torch.save` file);
the other modes load it. The levels condition on the values
`antmaze_level_values` derives; reflow pairs condition level 0 only.
Inference ranks `num_candidates` level-0 plans per environment by IQL's V
at plan index 1 under CFG weights (1, 0, 0) and a target return that
depends on the ant's position. The modes run through
cli/diffuserlite_d4rl_mujoco.py's functions; the kitchen CLI runs through
`run` here. `mode=inference` steps gymnasium_robotics' AntMaze.
"""

import sys
from pathlib import Path

import numpy as np
import torch

from ..dataset import D4RLAntmazeTDDataset, MultiHorizonD4RLAntmazeDataset
from ..pipelines import compute_temporal_horizons
from ..pipelines.data_loading import load_d4rl_dataset, load_d4rl_qlearning_dataset
from ..pipelines.diffuserlite_value import (
    IQLValueMultiHorizonDataset,
    antmaze_level_values,
    build_candidate_plan_fn,
    prepare_value_reflow_pairs,
    train_iql,
    value_train_step,
)
from ..parallel import place_pipeline
from ..pipelines.runner import d4rl_eval_loop
from ..utils.config import load_config, parse_cli
from ..utils.iql import IQL
from . import diffuserlite_d4rl_mujoco as lite

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/diffuserlite/antmaze"
W_CFGS = [1.0, 0.0, 0.0]  # only level 0 is guided
IQL_BATCH = 256


def antmaze_target_return(env_name: str, raw_obs: np.ndarray) -> np.ndarray:
    """The CFG target by the ant's x-y, per maze (E, 1)."""
    tgt = np.ones(raw_obs.shape[0], dtype=np.float32)
    x, y = raw_obs[:, 0], raw_obs[:, 1]
    if "medium-play" in env_name:
        tgt[:] = 0.2
        tgt[y > 18.0] = 0.8
    elif "medium-diverse" in env_name:
        tgt[:] = 0.2
        tgt[x > 10.0] = 0.3
        tgt[y > 15.0] = 0.8
    elif "large-play" in env_name:
        tgt[:] = 0.6
        tgt[np.logical_and(x >= 13.0, y < 28.0)] = 0.25
        tgt[x < 13.0] = 0.1
    elif "large-diverse" in env_name:
        tgt[:] = 0.6
        tgt[np.logical_and(x >= 13.0, y < 28.0)] = 0.3
        tgt[x < 13.0] = 0.25
    return tgt[:, None]


def build(args, device, base=None):
    """The suite's multi-horizon dataset (unless given) and pipeline on
    `device`."""
    if base is None:
        base = MultiHorizonD4RLAntmazeDataset(
            load_d4rl_dataset(args.task.env_name),
            horizons=compute_temporal_horizons(list(args.task.planning_horizons)),
            noreaching_penalty=args.noreaching_penalty, discount=args.discount, device=device)
    return base, lite.build_pipeline(args, device, base.o_dim, base.a_dim, 1.0)


def build_iql(args, base, device) -> IQL:
    """The suite's IQL: hidden 512, expectile 0.7."""
    return IQL(base.o_dim, base.a_dim, hidden_dim=512, discount=args.discount, tau=0.7,
               rng=args.seed + 7, device=device)


def td_dataset(args, device):
    return D4RLAntmazeTDDataset(load_d4rl_qlearning_dataset(args.task.env_name), device=device)


def antmaze_act_fn(args, plan_fn, normalizer, generator):
    def act_fn(nobs):
        tgt = antmaze_target_return(args.task.env_name, normalizer.unnormalize(nobs))
        return plan_fn(generator, nobs, tgt)[0].cpu().numpy()

    return act_fn


def run(args, build, td_dataset, level_values, act_fn_of, w_cfgs, select_t: int,
        reward_mode: str):
    """The modes of an IQL-valued suite: its dataset and pipeline
    (`build`), TD data (`td_dataset`), level values, act function
    (`act_fn_of(args, plan_fn, normalizer, generator)`), CFG weights, the
    plan index IQL ranks at and `d4rl_eval_loop`'s reward mode."""
    device, save_path, logger, base, pipe, mesh = lite.setup(args, build)
    iql = build_iql(args, base, device)
    place_pipeline(iql, mesh)
    iql_ckpt = str(save_path / "iql_ckpt_latest.pkl")
    val_fn = lambda batch, level: level_values(batch, level, args.discount)  # noqa: E731

    if args.mode == "iql_training":
        td = td_dataset(args, device)
        if mesh is not None:
            td.place_on_mesh(mesh)
        train_iql(iql, td, args.iql_gradient_steps, IQL_BATCH,
                  args.log_interval, args.save_interval, lambda: iql.save(iql_ckpt), args.seed)
        iql.save(iql_ckpt)
        logger.finish()
        return
    iql.load(iql_ckpt)
    if args.mode == "training":
        dataset = IQLValueMultiHorizonDataset(base, iql, device=device)
        lite.train(pipe, dataset, args, save_path, logger, device,
                   lambda b, left: value_train_step(pipe, b, val_fn, left), mesh)
    elif args.mode == "prepare_dataset":
        dataset = IQLValueMultiHorizonDataset(base, iql, device=device)
        lite.prepare_dataset(pipe, dataset, args, save_path, device,
                             lambda b, g: prepare_value_reflow_pairs(
                                 pipe, b, val_fn, args.dataset_prepare_sampling_steps, g))
    elif args.mode == "reflow":
        lite.reflow(pipe, args, save_path, logger, mesh)
    elif args.mode == "inference":
        prefix = "reflow_ckpt" if args.test_model == "R2" else "ckpt"
        pipe.load(str(save_path / f"{prefix}_{args.diffusion_ckpt}"))
        steps = 2 if args.test_model == "R2" else 5
        plan_fn = build_candidate_plan_fn(pipe, iql, args.num_envs, args.num_candidates, steps,
                                          w_cfgs, select_t)
        generator = torch.Generator(device=device).manual_seed(args.seed + 99)
        d4rl_eval_loop(act_fn_of(args, plan_fn, base.get_normalizer(), generator),
                       args.task.env_name, base.get_normalizer(), args.num_envs,
                       args.num_episodes, args.seed, logger=logger, reward_mode=reward_mode)
    else:
        raise ValueError(f"Invalid mode: {args.mode}")
    logger.finish()


def pipeline(args):
    run(args, build, td_dataset, antmaze_level_values, antmaze_act_fn, W_CFGS, select_t=1,
        reward_mode="antmaze")


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "antmaze", parse_cli(sys.argv[1:])))

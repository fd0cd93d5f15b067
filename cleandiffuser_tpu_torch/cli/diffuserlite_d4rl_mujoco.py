"""DiffuserLite on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/diffuserlite_d4rl_mujoco.py), reading the same
`configs/diffuserlite/mujoco` tree. Modes: training, then prepare_dataset
and reflow (for R2), then inference (`test_model` R1: 3 Euler steps per
level; R2: 1 step from the reflowed nets).

    python -m cleandiffuser_tpu_torch.cli.diffuserlite_d4rl_mujoco mode=training
    python -m cleandiffuser_tpu_torch.cli.diffuserlite_d4rl_mujoco mode=prepare_dataset
    python -m cleandiffuser_tpu_torch.cli.diffuserlite_d4rl_mujoco mode=reflow
    python -m cleandiffuser_tpu_torch.cli.diffuserlite_d4rl_mujoco mode=inference test_model=R2

Runs on the CUDA device, and raises without one, unless the config says
`platform=cpu`. Results go to `results/torch/<pipeline_name>/<env_name>/`:
`ckpt_<tag>.diffusion<i>` and `.invdyn` (training), `reflow_pairs.pkl`
(prepare_dataset: per level the numpy "x0", "x1" and "condition", the JAX
CLI's layout, read back without unpickling anything but numpy arrays),
`reflow_ckpt_<tag>.*` (reflow). `mode=training` runs window by window
(`make_train_scan`) when the intervals allow it, the inverse dynamics
within the first `invdyn_gradient_steps` steps. `mode=prepare_dataset`
samples `cond_dataset_size // dataset_prepare_batch_size` batches (at least
one) of `dataset_prepare_batch_size` pairs per level from
`ckpt_<reflow_backbone_ckpt>`; `mode=reflow` takes `reflow_gradient_steps`
steps on batches drawn from the pairs by a numpy generator seeded with
`seed`. The antmaze and kitchen CLIs build on the functions here.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch

from ..dataset import MultiHorizonD4RLMuJoCoDataset
from ..parallel import device_of, place_pipeline, setup_mesh, shard_batch
from ..pipelines import DiffuserLitePipeline, compute_temporal_horizons
from ..pipelines.data_loading import load_d4rl_dataset
from ..pipelines.runner import d4rl_eval_loop, train_loop
from ..utils import DD_RETURN_SCALE
from ..utils.config import load_config, parse_cli
from ..utils.logger import Logger
from ..utils.ranks import is_writer
from ..utils.tensors import set_seed
from ..utils.train_state import read_jax_pickle

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/diffuserlite/mujoco"


def build_pipeline(args, device, o_dim: int, a_dim: int, return_scale: float, **kwargs):
    return DiffuserLitePipeline(
        obs_dim=o_dim, act_dim=a_dim, planning_horizons=list(args.task.planning_horizons),
        emb_dim=args.emb_dim, d_model=args.d_model, n_heads=args.n_heads, depth=args.depth,
        next_obs_loss_weight=args.next_obs_loss_weight, return_scale=return_scale,
        ema_rate=args.ema_rate, diffusion_gradient_steps=args.diffusion_gradient_steps,
        temperature=args.temperature, rng=args.seed, device=device, **kwargs)


def build(args, device, dataset=None):
    """The config's multi-horizon dataset (unless given) and pipeline on
    `device`."""
    r2 = args.test_model == "R2"
    if dataset is None:
        dataset = MultiHorizonD4RLMuJoCoDataset(
            load_d4rl_dataset(args.task.env_name),
            horizons=compute_temporal_horizons(list(args.task.planning_horizons)),
            terminal_penalty=args.terminal_penalty, discount=args.discount, device=device)
    pipe = build_pipeline(
        args, device, dataset.o_dim, dataset.a_dim,
        DD_RETURN_SCALE.get(args.task.env_name, 1000.0),
        w_cfg=args.task.w_cfg_R2 if r2 else args.task.w_cfg_R1,
        target_return=args.task.target_return_R2 if r2 else args.task.target_return_R1)
    return dataset, pipe


def batches(pipe, dataset, generator, batch_size: int):
    """A batch per level, drawn one after the other from `generator`."""
    return [dataset.sample_batch(generator, batch_size, horizon_idx=i)
            for i in range(pipe.n_levels)]


def train(pipe, dataset, args, save_path, logger, device, train_step=None, mesh=None):
    """mode=training: `train_step` (the pipeline's own unless given) on a
    batch per level, saving `ckpt_<step>` and `ckpt_latest` on the save
    grid; window by window when the intervals are on the log grid. On a
    mesh the dataset is placed first: each rank steps on its rows."""
    if mesh is not None:
        dataset.place_on_mesh(mesh)
    window = None
    if (args.save_interval % args.log_interval == 0
            and args.diffusion_gradient_steps % args.log_interval == 0):
        window = pipe.make_train_scan(dataset, args.batch_size, args.log_interval,
                                      args.invdyn_gradient_steps, train_step)
    train_loop(pipe.step_fn(dataset, args.batch_size, args.invdyn_gradient_steps, train_step),
               args.diffusion_gradient_steps, args.log_interval, args.save_interval,
               lambda tag: pipe.save(str(save_path / f"ckpt_{tag}")), logger, args.seed,
               window_fn=window, device=device)


def prepare_dataset(pipe, dataset, args, save_path, device, pairs_fn=None):
    """mode=prepare_dataset: `pairs_fn(batches)` (the pipeline's
    `prepare_reflow_pairs` unless given) per batch of
    `dataset_prepare_batch_size`, merged per level into `reflow_pairs.pkl`.
    On a mesh every rank computes all the pairs (the sampler is not split)
    and rank 0 writes them."""
    pipe.load(str(save_path / f"ckpt_{args.reflow_backbone_ckpt}"))
    pairs_fn = pairs_fn or (lambda b, g: pipe.prepare_reflow_pairs(
        b, sampling_steps=args.dataset_prepare_sampling_steps, generator=g))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    n_batches = max(args.cond_dataset_size // args.dataset_prepare_batch_size, 1)
    all_pairs = []
    for b in range(n_batches):
        all_pairs.append(pairs_fn(batches(pipe, dataset, generator,
                                          args.dataset_prepare_batch_size), generator))
        print(f"reflow pairs: step {b + 1}/{n_batches}", flush=True)
    merged = [{key: np.concatenate([p[i][key] for p in all_pairs]) for key in all_pairs[0][i]}
              for i in range(pipe.n_levels)]
    if is_writer():
        with open(save_path / "reflow_pairs.pkl", "wb") as f:
            pickle.dump(merged, f)


def reflow(pipe, args, save_path, logger, mesh=None):
    """mode=reflow: `reflow_gradient_steps` steps on pairs drawn from
    `reflow_pairs.pkl`, saving `reflow_ckpt_<step>` and
    `reflow_ckpt_latest` on the save grid. On a mesh each rank steps on its
    rows of the drawn pairs (`shard_batch`)."""
    pipe.load(str(save_path / f"ckpt_{args.reflow_backbone_ckpt}"))
    merged = read_jax_pickle(save_path / "reflow_pairs.pkl")
    rng = np.random.default_rng(args.seed)
    N = merged[0]["x0"].shape[0]
    acc = {}
    for step in range(args.reflow_gradient_steps):
        idx = rng.integers(0, N, args.batch_size)
        pairs = [{k: v[idx] for k, v in m.items()} for m in merged]
        log = pipe.reflow_step(pairs if mesh is None else shard_batch(mesh, pairs))
        for k, v in log.items():
            acc[k] = acc.get(k, 0.0) + v
        if (step + 1) % args.log_interval == 0:
            out = {k: float(v) / args.log_interval for k, v in acc.items()}
            out["gradient_steps"] = step + 1
            print(out, flush=True)
            logger.log(out, "reflow")
            acc = {}
        if (step + 1) % args.save_interval == 0:
            pipe.save(str(save_path / f"reflow_ckpt_{step + 1}"))
            pipe.save(str(save_path / "reflow_ckpt_latest"))


def setup(args, build):
    """(device, save_path, logger, dataset, pipe, mesh) of a run; the
    pipeline placed on the mesh (the dataset is placed by `train`)."""
    mesh = setup_mesh(args)
    device = device_of(args)
    set_seed(args.seed)
    save_path = Path(f"results/torch/{args.pipeline_name}/{args.task.env_name}/")
    save_path.mkdir(parents=True, exist_ok=True)
    logger = Logger(save_path, args.to_dict())
    dataset, pipe = build(args, device)
    place_pipeline(pipe, mesh)
    return device, save_path, logger, dataset, pipe, mesh


def pipeline(args):
    device, save_path, logger, dataset, pipe, mesh = setup(args, build)
    if args.mode == "training":
        train(pipe, dataset, args, save_path, logger, device, mesh=mesh)
    elif args.mode == "prepare_dataset":
        prepare_dataset(pipe, dataset, args, save_path, device)
    elif args.mode == "reflow":
        reflow(pipe, args, save_path, logger, mesh)
    elif args.mode == "inference":
        prefix = "reflow_ckpt" if args.test_model == "R2" else "ckpt"
        pipe.load(str(save_path / f"{prefix}_{args.diffusion_ckpt}"))
        steps = 1 if args.test_model == "R2" else 3
        d4rl_eval_loop(lambda nobs: pipe.act(nobs, sample_steps=steps)[0].cpu().numpy(),
                       args.task.env_name, dataset.get_normalizer(), args.num_envs,
                       args.num_episodes, args.seed, logger=logger)
    else:
        raise ValueError(f"Invalid mode: {args.mode}")
    logger.finish()


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

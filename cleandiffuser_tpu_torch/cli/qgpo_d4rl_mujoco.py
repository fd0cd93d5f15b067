"""QGPO on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/qgpo_d4rl_mujoco.py), reading the same `configs/qgpo/mujoco` tree.

    python -m cleandiffuser_tpu_torch.cli.qgpo_d4rl_mujoco mode=bc_training
    python -m cleandiffuser_tpu_torch.cli.qgpo_d4rl_mujoco mode=supported_action_collecting
    python -m cleandiffuser_tpu_torch.cli.qgpo_d4rl_mujoco mode=q_training
    python -m cleandiffuser_tpu_torch.cli.qgpo_d4rl_mujoco mode=cep_training
    python -m cleandiffuser_tpu_torch.cli.qgpo_d4rl_mujoco mode=inference

Runs on the CUDA device, and raises without one, unless the config says
`platform=cpu`. Files go to `results/torch/<pipeline_name>/<env_name>/`:

- `bc_training`: the behavior actor at batch 256, window by window when the
  intervals allow it; `diffusion_ckpt_latest` on the save grid.
- `supported_action_collecting`: K actions per next state of the dataset in
  batches of 5,000 states; `supported_act.npy`.
- `q_training` / `cep_training`: `q_gradient_steps` / `cep_gradient_steps`
  steps at batch 256 on the shared device store, in windows of
  `log_interval` steps when the step count allows it, else step by step;
  `q_state.pt` (the CEP stage reads it) / `clf_ckpt_latest`.
- `inference`: the actor and the classifier, guided by the task's `w_cg`,
  served by `d4rl_eval_loop` on gymnasium's MuJoCo envs.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..dataset import D4RLMuJoCoTDDataset
from ..parallel import device_of, place_pipeline, setup_mesh
from ..pipelines import QGPOPipeline
from ..pipelines.data_loading import load_d4rl_qlearning_dataset
from ..pipelines.runner import d4rl_eval_loop, step_generator, train_loop
from ..utils.config import load_config, parse_cli
from ..utils.logger import Logger
from ..utils.tensors import set_seed

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/qgpo/mujoco"
BATCH = 256  # the reference CLI's batch, every stage
COLLECT_BATCH = 5000  # states per sampler call of the support collection


def build(args, device, dataset=None):
    if dataset is None:
        dataset = D4RLMuJoCoTDDataset(load_d4rl_qlearning_dataset(args.task.env_name), True,
                                      device=device)
    pipe = QGPOPipeline(obs_dim=dataset.o_dim, act_dim=dataset.a_dim, K=args.K,
                        betaQ=args.betaQ, beta=args.beta, ema_rate=args.ema_rate,
                        rng=args.seed, device=device)
    return dataset, pipe


def act_fn(pipe, args):
    return lambda nobs: pipe.act(nobs, w_cg=args.task.w_cg, sampling_steps=args.sampling_steps)


def _train_stage(pipe, dataset, sup, args, logger, device):
    """The Q or CEP stage: windows of `log_interval` steps on the shared
    store when the step count is a multiple of it, else step by step."""
    q = args.mode == "q_training"
    steps = args.q_gradient_steps if q else args.cep_gradient_steps
    gen = step_generator(args.seed, 0, device)
    if steps % args.log_interval == 0:
        make = pipe.make_q_train_scan if q else pipe.make_cep_train_scan
        window = make(dataset, sup, BATCH, args.log_interval)
        t0 = time.time()
        for w in range(steps // args.log_interval):
            out = {k: float(v) for k, v in window(gen).items()}
            out["gradient_steps"] = (w + 1) * args.log_interval
            now = time.time()
            out["steps_per_sec"] = round(args.log_interval / max(now - t0, 1e-9), 2)
            t0 = now
            print(out, flush=True)
            logger.log(out, args.mode)
        return
    store = pipe.support_store(dataset, sup)
    for step in range(steps):
        idx = torch.randint(dataset.size, (BATCH,), generator=gen, device=device)
        batch = pipe.store_batch(store, idx)
        log = pipe.q_train_step(batch) if q else pipe.cep_train_step(batch, generator=gen)
        if (step + 1) % args.log_interval == 0:
            out = {"gradient_steps": step + 1, **{k: float(v) for k, v in log.items()}}
            print(out, flush=True)
            logger.log(out, args.mode)


def pipeline(args):
    mesh = setup_mesh(args)  # before the first device use
    device = device_of(args)
    set_seed(args.seed)
    save_path = Path(f"results/torch/{args.pipeline_name}/{args.task.env_name}/")
    save_path.mkdir(parents=True, exist_ok=True)
    logger = Logger(save_path, args.to_dict())

    dataset, pipe = build(args, device)
    place_pipeline(pipe, mesh)
    sup_path, q_path = save_path / "supported_act.npy", save_path / "q_state.pt"
    actor_ckpt = str(save_path / "diffusion_ckpt_latest")

    if args.mode == "bc_training":
        window_fn = None
        if args.save_interval % args.log_interval == 0 and \
                args.bc_gradient_steps % args.log_interval == 0:
            window_fn = pipe.make_bc_train_scan(dataset, BATCH, args.log_interval)
        train_loop(
            lambda g: pipe.bc_train_step(dataset.sample_batch(g, BATCH)),
            args.bc_gradient_steps, args.log_interval, args.save_interval,
            lambda tag: pipe.actor.save(actor_ckpt), logger, args.seed,
            window_fn=window_fn, device=device,
        )
    elif args.mode == "supported_action_collecting":
        pipe.actor.load(actor_ckpt)
        np.save(sup_path, pipe.collect_supported_actions(dataset.next_obs, COLLECT_BATCH))
    elif args.mode in ("q_training", "cep_training"):
        pipe.actor.load(actor_ckpt)
        sup = np.load(sup_path)
        if args.mode == "cep_training" and q_path.exists():
            pipe.load_q(str(q_path))
        _train_stage(pipe, dataset, sup, args, logger, device)
        if args.mode == "q_training":
            pipe.save_q(str(q_path))
        else:
            pipe.classifier.save(str(save_path / "clf_ckpt_latest"))
    elif args.mode == "inference":
        pipe.actor.load(actor_ckpt)
        pipe.classifier.load(str(save_path / "clf_ckpt_latest"))
        act = act_fn(pipe, args)
        d4rl_eval_loop(lambda nobs: act(nobs).cpu().numpy(), args.task.env_name,
                       dataset.get_normalizer(), args.num_envs, args.num_episodes, args.seed,
                       logger=logger)
    else:
        raise ValueError(f"Invalid mode: {args.mode}")
    logger.finish()


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

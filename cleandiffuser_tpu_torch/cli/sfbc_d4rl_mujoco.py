"""SfBC on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/sfbc_d4rl_mujoco.py), reading the same `configs/sfbc/mujoco` tree.

    python -m cleandiffuser_tpu_torch.cli.sfbc_d4rl_mujoco mode=bc_training
    python -m cleandiffuser_tpu_torch.cli.sfbc_d4rl_mujoco mode=critic_training
    python -m cleandiffuser_tpu_torch.cli.sfbc_d4rl_mujoco mode=inference

Runs on the CUDA device, and raises without one, unless the config says
`platform=cpu`. Files go to `results/torch/<pipeline_name>/<env_name>/`.

- `bc_training`: the behavior actor on (batch, horizon 32) windows, window
  by window (`make_bc_train_scan`) when the intervals allow it; saves
  `ckpt_<step>` and `ckpt_latest` (`.actor`, `.critic`) on the save grid.
- `critic_training`: from `ckpt_<eval_actor_ckpt>`, `q_training_iters`
  in-sample-planning iterations: from the second on, `monte_carlo_reevaluate`
  over every path and a fresh critic; each trains `critic_gradient_steps`
  steps on 64 (path, step) cells drawn by a numpy generator seeded by the
  seed, as the reference's; saves `ckpt_critic`.
- `inference`: `ckpt_<ckpt>`, then `ckpt_critic` if there is one, served by
  `d4rl_eval_loop` on gymnasium's MuJoCo envs.
"""

import sys
from pathlib import Path

import numpy as np

from ..dataset import D4RLMuJoCoDataset
from ..parallel import device_of, place_pipeline, setup_mesh
from ..pipelines import SfBCPipeline
from ..pipelines.data_loading import load_d4rl_dataset
from ..pipelines.runner import d4rl_eval_loop, train_loop
from ..utils.config import load_config, parse_cli
from ..utils.logger import Logger
from ..utils.normalizers import GaussianNormalizer
from ..utils.tensors import set_seed

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/sfbc/mujoco"
CRITIC_BATCH = 64  # the reference's critic batch


def build(args, device, dataset=None):
    """The config's dataset (horizon-32 windows) and pipeline on `device`."""
    if dataset is None:
        dataset = D4RLMuJoCoDataset(load_d4rl_dataset(args.task.env_name), horizon=32,
                                    discount=args.discount, device=device)
    pipe = SfBCPipeline(
        obs_dim=dataset.o_dim, act_dim=dataset.a_dim, hidden_dim=args.hidden_dim,
        actor_lr=args.actor_learning_rate, critic_lr=args.critic_learning_rate,
        ema_rate=args.ema_rate, predict_noise=args.predict_noise, discount=args.discount,
        monte_carlo_samples=args.monte_carlo_samples,
        weight_temperature=args.weight_temperature, rng=args.seed, device=device,
    )
    return dataset, pipe


def act_fn(pipe, args):
    """The evaluation's request: normalised observations in, actions out."""
    return lambda nobs: pipe.act(nobs, num_candidates=args.num_candidates,
                                 top_k_average=args.top_k_average,
                                 sampling_steps=args.sampling_steps, temperature=args.temperature)


def pipeline(args):
    mesh = setup_mesh(args)  # before the first device use
    device = device_of(args)
    set_seed(args.seed)
    save_path = Path(f"results/torch/{args.pipeline_name}/{args.task.env_name}/")
    save_path.mkdir(parents=True, exist_ok=True)
    logger = Logger(save_path, args.to_dict())

    dataset, pipe = build(args, device)
    place_pipeline(pipe, mesh)
    if mesh is not None:
        dataset.place_on_mesh(mesh)
    val_normalizer = GaussianNormalizer(dataset.seq_val)

    if args.mode == "bc_training":
        window_fn = None
        if args.save_interval % args.log_interval == 0 and \
                args.bc_gradient_steps % args.log_interval == 0:
            window_fn = pipe.make_bc_train_scan(dataset, args.batch_size, args.log_interval)
        train_loop(
            lambda g: pipe.bc_train_step(dataset.sample_batch(g, args.batch_size)),
            args.bc_gradient_steps, args.log_interval, args.save_interval,
            lambda tag: pipe.save(str(save_path / f"ckpt_{tag}")), logger, args.seed,
            window_fn=window_fn, device=device,
        )
    elif args.mode == "critic_training":
        pipe.load(str(save_path / f"ckpt_{args.eval_actor_ckpt}"))
        seq_val = dataset.seq_val
        rng = np.random.default_rng(args.seed)
        for it in range(args.q_training_iters):
            if it > 0:
                seq_val, val_normalizer = pipe.monte_carlo_reevaluate(
                    dataset.seq_obs, dataset.seq_rew, seq_val, dataset.tml_and_not_timeout,
                    val_normalizer, sampling_steps=args.eval_actor_sampling_steps)
                pipe.reset_critic()
            normed_val = val_normalizer.normalize(seq_val)
            for step in range(args.critic_gradient_steps):
                p = rng.integers(0, dataset.seq_obs.shape[0], CRITIC_BATCH)
                t = rng.integers(0, dataset.seq_obs.shape[1], CRITIC_BATCH)
                log = pipe.critic_train_step(dataset.seq_obs[p, t], dataset.seq_act[p, t],
                                             normed_val[p, t])
                if (step + 1) % args.log_interval == 0:
                    out = {"iter": it, "gradient_steps": step + 1,
                           "critic_loss": float(log["critic_loss"])}
                    print(out, flush=True)
                    logger.log(out, "critic_training")
        pipe.save(str(save_path / "ckpt_critic"))
    elif args.mode == "inference":
        pipe.load(str(save_path / f"ckpt_{args.ckpt}"))
        if (save_path / "ckpt_critic.critic").exists():
            pipe.load(str(save_path / "ckpt_critic"))
        act = act_fn(pipe, args)
        d4rl_eval_loop(lambda nobs: act(nobs).cpu().numpy(), args.task.env_name,
                       dataset.get_normalizer(), args.num_envs, args.num_episodes, args.seed,
                       logger=logger)
    else:
        raise ValueError(f"Invalid mode: {args.mode}")
    logger.finish()


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

"""Diffuser on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/diffuser_d4rl_mujoco.py), reading the same
`configs/diffuser/mujoco` tree.

    python -m cleandiffuser_tpu_torch.cli.diffuser_d4rl_mujoco mode=train task=halfcheetah-medium-v2
    python -m cleandiffuser_tpu_torch.cli.diffuser_d4rl_mujoco mode=inference ckpt=latest

Runs on the CUDA device, and raises without one, unless the config says
`platform=cpu`. Checkpoints and logs go to
`results/torch/<pipeline_name>/<env_name>/`. The U-Net's residual blocks
run the fused kernel (K3) on the card (the configs have no kernel switch
for it). `mode=inference` is the reference
CLI's own loop over gymnasium's MuJoCo envs, `num_candidates` plans per env
per step, episodes of at most `MAX_STEPS` steps. The antmaze and kitchen
CLIs, and AdaptDiffuser's, run through `build` and `pipeline` here with
their own dataset, pipeline class and evaluation.
"""

import sys
from pathlib import Path

import numpy as np

from ..dataset import D4RLMuJoCoDataset
from ..parallel import device_of, place_pipeline, setup_mesh
from ..pipelines import DiffuserPipeline
from ..pipelines.data_loading import (
    get_normalized_score_fn,
    load_d4rl_dataset,
    make_eval_env_fns,
)
from ..pipelines.runner import d4rl_eval_loop, planner_window_fn, train_loop
from ..utils.config import load_config, parse_cli
from ..utils.logger import Logger
from ..utils.tensors import set_seed

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/diffuser/mujoco"
MAX_STEPS = 1000  # d4rl's locomotion episode length


def build(args, device, dataset=None, pipeline_cls=DiffuserPipeline):
    """The config's dataset and pipeline on `device`: `dataset` and
    `pipeline_cls` (which takes DiffuserPipeline's arguments) are another
    CLI's."""
    if dataset is None:
        dataset = D4RLMuJoCoDataset(
            load_d4rl_dataset(args.task.env_name),
            horizon=args.task.horizon,
            terminal_penalty=args.terminal_penalty,
            discount=args.discount,
            device=device,
        )
    pipe = pipeline_cls(
        obs_dim=dataset.o_dim,
        act_dim=dataset.a_dim,
        horizon=args.task.horizon,
        model_dim=args.model_dim,
        dim_mult=tuple(args.task.dim_mult),
        diffusion_steps=args.diffusion_steps,
        sampling_steps=args.sampling_steps,
        solver=args.solver,
        predict_noise=args.predict_noise,
        action_loss_weight=args.action_loss_weight,
        ema_rate=args.ema_rate,
        diffusion_gradient_steps=args.diffusion_gradient_steps,
        classifier_gradient_steps=args.classifier_gradient_steps,
        w_cg=args.task.w_cg,
        temperature=args.temperature,
        use_pallas_block=True,
        rng=args.seed,
        device=device,
    )
    return dataset, pipe


def evaluate(pipe, dataset, args, logger):
    """The reference CLI's evaluation on gymnasium's MuJoCo envs."""
    normalizer = dataset.get_normalizer()
    score_fn = get_normalized_score_fn(args.task.env_name)
    import gymnasium as gym

    envs = gym.vector.SyncVectorEnv(make_eval_env_fns(args.task.env_name, args.num_envs))
    episode_rewards = []
    for ep in range(args.num_episodes):
        # per-episode seed block (vector reset seeds sub-envs [s..s+n-1])
        obs, _ = envs.reset(seed=args.seed + ep * args.num_envs)
        ep_reward, cum_done, t = np.zeros(args.num_envs), np.zeros(args.num_envs), 0
        while not np.all(cum_done) and t < MAX_STEPS + 1:
            nobs = normalizer.normalize(obs)
            act, _ = pipe.act(nobs, num_candidates=args.num_candidates)
            obs, rew, term, trunc, _ = envs.step(act.cpu().numpy())
            done = np.logical_or(term, trunc)
            t += 1
            cum_done = np.logical_or(cum_done, done)
            ep_reward += rew * (1 - cum_done) if t < MAX_STEPS else rew
        episode_rewards.append([score_fn(r) for r in ep_reward])
        print(f"episode {ep}: {np.mean(episode_rewards[-1]):.3f}")
    episode_rewards = np.array(episode_rewards)
    print(np.mean(episode_rewards, -1), np.std(episode_rewards, -1))
    logger.log({"normalized_score_mean": float(np.mean(episode_rewards))}, "inference")


def eval_loop(reward_mode: str):
    """Evaluation through `d4rl_eval_loop` in `reward_mode`, the other
    suites' (and AdaptDiffuser's) CLIs' way."""
    def run(pipe, dataset, args, logger):
        d4rl_eval_loop(
            lambda nobs: pipe.act(nobs, num_candidates=args.num_candidates)[0].cpu().numpy(),
            args.task.env_name, dataset.get_normalizer(), args.num_envs, args.num_episodes,
            args.seed, logger=logger, reward_mode=reward_mode)
    return run


def pipeline(args, build=build, evaluate=evaluate, finetune=None):
    """Run `args.mode` for the dataset and pipeline `build(args, device)`
    makes: `evaluate(pipe, dataset, args, logger)` serves `mode=inference`
    from `ckpt_<ckpt>`; a CLI that has `finetune(pipe, dataset, args,
    save_path, logger)` takes `mode=finetune`."""
    mesh = setup_mesh(args)  # before the first device use
    device = device_of(args)
    set_seed(args.seed)
    save_path = Path(f"results/torch/{args.pipeline_name}/{args.task.env_name}/")
    save_path.mkdir(parents=True, exist_ok=True)
    logger = Logger(save_path, args.to_dict())

    dataset, pipe = build(args, device)
    place_pipeline(pipe, mesh)

    if args.mode == "train":
        if mesh is not None:  # the training batches as this rank's rows
            dataset.place_on_mesh(mesh)
        train_loop(
            lambda g: pipe.train_step(dataset.sample_batch(g, args.batch_size)),
            args.diffusion_gradient_steps, args.log_interval, args.save_interval,
            lambda tag: pipe.save(str(save_path / f"ckpt_{tag}")), logger, args.seed,
            window_fn=planner_window_fn(pipe, dataset, args, mesh), device=device,
        )
    elif args.mode == "inference":
        pipe.load(str(save_path / f"ckpt_{args.ckpt}"))
        evaluate(pipe, dataset, args, logger)
    elif args.mode == "finetune" and finetune is not None:
        finetune(pipe, dataset, args, save_path, logger)
    else:
        raise ValueError(f"Invalid mode: {args.mode}")
    logger.finish()


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

"""Diffusion Veteran on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/veteran_d4rl_mujoco.py), reading the same `configs/veteran/mujoco`
tree. Modes: train, then train_expected_value, then inference.

    python -m cleandiffuser_tpu_torch.cli.veteran_d4rl_mujoco mode=train
    python -m cleandiffuser_tpu_torch.cli.veteran_d4rl_mujoco mode=train_expected_value
    python -m cleandiffuser_tpu_torch.cli.veteran_d4rl_mujoco mode=inference ckpt=latest

Runs on the CUDA device, and raises without one, unless the config says
`platform=cpu`. Checkpoints (`veteran_<tag>.pkl`, one `torch.save` file of
every component) and logs go to
`results/torch/<pipeline_name>_<guidance_type>/<env_name>/` (the maze2d,
antmaze and kitchen CLIs leave out the guidance type, as the reference's
do). `mode=train` trains the planner and its guidance and policy, window
by window (`make_train_scan`) when the intervals allow it; the planner's
DiT blocks are the plain ones, as the reference builds them.
`mode=train_expected_value` loads `veteran_latest.pkl` if there is one,
trains the EV net for `EV_GRADIENT_STEPS` TD steps on batches of
`EV_BATCH` and saves `veteran_latest.pkl` on the save grid.
`mode=inference` loads `veteran_<ckpt>.pkl` and evaluates on gymnasium's
MuJoCo envs (`d4rl_eval_loop`). The suite CLIs run through `build` and
`pipeline` here with their own datasets, keys and reward mode.
"""

import sys
from pathlib import Path
from typing import Optional

from ..dataset import D4RLMuJoCoTDDataset, DV_D4RLMuJoCoSeqDataset
from ..parallel import device_of, place_pipeline, setup_mesh
from ..pipelines import VeteranPipeline
from ..pipelines.data_loading import load_d4rl_dataset, load_d4rl_qlearning_dataset
from ..pipelines.runner import d4rl_eval_loop, planner_window_fn, train_loop
from ..utils.config import load_config, parse_cli
from ..utils.logger import Logger
from ..utils.tensors import set_seed

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/veteran/mujoco"
# The EV stage's length: the reference's CLIs fix it at 1,000,000 steps with
# no config key (ROADMAP queue 3 logs it); tests patch it down.
EV_GRADIENT_STEPS = 1_000_000
EV_BATCH = 256


def build(args, device, dataset=None, **pipe_kwargs):
    """The config's sequence dataset and pipeline on `device`. A suite's
    CLI passes its own `dataset` and extra pipeline arguments."""
    if dataset is None:
        dataset = DV_D4RLMuJoCoSeqDataset(
            load_d4rl_dataset(args.task.env_name), horizon=args.task.planner_horizon,
            discount=args.discount, center_mapping=(args.guidance_type != "cfg"),
            stride=args.task.stride, device=device,
        )
    pipe = VeteranPipeline(
        obs_dim=dataset.o_dim, act_dim=dataset.a_dim,
        planner_horizon=args.task.planner_horizon,
        guidance_type=args.guidance_type, pipeline_type=args.pipeline_type,
        planner_net=args.planner_net,
        use_diffusion_invdyn=bool(args.use_diffusion_invdyn),
        use_weighted_regression=args.use_weighted_regression,
        weight_factor=args.weight_factor, planner_emb_dim=args.planner_emb_dim,
        planner_d_model=args.planner_d_model, planner_depth=args.planner_depth,
        unet_dim=args.unet_dim, next_obs_loss_weight=args.planner_next_obs_loss_weight,
        policy_hidden_dim=args.policy_hidden_dim,
        policy_diffusion_steps=args.policy_diffusion_steps,
        discount=args.discount, gradient_steps=args.planner_diffusion_gradient_steps,
        critic_lr=args.critic_learning_rate, planner_solver=args.planner_solver,
        planner_sampling_steps=args.planner_sampling_steps,
        policy_solver=args.policy_solver, policy_sampling_steps=args.policy_sampling_steps,
        rebase_policy=args.get("rebase_policy", False),
        w_cfg=args.task.planner_w_cfg, target_return=args.task.planner_target_return,
        temperature=args.task.planner_temperature, rng=args.seed, device=device,
        **pipe_kwargs,
    )
    return dataset, pipe


def td_dataset(args, device):
    return D4RLMuJoCoTDDataset(load_d4rl_qlearning_dataset(args.task.env_name), device=device)


def pipeline(args, build=build, td_dataset=td_dataset, reward_mode: str = "mujoco",
             save_dir: Optional[str] = None):
    """Run `args.mode` for the dataset and pipeline `build(args, device)`
    makes; `td_dataset(args, device)` is the EV stage's data,
    `reward_mode` `d4rl_eval_loop`'s, `save_dir` the results directory's
    name (default `<pipeline_name>_<guidance_type>`)."""
    mesh = setup_mesh(args)
    device = device_of(args)
    set_seed(args.seed)
    save_dir = save_dir or f"{args.pipeline_name}_{args.guidance_type}"
    save_path = Path(f"results/torch/{save_dir}/{args.task.env_name}/")
    save_path.mkdir(parents=True, exist_ok=True)
    logger = Logger(save_path, args.to_dict())

    dataset, pipe = build(args, device)
    place_pipeline(pipe, mesh)
    if mesh is not None:
        dataset.place_on_mesh(mesh)
    ckpt = lambda tag: str(save_path / f"veteran_{tag}.pkl")

    if args.mode == "train":
        train_loop(pipe.step_fn(dataset, args.batch_size),
                   args.planner_diffusion_gradient_steps, args.log_interval,
                   args.save_interval, lambda tag: pipe.save(ckpt(tag)), logger, args.seed,
                   window_fn=planner_window_fn(pipe, dataset, args, mesh,
                                               steps_key="planner_diffusion_gradient_steps"),
                   device=device)
    elif args.mode == "train_expected_value":
        if Path(ckpt("latest")).exists():
            pipe.load(ckpt("latest"))
        td = td_dataset(args, device)
        if mesh is not None:
            td.place_on_mesh(mesh)
        ev_window = None
        if (args.save_interval % args.log_interval == 0
                and EV_GRADIENT_STEPS % args.log_interval == 0):
            ev_window = pipe.make_ev_train_scan(td, EV_BATCH, args.log_interval)
        train_loop(lambda g: pipe.train_expected_value_step(td.sample_batch(g, EV_BATCH)),
                   EV_GRADIENT_STEPS, args.log_interval, args.save_interval,
                   lambda tag: pipe.save(ckpt("latest")), logger, args.seed,
                   window_fn=ev_window, device=device)
    elif args.mode == "inference":
        path = Path(ckpt(args.get("ckpt", "latest")))
        if path.exists():
            pipe.load(str(path))
        else:
            pipe.planner.load(str(save_path / "planner_latest"))
        K = args.planner_num_candidates
        if args.get("goal_inpaint", False):
            def act_fn(nobs, goal_normed):
                return pipe.act(nobs, num_candidates=K, goal_normed=goal_normed)[0].cpu().numpy()
        else:
            def act_fn(nobs):
                return pipe.act(nobs, num_candidates=K)[0].cpu().numpy()
        d4rl_eval_loop(act_fn, args.task.env_name, dataset.get_normalizer(), args.num_envs,
                       args.num_episodes, args.seed,
                       max_steps=args.task.get("max_path_length", 1000), logger=logger,
                       reward_mode=reward_mode)
    else:
        raise ValueError(f"Invalid mode: {args.mode}")
    logger.finish()


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

"""Decision Diffuser on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/dd_d4rl_mujoco.py), reading the same `configs/dd/mujoco` tree.

    python -m cleandiffuser_tpu_torch.cli.dd_d4rl_mujoco mode=train task=hopper-medium-v2
    python -m cleandiffuser_tpu_torch.cli.dd_d4rl_mujoco mode=inference diffusion_ckpt=latest

Runs on the CUDA device, and raises without one, unless the config says
`platform=cpu`. Checkpoints and logs go to
`results/torch/<pipeline_name>/<env_name>/` (the JAX CLI's go to
`results/<pipeline_name>/...`, in another format). `mode=train` trains
window by window (`make_train_scan`) when the intervals allow it, with DiT
blocks through the fused kernel when `use_pallas_block` is on (as shipped);
`mode=inference` loads `ckpt_<diffusion_ckpt>` and evaluates on gymnasium's
MuJoCo envs (`d4rl_eval_loop`), which must be installed. The antmaze and
kitchen CLIs run through `build` and `pipeline` here with their own dataset,
return scale, value shift and reward mode.
"""

import sys
from pathlib import Path

from ..dataset import D4RLMuJoCoDataset
from ..parallel import device_of, place_pipeline, setup_mesh
from ..pipelines import DDPipeline
from ..pipelines.data_loading import load_d4rl_dataset
from ..pipelines.runner import d4rl_eval_loop, planner_window_fn, train_loop
from ..utils import DD_RETURN_SCALE
from ..utils.config import load_config, parse_cli
from ..utils.logger import Logger
from ..utils.tensors import set_seed

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/dd/mujoco"


def build(args, device, dataset=None, return_scale: float = 1000.0, val_shift: float = 0.0):
    """The config's dataset and pipeline on `device`. Another suite's CLI
    passes its `dataset`, the return scale of a task that `DD_RETURN_SCALE`
    does not list, and the shift of the scaled return (antmaze's returns
    are <= 0: 1.0 moves them into [0, 1])."""
    if dataset is None:
        dataset = D4RLMuJoCoDataset(
            load_d4rl_dataset(args.task.env_name), horizon=args.task.horizon,
            terminal_penalty=args.terminal_penalty, discount=args.discount, device=device,
        )
    pipe = DDPipeline(
        obs_dim=dataset.o_dim, act_dim=dataset.a_dim, horizon=args.task.horizon,
        emb_dim=args.emb_dim, d_model=args.d_model, n_heads=args.n_heads,
        depth=args.depth, label_dropout=args.label_dropout,
        predict_noise=args.predict_noise,
        next_obs_loss_weight=args.next_obs_loss_weight,
        return_scale=DD_RETURN_SCALE.get(args.task.env_name, return_scale),
        val_shift=val_shift,
        ema_rate=args.ema_rate,
        diffusion_gradient_steps=args.diffusion_gradient_steps,
        invdyn_gradient_steps=args.invdyn_gradient_steps,
        solver=args.solver, sampling_steps=args.sampling_steps,
        w_cfg=args.task.w_cfg, target_return=args.task.target_return,
        temperature=args.temperature, rng=args.seed,
        use_pallas_block=bool(args.get("use_pallas_block", False)), device=device,
    )
    return dataset, pipe


def pipeline(args, build=build, reward_mode: str = "mujoco"):
    """Run `args.mode` for the dataset and pipeline `build(args, device)`
    makes; `reward_mode` is `d4rl_eval_loop`'s."""
    mesh = setup_mesh(args)  # before the first device use: the bf16_* keys
    device = device_of(args)
    set_seed(args.seed)
    save_path = Path(f"results/torch/{args.pipeline_name}/{args.task.env_name}/")
    save_path.mkdir(parents=True, exist_ok=True)
    logger = Logger(save_path, args.to_dict())

    dataset, pipe = build(args, device)
    place_pipeline(pipe, mesh)
    if mesh is not None:
        dataset.place_on_mesh(mesh)

    if args.mode == "train":
        train_loop(
            lambda g: pipe.train_step(dataset.sample_batch(g, args.batch_size)),
            args.diffusion_gradient_steps, args.log_interval, args.save_interval,
            lambda tag: pipe.save(str(save_path / f"ckpt_{tag}")), logger, args.seed,
            window_fn=planner_window_fn(pipe, dataset, args, mesh), device=device,
        )
    elif args.mode == "inference":
        pipe.load(str(save_path / f"ckpt_{args.diffusion_ckpt}"))
        d4rl_eval_loop(
            lambda nobs: pipe.act(nobs)[0].cpu().numpy(), args.task.env_name,
            dataset.get_normalizer(), args.num_envs, args.num_episodes,
            args.seed, logger=logger, reward_mode=reward_mode,
        )
    else:
        raise ValueError(f"Invalid mode: {args.mode}")
    logger.finish()


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

"""What the DQL, IDQL and EDP D4RL CLIs share: set-up, `mode=train`
window by window (`rl_window_fn`) when the intervals allow it, and
`mode=inference` from `ckpt_<ckpt>`.

Runs on the CUDA device, and raises without one, unless the config says
`platform=cpu`. Checkpoints and logs go to
`results/torch/<pipeline_name>/<env_name>/`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

from ..parallel import device_of, place_pipeline, setup_mesh
from ..pipelines.runner import d4rl_eval_loop, rl_window_fn, train_loop
from ..utils.logger import Logger
from ..utils.tensors import set_seed


def run_rl_cli(args, build: Callable, weight_temperature: float,
               inference: Optional[Callable] = None, resume: bool = False,
               reward_mode: str = "mujoco") -> None:
    """Run `args.mode` for the pipeline `build(args, device)` makes, as
    (dataset, pipe). Requests are `pipe.act(nobs, ...)` with the config's
    candidates and `weight_temperature`; `inference(act, dataset, args,
    logger)` evaluates them, by default `d4rl_eval_loop` in `reward_mode`.
    With `resume`, `resume=true` in the config resumes training from
    `ckpt_latest`."""
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

    if args.mode == "train":
        def resume_fn():
            ckpt = save_path / "ckpt_latest.pt"
            if args.get("resume", False) and ckpt.exists():
                pipe.load(str(ckpt))
                return pipe.trained_steps
            return 0

        train_loop(
            lambda g: pipe.train_step(dataset.sample_batch(g, args.batch_size)),
            args.gradient_steps, args.log_interval, args.save_interval,
            lambda tag: pipe.save(str(save_path / f"ckpt_{tag}.pt")), logger, args.seed,
            resume_fn=resume_fn if resume else None,
            window_fn=rl_window_fn(pipe, dataset, args, mesh), device=device,
        )
    elif args.mode == "inference":
        pipe.load(str(save_path / f"ckpt_{args.ckpt}.pt"))

        def act(nobs):
            return pipe.act(nobs, num_candidates=args.num_candidates,
                            weight_temperature=weight_temperature, use_ema=args.use_ema,
                            temperature=args.temperature)

        if inference is not None:
            inference(act, dataset, args, logger)
        else:
            d4rl_eval_loop(lambda nobs: act(nobs).cpu().numpy(), args.task.env_name,
                           dataset.get_normalizer(), args.num_envs, args.num_episodes,
                           args.seed, logger=logger, reward_mode=reward_mode)
    else:
        raise ValueError(f"Invalid mode: {args.mode}")
    logger.finish()

"""What the Diffusion Policy and DiffusionBC CLIs share (counterpart of the
loops of pipelines/{dp,dbc}_{pusht,kitchen}.py): set-up, `mode=train`
window by window, `mode=inference` from `ckpt_<ckpt>`.

Training is `runner.train_loop`: `gradient_steps` steps at `batch_size`,
logging every `log_freq` steps (`{<loss key>, "step", "steps_per_sec"}` to
train.jsonl), saving every `save_freq` steps (`ckpt_<step>` where the JAX
CLI saves one, and `ckpt_latest`) and evaluating every `eval_freq` steps
(0 or absent: never). When `save_freq`, `eval_freq` and `gradient_steps`
are multiples of `log_freq`, a log window is one `make_train_scan` window
(logs kept on the device, one read per window); otherwise the steps run
one by one, the loss summed on the device, and a last, shorter window is
logged too.

Runs on the CUDA device, and raises without one, unless the config says
`platform=cpu`. Checkpoints and logs go to
`results/torch/<pipeline_name>/<env_name or task_name>/`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

from ..parallel import device_of, place_pipeline, setup_mesh
from ..pipelines.runner import train_loop
from ..utils.logger import Logger
from ..utils.tensors import set_seed


def task_of(args):
    """The config's task group, or the config itself where the task's keys
    sit at the top (the robomimic `*_abs.yaml` files)."""
    return args.task if "task" in args else args


def save_dir(args) -> Path:
    """results/torch/<pipeline_name>/<env_name>/ (robomimic: the task's
    name; Kitchen: kitchen)."""
    name = args.get("env_name") or task_of(args).get("task_name") or "kitchen"
    return Path(f"results/torch/{args.pipeline_name}/{name}/")


def run_imitation_cli(args, build: Callable, evaluate: Callable, loss_key: str = "avg_loss",
                      numbered_ckpts: bool = False) -> None:
    """Run `args.mode` for `build(args, device) -> (dataset, pipe)`;
    `evaluate(pipe, dataset, args) -> dict` scores the policy."""
    mesh = setup_mesh(args)  # before the first device use
    device = device_of(args)
    set_seed(args.seed)
    save_path = save_dir(args)
    save_path.mkdir(parents=True, exist_ok=True)
    logger = Logger(save_path, args.to_dict())
    dataset, pipe = build(args, device)
    place_pipeline(pipe, mesh)
    if mesh is not None:
        dataset.place_on_mesh(mesh)

    def scored(m: dict) -> None:
        print(m, flush=True)
        logger.log(m, "inference")

    if args.mode == "train":
        eval_freq = int(args.get("eval_freq", 0) or 0)
        window = None
        if all(v % args.log_freq == 0 for v in (args.save_freq, eval_freq, args.gradient_steps)):
            scan = pipe.make_train_scan(dataset, args.batch_size, args.log_freq)
            window = lambda g: {loss_key: scan(g)["loss"]}

        def save(tag: str) -> None:
            if numbered_ckpts or tag == "latest":
                pipe.save(str(save_path / f"ckpt_{tag}"))

        train_loop(
            lambda g: {loss_key: pipe.train_step(dataset.sample_batch(g, args.batch_size))["loss"]},
            args.gradient_steps, args.log_freq, args.save_freq, save, logger, seed=args.seed,
            window_fn=window, device=device, step_key="step", log_tail=True,
            eval_interval=eval_freq,
            eval_fn=lambda step: scored({"step": step, **evaluate(pipe, dataset, args)}))
    elif args.mode == "inference":
        pipe.load(str(save_path / f"ckpt_{args.get('ckpt', 'latest')}"))
        scored(evaluate(pipe, dataset, args))
    else:
        raise ValueError(f"Invalid mode: {args.mode}")
    logger.finish()

"""AdaptDiffuser on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/adaptdiffuser_d4rl_mujoco.py), reading the same
`configs/adaptdiffuser/mujoco` tree. Modes: train, then finetune (the
self-evolving stage), then inference.

    python -m cleandiffuser_tpu_torch.cli.adaptdiffuser_d4rl_mujoco mode=train
    python -m cleandiffuser_tpu_torch.cli.adaptdiffuser_d4rl_mujoco mode=finetune ft_target=5000
    python -m cleandiffuser_tpu_torch.cli.adaptdiffuser_d4rl_mujoco mode=inference ckpt=finetuned_latest

`mode=train` and `mode=inference` (`d4rl_eval_loop`) are Diffuser's
(cli/diffuser_d4rl_mujoco.py): the U-Net's residual blocks run the fused
kernel (K3) on the card. `mode=finetune` loads `ckpt_<ft_ckpt>`, then
generates rounds of `GENERATION_BATCH` trajectories from the start states
of dataset windows (K3 in every U-Net call, the classifier's gradient at
every step) and keeps those whose classifier log p clears the task's
`metric_value`, until `ft_target` are kept or `ft_max_rounds` rounds have
run (it raises if none is kept); then takes `ft_gradient_steps` diffusion
updates on batches of `FINETUNE_BATCH` drawn from the kept set by a numpy
generator seeded with `seed`, saving `ckpt_finetuned_latest` every
`save_interval` steps. Each round and each `log_interval` of steps is
logged to `finetune.jsonl`. The antmaze and kitchen CLIs run this loop
with their suite's dataset and evaluation (the JAX package's antmaze and
kitchen CLIs have no `ft_*` overrides and name the checkpoint
`finetuned_ckpt_latest`: the port keeps the MuJoCo CLI's loop for all
three).
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..pipelines import AdaptDiffuserPipeline
from ..utils.config import load_config, parse_cli
from . import diffuser_d4rl_mujoco

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/adaptdiffuser/mujoco"
GENERATION_BATCH = 2000  # start states per round
FINETUNE_BATCH = 32


def build(args, device):
    return diffuser_d4rl_mujoco.build(args, device, pipeline_cls=AdaptDiffuserPipeline)


def finetune(pipe, dataset, args, save_path, logger):
    """The self-evolving stage (the module's docstring)."""
    pipe.load(str(save_path / f"ckpt_{args.ft_ckpt}"))
    target = int(args.get("ft_target", 50_000))
    ft_steps = int(args.get("ft_gradient_steps", 200_000))
    max_rounds = int(args.get("ft_max_rounds", 500))
    metric_value = float(args.task.metric_value)
    generator = torch.Generator(device=pipe.device).manual_seed(args.seed)
    buffer, kept, rounds = [], 0, 0
    while kept < target and rounds < max_rounds:
        t0 = time.perf_counter()
        start_obs = dataset.sample_batch(generator, GENERATION_BATCH)["obs"]["state"][:, 0]
        traj, _ = pipe.generate_and_filter(start_obs, metric_value)
        n = int(traj.shape[0])  # waits for the round
        rounds += 1
        kept += n
        if n:
            buffer.append(traj)
        logger.log({"round": rounds, "generated": len(start_obs), "kept": n,
                    "seconds": time.perf_counter() - t0}, "finetune")
        print(f"selected {kept}/{target} synthetic trajectories", flush=True)
    if not buffer:
        raise RuntimeError(
            "finetune: the reward filter accepted zero trajectories in "
            f"{rounds} rounds: metric_value {metric_value} "
            "is above what the trained planner generates")
    buffer = torch.cat(buffer)[:target]
    rng = np.random.default_rng(args.seed)
    for step in range(ft_steps):
        idx = torch.as_tensor(rng.integers(0, buffer.shape[0], FINETUNE_BATCH),
                              device=buffer.device)
        log = pipe.finetune_step(buffer[idx])
        if (step + 1) % args.log_interval == 0:
            out = {"gradient_steps": step + 1, **{k: float(v) for k, v in log.items()}}
            print(out, flush=True)
            logger.log(out, "finetune")
        if (step + 1) % args.save_interval == 0:
            # ckpt_<tag>: mode=inference ckpt=finetuned_latest serves it
            pipe.save(str(save_path / "ckpt_finetuned_latest"))


def pipeline(args, build=build, reward_mode: str = "mujoco"):
    diffuser_d4rl_mujoco.pipeline(args, build, diffuser_d4rl_mujoco.eval_loop(reward_mode),
                                  finetune)


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

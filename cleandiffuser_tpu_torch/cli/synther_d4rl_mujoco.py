"""SynthER on D4RL-MuJoCo: the port's CLI (counterpart of
pipelines/synther_d4rl_mujoco.py), reading the same `configs/synther/mujoco`
tree.

    python -m cleandiffuser_tpu_torch.cli.synther_d4rl_mujoco mode=train_diffusion
    python -m cleandiffuser_tpu_torch.cli.synther_d4rl_mujoco mode=transition_generation
    python -m cleandiffuser_tpu_torch.cli.synther_d4rl_mujoco mode=train_td3bc
    python -m cleandiffuser_tpu_torch.cli.synther_d4rl_mujoco mode=inference

Runs on the CUDA device, and raises without one, unless the config says
`platform=cpu`. Files go to `results/torch/<pipeline_name>/<env_name>/`:

- `train_diffusion`: the transition model, window by window when the
  intervals allow it; `diff_ckpt_<step>` and `diff_ckpt_latest` on the save
  grid.
- `transition_generation`: `num_transitions` synthetic transitions from
  `diff_ckpt_latest` in sampler calls of up to 100,000 rows;
  `extra_transitions.npy`.
- `train_td3bc`: TD3+BC on the real transitions and the synthetic ones
  (`mix_transitions`: actions clipped to [-1, 1], terminals `tml > 0.5`),
  window by window when the intervals allow it; `td3bc.pt` at the end.
- `inference`: the TD3+BC actor served by `d4rl_eval_loop`.

The antmaze and kitchen CLIs run through `pipeline` here with their suite's
TD dataset and reward mode.
"""

import sys
from pathlib import Path

import numpy as np

from ..dataset import D4RLMuJoCoTDDataset
from ..dataset.base import DeviceTDSampler
from ..parallel import device_of, place_pipeline, setup_mesh
from ..pipelines import TD3BC, SynthERPipeline
from ..pipelines.data_loading import load_d4rl_qlearning_dataset
from ..pipelines.runner import d4rl_eval_loop, planner_window_fn, train_loop
from ..utils.config import load_config, parse_cli
from ..utils.logger import Logger
from ..utils.ranks import is_writer
from ..utils.tensors import set_seed

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs/synther/mujoco"


def td_dataset(args, raw, device):
    """The suite's transition dataset of the raw data."""
    return D4RLMuJoCoTDDataset(raw, args.normalize_reward, device=device)


def mix_transitions(dataset, extra: np.ndarray, device):
    """`dataset` with the synthetic rows [obs, act, rew, next_obs, tml]
    appended (synthetic observations are already normalised; actions
    clipped to [-1, 1]; terminals `tml > 0.5`), its device store rebuilt."""
    o, a = dataset.o_dim, dataset.a_dim
    dataset.obs = np.concatenate([dataset.obs, extra[:, :o]], 0)
    dataset.act = np.concatenate([dataset.act, extra[:, o:o + a].clip(-1, 1)], 0)
    dataset.rew = np.concatenate([dataset.rew, extra[:, o + a:o + a + 1]], 0)
    dataset.next_obs = np.concatenate([dataset.next_obs, extra[:, o + a + 1:2 * o + a + 1]], 0)
    dataset.tml = np.concatenate([dataset.tml, (extra[:, -1:] > 0.5).astype(np.float32)], 0)
    dataset.size = dataset.obs.shape[0]
    dataset._sampler = DeviceTDSampler(
        {"obs": dataset.obs, "next_obs": dataset.next_obs, "act": dataset.act,
         "rew": dataset.rew, "tml": dataset.tml}, device=device)
    return dataset


def build(args, device, td=td_dataset):
    """(raw data, its TD dataset, the SynthER pipeline) on `device`."""
    raw = load_d4rl_qlearning_dataset(args.task.env_name)
    dataset = td(args, raw, device)
    # the shipped configs name no width: the pipeline's (hidden 1024 x 6
    # blocks) unless `+hidden_dim=...` / `+n_blocks=...` add one
    widths = {k: args[k] for k in ("hidden_dim", "n_blocks") if k in args}
    synther = SynthERPipeline(
        obs_dim=dataset.o_dim, act_dim=dataset.a_dim, diffusion_steps=args.diffusion_steps,
        lr=args.diffusion_learning_rate, gradient_steps=args.diffusion_gradient_steps,
        ema_rate=args.ema_rate, rng=args.seed, device=device, **widths,
    )
    return raw, dataset, synther


def build_agent(args, dataset, device, gradient_steps=None):
    kw = {} if gradient_steps is None else {"gradient_steps": gradient_steps}
    return TD3BC(obs_dim=dataset.o_dim, act_dim=dataset.a_dim, rng=args.seed, device=device,
                 **kw)


def pipeline(args, td=td_dataset, reward_mode: str = "mujoco"):
    mesh = setup_mesh(args)  # before the first device use
    device = device_of(args)
    set_seed(args.seed)
    save_path = Path(f"results/torch/{args.pipeline_name}/{args.task.env_name}/")
    save_path.mkdir(parents=True, exist_ok=True)
    logger = Logger(save_path, args.to_dict())

    raw, dataset, synther = build(args, device, td)
    place_pipeline(synther, mesh)
    if mesh is not None:
        dataset.place_on_mesh(mesh)
    extra_path = save_path / "extra_transitions.npy"

    if args.mode == "train_diffusion":
        train_loop(
            lambda g: synther.train_step(dataset.sample_batch(g, args.batch_size)),
            args.diffusion_gradient_steps, args.log_interval, args.save_interval,
            lambda tag: synther.diffusion.save(str(save_path / f"diff_ckpt_{tag}")), logger,
            args.seed, window_fn=planner_window_fn(synther, dataset, args, mesh), device=device,
        )
    elif args.mode == "transition_generation":
        synther.diffusion.load(str(save_path / "diff_ckpt_latest"))
        extra = synther.generate_transitions(args.num_transitions)
        if is_writer():
            np.save(extra_path, extra)
    elif args.mode == "train_td3bc":
        mixed = mix_transitions(td(args, raw, device), np.load(extra_path), device)
        agent = build_agent(args, mixed, device, args.td3bc_gradient_steps)
        place_pipeline(agent, mesh)
        if mesh is not None:
            mixed.place_on_mesh(mesh)
        train_loop(
            lambda g: agent.update(mixed.sample_batch(g, args.batch_size)),
            args.td3bc_gradient_steps, args.log_interval, args.save_interval,
            lambda tag: None, logger, args.seed,
            window_fn=planner_window_fn(agent, mixed, args, mesh,
                                        steps_key="td3bc_gradient_steps"), device=device,
        )
        agent.save(str(save_path / "td3bc.pt"))
    elif args.mode == "inference":
        agent = build_agent(args, dataset, device)
        agent.load(str(save_path / "td3bc.pt"))
        d4rl_eval_loop(lambda nobs: agent.act(nobs).cpu().numpy(), args.task.env_name,
                       dataset.get_normalizer(), args.num_envs, args.num_episodes, args.seed,
                       logger=logger, reward_mode=reward_mode)
    else:
        raise ValueError(f"Invalid mode: {args.mode}")
    logger.finish()


if __name__ == "__main__":
    pipeline(load_config(CONFIG_DIR, "mujoco", parse_cli(sys.argv[1:])))

"""Diffuser's hermetic Goal2D gate over several seeds, in either package.

The gate (tests/test_hermetic_parity.py:203 for the JAX package,
tests/test_torch_hermetic.py for the PyTorch port) trains Diffuser for 2500
steps on the Goal2D behavior data and scores 32 planned episodes against the
task's analytic optimum (1.0) and the uniform-random policy (0.0); its bar is
0.60. This script runs that recipe with the seed as a parameter (the
pipeline's `rng` and the batch draws' seed) and prints one line per seed, so
the gate's spread over seeds can be read in both packages:

    JAX_PLATFORMS=cpu python tools/diffuser_seed_sweep.py --package jax --seeds 0 1 2
    python tools/diffuser_seed_sweep.py --package port --seeds 0 1 2 [--device cuda]

`--package jax` needs the JAX package; `--package port` imports only torch,
unless it is asked to take the JAX pipeline's weights of the same seed, to
separate the initial draw, the training and the planning:
`--jax-weights init` trains the port from JAX's initial weights,
`--jax-weights trained` plans with the port from JAX-trained weights.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEPS, BATCH, ENVS, CANDIDATES = 2500, 64, 32, 16


def config(seed: int) -> dict:
    return dict(obs_dim=2, act_dim=2, horizon=8, model_dim=32, dim_mult=(1, 2),
                diffusion_steps=20, sampling_steps=10, terminal_penalty=0.0, discount=0.99,
                diffusion_gradient_steps=STEPS, classifier_gradient_steps=STEPS, w_cg=5.0,
                rng=seed)


def train_jax(seed: int):
    """The JAX pipeline of the seed, trained as its gate trains it, and the
    dataset."""
    import jax

    from cleandiffuser_tpu.dataset.d4rl_mujoco import D4RLMuJoCoDataset
    from cleandiffuser_tpu.dataset.hermetic import goal2d_sequence_dataset
    from cleandiffuser_tpu.pipelines.diffuser import DiffuserPipeline

    ds = D4RLMuJoCoDataset(goal2d_sequence_dataset(n_episodes=1000, seed=0),
                           terminal_penalty=0.0, horizon=8, max_path_length=40, discount=0.99)
    pipe = DiffuserPipeline(**config(seed))
    rng = jax.random.PRNGKey(seed)
    for _ in range(STEPS):
        rng, k = jax.random.split(rng)
        pipe.train_step(ds.sample_batch(k, BATCH))
    return pipe, ds


def sweep_jax(seed: int) -> float:
    import numpy as np

    from cleandiffuser_tpu.env.goal2d import evaluate_policy, normalized_score_fn

    pipe, ds = train_jax(seed)
    norm = ds.get_normalizer()

    def act_fn(k, obs):
        return pipe.act(np.asarray(norm.normalize(obs)), num_candidates=CANDIDATES, rng=k)[0]

    return normalized_score_fn()(evaluate_policy(act_fn, num_envs=ENVS, seed=1))


def jax_weights(seed: int, trained: bool) -> dict:
    """The JAX pipeline's weights of the seed, initial or trained, as the
    port's `load_jax_params` takes them."""
    import jax
    import numpy as np

    from cleandiffuser_tpu.pipelines.diffuser import DiffuserPipeline

    pipe = train_jax(seed)[0] if trained else DiffuserPipeline(**config(seed))
    tree = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)
    return dict(params=tree(pipe.agent.state.params), ema_params=tree(pipe.agent.state.ema_params),
                cls_params=tree(pipe.classifier.state.params),
                cls_ema_params=tree(pipe.classifier.state.ema_params))


def sweep_port(seed: int, device: str, jax_init: str) -> float:
    import torch

    from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoDataset
    from cleandiffuser_tpu_torch.dataset.hermetic import goal2d_sequence_dataset
    from cleandiffuser_tpu_torch.env.goal2d import evaluate_policy, normalized_score_fn
    from cleandiffuser_tpu_torch.pipelines import DiffuserPipeline

    ds = D4RLMuJoCoDataset(goal2d_sequence_dataset(n_episodes=1000, seed=0),
                           terminal_penalty=0.0, horizon=8, max_path_length=40, discount=0.99,
                           device=device)
    pipe = DiffuserPipeline(**config(seed), use_pallas_block=True, device=device)
    if jax_init != "none":
        pipe.load_jax_params(**jax_weights(seed, trained=jax_init == "trained"))
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(STEPS if jax_init != "trained" else 0):
        pipe.train_step(ds.sample_batch(gen, BATCH))
    norm = ds.get_normalizer()

    def act_fn(gen, obs):
        return pipe.act(norm.normalize(obs), num_candidates=CANDIDATES, generator=gen)[0]

    return normalized_score_fn(device=device)(evaluate_policy(act_fn, num_envs=ENVS, seed=1,
                                                              device=device))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--device", default="cpu", help="the port's device (cpu or cuda)")
    ap.add_argument("--jax-weights", choices=("none", "init", "trained"), default="none",
                    help="the port only: start from JAX's initial weights, or plan with "
                         "JAX-trained ones")
    args = ap.parse_args()
    if args.package == "port" and args.device.startswith("cuda"):
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.package == "jax":
            score = sweep_jax(seed)
        else:
            score = sweep_port(seed, args.device, args.jax_weights)
        print(f"package {args.package} device {args.device if args.package == 'port' else 'cpu'}"
              f" jax weights {args.jax_weights} seed {seed}: normalized score {score:.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Replay of Diffuser's Goal2D training in both packages from one start.

The JAX package's `DiffuserPipeline` and the PyTorch port's train the
Goal2D recipe (tests/test_hermetic_parity.py:203, tools/diffuser_seed_sweep.py)
side by side on the CPU, from the same start and on the same draws:

- the port loads the JAX pipeline's initial weights of the seed (U-Net,
  classifier and both EMAs) through `utils/jax_params.py`;
- every step gathers the batch at the JAX draw's indices
  (`randint(k, (64,), 0, N)`) through the port's device sampler;
- the diffusion loss's (t, eps) and the classifier's noised input (t, eps)
  are the JAX update's own key splits, passed to the port's `train_step` as
  explicit `noise=` / `classifier_noise=` (as tests/test_torch_diffuser_train.py
  replays them).

It prints the largest relative parameter gap (over the U-Net, the classifier
and both EMAs: max |port - jax| of a leaf over max |jax| of that leaf) at
steps 10, 100, 500 and the last, the first step where that gap exceeds 1e-3,
and both EMA planners' Goal2D scores (each package's own evaluation, 32
episodes, 16 candidates):

    JAX_PLATFORMS=cpu python tools/diffuser_replay.py [--seed 0] [--steps 2500]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from diffuser_seed_sweep import BATCH, CANDIDATES, ENVS, config  # noqa: E402

REPORT_AT = (10, 100, 500)
GAP_LIMIT = 1e-3


def jax_draws(jpipe, shape, T):
    """The JAX step's draws, read before it runs: the diffusion update's
    `split(split(state.rng)[1], 3)[0]` and the classifier's noised input
    from `split(_sample_rng)[1]`, each split into (t, eps)."""
    import jax
    import numpy as np
    import torch

    def levels(key):
        k_t, k_eps = jax.random.split(key)
        t = jax.random.randint(k_t, (shape[0],), 0, T)
        return (torch.from_numpy(np.array(t)),
                torch.from_numpy(np.array(jax.random.normal(k_eps, shape))))

    _, sub = jax.random.split(jpipe.agent.state.rng)
    t, eps = levels(jax.random.split(sub, 3)[0])
    _, k_cls = jax.random.split(jpipe.agent._sample_rng)
    return (t, eps, None), levels(k_cls)


def param_gap(tpipe, jpipe) -> float:
    """max over leaves of max |port - jax| / max |jax|."""
    import jax
    import numpy as np

    from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, jax_params_of

    pairs = ((agent_params_of(tpipe.agent.params), jpipe.agent.state.params),
             (agent_params_of(tpipe.agent.ema_params), jpipe.agent.state.ema_params),
             ({"params": jax_params_of(tpipe.classifier.params)}, jpipe.classifier.state.params),
             ({"params": jax_params_of(tpipe.classifier.ema_params)},
              jpipe.classifier.state.ema_params))
    gap = 0.0
    for port, ref in pairs:
        for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(ref)):
            b = np.asarray(b, np.float32)
            gap = max(gap, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)))
    return gap


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2500)
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch

    from cleandiffuser_tpu.dataset.d4rl_mujoco import D4RLMuJoCoDataset as JaxDataset
    from cleandiffuser_tpu.dataset.hermetic import goal2d_sequence_dataset as jax_goal2d
    from cleandiffuser_tpu.env.goal2d import evaluate_policy as jax_evaluate
    from cleandiffuser_tpu.env.goal2d import normalized_score_fn as jax_score_fn
    from cleandiffuser_tpu.pipelines.diffuser import DiffuserPipeline as JaxDiffuser
    from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoDataset
    from cleandiffuser_tpu_torch.dataset.hermetic import goal2d_sequence_dataset
    from cleandiffuser_tpu_torch.env.goal2d import evaluate_policy, normalized_score_fn
    from cleandiffuser_tpu_torch.pipelines import DiffuserPipeline

    torch.set_num_threads(4)
    cfg = dict(config(args.seed), diffusion_gradient_steps=args.steps,
               classifier_gradient_steps=args.steps)
    data = dict(terminal_penalty=0.0, horizon=8, max_path_length=40, discount=0.99)
    jds = JaxDataset(jax_goal2d(n_episodes=1000, seed=0), **data)
    tds = D4RLMuJoCoDataset(goal2d_sequence_dataset(n_episodes=1000, seed=0), **data,
                            device="cpu")
    jpipe = JaxDiffuser(**cfg)
    tpipe = DiffuserPipeline(**cfg, use_pallas_block=True, device="cpu")
    tree = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)
    tpipe.load_jax_params(tree(jpipe.agent.state.params), tree(jpipe.agent.state.ema_params),
                          tree(jpipe.classifier.state.params),
                          tree(jpipe.classifier.state.ema_params))
    print(f"seed {args.seed}, {args.steps} steps, batch {BATCH}; start gap "
          f"{param_gap(tpipe, jpipe):.3e}", flush=True)

    N = len(tds)
    shape = (BATCH, 8, cfg["obs_dim"] + cfg["act_dim"])
    rng = jax.random.PRNGKey(args.seed)
    first_over, t0 = None, time.perf_counter()
    worst_loss = 0.0
    for step in range(1, args.steps + 1):
        rng, k = jax.random.split(rng)
        idx = torch.from_numpy(np.array(jax.random.randint(k, (BATCH,), 0, N)))
        noise, cls_noise = jax_draws(jpipe, shape, cfg["diffusion_steps"])
        lj = jpipe.train_step(jds.sample_batch(k, BATCH))
        lt = tpipe.train_step(D4RLMuJoCoDataset.batch(tds._sampler.gather(idx)),
                              noise=noise, classifier_noise=cls_noise)
        worst_loss = max(worst_loss, max(abs(float(lt[n]) - float(lj[n])) / abs(float(lj[n]))
                                         for n in ("loss", "classifier_loss")))
        gap = param_gap(tpipe, jpipe)
        if first_over is None and gap > GAP_LIMIT:
            first_over = step
            print(f"step {step}: the gap first exceeds {GAP_LIMIT}: {gap:.3e}", flush=True)
        if step in REPORT_AT or step == args.steps:
            print(f"step {step}: largest relative parameter gap {gap:.3e}; largest relative "
                  f"loss gap so far {worst_loss:.3e} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    print(f"first step with a gap above {GAP_LIMIT}: {first_over or 'none'}", flush=True)

    jnorm, tnorm = jds.get_normalizer(), tds.get_normalizer()

    def jax_act(k, obs):
        return jpipe.act(np.asarray(jnorm.normalize(obs)), num_candidates=CANDIDATES, rng=k)[0]

    def port_act(gen, obs):
        return tpipe.act(tnorm.normalize(obs), num_candidates=CANDIDATES, generator=gen)[0]

    s_jax = jax_score_fn()(jax_evaluate(jax_act, num_envs=ENVS, seed=1))
    s_port = normalized_score_fn(device="cpu")(evaluate_policy(port_act, num_envs=ENVS, seed=1,
                                                               device="cpu"))
    print(f"Goal2D score of the EMA planner: JAX {float(s_jax):.4f}, port {float(s_port):.4f} "
          f"(difference {float(s_port) - float(s_jax):+.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

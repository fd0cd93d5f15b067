"""Hermetic score gates of the PyTorch port: Decision Diffuser and Diffuser
trained on the Goal2D behavior data (dataset/hermetic.py) must plan to the
JAX package's bars (tests/test_hermetic_parity.py:132 and :203).

Normalized score 1.0 is the closed-form optimum, 0.0 the uniform-random
policy; the behavior data scores ~0.49. The configurations, step counts,
batch sizes and evaluation sizes are the JAX tests'. Batches come from the
device sampler (`sample_batch` with a seeded torch generator), episodes
from the torch env, on the CUDA device when there is one, else on the CPU.
No JAX import: on the card, run them with
`python -m pytest --noconftest tests/test_torch_hermetic.py -m slow`.

Slow tier (minutes each on a CPU): excluded from the default run.
"""

import pytest
import torch

from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoDataset
from cleandiffuser_tpu_torch.dataset.hermetic import goal2d_sequence_dataset
from cleandiffuser_tpu_torch.env.goal2d import evaluate_policy, normalized_score_fn
from cleandiffuser_tpu_torch.pipelines import DDPipeline, DiffuserPipeline

pytestmark = pytest.mark.slow


@pytest.fixture
def device():
    return "cuda" if torch.cuda.is_available() else "cpu"


def _dataset(device):
    return D4RLMuJoCoDataset(goal2d_sequence_dataset(n_episodes=1000, seed=0),
                             terminal_penalty=0.0, horizon=8, max_path_length=40,
                             discount=0.99, device=device)


def _train(pipe, dataset, steps: int, batch: int):
    gen = torch.Generator(device=pipe.device).manual_seed(0)
    for _ in range(steps):
        pipe.train_step(dataset.sample_batch(gen, batch))


def test_dd_cfg_target_return_near_optimum(device):
    """DD: CFG on the scaled MC return steers plans near the optimum (the
    JAX package measured 0.96 at this budget)."""
    ds, GS = _dataset(device), 3000
    pipe = DDPipeline(obs_dim=2, act_dim=2, horizon=8, emb_dim=64, d_model=128, n_heads=4,
                      depth=2, return_scale=40.0, val_shift=1.0, sampling_steps=10, w_cfg=1.2,
                      target_return=1.0, temperature=0.5, diffusion_gradient_steps=GS,
                      invdyn_gradient_steps=GS, use_pallas_block=True, rng=0, device=device)
    _train(pipe, ds, GS, 64)
    norm = ds.get_normalizer()
    score = normalized_score_fn(device=device)
    s = score(evaluate_policy(lambda gen, obs: pipe.act(norm.normalize(obs), generator=gen)[0],
                              num_envs=64, seed=1, device=device))
    assert s >= 0.85, f"DD normalized score {s:.3f} < 0.85"


def test_diffuser_beats_behavior(device):
    """Diffuser: classifier-guided planning with a horizon of 8 of the 40
    steps is myopic; the bar is beating the 0.49 behavior data clearly (the
    JAX package measured ~0.73 at this budget). At this budget the score
    swings widely with the seed, in both packages: ROADMAP queue 3 logs
    this gate as open for the port."""
    ds, GS = _dataset(device), 2500
    pipe = DiffuserPipeline(obs_dim=2, act_dim=2, horizon=8, model_dim=32, dim_mult=(1, 2),
                            diffusion_steps=20, sampling_steps=10, terminal_penalty=0.0,
                            discount=0.99, diffusion_gradient_steps=GS,
                            classifier_gradient_steps=GS, w_cg=5.0, use_pallas_block=True, rng=0,
                            device=device)
    _train(pipe, ds, GS, 64)
    norm = ds.get_normalizer()
    score = normalized_score_fn(device=device)

    def act_fn(gen, obs):
        return pipe.act(norm.normalize(obs), num_candidates=16, generator=gen)[0]

    s = score(evaluate_policy(act_fn, num_envs=32, seed=1, device=device))
    assert s >= 0.60, f"Diffuser normalized score {s:.3f} < 0.60"

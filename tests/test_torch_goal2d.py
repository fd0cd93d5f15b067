"""The PyTorch port's Goal2D task (env/goal2d.py) against the JAX package's.

Deterministic parts are held exactly or to float32 rounding: the step and
the closed-form optimal return on the same states and actions, and the
brute-force tightness of that closed form (tests/test_hermetic_parity.py:73-98).
The random parts draw from a torch generator, which gives other draws than
JAX's key from one seed, so the normalization anchors (the random policy's
mean return over 4096 episodes, the expected optimum over 100k starts) and
the anchors' checks of test_hermetic_parity.py:64-70 are held to a
Monte-Carlo tolerance: 5 standard errors of the difference of two
independent means, the standard deviation measured on the same
distribution here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.env import goal2d as jg
from cleandiffuser_tpu_torch.env import goal2d as tg

# float32 on both sides: one step, a rounding apart; a sum of 40 norms, in
# another order
STEP_TOL = 1e-6
RETURN_TOL = 1e-5
MC_SIGMAS = 5.0


@pytest.fixture(scope="module")
def scores():
    return jg.normalized_score_fn(), tg.normalized_score_fn(device="cpu")


def _mc_tol(samples: np.ndarray, n: int) -> float:
    """MC_SIGMAS standard errors of the difference of two means of n draws."""
    return MC_SIGMAS * np.sqrt(2.0) * samples.std() / np.sqrt(n)


def test_step_matches_jax():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-2.2, 2.2, (64, 2)).astype(np.float32)
    act = rng.uniform(-1.5, 1.5, (64, 2)).astype(np.float32)  # clipped to the box
    js, jobs, jrew, jdone = jg.Goal2DEnv().step(jg.Goal2DState(jnp.asarray(pos)),
                                                jnp.asarray(act))
    ts, tobs, trew, tdone = tg.Goal2DEnv().step(tg.Goal2DState(torch.from_numpy(pos)),
                                                torch.from_numpy(act))
    # pos + DT * a: XLA may fuse it into one FMA, one rounding fewer
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_array_equal(tobs.numpy(), ts.pos.numpy())
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=STEP_TOL)
    assert not tdone.any() and tdone.shape == (64,)


def test_reset_is_seeded_and_uniform():
    env = tg.Goal2DEnv()
    s1, o1 = env.reset(torch.Generator().manual_seed(0), 4096)
    s2, _ = env.reset(torch.Generator().manual_seed(0), 4096)
    assert torch.equal(s1.pos, s2.pos) and torch.equal(o1, s1.pos)
    assert s1.pos.abs().max() <= 1.0 and abs(float(s1.pos.mean())) < 0.05


def test_optimal_return_matches_jax():
    s0 = np.random.default_rng(1).uniform(-2, 2, (256, 2)).astype(np.float32)
    want = np.asarray(jg.optimal_return(jnp.asarray(s0)))
    got = tg.optimal_return(torch.from_numpy(s0)).numpy()
    np.testing.assert_allclose(got, want, rtol=RETURN_TOL)
    np.testing.assert_allclose(tg.optimal_return(torch.from_numpy(s0), horizon=7).numpy(),
                               np.asarray(jg.optimal_return(jnp.asarray(s0), horizon=7)),
                               rtol=RETURN_TOL)


def test_optimal_return_is_achievable_and_tight():
    """The closed form equals a brute-force greedy rollout; with box actions
    the optimum beats the ball-speed bound on a diagonal start."""
    env = tg.Goal2DEnv()
    s0 = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (64, 2)).astype(np.float32))
    state, total = tg.Goal2DState(s0), torch.zeros(64)
    for _ in range(tg.HORIZON):
        state, _, rew, _ = env.step(state, torch.clamp(-state.pos / tg.DT, -1, 1))
        total = total + rew
    np.testing.assert_allclose(total.numpy(), tg.optimal_return(s0).numpy(), atol=1e-5)
    diag = torch.tensor([[1.0, 1.0]])
    d0 = float(torch.linalg.vector_norm(diag))
    ball_bound = -sum(max(d0 - t * tg.DT, 0.0) for t in range(1, tg.HORIZON + 1))
    assert float(tg.optimal_return(diag)[0]) > ball_bound + 1e-3


def test_anchors_match_jax_within_monte_carlo(scores):
    env = tg.Goal2DEnv()
    gen = torch.Generator().manual_seed(5)
    state, _ = env.reset(gen, 4096)
    total = torch.zeros(4096)
    for _ in range(tg.HORIZON):
        state, _, rew, _ = env.step(state, torch.rand((4096, 2), generator=gen) * 2 - 1)
        total = total + rew
    lo_tol = _mc_tol(total.numpy(), 4096)
    opt = tg.optimal_return(torch.rand((100_000, 2), generator=gen) * 2 - 1).numpy()
    hi_tol = _mc_tol(opt, 100_000)
    j_lo, j_hi = jg.random_return(), jg.expected_optimal_return()
    t_lo, t_hi = scores[1].anchors
    assert abs(t_lo - j_lo) < lo_tol, (t_lo, j_lo, lo_tol)
    assert abs(t_hi - j_hi) < hi_tol, (t_hi, j_hi, hi_tol)
    assert t_lo < t_hi < 0.0
    # each anchor's score is exact by construction
    assert scores[1](t_lo) == 0.0 and abs(scores[1](t_hi) - 1.0) < 1e-12


def test_analytic_anchors(scores):
    """The optimum's return is negative; the behavior data scores ~0.49
    (test_hermetic_parity.py:64-70), on the port's score and data."""
    from cleandiffuser_tpu_torch.dataset.hermetic import goal2d_qlearning_dataset

    s0 = torch.rand((128, 2), generator=torch.Generator().manual_seed(1)) * 2 - 1
    assert float(tg.optimal_return(s0).mean()) < 0.0
    data = goal2d_qlearning_dataset(n_episodes=500, seed=3)
    behavior = scores[1](float(data["rewards"].sum()) / 500)
    assert 0.35 < behavior < 0.65
    # the JAX package's score of the same return, within the anchors' MC gap
    assert abs(behavior - scores[0](float(data["rewards"].sum()) / 500)) < 0.01


def test_evaluate_policy_scores_the_optimal_and_random_policies(scores):
    """The episode loop on the device: the greedy optimal policy scores 1
    and the uniform-random one 0, within Monte-Carlo error of 256 episodes;
    `act_fn` gets the generator and the observations."""
    score = scores[1]
    seen = []

    def optimal(gen, obs):
        seen.append(isinstance(gen, torch.Generator))
        return torch.clamp(-obs / tg.DT, -1, 1)

    s_opt = score(tg.evaluate_policy(optimal, num_envs=256, seed=1, device="cpu"))
    s_rnd = score(tg.evaluate_policy(
        lambda gen, obs: torch.rand(obs.shape, generator=gen) * 2 - 1, num_envs=256, seed=1,
        device="cpu"))
    assert all(seen) and len(seen) == tg.HORIZON
    assert abs(s_opt - 1.0) < 0.05, s_opt
    assert abs(s_rnd) < 0.1, s_rnd


def test_env_loops_default_to_the_gpu():
    """Without a `device` the episode loop and the anchors run on the CUDA
    device and raise without one; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: tg.evaluate_policy(lambda g, o: o, num_envs=2),
                 lambda: tg.random_return(num_envs=2), lambda: tg.normalized_score_fn(n_mc=10)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()

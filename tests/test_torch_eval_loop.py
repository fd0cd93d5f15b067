"""The port's evaluation loop (pipelines/runner.py `d4rl_eval_loop`) and d4rl
scores (pipelines/data_loading.py) against the JAX package's.

Both loops step gymnasium's `HalfCheetah-v5` for halfcheetah-medium-v2, 2
envs, 1 episode, `max_steps=20`, with the same deterministic numpy `act_fn`
and seed: their `episode_rewards` are identical in every reward mode
(mujoco, antmaze, kitchen, maze2d: numpy bookkeeping over the same rewards);
and the antmaze and kitchen modes on their own eval envs. The env tests skip
where gymnasium's MuJoCo envs (or gymnasium_robotics) are not installed.
"""

import numpy as np
import pytest

from cleandiffuser_tpu.pipelines import data_loading as jax_data
from cleandiffuser_tpu.pipelines.runner import d4rl_eval_loop as jax_eval_loop
from cleandiffuser_tpu_torch.pipelines import data_loading
from cleandiffuser_tpu_torch.pipelines.runner import d4rl_eval_loop
from cleandiffuser_tpu_torch.utils.normalizers import GaussianNormalizer

ENV = "halfcheetah-medium-v2"


def _normalizer():
    rng = np.random.default_rng(0)
    return GaussianNormalizer(rng.standard_normal((64, 17)).astype(np.float32) * 2 + 0.5)


def _act(nobs):
    return np.tanh(nobs[:, :6] - 0.3 * nobs[:, 6:12])


@pytest.mark.parametrize("reward_mode", ["mujoco", "antmaze", "kitchen", "maze2d"])
def test_eval_loop_matches_jax(reward_mode):
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    kw = dict(env_name=ENV, normalizer=_normalizer(), num_envs=2, num_episodes=1, seed=3,
              max_steps=20, reward_mode=reward_mode)
    got = d4rl_eval_loop(_act, **kw)
    want = jax_eval_loop(_act, **kw)
    assert got.shape == (1, 2)
    np.testing.assert_array_equal(got, want)
    if reward_mode == "mujoco":
        assert np.all(got != 0)


def test_eval_loop_passes_the_running_reward():
    """An act_fn declaring `ep_reward` receives each env's running reward,
    as the JAX package's does."""
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    seen = {"port": [], "jax": []}

    def act_for(name):
        def act(nobs, ep_reward):
            seen[name].append(np.array(ep_reward))
            return _act(nobs)
        return act

    kw = dict(env_name=ENV, normalizer=_normalizer(), num_envs=2, num_episodes=1, max_steps=5)
    np.testing.assert_array_equal(d4rl_eval_loop(act_for("port"), **kw),
                                  jax_eval_loop(act_for("jax"), **kw))
    np.testing.assert_array_equal(np.stack(seen["port"]), np.stack(seen["jax"]))
    assert len(seen["port"]) == 6 and np.any(seen["port"][-1] != 0)


def test_normalized_scores_match_jax():
    assert data_loading.D4RL_SCORE_RANGES == jax_data.D4RL_SCORE_RANGES
    names = list(data_loading.D4RL_SCORE_RANGES) + [
        "halfcheetah-medium-v2", "maze2d-large-v1", "kitchen-mixed-v0", "pendulum"]
    for name in names:
        for ret in (-300.0, 0.0, 1.0, 4321.5):
            assert data_loading.get_normalized_score_fn(name)(ret) == \
                jax_data.get_normalized_score_fn(name)(ret), name


@pytest.mark.parametrize("reward_mode", ["antmaze", "kitchen"])
def test_eval_loop_matches_jax_on_the_suite_envs(reward_mode):
    """`d4rl_eval_loop` on the antmaze and kitchen eval envs
    (gymnasium_robotics) against the JAX loop on its own wrappers: the same
    episode rewards, clipped to [0, 1] and [0, 4] and scored."""
    pytest.importorskip("gymnasium_robotics")
    env = {"antmaze": "antmaze-medium-play-v2", "kitchen": "kitchen-mixed-v0"}[reward_mode]
    o_dim, a_dim = (29, 8) if reward_mode == "antmaze" else (60, 9)
    rng = np.random.default_rng(0)
    norm = GaussianNormalizer(rng.standard_normal((64, o_dim)).astype(np.float32))
    w = rng.standard_normal((o_dim, a_dim)).astype(np.float32) / np.sqrt(o_dim)
    kw = dict(env_name=env, normalizer=norm, num_envs=2, num_episodes=1, seed=5, max_steps=8,
              reward_mode=reward_mode)
    got = d4rl_eval_loop(lambda nobs: np.tanh(nobs @ w), **kw)
    np.testing.assert_array_equal(got, jax_eval_loop(lambda nobs: np.tanh(nobs @ w), **kw))
    assert got.shape == (1, 2) and np.isfinite(got).all()


def test_locomotion_eval_envs():
    gym = pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    for name, gid in (("hopper-medium-v2", "Hopper-v5"), ("walker2d-medium-v2", "Walker2d-v5")):
        fns = data_loading.make_eval_env_fns(name, 2)
        assert len(fns) == 2
        env = fns[0]()
        assert env.spec.id == gid and isinstance(env, gym.Env)
        env.close()
    with pytest.raises(ValueError):
        data_loading.make_eval_env_fns("pendulum", 1)

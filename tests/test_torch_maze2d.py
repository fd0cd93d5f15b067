"""The port's D4RL-Maze2D datasets and waypoint expert against the JAX
package's.

Datasets, on a seeded maze2d-format stream whose goal events (reward 1,
some in runs) split it into segments of 1 to 400 steps, so segments are cut
to `max_path_length`:

- both packages build the same host arrays (windows, values, indices,
  normaliser statistics) bit for bit, for the goal-segment scan, the
  fixed-length fallback of a stream with no goal event and
  `learn_policy`'s windows, and the TD transitions with and without the IQL
  reward tune;
- the port's device gather at the JAX draw's indices
  (`randint(key, (B,), 0, N)`) gives the JAX batch bit for bit
  (`learn_policy` recentres each window's x-y at its start).

The expert: tests/test_maze2d_expert.py's checks (the generator's schema
and goal events, and the DV dataset reading its stream) on the port; the
generator's stream is the JAX package's bit for bit. It steps
gymnasium_robotics' PointMaze and skips without it; without it the port
raises ImportError naming it. The BFS helpers are checked on a small maze
without any env.
"""

import importlib.util

import jax
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.dataset import d4rl_maze2d as jmaze
from cleandiffuser_tpu.env import maze2d_expert as jexpert
from cleandiffuser_tpu_torch.dataset import (
    D4RLMaze2DTDDataset,
    D4RLMuJoCoTDDataset,
    DV_D4RLMaze2DSeqDataset,
)
from cleandiffuser_tpu_torch.env import maze2d_expert as texpert

HAS_ROBOTICS = importlib.util.find_spec("gymnasium_robotics") is not None
SEQ_ARRAYS = ("seq_obs", "seq_act", "seq_rew", "seq_val", "indices")


def _stream(seed=0, n=2400, goals=True):
    rng = np.random.default_rng(seed)
    rew = np.zeros(n, np.float32)
    if goals:
        t = 30
        while t < n:
            run = rng.integers(1, 4)
            rew[t:t + run] = 1.0
            t += run + rng.integers(1, 400)
    return {"observations": rng.standard_normal((n, 4)).astype(np.float32) * 2,
            "actions": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
            "rewards": rew, "terminals": np.zeros(n, np.float32),
            "timeouts": np.zeros(n, np.float32)}


def _jax_indices(key, batch, n):
    return torch.from_numpy(np.asarray(jax.random.randint(key, (batch,), 0, n)).astype(np.int64))


def _same_arrays(td, jd, names):
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(td, name)),
                                      np.asarray(getattr(jd, name)), err_msg=name)
    for stat in ("mean", "std"):
        np.testing.assert_array_equal(getattr(td.get_normalizer(), stat),
                                      getattr(jd.get_normalizer(), stat))


def _same_batch(jbatch, tbatch):
    jl = jax.tree_util.tree_leaves_with_path(jbatch)
    tl = jax.tree_util.tree_leaves_with_path(tbatch)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=jax.tree_util.keystr(path))


SEQ_CASES = {
    "goals": (dict(goals=True), dict(horizon=8, max_path_length=300, stride=3,
                                     reward_tune="iql", continous_reward_at_done=True,
                                     discount=1.0)),
    "goals-uncentred": (dict(goals=True), dict(horizon=4, max_path_length=120,
                                               center_mapping=False, discount=0.99)),
    "no-goals": (dict(goals=False), dict(horizon=6, max_path_length=300, stride=2)),
    "learn-policy": (dict(goals=True), dict(horizon=5, max_path_length=200, stride=2,
                                            learn_policy=True, reward_tune="iql")),
}


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_dv_maze2d_dataset_matches_jax(case):
    stream_kw, kw = SEQ_CASES[case]
    raw = _stream(**stream_kw)
    jd = jmaze.DV_D4RLMaze2DSeqDataset(dict(raw), **kw)
    td = DV_D4RLMaze2DSeqDataset(dict(raw), device="cpu", **kw)
    _same_arrays(td, jd, SEQ_ARRAYS)
    assert len(td) == len(jd) and td.seq_obs.shape[0] > 1
    for i in (0, len(td) // 2, len(td) - 1):
        for a, b in zip(jax.tree_util.tree_leaves(jd[i]), jax.tree_util.tree_leaves(td[i])):
            np.testing.assert_array_equal(a, b)
    key = jax.random.PRNGKey(3)
    jbatch = jd.sample_batch(key, 16)
    tbatch = td.gather(_jax_indices(key, 16, len(td)))
    _same_batch(jbatch, tbatch)
    g = torch.Generator().manual_seed(0)
    out = td.sample_batch(g, 5)
    assert out["obs"]["state"].shape == (5, kw["horizon"], 4)
    if kw.get("learn_policy"):
        assert (out["obs"]["state"][:, 0, :2] == 0).all()


@pytest.mark.parametrize("reward_tune", ["none", "iql"])
def test_maze2d_td_dataset_matches_jax(reward_tune):
    raw = _stream(1)
    jd = jmaze.D4RLMaze2DTDDataset(dict(raw), reward_tune=reward_tune)
    td = D4RLMaze2DTDDataset(dict(raw), reward_tune=reward_tune, device="cpu")
    _same_arrays(td, jd, ("obs", "next_obs", "act", "rew", "tml"))
    assert td.tml.sum() == raw["rewards"].sum()
    key = jax.random.PRNGKey(4)
    out = td._sampler.gather(_jax_indices(key, 32, len(td)))
    _same_batch(jd.sample_batch(key, 32), D4RLMuJoCoTDDataset.batch(out))


def test_maze2d_td_uses_given_next_observations():
    raw = _stream(2, n=300)
    raw["next_observations"] = raw["observations"][::-1].copy()
    jd = jmaze.D4RLMaze2DTDDataset(dict(raw))
    td = D4RLMaze2DTDDataset(dict(raw), device="cpu")
    np.testing.assert_array_equal(td.next_obs, jd.next_obs)


def test_bfs_helpers_match_jax():
    maze = [[1, 1, 1, 1, 1],
            [1, 0, 0, 0, 1],
            [1, 1, 1, 0, 1],
            [1, 0, 0, 0, 1],
            [1, 1, 1, 1, 1]]
    assert texpert._open_cells(maze) == jexpert._open_cells(maze)
    path = texpert._bfs_path(maze, (1, 1), (3, 1))
    assert path == jexpert._bfs_path(maze, (1, 1), (3, 1))
    assert path[0] == (1, 1) and path[-1] == (3, 1) and len(path) == 7
    assert texpert._bfs_path(maze, (1, 1), (0, 0)) == [(0, 0)]


@pytest.mark.skipif(HAS_ROBOTICS, reason="checks the error raised without gymnasium_robotics")
def test_generator_names_missing_gymnasium_robotics():
    with pytest.raises(ImportError, match="gymnasium_robotics"):
        texpert.generate_maze2d_dataset("maze2d-umaze-v1", n_steps=10)


@pytest.fixture(scope="module")
def umaze_data():
    if not HAS_ROBOTICS:
        pytest.skip("the maze2d expert steps gymnasium_robotics' PointMaze")
    return texpert.generate_maze2d_dataset("maze2d-umaze-v1", n_steps=1500, seed=3)


def test_generator_schema_and_goal_events(umaze_data):
    data = umaze_data
    assert set(data) == {"observations", "actions", "rewards", "terminals", "timeouts"}
    n = data["rewards"].shape[0]
    assert data["observations"].shape == (n, 4) and data["actions"].shape == (n, 2)
    assert np.all(np.abs(data["actions"]) <= 1.0)
    assert np.all(np.isfinite(data["observations"]))
    assert data["rewards"].sum() >= 5
    assert data["terminals"].sum() == 0 and data["timeouts"][-1] == 1
    want = jexpert.generate_maze2d_dataset("maze2d-umaze-v1", n_steps=1500, seed=3)
    for k in want:
        np.testing.assert_array_equal(data[k], want[k], err_msg=k)


def test_dv_dataset_consumes_generated_stream(umaze_data):
    ds = DV_D4RLMaze2DSeqDataset(dict(umaze_data), horizon=32, discount=1.0,
                                 center_mapping=True, reward_tune="iql",
                                 continous_reward_at_done=True, stride=15, device="cpu")
    assert len(ds) > 0
    batch = ds.sample_batch(torch.Generator().manual_seed(0), 4)
    for leaf in (batch["obs"]["state"], batch["act"], batch["val"]):
        assert torch.isfinite(leaf).all()

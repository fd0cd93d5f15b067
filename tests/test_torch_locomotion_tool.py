"""The port's locomotion-data tool (cli/make_locomotion_dataset.py) against
the JAX package's (tools/make_locomotion_dataset.py).

`to_qlearning` on the same stream gives the same transition view (with
tests/test_sac.py's own gate on the port's), `rollout` of the same actor
snapshot on HalfCheetah-v5 gives the same stream bit for bit, timeouts
marked at the truncation and at each env's last row, and a short real run
(`--platform cpu --replay-only`, 4 envs, a 128-step warm-up, 512 steps)
writes the medium-replay snapshot schema, which the port's
`load_d4rl_dataset` / `load_d4rl_qlearning_dataset` and the MuJoCo
datasets read unchanged. The gymnasium cases skip only when gymnasium's
MuJoCo envs are absent.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cleandiffuser_tpu_torch.cli import make_locomotion_dataset as tool

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import make_locomotion_dataset as jax_tool  # noqa: E402

torch.set_num_threads(1)


def _mujoco():
    gym = pytest.importorskip("gymnasium")
    try:
        gym.make("HalfCheetah-v5").close()
    except Exception as e:  # gymnasium without its MuJoCo envs
        pytest.skip(f"gymnasium's MuJoCo envs are absent: {e}")


def test_port_qlearning_view_drops_episode_boundaries():
    """tests/test_sac.py's case on the port, and the same view as the JAX
    tool's, bit for bit."""
    n = 10
    data = {
        "observations": np.arange(n * 2, dtype=np.float32).reshape(n, 2),
        "actions": np.arange(n, dtype=np.float32)[:, None],
        "rewards": np.arange(n, dtype=np.float32),
        "terminals": np.zeros((n,), np.float32),
        "timeouts": np.zeros((n,), np.float32),
    }
    data["terminals"][4] = 1.0  # rows 5.. belong to a new episode
    data["timeouts"][7] = 1.0
    q = tool.to_qlearning(data)
    assert q["observations"].shape[0] == n - 2
    assert 4.0 in q["rewards"] and q["terminals"].sum() == 1
    assert 7.0 not in q["rewards"]
    np.testing.assert_allclose(q["next_observations"][:4], data["observations"][1:5])
    want = jax_tool.to_qlearning(data)
    assert q.keys() == want.keys()
    for k in q:
        np.testing.assert_array_equal(q[k], want[k])


def _actor(obs_dim, act_dim, seed=0):
    """A seeded actor snapshot in the flax layout both packages take."""
    rng = np.random.default_rng(seed)
    dims = [(obs_dim, 256), (256, 256), (256, act_dim), (256, act_dim)]
    return {"params": {f"Dense_{i}": {
        "kernel": (rng.standard_normal(d) / np.sqrt(d[0])).astype(np.float32),
        "bias": (rng.standard_normal(d[1]) * 0.1).astype(np.float32)}
        for i, d in enumerate(dims)}}


def test_rollout_matches_jax_tool():
    """2 envs x 1005 steps: each env's stream crosses HalfCheetah's
    1000-step truncation, which the rollout marks as a timeout, and skips
    the reset row that follows it."""
    _mujoco()
    actor = _actor(17, 6)
    got = tool.rollout("halfcheetah", actor, 2 * 1005, seed=3, n_envs=2)
    want = jax_tool.rollout("halfcheetah", actor, 2 * 1005, seed=3, n_envs=2)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    per = 1005
    assert got["observations"].shape == (2 * per, 17)
    # the truncation at step 1000 and the end of each env's column
    np.testing.assert_array_equal(np.nonzero(got["timeouts"])[0],
                                  [999, per - 1, per + 999, 2 * per - 1])
    assert got["terminals"].sum() == 0
    q, q_want = tool.to_qlearning(got), jax_tool.to_qlearning(want)
    for k in q:
        np.testing.assert_array_equal(q[k], q_want[k], err_msg=k)


def test_evaluate_mean_matches_jax_tool():
    _mujoco()
    actor = _actor(17, 6, seed=1)
    for stochastic in (False, True):
        assert (tool.evaluate_mean("HalfCheetah-v5", actor, episodes=1, seed=2,
                                   stochastic=stochastic)
                == jax_tool.evaluate_mean("HalfCheetah-v5", actor, episodes=1, seed=2,
                                          stochastic=stochastic))


def test_replay_only_run_writes_the_schema(tmp_path, monkeypatch):
    """`main` on HalfCheetah-v5 on the CPU: 4 envs, 128 warm-up steps of
    random actions, then the collector's updates (K = 4 of batch 256 per
    iteration) to 512 steps, with a gate eval every 256; the gate is not
    reached, so the final ring is the medium-replay export. The files load
    through the port's data loading into its MuJoCo datasets."""
    _mujoco()
    from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoDataset, D4RLMuJoCoTDDataset
    from cleandiffuser_tpu_torch.pipelines.data_loading import (
        load_d4rl_dataset,
        load_d4rl_qlearning_dataset,
    )

    calls = []

    def train_sac(*args, **kwargs):
        calls.append(kwargs)
        return orig(*args, warmup=128, **kwargs)

    orig = tool.train_sac
    monkeypatch.setattr(tool, "train_sac", train_sac)
    monkeypatch.setenv("CLEANDIFFUSER_DATA", str(tmp_path))
    tool.main(["halfcheetah", "--platform", "cpu", "--replay-only", "--n-envs", "4",
               "--max-steps", "512", "--eval-every", "256"])
    assert calls and calls[0]["device"] == "cpu" and calls[0]["stop_at_medium"]
    assert calls[0]["out_dir"] == tmp_path
    name = "halfcheetah-medium-replay-v2"
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [f"{name}.npz",
                                                                f"{name}.qlearning.npz"]
    data, q = load_d4rl_dataset(name), load_d4rl_qlearning_dataset(name)
    assert set(data) == {"observations", "actions", "rewards", "terminals", "timeouts"}
    assert set(q) == {"observations", "actions", "next_observations", "rewards", "terminals"}
    n = 512  # no episode ends within 128 steps per env: every row is valid
    assert data["observations"].shape == (n, 17) and data["actions"].shape == (n, 6)
    assert q["observations"].shape == (n, 17) and q["next_observations"].shape == (n, 17)
    assert np.all(np.abs(data["actions"]) <= 1.0)
    assert np.isfinite(data["rewards"]).all() and data["terminals"].sum() == 0
    # 4 env segments of 128 rows, each ending in a timeout
    np.testing.assert_array_equal(np.nonzero(data["timeouts"])[0], [127, 255, 383, 511])
    # the transition view's successors are the stored ones: within one env
    # stream they are the next row's observation
    seq_obs = data["observations"]
    assert any(np.array_equal(q["next_observations"][0], o) for o in seq_obs[1:128])
    seq = D4RLMuJoCoDataset(data, horizon=32, device="cpu")
    td = D4RLMuJoCoTDDataset(q, device="cpu")
    assert len(seq) > 0 and len(td) == n

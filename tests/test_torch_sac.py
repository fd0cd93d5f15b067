"""The port's online SAC (utils/sac.py) against the JAX package's.

Every case of tests/test_sac.py on the port (the ring's wrap and export,
the update window learning a constant-reward MDP, acting, the collector's
masked ring and its exports, a checkpoint round trip; the tool's
qlearning view is in test_torch_locomotion_tool.py), then the port
against the reference on the same state and the reference's own draws
replayed: the weights and Adam state come from a JAX `SAC.save` pickle
(`SAC.load_jax_checkpoint`), and the squash draws from the reference's key
splits (`k1, k2 = split(key)` per update; a window's keys `split(kk, K)`;
the collector's `ka, ki, ku = split(key, 3)`, its u from `ki`).

Tolerances: TOL = 1e-5 absolute and relative for parameters, the target,
log alpha, the Adam moments, the logs and the actions. Both sides compute
in float32 and differ in the order of float32 sums (read: the state 6.0e-7
of its scale after a K = 4 window, the logs within 2e-6). The rings and both export views are bit for bit:
the same rows go in on both sides.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.utils.sac import SAC as JaxSAC
from cleandiffuser_tpu.utils.sac import DeviceCollector as JaxCollector
from cleandiffuser_tpu.utils.sac import NumpyActor as JaxNumpyActor
from cleandiffuser_tpu.utils.sac import ReplayRing as JaxRing
from cleandiffuser_tpu_torch.utils.jax_params import jax_params_of
from cleandiffuser_tpu_torch.utils.sac import (
    SAC,
    DeviceCollector,
    NumpyActor,
    ReplayRing,
    squash,
)

torch.set_num_threads(1)

TOL = 1e-5
O, A, B, K = 3, 2, 8, 4


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, what):
    g, w = jax.tree_util.tree_leaves(_np(got)), jax.tree_util.tree_leaves(_np(want))
    assert len(g) == len(w) and len(g) > 0, what
    gap = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0)) for a, b in zip(g, w))
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=f"{what} (gap {gap:.2e})")
    return gap


def _moments(opt, net):
    """The Adam moments of `net`'s params in `opt`, as flax trees."""
    trees = []
    for key in ("exp_avg", "exp_avg_sq"):
        view = copy.deepcopy(net)
        with torch.no_grad():
            for p, q in zip(view.parameters(), net.parameters()):
                p.copy_(opt.state[q][key])
        trees.append(jax_params_of(view))
    return trees


def _same_state(tsac, jsac):
    """Parameters, target, log alpha and all three Adams, within TOL."""
    ts, js = tsac.state, jsac.state
    gaps = [_close(jax_params_of(getattr(ts, n)), js_n["params"], n)
            for n, js_n in (("actor", js.actor), ("critic", js.critic),
                            ("target_critic", js.target_critic))]
    gaps.append(_close(ts.log_alpha.detach().numpy(), js.log_alpha, "log_alpha"))
    for opt, net, jopt in ((ts.actor_opt, ts.actor, js.actor_opt),
                           (ts.critic_opt, ts.critic, js.critic_opt)):
        mu, nu = _moments(opt, net)
        gaps += [_close(mu, jopt[0].mu["params"], "mu"), _close(nu, jopt[0].nu["params"], "nu")]
        for p in net.parameters():
            assert int(opt.state[p]["step"]) == int(jopt[0].count)
    st = ts.alpha_opt.state[ts.log_alpha]
    gaps += [_close(st["exp_avg"].numpy(), js.alpha_opt[0].mu, "alpha mu"),
             _close(st["exp_avg_sq"].numpy(), js.alpha_opt[0].nu, "alpha nu")]
    assert int(st["step"]) == int(js.alpha_opt[0].count)
    return max(gaps)


def _logs_close(got, want):
    for k in ("critic_loss", "actor_loss", "alpha", "q_mean"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=TOL, rtol=TOL, err_msg=k)


def _stack(rng, k, b, obs_dim=O, act_dim=A, const_reward=False):
    return {
        "obs": rng.normal(0, 1.0, (k, b, obs_dim)).astype(np.float32),
        "act": rng.uniform(-1, 1, (k, b, act_dim)).astype(np.float32),
        "rew": (np.ones((k, b)) if const_reward else rng.normal(0, 1, (k, b))).astype(np.float32),
        "next_obs": rng.normal(0, 1.0, (k, b, obs_dim)).astype(np.float32),
        "term": (rng.uniform(size=(k, b)) < 0.2).astype(np.float32),
    }


def _update_draws(key, b=B, act_dim=A):
    k1, k2 = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, (b, act_dim)))) for k in (k1, k2))


def _window_draws(kk, k, b=B, act_dim=A):
    per = [_update_draws(key, b, act_dim) for key in jax.random.split(kk, k)]
    return torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per])


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    """A JAX SAC after two K-update windows (Adam moments and counts not
    trivial), its `save` pickle loaded into a port SAC on the CPU."""
    jsac = JaxSAC(O, A, rng=0)
    rng = np.random.default_rng(0)
    for _ in range(2):
        jsac.update_window(_stack(rng, K, B))
    path = tmp_path_factory.mktemp("sac") / "sac.pkl"
    jsac.save(str(path))
    tsac = SAC(O, A, rng=0, device="cpu")
    tsac.load_jax_checkpoint(str(path))
    return jsac, tsac, path


# ---------------------------------------------------------------------------
# tests/test_sac.py on the port
def test_port_replay_ring_wrap_and_export_equal_jax():
    rings = (ReplayRing(10, 2, 1), JaxRing(10, 2, 1))
    for i in range(14):
        for ring in rings:
            ring.add_batch(np.full((1, 2), i, np.float32), np.zeros((1, 1), np.float32),
                           np.array([i], np.float32), np.full((1, 2), i + 1, np.float32),
                           np.zeros((1,), np.float32))
    assert rings[0].size == 10 and rings[0].ptr == 4
    data, want = rings[0].export(), rings[1].export()
    np.testing.assert_allclose(data["rewards"], np.arange(4, 14))
    assert data["timeouts"].sum() == 0
    assert data.keys() == want.keys()
    for k in data:
        np.testing.assert_array_equal(data[k], want[k])
    mask = (np.arange(10) % 3 == 0).astype(np.float32)
    np.testing.assert_array_equal(rings[0].export(mask)["timeouts"],
                                  rings[1].export(mask)["timeouts"])
    got = rings[0].gather_stack(np.random.default_rng(1), 3, 4)
    ref = rings[1].gather_stack(np.random.default_rng(1), 3, 4)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_port_update_window_learns_constant_reward_mdp():
    """One-state MDP, reward 1, gamma 0.9: Q* = 10. After a few hundred
    updates the critic moves decisively toward it (the JAX test's gate)."""
    sac = SAC(obs_dim=2, act_dim=1, gamma=0.9, rng=0, device="cpu")
    rng = np.random.default_rng(0)

    def stack():
        s = _stack(rng, 8, 64, 2, 1, const_reward=True)
        s["obs"], s["next_obs"] = s["obs"] * 0.1, s["next_obs"] * 0.1
        s["term"] = np.zeros_like(s["term"])
        return s

    first = sac.update_window(stack())
    for _ in range(60):
        log = sac.update_window(stack())
    assert float(log["q_mean"]) > 3.0, log
    assert np.isfinite(float(log["critic_loss"]))
    assert float(log["q_mean"]) > float(first["q_mean"])


def test_port_act_shapes_and_determinism():
    sac = SAC(obs_dim=3, act_dim=2, rng=1, device="cpu")
    obs = np.zeros((5, 3), np.float32)
    a1 = sac.act(obs, deterministic=True)
    a2 = sac.act(obs, deterministic=True)
    np.testing.assert_array_equal(a1, a2)
    assert a1.shape == (5, 2) and np.all(np.abs(a1) <= 1.0)
    assert not np.allclose(sac.act(obs), sac.act(obs))  # the stochastic path samples


def test_port_sac_checkpoint_roundtrip(tmp_path):
    sac = SAC(obs_dim=2, act_dim=1, rng=0, device="cpu")
    sac.update_window(_stack(np.random.default_rng(2), 2, 4, 2, 1))
    obs = np.ones((3, 2), np.float32)
    p = str(tmp_path / "sac.pt")
    sac.save(p)
    sac2 = SAC(obs_dim=2, act_dim=1, rng=9, device="cpu")
    sac2.load(p)
    np.testing.assert_array_equal(sac2.act(obs, deterministic=True),
                                  sac.act(obs, deterministic=True))
    # the optimizers' state came along: the next window is the same
    stack = _stack(np.random.default_rng(3), 2, 4, 2, 1)
    noise = tuple(torch.randn(2, 4, 1, generator=torch.Generator().manual_seed(s)) for s in (0, 1))
    la, lb = sac.update_window(stack, noise), sac2.update_window(stack, noise)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


# ---------------------------------------------------------------------------
# against the JAX package
def test_squash_matches_jax():
    from cleandiffuser_tpu.utils.sac import _squash

    rng = np.random.default_rng(4)
    mu, ls = rng.normal(size=(6, A)).astype(np.float32), rng.normal(size=(6, A)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    act_j, logp_j = _squash(jnp.asarray(mu), jnp.asarray(ls), key)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (6, A))))
    act_t, logp_t = squash(torch.from_numpy(mu), torch.from_numpy(ls), eps)
    np.testing.assert_allclose(act_t.numpy(), np.asarray(act_j), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), atol=TOL, rtol=TOL)


def test_jax_checkpoint_loads_whole(synced):
    """The pickle carried every field: nets, target, log alpha, the Adams."""
    jsac, tsac, _ = synced
    assert _same_state(tsac, jsac) == 0.0


def test_update_step_matches_jax(synced):
    jsac, _, path = synced
    tsac = SAC(O, A, rng=5, device="cpu")
    tsac.load_jax_checkpoint(str(path))
    batch = {k: v[0] for k, v in _stack(np.random.default_rng(7), 1, B).items()}
    key = jax.random.PRNGKey(11)
    state, want = jsac._update_step(jsac.state, jax.tree_util.tree_map(jnp.asarray, batch), key)
    got = tsac.update_step(batch, noise=_update_draws(key))
    _logs_close(got, want)
    ref = JaxSAC.__new__(JaxSAC)
    ref.state = state
    gap = _same_state(tsac, ref)
    assert gap < TOL, gap


def test_update_window_matches_jax(synced):
    """A K = 4 window on both, from the same pickle, JAX's draws replayed;
    then the port's state is the reference's next state."""
    jsac, _, path = synced
    tsac = SAC(O, A, rng=5, device="cpu")
    tsac.load_jax_checkpoint(str(path))
    jref = JaxSAC(O, A, rng=3)
    jref.load(str(path))
    stack = _stack(np.random.default_rng(8), K, B)
    _, kk = jax.random.split(jref._rng)
    noise = _window_draws(kk, K)
    want = jref.update_window(stack)
    got = tsac.update_window(stack, noise)
    _logs_close(got, want)
    gap = _same_state(tsac, jref)
    assert gap < TOL, gap
    # a NumpyActor of either package's snapshot gives the same actions
    obs = np.random.default_rng(9).normal(size=(5, O)).astype(np.float32)
    np.testing.assert_allclose(NumpyActor(tsac.snapshot_actor())(obs),
                               JaxNumpyActor(jref.snapshot_actor())(obs), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(NumpyActor(jref.snapshot_actor())(obs),
                                  JaxNumpyActor(jref.snapshot_actor())(obs))
    for seed in (0, 1):
        np.testing.assert_array_equal(
            NumpyActor(jref.snapshot_actor())(obs, np.random.default_rng(seed)),
            JaxNumpyActor(jref.snapshot_actor())(obs, np.random.default_rng(seed)))
    np.testing.assert_allclose(tsac.act(obs, deterministic=True),
                               jref.act(obs, deterministic=True), atol=TOL, rtol=TOL)


def test_act_matches_jax(synced):
    jsac, tsac, _ = synced
    obs = np.random.default_rng(10).normal(size=(5, O)).astype(np.float32)
    _, k = jax.random.split(jsac._rng)
    eps = np.array(jax.random.normal(k, (5, A)))
    want = jsac.act(obs)
    np.testing.assert_allclose(tsac.act(obs, noise=eps), want, atol=TOL, rtol=TOL)


def _collector_draws(sac_rng, k, b, n, act_dim=A):
    """The draws of one `DeviceCollector.step` of the reference."""
    _, key = jax.random.split(sac_rng)
    ka, ki, ku = jax.random.split(key, 3)
    return {"act": np.array(jax.random.normal(ka, (n, act_dim))),
            "u": np.array(jax.random.uniform(ki, (k, b))),
            "squash": _window_draws(ku, k, b, act_dim)}


def test_device_collector_matches_jax_and_its_gate(synced):
    """tests/test_sac.py's collector case on both packages in lockstep,
    the same rows fed to both (JAX's actions): the port's actions and logs
    within TOL of JAX's, its ring and both export views bit for bit, and
    the reference's own gate on the port's views."""
    _, _, path = synced
    n = 4
    jsac, tsac = JaxSAC(O, A, rng=0), SAC(O, A, rng=0, device="cpu")
    jsac.load(str(path))
    tsac.load_jax_checkpoint(str(path))
    jcol = JaxCollector(jsac, capacity=32, n_envs=n, batch_size=8, updates_per_iter=2)
    tcol = DeviceCollector(tsac, capacity=32, n_envs=n, batch_size=8, updates_per_iter=2)
    with pytest.raises(ValueError, match="empty ring"):
        tcol.step(np.zeros((n, O), np.float32), None, update=True)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((n, O)).astype(np.float32)
    new, written = None, []
    for it in range(6):
        draws = _collector_draws(jsac._rng, 2, 8, n)
        act, log = jcol.step(obs, new, update=it >= 2)
        act_t, log_t = tcol.step(obs, new, update=it >= 2, draws=draws)
        np.testing.assert_allclose(act_t, act, atol=TOL, rtol=TOL)
        _logs_close(log_t, log)
        assert act_t.shape == (n, A) and np.all(np.abs(act_t) <= 1.0)
        assert (tcol.ptr, tcol.size) == (jcol.ptr, jcol.size)
        nobs = rng.standard_normal((n, O)).astype(np.float32)
        mask = np.ones((n,), np.float32)
        mask[it % n] = 0.0  # one autoreset row per iteration
        new = {"obs": obs, "act": act, "rew": np.full((n,), float(it), np.float32),
               "next_obs": nobs, "term": (rng.uniform(size=n) < 0.2).astype(np.float32),
               "done": (rng.uniform(size=n) < 0.3).astype(np.float32),
               "env": np.arange(n, dtype=np.int32), "mask": mask}
        for i in range(n):
            if mask[i]:
                written.append((i, float(it), obs[i].copy(), nobs[i].copy()))
        obs = nobs
    for k, v in jcol.ring.items():
        np.testing.assert_array_equal(tcol.ring[k].numpy(), np.asarray(v), err_msg=k)
    assert _same_state(tsac, jsac) < TOL
    ex, want = tcol.export(), jcol.export()
    q, q_want = ex.pop("qlearning"), want.pop("qlearning")
    assert ex.keys() == want.keys() and q.keys() == q_want.keys()
    for k in ex:
        np.testing.assert_array_equal(ex[k], want[k], err_msg=k)
    for k in q:
        np.testing.assert_array_equal(q[k], q_want[k], err_msg=k)
    # the reference's gate, on the port: the last `new` not yet flushed
    assert tcol.size == len(written) - (n - 1)
    kept = written[:tcol.size]
    for row, (env_i, rew, o, no) in enumerate(kept):
        np.testing.assert_array_equal(q["observations"][row], o)
        np.testing.assert_array_equal(q["next_observations"][row], no)
        assert q["rewards"][row] == rew
    envs_of = np.array([w[0] for w in kept])
    np.testing.assert_array_equal(ex["rewards"],
                                  np.array([w[1] for w in kept])[np.argsort(envs_of,
                                                                            kind="stable")])
    assert ex["timeouts"].sum() >= len(np.unique(envs_of))


def test_device_collector_wraps_the_ring():
    """Past capacity the ring overwrites its oldest rows and the export
    starts at ptr, as the reference's."""
    n, cap = 4, 10
    jsac, tsac = JaxSAC(O, A, rng=0), SAC(O, A, rng=0, device="cpu")
    jcol = JaxCollector(jsac, capacity=cap, n_envs=n, batch_size=4, updates_per_iter=1)
    tcol = DeviceCollector(tsac, capacity=cap, n_envs=n, batch_size=4, updates_per_iter=1)
    rng = np.random.default_rng(1)
    obs = np.zeros((n, O), np.float32)
    for it in range(5):
        new = {"obs": rng.standard_normal((n, O)).astype(np.float32),
               "act": rng.uniform(-1, 1, (n, A)).astype(np.float32),
               "rew": np.full((n,), float(it), np.float32),
               "next_obs": rng.standard_normal((n, O)).astype(np.float32),
               "term": np.zeros((n,), np.float32), "done": np.zeros((n,), np.float32),
               "env": np.arange(n, dtype=np.int32),
               "mask": (np.arange(n) != it % n).astype(np.float32)}
        jcol.step(obs, new, update=False)
        tcol.step(obs, new, update=False, draws={"act": np.zeros((n, A), np.float32)})
        assert (tcol.ptr, tcol.size) == (jcol.ptr, jcol.size)
    assert tcol.size == cap
    ex, want = tcol.export(), jcol.export()
    for k in ("observations", "rewards", "timeouts"):
        np.testing.assert_array_equal(ex[k], want[k], err_msg=k)
    np.testing.assert_array_equal(ex["qlearning"]["rewards"], want["qlearning"]["rewards"])


def test_jax_pickle_then_next_window_matches_jax(synced, tmp_path):
    """A JAX `SAC.save` pickle loaded by the port after one more JAX window:
    the port's next window matches the reference's next one."""
    jsac, _, path = synced
    jref = JaxSAC(O, A, rng=4)
    jref.load(str(path))
    jref.update_window(_stack(np.random.default_rng(12), K, B))
    p2 = tmp_path / "sac2.pkl"
    jref.save(str(p2))
    tsac = SAC(O, A, rng=5, device="cpu")
    tsac.load_jax_checkpoint(str(p2))
    assert _same_state(tsac, jref) == 0.0
    stack = _stack(np.random.default_rng(13), K, B)
    _, kk = jax.random.split(jref._rng)
    got = tsac.update_window(stack, _window_draws(kk, K))
    want = jref.update_window(stack)
    _logs_close(got, want)
    assert _same_state(tsac, jref) < TOL

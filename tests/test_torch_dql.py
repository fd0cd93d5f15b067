"""The port's DQL and EDP training and acting against the JAX package's.

Same weights (seeded normals in the JAX layout for the actor, a different
EMA, the critic and a different critic target, carried in by the
converter), same batches, and the JAX step's own draws replayed through
`train_step(noise=)`: `rng, k_next, k_bc, k_new, k_coin = split(rng, 5)`
(EDP: `k_next, k_bc, k_t, k_eps, k_coin`), the samplers' draws from their
keys as the sampler splits them, the BC loss's (t, eps) from
`k_noise, _, _ = split(k_bc, 3)`, `k_t, k_eps = split(k_noise)`.

Both packages start at actor step 1000 with `ema_update_interval=2`, so the
3 steps cross both gates: steps 1000 and 1002 move the EMA and the critic
target, step 1001 neither. Checked per step: the four logs; after 3 steps:
the actor's params, EMA, the critic, its target, the counts and steps.
Cases: DQL, DQL with `max_q_backup=2`, EDP. Then `act` with the JAX draws
(sampler noise and the choice's Gumbel noise), the port's own checkpoint,
and a JAX checkpoint resumed in the port.

Tolerances: 1e-5 absolute / 1e-4 relative for the logs, the critic and
its target (read: within 2.4e-7). The actor's params and EMA are held to
ACTOR_TOL absolute, DQL 5e-5 and EDP 2e-4 (read on the CPU: 1.3e-5 and
1.2e-4): the policy's Q term reaches the actor through the diffusion at
levels where alpha is small (the sampler's first step starts at level
T - 1, alpha ~0.006, and x0 = (xt - sigma * eps) / alpha amplifies float32
rounding ~160-fold, see test_torch_sampler_grad.py), and Adam's first
steps scale each element's update by its own gradient's size, so an
element with a small gradient carries that rounding into its update. Both
bounds are below the last step's smallest move of a leaf (4.0e-4), and
every net is checked to fail its bound in the state before the last step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines.dql import DQLPipeline as JaxDQL
from cleandiffuser_tpu.pipelines.edp import EDPPipeline as JaxEDP
from cleandiffuser_tpu_torch.pipelines import DQLPipeline, EDPPipeline
from cleandiffuser_tpu_torch.utils.jax_params import (
    agent_params_of,
    jax_params_of,
    load_agent_params,
    load_jax_params,
)

torch.set_num_threads(1)

OBS, ACT, B, STEPS, START = 5, 3, 8, 3, 1000
LR = 1e-3
CFG = dict(obs_dim=OBS, act_dim=ACT, diffusion_steps=2, sampling_steps=2, emb_dim=16,
           hidden_dim=32, actor_lr=LR, critic_lr=LR, gradient_steps=5, discount=0.9,
           eta=1.0, ema_rate=0.9, ema_update_interval=2)
ATOL, RTOL = 1e-5, 1e-4
ACTOR_TOL = {"dql": 5e-5, "edp": 2e-4}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _seeded(tree, seed):
    rng = np.random.default_rng(seed)

    def fill(path, a):
        z = rng.standard_normal(a.shape)
        if a.ndim >= 2:
            return (z / np.sqrt(a.shape[0])).astype(np.float32)
        scale = jax.tree_util.keystr(path).endswith("['scale']")
        return (z * 0.1 + (1.0 if scale else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, _np(tree))


def _batch(rng):
    return {"obs": {"state": rng.standard_normal((B, OBS)).astype(np.float32)},
            "next_obs": {"state": rng.standard_normal((B, OBS)).astype(np.float32)},
            "act": rng.uniform(-1, 1, (B, ACT)).astype(np.float32),
            "rew": rng.standard_normal((B, 1)).astype(np.float32),
            "tml": (rng.uniform(size=(B, 1)) < 0.25).astype(np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _sampler_noise(key, shape, steps):
    """The JAX sampler's draws: k_init, k_scan = split(rng); then
    rng, k_noise = split(rng) at every step."""
    k_init, k = jax.random.split(key)
    per = []
    for _ in range(steps):
        k, k_noise = jax.random.split(k)
        per.append(np.asarray(jax.random.normal(k_noise, shape)))
    return _t(jax.random.normal(k_init, shape)), _t(np.stack(per))


def _t_eps(key, T):
    k_t, k_eps = jax.random.split(key)
    return _t(jax.random.randint(k_t, (B,), 0, T)), _t(jax.random.normal(k_eps, (B, ACT)))


def _jax_draws(jpipe, edp: bool):
    """The draws of the JAX pipeline's next step, as the port's `noise`."""
    T, steps, M = jpipe.actor.diffusion_steps, jpipe.sampling_steps, jpipe.max_q_backup
    if edp:
        _, k_next, k_bc, k_t, k_eps, k_coin = jax.random.split(jpipe.actor.state.rng, 6)
    else:
        _, k_next, k_bc, k_new, k_coin = jax.random.split(jpipe.actor.state.rng, 5)
    k_noise, _, _ = jax.random.split(k_bc, 3)
    noise = {"next": _sampler_noise(k_next, (B * max(M, 1), ACT), steps),
             "bc": _t_eps(k_noise, T),
             "coin": _t(jax.random.uniform(k_coin) > 0.5)}
    if edp:
        noise["q"] = (_t(jax.random.randint(k_t, (B,), 0, T)),
                      _t(jax.random.normal(k_eps, (B, ACT))))
    else:
        noise["new"] = _sampler_noise(k_new, (B, ACT), steps)
    return noise


def _pair(family, **kw):
    """A JAX pipeline and a port pipeline on the same seeded weights, both
    at actor step START."""
    J, P = (JaxEDP, EDPPipeline) if family == "edp" else (JaxDQL, DQLPipeline)
    jpipe, tpipe = J(**CFG, **kw), P(**CFG, **kw, device="cpu")
    st, cs = jpipe.actor.state, jpipe.critic_state
    params, ema = _seeded(st.params, 1), _seeded(st.ema_params, 2)
    cp, ct = _seeded(cs.params, 3), _seeded(cs.target_params, 4)
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    jpipe.actor.state = st.replace(params=jt(params), ema_params=jt(ema),
                                   step=jnp.asarray(START, jnp.int32))
    jpipe.critic_state = cs.replace(params=jt(cp), target_params=jt(ct))
    load_agent_params(tpipe.actor.params, params)
    load_agent_params(tpipe.actor.ema_params, ema)
    load_jax_params(tpipe.critic, cp["params"])
    load_jax_params(tpipe.critic_target, ct["params"])
    tpipe.actor.step = START
    return jpipe, tpipe


def _run(jpipe, tpipe, batches, edp):
    """The steps on both packages, the port with the JAX draws: (the logs of
    both, the draws) per step."""
    logs, draws = [], []
    for batch in batches:
        noise = _jax_draws(jpipe, edp)
        lj = jpipe.train_step(jax.tree_util.tree_map(jnp.asarray, batch))
        lt = tpipe.train_step(batch, noise=noise)
        logs.append(({k: float(v) for k, v in lj.items()}, {k: float(v) for k, v in lt.items()}))
        draws.append(noise)
    return logs, draws


def _assert_tree(got, want, tol=ATOL):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(_np(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, atol=tol, rtol=RTOL, err_msg=jax.tree_util.keystr(path))


def _assert_moved(after, before, tol):
    """Every leaf of `before` fails the bound `after` is held to: the last
    update moved each leaf by more than the bound can hide."""
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(after),
                            jax.tree_util.tree_leaves(before)):
        assert not np.allclose(b, a, atol=tol, rtol=RTOL), jax.tree_util.keystr(path)


def _nets(tpipe):
    """The port's four nets as JAX trees (copies)."""
    return {"params": agent_params_of(tpipe.actor.params),
            "ema": agent_params_of(tpipe.actor.ema_params),
            "critic": {"params": jax_params_of(tpipe.critic)},
            "target": {"params": jax_params_of(tpipe.critic_target)}}


def _assert_state(tpipe, jpipe, actor_tol):
    st, cs = jpipe.actor.state, jpipe.critic_state
    got = _nets(tpipe)
    _assert_tree(got["params"], st.params, actor_tol)
    _assert_tree(got["ema"], st.ema_params, actor_tol)
    _assert_tree(got["critic"], cs.params)
    _assert_tree(got["target"], cs.target_params)
    assert tpipe.actor.step == int(st.step) and tpipe.critic_step == int(cs.step)
    assert tpipe.actor.optimizer.count == int(st.opt_state[0][2].count)
    assert tpipe.critic_optimizer.count == int(cs.opt_state[1].count)


CASES = {"dql": ("dql", {}), "dql_max_q_backup": ("dql", {"max_q_backup": 2}),
         "edp": ("edp", {})}


def _train(name, tmp_dir):
    family, kw = CASES[name]
    jpipe, tpipe = _pair(family, **kw)
    before = _nets(tpipe)
    rng = np.random.default_rng(5)
    batches = [_batch(rng) for _ in range(STEPS)]
    logs, draws = _run(jpipe, tpipe, batches[:2], family == "edp")
    ckpt = str(tmp_dir / f"{name}.pkl")
    jpipe.save(ckpt)
    before_last = _nets(tpipe)
    more, last = _run(jpipe, tpipe, batches[2:], family == "edp")
    return dict(family=family, kw=kw, jpipe=jpipe, tpipe=tpipe, logs=logs + more,
                draws=draws + last, before=before, before_last=before_last,
                batches=batches, ckpt=ckpt, actor_tol=ACTOR_TOL[family])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case trained once for the module, at first use."""
    tmp, done = tmp_path_factory.mktemp("dql"), {}

    def get(name):
        if name not in done:
            done[name] = _train(name, tmp)
        return done[name]

    return get


@pytest.fixture(params=list(CASES))
def trained(request, runs):
    return runs(request.param)


def test_logs_match_jax_step_by_step(trained):
    for lj, lt in trained["logs"]:
        assert set(lt) == {"bc_loss", "q_loss", "critic_loss", "target_q_mean"} == set(lj)
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    assert trained["logs"][0][1]["q_loss"] != trained["logs"][1][1]["q_loss"]


def test_state_after_three_steps_matches_jax(trained):
    _assert_state(trained["tpipe"], trained["jpipe"], trained["actor_tol"])
    assert trained["tpipe"].actor.step == START + STEPS
    assert trained["tpipe"].critic_optimizer.count == STEPS
    # the bounds would catch a missing last update
    tol = {"params": trained["actor_tol"], "ema": trained["actor_tol"], "critic": ATOL,
           "target": ATOL}
    after = _nets(trained["tpipe"])
    for k in after:
        _assert_moved(after[k], trained["before_last"][k], tol[k])


def test_gates_moved_the_ema_and_the_target(trained):
    """Steps 1000 and 1002 moved the EMA and the critic target: neither is
    where it started."""
    after = _nets(trained["tpipe"])
    for k in ("ema", "target"):
        _assert_moved(after[k], trained["before"][k], ATOL)


def test_jax_checkpoint_resumes_in_the_port(runs):
    """The JAX DQL `save` after 2 steps, read without JAX's classes into a
    fresh port pipeline: step 3 with the JAX draws matches the JAX
    pipeline's step 3 (logs and state)."""
    run = runs("dql")
    tres = DQLPipeline(**CFG, rng=9, device="cpu")
    tres.load_jax_checkpoint(run["ckpt"])
    assert (tres.actor.step, tres.critic_step) == (START + 2, 2)
    assert (tres.actor.optimizer.count, tres.critic_optimizer.count) == (2, 2)
    lt = tres.train_step(run["batches"][2], noise=run["draws"][2])
    lj = run["logs"][2][0]
    for k in lj:
        np.testing.assert_allclose(float(lt[k]), lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    _assert_state(tres, run["jpipe"], run["actor_tol"])


def test_port_checkpoint_resumes_exactly(runs, tmp_path):
    run = runs("dql")
    tpipe, batch = run["tpipe"], run["batches"][0]
    tpipe.save(str(tmp_path / "dql.pt"))
    other = DQLPipeline(**CFG, rng=7, device="cpu")
    other.load(str(tmp_path / "dql.pt"))
    assert other.trained_steps == tpipe.trained_steps == START + STEPS
    la, lb = tpipe.train_step(batch), other.train_step(batch)  # draws from the restored generator
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for m in ("critic", "critic_target"):
        for a, b in zip(getattr(tpipe, m).parameters(), getattr(other, m).parameters()):
            assert torch.equal(a, b)
    for a, b in zip(tpipe.actor.params.parameters(), other.actor.params.parameters()):
        assert torch.equal(a, b)


def test_act_matches_jax():
    """E x K candidates with the JAX draws, scored by the target critic,
    one per env by the Gumbel-max choice; from the EMA and from the
    params."""
    jpipe, tpipe = _pair("dql")
    E, K, wt, temp = 4, 6, 3.0, 0.5
    obs = np.random.default_rng(6).standard_normal((E, OBS)).astype(np.float32)
    for use_ema, key in ((True, jax.random.PRNGKey(11)), (False, jax.random.PRNGKey(12))):
        want = jpipe.act(obs, num_candidates=K, weight_temperature=wt, use_ema=use_ema,
                         temperature=temp, rng=key)
        k_sample, k_choice = jax.random.split(key)
        noise = (_sampler_noise(k_sample, (E * K, ACT), CFG["sampling_steps"]),
                 _t(jax.random.gumbel(k_choice, (E, K))))
        got = tpipe.act(obs, num_candidates=K, weight_temperature=wt, use_ema=use_ema,
                        temperature=temp, noise=noise)
        assert got.shape == (E, ACT) and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # the generator's own draws: seeded, in [-1, 1]
    a = tpipe.act(obs, num_candidates=K, generator=torch.Generator().manual_seed(0))
    b = tpipe.act(obs, num_candidates=K, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.abs().max() <= 1.0

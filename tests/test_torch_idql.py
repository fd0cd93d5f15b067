"""The port's IDQL and IQL against the JAX package's.

IDQL: same seeded weights (actor, a different EMA, TwinQ, a different
target, V), same batches, 4 steps with `actor_dropout=0.0` (flax draws its
dropout masks from module-path-folded keys, which the port does not
replay), the JAX step's draws replayed through `train_step(noise=)`:
`rng, k_bc = split(rng)`, then the BC loss's `k_noise, _, _ = split(k_bc,
3)`, `k_t, k_eps = split(k_noise)`. Steps 1 and 3 run the IQL critic
(critic steps 0 and 2), steps 2 and 4 freeze it: per step the logs, the
Adam and schedule counts of both critic optimizers; after 4 steps every
net, within 1e-5 absolute / 1e-4 relative (no sampler runs in training
here), each net's state before its last update failing that bound; a JAX
checkpoint after 2 steps resumes in the port. `act` with the JAX draws. IQL's `update_V` /
`update_Q` against the JAX IQL's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines.idql import IDQLPipeline as JaxIDQL
from cleandiffuser_tpu.utils.iql import IQL as JaxIQL
from cleandiffuser_tpu_torch.pipelines import IDQLPipeline
from cleandiffuser_tpu_torch.utils.iql import IQL
from cleandiffuser_tpu_torch.utils.jax_params import (
    agent_params_of,
    jax_params_of,
    load_agent_params,
    load_jax_params,
)
from test_torch_dql import _assert_moved, _batch, _np, _sampler_noise, _seeded, _t, _t_eps

torch.set_num_threads(1)

OBS, ACT, B, STEPS = 5, 3, 8, 4
LR = 1e-3
CFG = dict(obs_dim=OBS, act_dim=ACT, diffusion_steps=2, sampling_steps=2, emb_dim=16,
           actor_hidden_dim=32, actor_n_blocks=2, actor_dropout=0.0, critic_hidden_dim=32,
           actor_lr=LR, critic_lr=LR, gradient_steps=6, discount=0.9, iql_tau=0.7,
           ema_rate=0.9)
ATOL, RTOL = 1e-5, 1e-4
CRITIC = ("q_params", "q_target_params", "v_params")


def _close_tree(got, want, tol=ATOL):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(_np(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, atol=tol, rtol=RTOL, err_msg=jax.tree_util.keystr(path))


def _counts(tpipe, jpipe):
    cs = jpipe.critic_state
    jax_counts = [int(cs.q_opt_state[0].count), int(cs.q_opt_state[1].count),
                  int(cs.v_opt_state[0].count), int(cs.v_opt_state[1].count)]
    opts = (tpipe.iql.state.q_opt_state, tpipe.iql.state.v_opt_state)
    port_adam = [int(next(iter(o.optimizer.state.values()))["step"]) if o.optimizer.state else 0
                 for o in opts]
    port = [port_adam[0], opts[0].count, port_adam[1], opts[1].count]
    return port, jax_counts


def _nets(tpipe):
    """The port's five nets as JAX trees (copies)."""
    nets = {"params": agent_params_of(tpipe.actor.params),
            "ema_params": agent_params_of(tpipe.actor.ema_params)}
    for name in CRITIC:
        nets[name] = {"params": jax_params_of(getattr(tpipe.iql.state, name))}
    return nets


def _assert_critic(tpipe, jpipe):
    cs, got = jpipe.critic_state, _nets(tpipe)
    for name in CRITIC:
        _close_tree(got[name], getattr(cs, name))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jpipe, tpipe = JaxIDQL(**CFG), IDQLPipeline(**CFG, device="cpu")
    st, cs = jpipe.actor.state, jpipe.critic_state
    w = {"params": _seeded(st.params, 1), "ema": _seeded(st.ema_params, 2),
         "q": _seeded(cs.q_params, 3), "qt": _seeded(cs.q_target_params, 4),
         "v": _seeded(cs.v_params, 5)}
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    jpipe.actor.state = st.replace(params=jt(w["params"]), ema_params=jt(w["ema"]))
    jpipe.critic_state = cs.replace(q_params=jt(w["q"]), q_target_params=jt(w["qt"]),
                                    v_params=jt(w["v"]))
    load_agent_params(tpipe.actor.params, w["params"])
    load_agent_params(tpipe.actor.ema_params, w["ema"])
    for name, key in zip(CRITIC, ("q", "qt", "v")):
        load_jax_params(getattr(tpipe.iql.state, name), w[key]["params"])

    rng = np.random.default_rng(6)
    batches = [_batch(rng) for _ in range(STEPS)]
    logs, counts, draws, nets = [], [], [], []
    ckpt = str(tmp_path_factory.mktemp("idql") / "jax.pkl")
    for i, batch in enumerate(batches):
        _, k_bc = jax.random.split(jpipe.actor.state.rng)
        k_noise, _, _ = jax.random.split(k_bc, 3)
        noise = (*_t_eps(k_noise, CFG["diffusion_steps"]), None)
        lj = jpipe.train_step(jax.tree_util.tree_map(jnp.asarray, batch))
        lt = tpipe.train_step(batch, noise=noise)
        logs.append(({k: float(v) for k, v in lj.items()}, {k: float(v) for k, v in lt.items()}))
        counts.append(_counts(tpipe, jpipe))
        draws.append(noise)
        nets.append(_nets(tpipe))
        if i == 1:
            jpipe.save(ckpt)
    return dict(jpipe=jpipe, tpipe=tpipe, logs=logs, counts=counts, batches=batches,
                draws=draws, ckpt=ckpt, nets=nets)


def test_logs_match_jax_step_by_step(run):
    for lj, lt in run["logs"]:
        assert set(lt) == {"bc_loss", "q_loss", "v_loss"} == set(lj)
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)


def test_odd_steps_freeze_the_critic_and_its_counts(run):
    """(Q Adam count, Q schedule count, V Adam count, V schedule count)
    after each step: the critic moves on steps 1 and 3 only."""
    want = [[1] * 4, [1] * 4, [2] * 4, [2] * 4]
    assert [port for port, _ in run["counts"]] == want
    assert [jax_counts for _, jax_counts in run["counts"]] == want


def test_state_after_four_steps_matches_jax(run):
    tpipe, jpipe = run["tpipe"], run["jpipe"]
    st = jpipe.actor.state
    _close_tree(agent_params_of(tpipe.actor.params), st.params)
    _close_tree(agent_params_of(tpipe.actor.ema_params), st.ema_params)
    _assert_critic(tpipe, jpipe)
    assert tpipe.actor.step == int(st.step) == STEPS
    assert tpipe.critic_step == int(jpipe.critic_state.step) == STEPS
    # the bound would catch a missing last update: the actor's at step 4,
    # the critic's at step 3 (step 4 leaves it bit for bit)
    nets = run["nets"]
    for k in ("params", "ema_params"):
        _assert_moved(nets[3][k], nets[2][k], ATOL)
    for k in CRITIC:
        _assert_moved(nets[2][k], nets[1][k], ATOL)
        for a, b in zip(jax.tree_util.tree_leaves(nets[3][k]),
                        jax.tree_util.tree_leaves(nets[2][k])):
            np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_resumes_in_the_port(run):
    tres = IDQLPipeline(**CFG, rng=3, device="cpu")
    tres.load_jax_checkpoint(run["ckpt"])
    assert (tres.actor.step, tres.critic_step) == (2, 2)
    assert (tres.iql.state.q_opt_state.count, tres.iql.state.v_opt_state.count) == (1, 1)
    for batch, noise, (lj, _) in zip(run["batches"][2:], run["draws"][2:], run["logs"][2:]):
        lt = tres.train_step(batch, noise=noise)
        for k in lj:
            np.testing.assert_allclose(float(lt[k]), lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    _assert_critic(tres, run["jpipe"])


def test_act_matches_jax(run):
    """Candidates from the EMA with the JAX draws, the advantage
    min-Q(target) - V, the Gumbel-max choice."""
    jpipe, tpipe = run["jpipe"], IDQLPipeline(**CFG, device="cpu")
    # the JAX pipeline's trained state, carried in exactly
    st, cs = jpipe.actor.state, jpipe.critic_state
    load_agent_params(tpipe.actor.ema_params, _np(st.ema_params))
    for name in CRITIC:
        load_jax_params(getattr(tpipe.iql.state, name), _np(getattr(cs, name))["params"])
    E, K, wt = 3, 5, 4.0
    obs = np.random.default_rng(7).standard_normal((E, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    want = jpipe.act(obs, num_candidates=K, weight_temperature=wt, temperature=0.5, rng=key)
    k_sample, k_choice = jax.random.split(key)
    noise = (_sampler_noise(k_sample, (E * K, ACT), CFG["sampling_steps"]),
             _t(jax.random.gumbel(k_choice, (E, K))))
    got = tpipe.act(obs, num_candidates=K, weight_temperature=wt, temperature=0.5, noise=noise)
    assert got.shape == (E, ACT) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_iql_updates_match_jax():
    jiql = JaxIQL(OBS, ACT, hidden_dim=32, lr=LR, discount=0.9)
    tiql = IQL(OBS, ACT, hidden_dim=32, lr=LR, discount=0.9, device="cpu")
    js = jiql.state
    w = {"q_params": _seeded(js.q_params, 8), "q_target_params": _seeded(js.q_target_params, 9),
         "v_params": _seeded(js.v_params, 10)}
    jiql.state = js.replace(**{k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in w.items()})
    for name, tree in w.items():
        load_jax_params(getattr(tiql.state, name), tree["params"])
    rng = np.random.default_rng(11)
    for i in range(2):
        if i == 1:
            before_last = {n: {"params": jax_params_of(getattr(tiql.state, n))} for n in w}
        b = _batch(rng)
        args = (b["obs"]["state"], b["act"])
        more = (b["rew"], b["next_obs"]["state"], b["tml"])
        pairs = [(jiql.update_V(*args), tiql.update_V(*map(torch.from_numpy, args))),
                 (jiql.update_Q(*args, *more),
                  tiql.update_Q(*map(torch.from_numpy, args + more)))]
        for lj, lt in pairs:
            np.testing.assert_allclose(float(lt), float(lj), atol=ATOL, rtol=RTOL)
    for name in w:
        got = {"params": jax_params_of(getattr(tiql.state, name))}
        _close_tree(got, getattr(jiql.state, name))
        _assert_moved(got, before_last[name], ATOL)
    o, a = torch.from_numpy(b["obs"]["state"]), torch.from_numpy(b["act"])
    np.testing.assert_allclose(tiql.q(o, a).numpy(), np.asarray(jiql.q(*args)), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tiql.v(o).numpy(), np.asarray(jiql.v(args[0])), atol=ATOL,
                               rtol=RTOL)

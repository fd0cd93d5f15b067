"""The port's QGPO against the JAX package's.

`QGPONNClassifier` forward on the same weights within 1e-5. The pipeline
on the same seeded weights (actor params and a different EMA, the Q network
and a different target, the energy net and a different EMA), with the JAX
programs' draws replayed as the port's explicit `noise`:

- 3 BC steps (`k_noise, k_cond, _ = split(sub, 3)`; the condition's
  keep-mask read back from the JAX condition's zeroed rows); the untrainable
  Fourier frequencies sit in the actor's AdamW as the reference's do;
- `collect_supported_actions` over 7 states in batches of 3 (the last
  padded), the sampler draws from `self._rng, k = split(self._rng)`;
- 3 Q steps on the support (the target moves every step);
- 3 CEP steps: the noising draws `k_t, k_eps = split(k)` of
  `self._rng, k = split(self._rng)`;
- the guided `act` (w_cg 1.0, final log p), its Gumbel pick from
  `k_s, k_c = split(rng)`.

Tolerance 1e-5 absolute / 1e-4 relative for losses, logs, the Q nets, the
support set, log p and actions; the actor's and the energy net's params
after 3 steps as in tests/test_torch_sfbc.py (`_close_adam`: all but 1e-4 of
the elements within 1e-5, every element within 2 lr per step). Then the
shared store, JAX checkpoints read without JAX, and
tests/test_rl_pipelines.py's QGPO smoke test and
tests/test_fused_rl_window.py's window test, on the port.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.nn_classifier import QGPONNClassifier as JaxQGPONN
from cleandiffuser_tpu.pipelines.qgpo import QGPOPipeline as JaxQGPO
from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoTDDataset, fake_d4rl_qlearning_dataset
from cleandiffuser_tpu_torch.nn_classifier import QGPONNClassifier
from cleandiffuser_tpu_torch.pipelines import QGPOPipeline
from cleandiffuser_tpu_torch.utils.jax_params import (
    agent_params_of,
    jax_params_of,
    load_agent_params,
    load_jax_params,
)
from test_torch_dql import _sampler_noise, _seeded, _t
from test_torch_edm_cm import _close_tree, _jt
from test_torch_sfbc import _close_adam

torch.set_num_threads(1)

OBS, ACT, B, K = 5, 3, 8, 4
ATOL, RTOL = 1e-5, 1e-4
CFG = dict(obs_dim=OBS, act_dim=ACT, K=K, betaQ=0.7, beta=1.3, emb_dim=16, ema_rate=0.9,
           discount=0.9)


def test_qgpo_energy_net_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (6, K, ACT)).astype(np.float32)
    t = rng.uniform(0, 1, (6, K)).astype(np.float32)
    y = rng.standard_normal((6, K, OBS)).astype(np.float32)
    net_j = JaxQGPONN(obs_dim=OBS, act_dim=ACT, emb_dim=16, hidden_dims=(32, 32),
                      timestep_emb_type="untrainable_fourier")
    params = _seeded(net_j.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(y)), 1)
    # large weights, so the tanh(out / 10) * 10 squash is exercised
    params["params"]["Mlp_0"]["Dense_2"]["kernel"] *= 30
    net_t = QGPONNClassifier(OBS, ACT, 16, (32, 32), timestep_emb_type="untrainable_fourier")
    load_jax_params(net_t, params["params"])
    want = np.asarray(net_j.apply(_jt(params), jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():
        got = net_t(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    assert got.shape == (6, K, 1) and np.abs(want).max() > 5.0
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def _batch(rng):
    return {"obs": {"state": rng.standard_normal((B, OBS)).astype(np.float32)},
            "next_obs": {"state": rng.standard_normal((B, OBS)).astype(np.float32)},
            "act": rng.uniform(-1, 1, (B, ACT)).astype(np.float32),
            "rew": rng.standard_normal((B, 1)).astype(np.float32),
            "tml": (rng.uniform(size=(B, 1)) < 0.25).astype(np.float32),
            "supported_act": rng.uniform(-1, 1, (B, K, ACT)).astype(np.float32)}


def _bc_draws(jpipe, batch):
    agent, st = jpipe.actor, jpipe.actor.state
    _, sub = jax.random.split(st.rng)
    k_noise, k_cond, _ = jax.random.split(sub, 3)
    k_t, k_eps = jax.random.split(k_noise)
    t = jax.random.uniform(k_t, (B,), minval=agent.t_diffusion[0], maxval=agent.t_diffusion[1])
    train = np.asarray(agent.apply_condition(st.params, jnp.asarray(batch["obs"]["state"]),
                                             train=True, rng=k_cond))
    keep = (np.abs(train).sum(-1) > 0).astype(np.float32)
    return _t(t), _t(jax.random.normal(k_eps, (B, ACT))), _t(keep)


def _cep_draws(jpipe):
    _, k = jax.random.split(jpipe._rng)
    k_t, k_eps = jax.random.split(k)
    lo, hi = jpipe.actor.t_diffusion
    return (_t(jax.random.uniform(k_t, (B,), minval=lo, maxval=hi)),
            _t(jax.random.normal(k_eps, (B, K, ACT))))


def _logs(lj, lt):
    return {k: float(v) for k, v in lj.items()}, {k: float(v) for k, v in lt.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jpipe, tpipe = JaxQGPO(**CFG), QGPOPipeline(**CFG, device="cpu")
    jpipe.classifier._ensure_init(jnp.zeros((1, ACT)), jnp.zeros((1,)), jnp.zeros((1, OBS)))
    st, cst = jpipe.actor.state, jpipe.classifier.state
    w = {"params": _seeded(st.params, 1), "ema": _seeded(st.ema_params, 2),
         "q": _seeded(jpipe.q_params, 3), "qt": _seeded(jpipe.q_target_params, 4),
         "clf": _seeded(cst.params, 5), "clf_ema": _seeded(cst.ema_params, 6)}
    jpipe.actor.state = st.replace(params=_jt(w["params"]), ema_params=_jt(w["ema"]))
    jpipe.q_params, jpipe.q_target_params = _jt(w["q"]), _jt(w["qt"])
    jpipe.classifier.state = cst.replace(params=_jt(w["clf"]), ema_params=_jt(w["clf_ema"]))
    load_agent_params(tpipe.actor.params, w["params"])
    load_agent_params(tpipe.actor.ema_params, w["ema"])
    load_jax_params(tpipe.q_net, w["q"]["params"])
    load_jax_params(tpipe.q_target, w["qt"]["params"])
    load_jax_params(tpipe.classifier.params, w["clf"]["params"])
    load_jax_params(tpipe.classifier.ema_params, w["clf_ema"]["params"])
    freqs0 = jax_params_of(tpipe.actor.params["diffusion"])["UntrainableFourierEmbedding_0"][
        "freqs"]

    rng = np.random.default_rng(7)
    out = {"bc": [], "q": [], "cep": []}
    for _ in range(3):
        batch = _batch(rng)
        noise = _bc_draws(jpipe, batch)
        lj = jpipe.bc_train_step(jax.tree_util.tree_map(jnp.asarray, batch))
        out["bc"].append(_logs(lj, tpipe.bc_train_step(batch, noise=noise)))
    for _ in range(3):
        batch = _batch(rng)
        lj = jpipe.q_train_step(jax.tree_util.tree_map(jnp.asarray, batch))
        out["q"].append(_logs(lj, tpipe.q_train_step(batch)))
    for _ in range(3):
        batch = _batch(rng)
        noise = _cep_draws(jpipe)
        lj = jpipe.cep_train_step(jax.tree_util.tree_map(jnp.asarray, batch))
        out["cep"].append(_logs(lj, tpipe.cep_train_step(batch, noise=noise)))
    tmp = tmp_path_factory.mktemp("qgpo")
    jpipe.classifier.save(str(tmp / "clf_ckpt_latest"))
    with open(tmp / "q_state.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jpipe.q_params), f)
    return dict(jpipe=jpipe, tpipe=tpipe, freqs0=freqs0, tmp=tmp, **out)


def test_bc_steps_match_jax_with_the_freqs_in_adamw(run):
    for lj, lt in run["bc"]:
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    jpipe, tpipe = run["jpipe"], run["tpipe"]
    # the actor's AdamW at the engine's default lr 2e-4
    _close_adam(agent_params_of(tpipe.actor.params), jpipe.actor.state.params, lr=2e-4)
    _close_adam(agent_params_of(tpipe.actor.ema_params), jpipe.actor.state.ema_params, lr=2e-4)
    freqs = jax_params_of(tpipe.actor.params["diffusion"])["UntrainableFourierEmbedding_0"]["freqs"]
    want = np.asarray(jpipe.actor.state.params["diffusion"]["params"][
        "UntrainableFourierEmbedding_0"]["freqs"])
    # no gradient reaches the freqs; they are a parameter of the AdamW the
    # decay applies to, as in JAX (at lr 2e-4 x wd 1e-5 a step's decay is
    # below float32 resolution, in both packages: they stay where they were)
    emb = tpipe.actor.params["diffusion"].time_emb
    assert any(p is emb.freqs for p in tpipe.actor.optimizer.params)
    np.testing.assert_array_equal(freqs, want)
    np.testing.assert_array_equal(freqs, run["freqs0"])


def test_q_steps_match_jax(run):
    for lj, lt in run["q"]:
        np.testing.assert_allclose(lt["q_loss"], lj["q_loss"], atol=ATOL, rtol=RTOL)
    jpipe, tpipe = run["jpipe"], run["tpipe"]
    _close_tree({"params": jax_params_of(tpipe.q_net)}, jpipe.q_params)
    _close_tree({"params": jax_params_of(tpipe.q_target)}, jpipe.q_target_params)
    assert {int(v["step"]) for v in tpipe.q_optimizer.optimizer.state.values()} == {3}


def test_cep_steps_match_jax(run):
    for lj, lt in run["cep"]:
        assert set(lt) == set(lj) == {"loss", "f_max", "f_mean", "f_min"}
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    jpipe, tpipe = run["jpipe"], run["tpipe"]
    cst = jpipe.classifier.state
    # the energy net's Adam at lr 1e-3, held as the actor is (`_close_adam`)
    _close_adam({"params": jax_params_of(tpipe.classifier.params)}, cst.params, lr=1e-3)
    _close_adam({"params": jax_params_of(tpipe.classifier.ema_params)}, cst.ema_params, lr=1e-3)
    assert tpipe.classifier.step == int(cst.step) == 3


def test_cep_loss_is_the_soft_label_cross_entropy():
    pipe = QGPOPipeline(**CFG, device="cpu")
    x = torch.rand(B, K, ACT) * 2 - 1
    t = torch.rand(B)
    y = {"soft_label": torch.softmax(torch.randn(B, K, 1), 1), "obs": torch.randn(B, OBS)}
    loss, aux = pipe.classifier.loss(pipe.classifier.params, x, t, y)
    with torch.no_grad():
        f = pipe.classifier.params(x, t[:, None].expand(B, K),
                                   y["obs"][:, None].expand(B, K, OBS))
    want = -(y["soft_label"] * (f - torch.logsumexp(f, 1, keepdim=True))).sum(1).mean()
    torch.testing.assert_close(loss.detach(), want)
    torch.testing.assert_close(aux["f_max"], f.max(1).values.mean())


def test_collect_supported_actions_pads_and_matches_jax(run):
    jpipe, tpipe = run["jpipe"], run["tpipe"]
    next_obs = np.random.default_rng(8).standard_normal((7, OBS)).astype(np.float32)
    steps, bs = 2, 3
    rng, noise = jpipe._rng, []
    for _ in range(3):
        rng, k = jax.random.split(rng)
        noise.append(_sampler_noise(k, (bs * K, ACT), steps))
    want = jpipe.collect_supported_actions(next_obs, batch_size=bs, sampling_steps=steps)
    got = tpipe.collect_supported_actions(next_obs, batch_size=bs, sampling_steps=steps,
                                          noise=noise)
    assert got.shape == (7, K, ACT) and np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_guided_act_matches_jax(run):
    jpipe, tpipe = run["jpipe"], run["tpipe"]
    E, n_cand, steps = 3, 5, 3
    obs = np.random.default_rng(9).standard_normal((E, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    want = jpipe.act(obs, w_cg=1.0, num_candidates=n_cand, sampling_steps=steps, rng=key)
    k_s, k_c = jax.random.split(key)
    noise = (_sampler_noise(k_s, (E * n_cand, ACT), steps),
             _t(jax.random.gumbel(k_c, (E, n_cand))))
    got, info = tpipe.act(obs, w_cg=1.0, num_candidates=n_cand, sampling_steps=steps,
                          noise=noise, return_info=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # the log p the pick reads: the energy net's EMA at t = 0
    with torch.no_grad():
        lp = tpipe.classifier.logp(tpipe.classifier.ema_params,
                                   info["candidates"].reshape(E * n_cand, ACT),
                                   torch.zeros(E * n_cand),
                                   torch.from_numpy(obs).repeat_interleave(n_cand, 0))
    torch.testing.assert_close(info["log_p"], lp.reshape(E, n_cand))
    torch.testing.assert_close(info["scores"], info["log_p"] + noise[1])
    # guidance changes the samples
    plain = tpipe.act(obs, w_cg=0.0, num_candidates=n_cand, sampling_steps=steps, noise=noise)
    assert not torch.allclose(plain, got)


def test_one_store_feeds_both_trainers():
    ds = D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset(n_steps=256), device="cpu")
    pipe = QGPOPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, emb_dim=16, K=K, device="cpu")
    sup = np.random.default_rng(0).standard_normal((ds.size, K, ds.a_dim)).astype(np.float32)
    pipe.make_q_train_scan(ds, sup, 8, 2)
    store = pipe.support_store(ds, sup)
    pipe.make_cep_train_scan(ds, sup, 8, 2)
    assert pipe.support_store(ds, sup) is store
    for name in ("obs", "next_obs", "act", "rew", "tml"):
        assert store[name] is ds._sampler.arrays[name]
    assert store["sup"].shape == (ds.size, K, ds.a_dim)


def test_jax_checkpoints_read_without_jax(run):
    jpipe, tmp = run["jpipe"], run["tmp"]
    fresh = QGPOPipeline(**CFG, rng=3, device="cpu")
    fresh.load_jax_q_state(str(tmp / "q_state.pkl"))
    _close_tree({"params": jax_params_of(fresh.q_net)}, jpipe.q_params, 0.0)
    fresh.classifier.load_jax_checkpoint(str(tmp / "clf_ckpt_latest"))
    cst = jpipe.classifier.state
    _close_tree({"params": jax_params_of(fresh.classifier.params)}, cst.params, 0.0)
    _close_tree({"params": jax_params_of(fresh.classifier.ema_params)}, cst.ema_params, 0.0)
    assert fresh.classifier.step == 3 and fresh.classifier.optimizer.count == 0
    # the port's own Q checkpoint round-trips
    run["tpipe"].save_q(str(tmp / "q_state.pt"))
    fresh.load_q(str(tmp / "q_state.pt"))
    for a, b in zip(fresh.q_target.parameters(), run["tpipe"].q_target.parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# tests/test_rl_pipelines.py:80 and tests/test_fused_rl_window.py:260 on the port
def test_qgpo_smoke_port():
    ds = D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset(n_steps=800, ep_len=150),
                             device="cpu")
    pipe = QGPOPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, K=4, device="cpu")
    g = torch.Generator().manual_seed(0)
    assert np.isfinite(float(pipe.bc_train_step(ds.sample_batch(g, 16))["loss"]))
    sup = pipe.collect_supported_actions(ds.next_obs[:64], batch_size=32, sampling_steps=2)
    assert sup.shape == (64, 4, ds.a_dim)
    batch = dict(ds.sample_batch(torch.Generator().manual_seed(1), 16))
    batch["supported_act"] = sup[:16]
    assert np.isfinite(float(pipe.q_train_step(batch)["q_loss"]))
    assert np.isfinite(float(pipe.cep_train_step(batch)["loss"]))
    act = pipe.act(np.random.randn(2, ds.o_dim).astype(np.float32), w_cg=1.0, num_candidates=4,
                   sampling_steps=2)
    assert act.shape == (2, ds.a_dim)


def test_qgpo_windows_equal_their_steps_port():
    ds = D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset(n_steps=256), device="cpu")
    sup = np.random.default_rng(0).standard_normal((ds.size, 4, ds.a_dim)).astype(np.float32)

    def mk():
        return QGPOPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, emb_dim=16, K=4, device="cpu")

    n_steps, batch = 3, 8
    seq, win = mk(), mk()
    g = torch.Generator().manual_seed(23)
    store = seq.support_store(ds, sup)
    for _ in range(n_steps):
        idx = torch.randint(ds.size, (batch,), generator=g)
        seq.q_train_step(seq.store_batch(store, idx))
        seq_log = None
    log = win.make_q_train_scan(ds, sup, batch, n_steps)(torch.Generator().manual_seed(23))
    assert np.isfinite(float(log["q_loss"]))
    for a, b in ((seq.q_net, win.q_net), (seq.q_target, win.q_target)):
        for x, y in zip(a.parameters(), b.parameters()):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    # the CEP window: indices, then the noising draws, from the window's generator
    g = torch.Generator().manual_seed(5)
    for _ in range(n_steps):
        idx = torch.randint(ds.size, (batch,), generator=g)
        seq_log = seq.cep_train_step(seq.store_batch(store, idx), generator=g)
    log = win.make_cep_train_scan(ds, sup, batch, n_steps)(torch.Generator().manual_seed(5))
    assert all(np.isfinite(float(v)) for v in log.values()) and np.isfinite(
        float(seq_log["loss"]))
    for x, y in zip(seq.classifier.params.parameters(), win.classifier.params.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert win.classifier.step == n_steps

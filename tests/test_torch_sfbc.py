"""The port's SfBC against the JAX package's.

`SfBCUNet` forward on the same weights within 1e-5 (flat and windowed x,
with and without a condition). The pipeline on the same seeded weights
(actor params, a different EMA, the critic): 3 BC steps on (batch,
horizon) windows with the JAX update's draws replayed through
`bc_train_step(noise=)` (`rng, sub = split(state.rng)`,
`k_noise, k_cond, _ = split(sub, 3)`, `k_t, k_eps = split(k_noise)`; the
condition's keep-mask read back from the JAX condition's zeroed rows),
two critic steps, `monte_carlo_reevaluate` with the JAX per-path sampler
draws (`self._rng, k = split(self._rng)`, `split(k, n)`, one key per path),
and `act` with JAX's draws. Tolerance 1e-5 absolute / 1e-4 relative
throughout (losses, parameters, values, targets, actions). Checkpoints:
the port's round trip, and the JAX `save` read by `load_jax_checkpoint`.
Then tests/test_rl_pipelines.py's SfBC smoke test and
tests/test_fused_rl_window.py's BC window test, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.nn_diffusion import SfBCUNet as JaxSfBCUNet
from cleandiffuser_tpu.pipelines.sfbc import SfBCPipeline as JaxSfBC
from cleandiffuser_tpu.utils.normalizers import GaussianNormalizer as JaxGaussian
from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoDataset, fake_d4rl_dataset
from cleandiffuser_tpu_torch.nn_diffusion import SfBCUNet
from cleandiffuser_tpu_torch.pipelines import SfBCPipeline
from cleandiffuser_tpu_torch.utils.jax_params import (
    agent_params_of,
    jax_params_of,
    load_agent_params,
    load_jax_params,
)
from cleandiffuser_tpu_torch.utils.normalizers import GaussianNormalizer
from test_torch_dql import _assert_moved, _np, _sampler_noise, _seeded, _t
from test_torch_edm_cm import _close_tree, _jt

torch.set_num_threads(1)

OBS, ACT, B, H = 5, 3, 4, 3
ATOL, RTOL = 1e-5, 1e-4
# The actor's params and EMA after 3 steps (`_close_adam`): Adam's step
# scales each element's update by its own gradient's size, so an element
# whose gradient is, at some step, within float32 rounding of 0 moves by up
# to lr the other way in one package. All but FLIP_SHARE of the U-Net's
# elements are held to 1e-5 (read on the CPU: 2 of 1,400,347 beyond it, the
# largest 1.7e-4), and every element to 2 lr per step.
ACTOR_LR, FLIP_SHARE = 1e-4, 1e-4
CFG = dict(obs_dim=OBS, act_dim=ACT, emb_dim=16, hidden_dim=32, actor_lr=ACTOR_LR,
           critic_lr=1e-3,
           ema_rate=0.9, discount=0.9, monte_carlo_samples=3, weight_temperature=2.0)


def test_sfbc_unet_forward_matches_jax():
    net_j = JaxSfBCUNet(act_dim=ACT, emb_dim=16, hidden_dims=(32, 16, 8))
    rng = np.random.default_rng(0)
    for shape in ((6, ACT), (6, H, ACT)):
        x = rng.standard_normal(shape).astype(np.float32)
        t = rng.uniform(0, 1, (6,)).astype(np.float32)
        emb = rng.standard_normal((6, 16)).astype(np.float32)
        params = _seeded(net_j.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t)), 1)
        net_t = SfBCUNet(ACT, 16, (32, 16, 8))
        load_jax_params(net_t, params["params"])
        for e in (None, emb):
            want = net_j.apply(_jt(params), jnp.asarray(x), jnp.asarray(t),
                               None if e is None else jnp.asarray(e))
            with torch.no_grad():
                got = net_t(torch.from_numpy(x), torch.from_numpy(t),
                            None if e is None else torch.from_numpy(e))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
        # the converter's layout round-trips, the freqs included
        _close_tree({"params": jax_params_of(net_t)}, params, 0.0)


def _close_adam(got, want, steps=3, lr=ACTOR_LR):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves(_np(want))
    beyond, total = 0, 0
    for (path, a), b in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, atol=2 * lr * steps, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        beyond += int((np.abs(a - b) > ATOL + RTOL * np.abs(b)).sum())
        total += a.size
    assert beyond <= FLIP_SHARE * total, f"{beyond} of {total} elements beyond {ATOL}"


def _windows(rng):
    return {"obs": {"state": rng.standard_normal((B, H, OBS)).astype(np.float32)},
            "act": rng.uniform(-1, 1, (B, H, ACT)).astype(np.float32)}


def _bc_draws(jpipe, batch):
    agent, st = jpipe.actor, jpipe.actor.state
    _, sub = jax.random.split(st.rng)
    k_noise, k_cond, _ = jax.random.split(sub, 3)
    k_t, k_eps = jax.random.split(k_noise)
    n = B * H
    t = jax.random.uniform(k_t, (n,), minval=agent.t_diffusion[0], maxval=agent.t_diffusion[1])
    eps = jax.random.normal(k_eps, (n, ACT))
    cond = jnp.asarray(batch["obs"]["state"].reshape(n, OBS))
    train = np.asarray(agent.apply_condition(st.params, cond, train=True, rng=k_cond))
    keep = (np.abs(train).sum(-1) > 0).astype(np.float32)
    return _t(t), _t(eps), _t(keep)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jpipe, tpipe = JaxSfBC(**CFG), SfBCPipeline(**CFG, device="cpu")
    st = jpipe.actor.state
    w = {"params": _seeded(st.params, 1), "ema": _seeded(st.ema_params, 2),
         "critic": _seeded(jpipe.critic_params, 3)}
    jpipe.actor.state = st.replace(params=_jt(w["params"]), ema_params=_jt(w["ema"]))
    jpipe.critic_params = _jt(w["critic"])
    load_agent_params(tpipe.actor.params, w["params"])
    load_agent_params(tpipe.actor.ema_params, w["ema"])
    load_jax_params(tpipe.critic, w["critic"]["params"])
    rng = np.random.default_rng(4)
    logs, keeps = [], []
    for i in range(3):
        if i == 2:
            before_last = agent_params_of(tpipe.actor.params)
        batch = _windows(rng)
        noise = _bc_draws(jpipe, batch)
        keeps.append(noise[2])
        lj = jpipe.bc_train_step(jax.tree_util.tree_map(jnp.asarray, batch))
        lt = tpipe.bc_train_step(batch, noise=noise)
        logs.append(({k: float(v) for k, v in lj.items()}, {k: float(v) for k, v in lt.items()}))
    critic_logs = []
    for _ in range(2):
        o = rng.standard_normal((8, OBS)).astype(np.float32)
        a = rng.uniform(-1, 1, (8, ACT)).astype(np.float32)
        v = rng.standard_normal((8, 1)).astype(np.float32)
        critic_logs.append((float(jpipe.critic_train_step(o, a, v)["critic_loss"]),
                            float(tpipe.critic_train_step(o, a, v)["critic_loss"])))
    ckpt = str(tmp_path_factory.mktemp("sfbc") / "ckpt_jax")
    jpipe.save(ckpt)
    return dict(jpipe=jpipe, tpipe=tpipe, logs=logs, keeps=keeps, critic_logs=critic_logs,
                ckpt=ckpt, tmp=tmp_path_factory.mktemp("sfbc_port"), before_last=before_last)


def test_bc_steps_match_jax(run):
    for lj, lt in run["logs"]:
        assert set(lt) == set(lj) == {"loss", "grad_norm"}
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    keep = torch.cat(run["keeps"])
    assert 0 < keep.sum() < keep.numel()  # the label dropout is live
    st = run["jpipe"].actor.state
    params = agent_params_of(run["tpipe"].actor.params)
    _close_adam(params, st.params)
    _close_adam(agent_params_of(run["tpipe"].actor.ema_params), st.ema_params)
    assert run["tpipe"].actor.step == int(st.step) == 3
    # the bound would catch a missing last update (the freqs get no gradient)
    moved = {"diffusion": {"params": {k: v for k, v in params["diffusion"]["params"].items()
                                      if not k.startswith("Untrainable")}},
             "condition": params["condition"]}
    before = run["before_last"]
    before = {"diffusion": {"params": {k: before["diffusion"]["params"][k]
                                       for k in moved["diffusion"]["params"]}},
              "condition": before["condition"]}
    _assert_moved(moved, before, ATOL)


def test_critic_steps_match_jax(run):
    for lj, lt in run["critic_logs"]:
        np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)
    _close_tree({"params": jax_params_of(run["tpipe"].critic)}, run["jpipe"].critic_params)


def _mc_noise(jpipe, n_paths, L, batch_paths, steps):
    """The JAX re-evaluation's sampler draws per batch of paths, and the
    pipeline key it leaves."""
    rng, out = jpipe._rng, []
    for i in range(0, n_paths, batch_paths):
        n = min(i + batch_paths, n_paths) - i
        rng, k = jax.random.split(rng)
        per_path = [_sampler_noise(kk, (L * jpipe.M, ACT), steps) for kk in jax.random.split(k, n)]
        out.append((torch.cat([p[0] for p in per_path]), torch.cat([p[1] for p in per_path], 1)))
    return out


def test_monte_carlo_reevaluate_matches_jax(run):
    jpipe, tpipe = run["jpipe"], run["tpipe"]
    rng = np.random.default_rng(5)
    n_paths, L, steps = 3, 5, 2
    seq_obs = rng.standard_normal((n_paths, L, OBS)).astype(np.float32)
    seq_rew = rng.standard_normal((n_paths, L, 1)).astype(np.float32)
    seq_val = rng.standard_normal((n_paths, L, 1)).astype(np.float32) * 3
    tml = np.array([[0, 4], [2, 3]], np.int64)
    noise = _mc_noise(jpipe, n_paths, L, 2, steps)
    want, want_norm = jpipe.monte_carlo_reevaluate(seq_obs, seq_rew, seq_val, tml,
                                                   JaxGaussian(seq_val), steps, 2)
    got, got_norm = tpipe.monte_carlo_reevaluate(seq_obs, seq_rew, seq_val, tml,
                                                 GaussianNormalizer(seq_val), steps, 2,
                                                 noise=noise)
    assert got.shape == (n_paths, L, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got[0, 4], seq_rew[0, 4])  # a terminal cell
    np.testing.assert_allclose(got_norm.mean, want_norm.mean, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_norm.std, want_norm.std, atol=ATOL, rtol=RTOL)


def test_act_matches_jax(run):
    jpipe, tpipe = run["jpipe"], run["tpipe"]
    E, K, k, steps = 3, 6, 2, 3
    obs = np.random.default_rng(6).standard_normal((E, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jpipe.act(obs, num_candidates=K, top_k_average=k, sampling_steps=steps,
                     temperature=0.7, rng=key)
    got, info = tpipe.act(obs, num_candidates=K, top_k_average=k, sampling_steps=steps,
                          temperature=0.7, noise=_sampler_noise(key, (E * K, ACT), steps),
                          return_info=True)
    assert got.shape == (E, ACT) and info["idx"].shape == (E, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # the mean of the k best candidates by the critic
    best = info["scores"].argsort(dim=1, descending=True)[:, :k]
    torch.testing.assert_close(
        got, torch.take_along_dim(info["candidates"], best[:, :, None], 1).mean(1))


def test_checkpoints(run):
    tpipe, path = run["tpipe"], str(run["tmp"] / "ckpt_latest")
    tpipe.save(path)
    fresh = SfBCPipeline(**CFG, rng=5, device="cpu")
    fresh.load(path)
    for a, b in ((fresh.actor.params, tpipe.actor.params),
                 (fresh.actor.ema_params, tpipe.actor.ema_params), (fresh.critic, tpipe.critic)):
        for x, y in zip(a.state_dict().values(), b.state_dict().values()):
            assert torch.equal(x, y)
    assert fresh.actor.step == tpipe.actor.step
    # the JAX `save` (.actor TrainState, .critic flax params), read without JAX
    jres = SfBCPipeline(**CFG, rng=6, device="cpu")
    jres.load_jax_checkpoint(run["ckpt"])
    jpipe = run["jpipe"]
    _close_tree(agent_params_of(jres.actor.params), jpipe.actor.state.params, 0.0)
    _close_tree(agent_params_of(jres.actor.ema_params), jpipe.actor.state.ema_params, 0.0)
    _close_tree({"params": jax_params_of(jres.critic)}, jpipe.critic_params, 0.0)
    assert jres.actor.step == 3


def test_reset_critic_draws_fresh_weights():
    pipe = SfBCPipeline(**CFG, device="cpu")
    before = [p.detach().clone() for p in pipe.critic.parameters()]
    pipe.critic_train_step(np.zeros((2, OBS)), np.zeros((2, ACT)), np.ones((2, 1)))
    pipe.reset_critic()
    after = list(pipe.critic.parameters())
    assert not torch.equal(before[0], after[0])
    assert pipe.critic_optimizer.count == 0 and not pipe.critic_optimizer.optimizer.state


# ---------------------------------------------------------------------------
# tests/test_rl_pipelines.py:50 and tests/test_fused_rl_window.py:237 on the port
def test_sfbc_smoke_port():
    ds = D4RLMuJoCoDataset(fake_d4rl_dataset(n_steps=1200, ep_len=60), horizon=4,
                           max_path_length=60, device="cpu")
    pipe = SfBCPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, hidden_dim=64,
                        monte_carlo_samples=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        assert np.isfinite(float(pipe.bc_train_step(ds.sample_batch(g, 8))["loss"]))
    batch = ds.sample_batch(torch.Generator().manual_seed(1), 8)
    obs = batch["obs"]["state"].reshape(-1, ds.o_dim)
    act = batch["act"].reshape(-1, ds.a_dim)
    val = torch.randn(obs.shape[0], 1)
    assert np.isfinite(float(pipe.critic_train_step(obs, act, val)["critic_loss"]))
    new_val, new_norm = pipe.monte_carlo_reevaluate(
        ds.seq_obs[:2], ds.seq_rew[:2], ds.seq_val[:2], ds.tml_and_not_timeout[:0],
        GaussianNormalizer(ds.seq_val), sampling_steps=2, batch_paths=2)
    assert new_val.shape == ds.seq_val[:2].shape and np.isfinite(new_val).all()
    out = pipe.act(np.random.randn(2, ds.o_dim).astype(np.float32), num_candidates=4,
                   top_k_average=2, sampling_steps=2)
    assert out.shape == (2, ds.a_dim)


def test_sfbc_bc_window_equals_its_steps_port():
    ds = D4RLMuJoCoDataset(fake_d4rl_dataset(n_steps=288, ep_len=48), horizon=4, device="cpu")

    def mk():
        return SfBCPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, emb_dim=16, hidden_dim=32,
                            device="cpu")

    seq, win = mk(), mk()
    g = torch.Generator().manual_seed(19)
    for _ in range(3):
        seq.bc_train_step(ds.sample_batch(g, 4))
    log = win.make_bc_train_scan(ds, 4, 3)(torch.Generator().manual_seed(19))
    assert np.isfinite(float(log["loss"]))
    for a, b in zip(seq.actor.params.parameters(), win.actor.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert win.actor.step == 3

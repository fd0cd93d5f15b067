"""The PyTorch port's DiffuserLite against the JAX package's.

Each case builds the JAX `DiffuserLitePipeline` at a small width (three
levels, planning horizons (3, 3, 5)), replaces its weights with seeded
numpy normals, writes its checkpoint (`save`) and reads the files into the
port's pipeline with `load_jax_checkpoint`. Then, with the JAX draws
replayed as explicit noise:

- `compute_temporal_horizons` on several hierarchies;
- R1 (3 Euler steps) and R2 (1 step) plans and actions
  (`keys = split(rng, n_levels)`, each level's `k_init, _ = split(key)`);
- 3 `train_step`s (each level's `k_t, k_x1, k_cond, _ = split(sub, 4)`;
  the condition's keep-mask and the inverse dynamics' dropout mask read
  back from the JAX modules), the third past the inverse dynamics' budget;
- reflow pairs (`_rng, k1, k2 = split(_rng, 3)`, x1 from k1) and 3 reflow
  steps on them; the pairs' pickle is the JAX CLI's layout;
- the window equals its steps taken one by one
  (tests/test_fused_rl_window.py:202-235);
- the value helpers and IQL's value dataset against the JAX ones, the
  checks of tests/test_benchmark_variants.py:156-207 on the port, and the
  candidate planner (env-major candidates, IQL ranking at `select_t` 1 and
  -1): the candidates, their scores, the picks and the actions.

Tolerance: float32 on both sides, sums in another order: 1e-5.
"""

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines import diffuserlite_value as jvalue
from cleandiffuser_tpu.pipelines.diffuserlite import (
    DiffuserLitePipeline as JaxLite,
    compute_temporal_horizons as jax_horizons,
)
from cleandiffuser_tpu.utils.iql import IQL as JaxIQL
from cleandiffuser_tpu_torch.dataset import (
    MultiHorizonD4RLAntmazeDataset,
    MultiHorizonD4RLMuJoCoDataset,
)
from cleandiffuser_tpu_torch.dataset.fake import fake_d4rl_dataset
from cleandiffuser_tpu_torch.pipelines import DiffuserLitePipeline, compute_temporal_horizons
from cleandiffuser_tpu_torch.pipelines import diffuserlite_value as tvalue
from cleandiffuser_tpu_torch.utils.iql import IQL
from cleandiffuser_tpu_torch.utils.jax_params import load_agent_params, load_jax_params
from cleandiffuser_tpu_torch.utils.train_state import read_jax_pickle
from jax_shaped_init import shaped_inits

torch.set_num_threads(1)

TOL = 1e-5
# Adam's largest step is (1 - b1) / sqrt(1 - b2) ~ 3.2 lr; 3 steps at lr 2e-4
KEY_BIAS_TOL = 3 * 3.2 * 2e-4
O, A, E, B = 4, 2, 3, 6
PLANNING = (3, 3, 5)
TEMPORAL = compute_temporal_horizons(PLANNING)  # [17, 5, 5]
CFG = dict(obs_dim=O, act_dim=A, planning_horizons=PLANNING, emb_dim=16, d_model=32, n_heads=2,
           depth=1, return_scale=10.0, ema_rate=0.9, diffusion_gradient_steps=10, w_cfg=1.3,
           target_return=0.6, temperature=0.9)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _seeded(tree, seed):
    rng = np.random.default_rng(seed)

    def fill(a):
        scale = 1 / np.sqrt(np.prod(a.shape[:-1])) if a.ndim >= 2 else 0.2
        return jnp.asarray((rng.standard_normal(a.shape) * scale).astype(np.float32))

    return jax.tree_util.tree_map(fill, _np(tree))


@pytest.fixture
def pair(tmp_path):
    # every leaf is seeded below: no compile of the nets' inits
    # (tests/jax_shaped_init.py)
    with shaped_inits():
        jp = JaxLite(**CFG, rng=0)
    for i, d in enumerate(jp.diffusions):
        d.state = d.state.replace(params=_seeded(d.state.params, 10 + i),
                                  ema_params=_seeded(d.state.ema_params, 20 + i))
    jp.invdyn.params = _seeded(jp.invdyn.params, 30)
    jp.save(str(tmp_path / "ckpt"))
    tp = DiffuserLitePipeline(**CFG, rng=0, device="cpu")
    tp.load_jax_checkpoint(str(tmp_path / "ckpt"))
    return jp, tp


def test_temporal_horizons_match_jax():
    for planning in ((5, 5, 9), (3, 3, 5), (5, 9), (4,), (2, 3, 4, 5)):
        assert compute_temporal_horizons(planning) == jax_horizons(planning)
    assert compute_temporal_horizons((5, 5, 9)) == [129, 33, 9]


def _level_noise(key, shapes):
    return [_t(jax.random.normal(jax.random.split(k)[0], s))
            for k, s in zip(jax.random.split(key, len(shapes)), shapes)]


@pytest.mark.parametrize("steps", [3, 1])
def test_plans_match_jax(pair, steps):
    jp, tp = pair
    obs = np.random.default_rng(1).standard_normal((E, O)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jact, jinfo = jp.act(obs, sample_steps=steps, rng=key)
    noise = _level_noise(key, [(E, h, O) for h in PLANNING])
    tact, tinfo = tp.act(obs, sample_steps=steps, noise=noise)
    np.testing.assert_allclose(tinfo["traj"].numpy(), np.asarray(jinfo["traj"]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=TOL, atol=TOL)
    assert tact.abs().max() <= 1.0


def _batches(rng, with_rew=False):
    out = []
    for h in TEMPORAL:
        b = {"obs": {"state": rng.standard_normal((B, h, O)).astype(np.float32)},
             "act": rng.uniform(-1, 1, (B, h, A)).astype(np.float32),
             "val": rng.uniform(0, 10, (B, 1)).astype(np.float32)}
        if with_rew:
            b["rew"] = -(rng.uniform(size=(B, h, 1)) < 0.8).astype(np.float32)
            b["pred_val"] = rng.standard_normal((B, h, 1)).astype(np.float32)
        out.append(b)
    return out


def _jb(batches):
    return [jax.tree_util.tree_map(jnp.asarray, b) for b in batches]


def _update_draws(engine, x0, cond):
    """(t, x1, keep) of the JAX engine's next update."""
    _, sub = jax.random.split(engine.state.rng)
    k_t, k_x1, k_cond, _ = jax.random.split(sub, 4)
    t = jax.random.uniform(k_t, (x0.shape[0],))
    x1 = jax.random.normal(k_x1, x0.shape)
    keep = None
    if cond is not None:
        emb = np.asarray(engine.apply_condition(engine.state.params, jnp.asarray(cond),
                                                train=True, rng=k_cond))
        keep = _t((np.abs(emb).sum(-1) > 0).astype(np.float32))
    return _t(t), _t(x1), keep


def _invdyn_keep(jinv, o, o2):
    _, sub = jax.random.split(jinv._rng)
    oo = jnp.concatenate([jnp.asarray(o), jnp.asarray(o2)], -1)
    _, inter = jinv.net.apply(jinv.params, oo, train=True, rngs={"dropout": sub},
                              capture_intermediates=True)
    return torch.from_numpy(np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0)


def _train_draws(jp, batches, val_fn=None, budget_left=True):
    noise = {}
    for i in range(jp.n_levels):
        obs, _ = jp._level_strided(batches[i], i)
        val = (val_fn(batches[i], i) if val_fn is not None
               else batches[i]["val"] / jp.return_scale)
        noise[i] = _update_draws(jp.diffusions[i], obs, val)
        if i == jp.n_levels - 1 and budget_left:
            o, o2 = obs[:, :-1].reshape(-1, O), obs[:, 1:].reshape(-1, O)
            noise["invdyn"] = _invdyn_keep(jp.invdyn, o, o2)
    return noise


def _assert_engines_close(tp, jp):
    """Each level's params and EMA against the JAX ones read into a copy;
    the DiT blocks' key bias (the third of `bqkv`) within KEY_BIAS_TOL: its
    gradient is 0 in exact arithmetic (softmax ignores a shift shared by a
    row's scores) and rounding noise in both packages, which Adam turns into
    steps of up to ~3 lr with the noise's sign."""
    for td, jd in zip(tp.diffusions, jp.diffusions):
        for mod, tree in ((td.params, jd.state.params), (td.ema_params, jd.state.ema_params)):
            view = copy.deepcopy(mod)
            load_agent_params(view, _np(tree))
            want = view.state_dict()
            for name, got in mod.state_dict().items():
                a, b = got.numpy().copy(), want[name].numpy().copy()
                if name.endswith("bqkv"):
                    ks = slice(a.shape[-1] // 3, 2 * a.shape[-1] // 3)
                    np.testing.assert_allclose(a[ks], b[ks], atol=KEY_BIAS_TOL, err_msg=name)
                    a[ks] = b[ks] = 0
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)


def test_three_train_steps_match_jax(pair):
    jp, tp = pair
    rng = np.random.default_rng(2)
    for step in range(3):
        batches = _batches(rng)
        left = step < 2
        noise = _train_draws(jp, _jb(batches), budget_left=left)
        jlog = jp.train_step(_jb(batches), left)
        tlog = tp.train_step(batches, left, noise=noise)
        assert set(tlog) == set(jlog)
        for k in jlog:
            np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=TOL, atol=1e-6,
                                       err_msg=k)
    assert "invdyn_loss" not in tlog
    _assert_engines_close(tp, jp)
    assert [d.step for d in tp.diffusions] == [3, 3, 3]
    want = DiffuserLitePipeline(**CFG, device="cpu").invdyn.net
    load_jax_params(want, _np(jp.invdyn.params["params"]))
    for (n, a), (_, b) in zip(tp.invdyn.net.state_dict().items(), want.state_dict().items()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL, err_msg=n)


def test_reflow_pairs_and_steps_match_jax(pair, tmp_path):
    jp, tp = pair
    batches = _batches(np.random.default_rng(3))
    x1s, r = [], jp._rng
    for i, h in enumerate(PLANNING):
        r, k1, _ = jax.random.split(r, 3)
        x1s.append(_t(jax.random.normal(k1, (B, h, O))))
    jpairs = jp.prepare_reflow_pairs(_jb(batches), sampling_steps=4)
    tpairs = tp.prepare_reflow_pairs(batches, sampling_steps=4, x1s=x1s)
    for jpr, tpr in zip(jpairs, tpairs):
        assert set(jpr) == set(tpr) == {"x0", "x1", "condition"}
        np.testing.assert_array_equal(tpr["x1"], jpr["x1"])
        np.testing.assert_array_equal(tpr["condition"], jpr["condition"])
        np.testing.assert_allclose(tpr["x0"], jpr["x0"], rtol=TOL, atol=TOL)
    # the JAX CLI's pickle reads back in the port
    with open(tmp_path / "reflow_pairs.pkl", "wb") as f:
        pickle.dump(jpairs, f)
    back = read_jax_pickle(tmp_path / "reflow_pairs.pkl")
    np.testing.assert_array_equal(back[2]["x0"], jpairs[2]["x0"])
    for _ in range(3):
        noise = {i: _update_draws(d, p["x0"], p["condition"])
                 for i, (d, p) in enumerate(zip(jp.diffusions, jpairs))}
        noise = {i: (t, None, keep) for i, (t, _, keep) in noise.items()}
        jlog = jp.reflow_step(jpairs)
        tlog = tp.reflow_step(jpairs, noise=noise)
        for k in jlog:
            np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=TOL, atol=1e-7,
                                       err_msg=k)
    _assert_engines_close(tp, jp)


def test_unconditioned_reflow_pairs(pair):
    _, tp = pair
    pairs = tp.prepare_reflow_pairs(_batches(np.random.default_rng(4)), sampling_steps=2,
                                    conditioned=False)
    assert all(set(p) == {"x0", "x1"} for p in pairs)
    assert set(tp.reflow_step(pairs, conditioned=False)) == {"loss0", "loss1", "loss2"}


# --- the window (tests/test_fused_rl_window.py:202-235) ---
def test_train_window_equals_its_steps():
    planning = (5, 9)
    ds = MultiHorizonD4RLMuJoCoDataset(
        fake_d4rl_dataset("halfcheetah-medium-v2", n_steps=400, ep_len=100),
        horizons=compute_temporal_horizons(planning), device="cpu")
    mk = lambda: DiffuserLitePipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim,  # noqa: E731
                                      planning_horizons=planning, emb_dim=16, d_model=32,
                                      n_heads=2, depth=1, diffusion_gradient_steps=100, rng=0,
                                      device="cpu")
    seq, win = mk(), mk()
    step = seq.step_fn(ds, 8, invdyn_budget=2)
    g = torch.Generator().manual_seed(29)
    logs = [step(g) for _ in range(3)]
    log = win.make_train_scan(ds, 8, 3, invdyn_budget=2)(torch.Generator().manual_seed(29))
    assert set(log) == {"loss0", "loss1", "invdyn_loss"}
    assert "invdyn_loss" not in logs[2]
    for k, v in log.items():
        want = sum(float(lg.get(k, 0.0)) for lg in logs) / 3
        np.testing.assert_allclose(float(v), want, rtol=1e-6, err_msg=k)
    for a, b in zip(seq.diffusions, win.diffusions):
        for (n, x), (_, y) in zip(a.params.state_dict().items(), b.params.state_dict().items()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=n)
        assert b.step == 3


# --- the value helpers (tests/test_benchmark_variants.py:156-207) ---
def test_level_values_match_jax():
    batch = _batches(np.random.default_rng(5), with_rew=True)[0]
    batch["rew"][0, 3] = 0.0
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tb = jax.tree_util.tree_map(_t, batch)
    for level in (0, 1):
        for jf, tf in ((jvalue.antmaze_level_values, tvalue.antmaze_level_values),
                       (jvalue.kitchen_level_values, tvalue.kitchen_level_values)):
            np.testing.assert_allclose(tf(tb, level, 0.99).numpy(),
                                       np.asarray(jf(jb, level, 0.99)), rtol=TOL, atol=1e-7)


def test_port_antmaze_level_values():
    rew = np.full((2, 6, 1), -1.0, np.float32)
    rew[0, 3] = 0.0
    batch = {"rew": _t(rew), "pred_val": _t(np.full((2, 6, 1), 0.5, np.float32))}
    v1 = tvalue.antmaze_level_values(batch, level=1, discount=0.99)
    assert float(v1[0, 0]) == pytest.approx(0.25) and float(v1[1, 0]) == 0.0
    v0 = tvalue.antmaze_level_values(batch, level=0, discount=0.99)
    assert torch.isfinite(v0).all() and float(v0[1, 0]) < 1.0


def test_port_kitchen_level_values():
    rew = np.zeros((2, 4, 1), np.float32)
    rew[0, 1] = 1.0
    batch = {"rew": _t(rew)}
    assert float(tvalue.kitchen_level_values(batch, 0, 0.99)[0, 0]) == pytest.approx(0.0099)
    assert float(tvalue.kitchen_level_values(batch, 1, 0.99)[0, 0]) == pytest.approx(0.25)


@pytest.fixture(scope="module")
def iql_pair():
    jiql = JaxIQL(O, A, hidden_dim=32, rng=3)
    st = jiql.state
    jiql.state = st.replace(v_params=_seeded(st.v_params, 40))
    tiql = IQL(O, A, hidden_dim=32, device="cpu")
    load_jax_params(tiql.state.v_params, _np(jiql.state.v_params["params"]))
    return jiql, tiql


def test_iql_value_dataset_matches_jax(iql_pair):
    from cleandiffuser_tpu.dataset import MultiHorizonD4RLAntmazeDataset as JaxMH
    from cleandiffuser_tpu.dataset.fake import fake_d4rl_dataset as jax_fake

    jiql, tiql = iql_pair
    raw = jax_fake("antmaze-medium-play-v2", n_steps=3000, ep_len=300)
    raw = {k: v[:, :O] if k == "observations" else (v[:, :A] if k == "actions" else v)
           for k, v in raw.items()}
    jds = jvalue.IQLValueMultiHorizonDataset(JaxMH(dict(raw), horizons=(5, 9)), jiql)
    tds = tvalue.IQLValueMultiHorizonDataset(
        MultiHorizonD4RLAntmazeDataset(dict(raw), horizons=(5, 9), device="cpu"), tiql,
        device="cpu")
    np.testing.assert_allclose(tds.pred_values, jds.pred_values, rtol=TOL, atol=TOL)
    batch = tds.sample_batch(torch.Generator().manual_seed(0), 4, horizon_idx=1)
    assert batch["rew"].shape == (4, 9, 1) and batch["pred_val"].shape == (4, 9, 1)
    assert torch.isfinite(batch["pred_val"]).all()


@pytest.mark.parametrize("select_t,w_cfgs", [(1, (1.0, 0.0, 0.0)), (-1, (1.0, 1.0, 1.0))])
def test_candidate_plans_match_jax(pair, iql_pair, select_t, w_cfgs):
    jp, tp = pair
    jiql, tiql = iql_pair
    K, steps = 4, 2
    obs = np.random.default_rng(6).standard_normal((E, O)).astype(np.float32)
    tgt = np.array([[0.2], [0.5], [0.8]], np.float32)
    key = jax.random.PRNGKey(8)
    jfn = jvalue.build_candidate_plan_fn(jp, jiql, E, K, steps, w_cfgs, select_t)
    jact = jfn([d.state.ema_params for d in jp.diffusions], jiql.state.v_params,
               jp.invdyn.params, key, jnp.asarray(obs), jnp.asarray(tgt))
    shapes = [(E * K, PLANNING[0], O)] + [(E, h, O) for h in PLANNING[1:]]
    noise = _level_noise(key, shapes)
    tfn = tvalue.build_candidate_plan_fn(tp, tiql, E, K, steps, w_cfgs, select_t)
    tact, info = tfn(None, obs, tgt, noise=noise)
    # the JAX level-0 candidates and their IQL scores, from the same key
    fn0 = jp.diffusions[0].build_sample_fn(sample_steps=steps,
                                           sample_step_schedule="quad_continuous",
                                           cfg_mode="mix")
    prior = jnp.zeros((E * K, PLANNING[0], O)).at[:, 0].set(jnp.repeat(jnp.asarray(obs), K, 0))
    cand, _ = fn0(jp.diffusions[0].state.ema_params, None, jax.random.split(key, 3)[0], prior,
                  condition_cfg=jnp.repeat(jnp.asarray(tgt), K, 0), w_cfg=w_cfgs[0],
                  temperature=jp.temperature)
    cand = np.asarray(cand).reshape(E, K, PLANNING[0], O)
    score = np.asarray(jiql.V.apply(jiql.state.v_params, jnp.asarray(cand[:, :, select_t])))[..., 0]
    np.testing.assert_allclose(info["candidates"].numpy(), cand, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(info["scores"].numpy(), score, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(info["idx"].numpy(), score.argmax(-1))
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=TOL, atol=TOL)

"""The port's staged consistency policy against the JAX package's: the
stages of tests/test_consistency_policy.py on the same seeded weights
(IQL's four nets, the EDM's and the consistency model's `IDQLMlp` params
and EMAs), the same batches and the JAX programs' draws replayed as the
port's `noise` (tests/test_torch_edm_cm.py names them); the backbones'
dropout masks are injected on both sides (tests/test_torch_synther.py's
stand-ins). Per stage the logs within 1e-5 absolute / 1e-4 relative, IQL's
nets within the same, the engines' params as in tests/test_torch_sfbc.py
(`_close_adam`); then `act` with every actor (the EDM's Euler and the
consistency model's multistep sampler) and JAX's draws, and the stages'
smoke test on the port alone. The Goal2D gate is in the slow tier
(tests/test_torch_hermetic.py).
"""

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines.consistency_policy import (
    ConsistencyPolicyPipeline as JaxCP,
)
from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoTDDataset, fake_d4rl_qlearning_dataset
from cleandiffuser_tpu_torch.nn_diffusion import mlps
from cleandiffuser_tpu_torch.pipelines import ConsistencyPolicyPipeline
from cleandiffuser_tpu_torch.utils.jax_params import (
    agent_params_of,
    jax_params_of,
    load_agent_params,
    load_jax_params,
)
from test_torch_dql import _seeded, _t
from test_torch_edm_cm import (
    _close_tree,
    _cm_draws_distillation,
    _cm_draws_training,
    _edm_draws,
    _jt,
)
from test_torch_sfbc import _close_adam
from test_torch_synther import KEEP, _Bernoulli, _port_block_forward

torch.set_num_threads(1)

OBS, ACT, B, H = 5, 3, 8, 32
ATOL, RTOL = 1e-5, 1e-4
CFG = dict(obs_dim=OBS, act_dim=ACT, emb_dim=16, hidden_dim=H, s0=4, s1=8, curriculum_cycle=50)
IQL_NETS = ("q_params", "q_target_params", "v_params")


def _batch(rng):
    return {"obs": {"state": rng.standard_normal((B, OBS)).astype(np.float32)},
            "next_obs": {"state": rng.standard_normal((B, OBS)).astype(np.float32)},
            "act": rng.uniform(-1, 1, (B, ACT)).astype(np.float32),
            "rew": rng.standard_normal((B, 1)).astype(np.float32),
            "tml": (rng.uniform(size=(B, 1)) < 0.25).astype(np.float32)}


def _logs(lj, lt):
    return {k: float(v) for k, v in lj.items()}, {k: float(v) for k, v in lt.items()}


@pytest.fixture(scope="module")
def run():
    jp, tp = JaxCP(**CFG), ConsistencyPolicyPipeline(**CFG, device="cpu")
    w = {n: _seeded(getattr(jp.iql.state, n), i) for i, n in enumerate(IQL_NETS)}
    jp.iql.state = jp.iql.state.replace(**{n: _jt(v) for n, v in w.items()})
    for n in IQL_NETS:
        load_jax_params(getattr(tp.iql.state, n), w[n]["params"])
    for i, name in enumerate(("edm", "cm")):
        je, te = getattr(jp, name), getattr(tp, name)
        params, ema = _seeded(je.state.params, 10 + i), _seeded(je.state.ema_params, 20 + i)
        je.state = je.state.replace(params=_jt(params), ema_params=_jt(ema))
        load_agent_params(te.params, params)
        load_agent_params(te.ema_params, ema)

    rng = np.random.default_rng(3)
    out = {"iql": [], "edm": [], "cd": [], "ct": []}
    for _ in range(2):
        b = _batch(rng)
        out["iql"].append(_logs(jp.iql_train_step(jax.tree_util.tree_map(jnp.asarray, b)),
                                tp.iql_train_step(b)))
    mp = pytest.MonkeyPatch()

    def masked(step_j, step_t, n_masks):
        masks = [rng.uniform(size=(B, H)) < KEEP for _ in range(n_masks)]
        jm, tm = list(masks), list(masks)
        mp.setattr(flax_stochastic, "random", _Bernoulli(jm))
        mp.setattr(mlps._LNResBlock, "forward", _port_block_forward(tm))
        lj, lt = step_j(), step_t()
        assert not jm and not tm
        return _logs(lj, lt)

    try:
        for _ in range(2):
            b = _batch(rng)
            noise = _edm_draws(jp.edm, b["act"])
            jp.edm._fn_cache.clear()
            out["edm"].append(masked(
                lambda: jp.edm_train_step(jax.tree_util.tree_map(jnp.asarray, b)),
                lambda: tp.edm_train_step(b, noise=noise), 3))
        jp.prepare_distillation(6)
        tp.prepare_distillation(6)
        for _ in range(2):
            b = _batch(rng)
            noise = _cm_draws_distillation(jp.cm, b["act"])
            out["cd"].append(_logs(jp.cd_train_step(jax.tree_util.tree_map(jnp.asarray, b)),
                                   tp.cd_train_step(b, noise=noise)))
        out["cd_state"] = (agent_params_of(tp.cm.params), jax.tree_util.tree_map(
            np.asarray, jp.cm.state.params))
        for _ in range(2):
            b = _batch(rng)
            noise = _cm_draws_training(jp.cm, b["act"])
            jp.cm._fn_cache.clear()
            out["ct"].append(masked(
                lambda: jp.ct_train_step(jax.tree_util.tree_map(jnp.asarray, b)),
                lambda: tp.ct_train_step(b, noise=noise), 3))
    finally:
        mp.undo()
    return dict(jp=jp, tp=tp, **out)


@pytest.mark.parametrize("stage", ["iql", "edm", "cd", "ct"])
def test_stage_logs_match_jax(run, stage):
    for lj, lt in run[stage]:
        assert set(lt) == set(lj)
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)


def test_stage_states_match_jax(run):
    jp, tp = run["jp"], run["tp"]
    for n in IQL_NETS:
        _close_tree({"params": jax_params_of(getattr(tp.iql.state, n))},
                    getattr(jp.iql.state, n))
    _close_adam(agent_params_of(tp.edm.params), jp.edm.state.params, steps=2, lr=2e-4)
    _close_adam(agent_params_of(tp.edm.ema_params), jp.edm.state.ema_params, steps=2, lr=2e-4)
    _close_adam(*run["cd_state"], steps=4, lr=2e-4)  # from the EDM's 2 steps, then 2 CD steps
    _close_adam(agent_params_of(tp.cm.params), jp.cm.state.params, steps=6, lr=2e-4)
    _close_adam(agent_params_of(tp.cm.ema_params), jp.cm.state.ema_params, steps=6, lr=2e-4)
    assert tp.cm.cur_logger.k == jp.cm.cur_logger.k == 2
    assert tp.edm.step == 2 and tp.cm.step == int(jp.cm.state.step)


@pytest.mark.parametrize("model,steps", [("edm", 3), ("cd", 2), ("ct", 1)])
def test_act_matches_jax(run, model, steps):
    jp, tp = run["jp"], run["tp"]
    E, K = 3, 4
    obs = np.random.default_rng(12).standard_normal((E, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jp.act(obs, model=model, num_candidates=K, sampling_steps=steps, rng=key)
    k_s, k_c = jax.random.split(key)
    k_init, k = jax.random.split(k_s)
    init = _t(jax.random.normal(k_init, (E * K, ACT)))
    if model == "edm":
        sample_noise = init
    else:
        per = []
        for _ in range(max(steps - 1, 1)):
            k, sub = jax.random.split(k)
            per.append(np.asarray(jax.random.normal(sub, (E * K, ACT))))
        sample_noise = (init, _t(np.stack(per)))
    got, info = tp.act(obs, model=model, num_candidates=K, sampling_steps=steps,
                       noise=(sample_noise, _t(jax.random.gumbel(k_c, (E, K)))),
                       return_info=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert info["candidates"].abs().max() <= 1.0


def test_consistency_policy_stages_port():
    """tests/test_consistency_policy.py on the port."""
    ds = D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset(n_steps=800, ep_len=100), device="cpu")
    pipe = ConsistencyPolicyPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, hidden_dim=64, s0=4,
                                     s1=8, curriculum_cycle=50, device="cpu")
    batch = ds.sample_batch(torch.Generator().manual_seed(0), 32)
    log = pipe.iql_train_step(batch)
    assert np.isfinite(float(log["loss_v"])) and np.isfinite(float(log["loss_q"]))
    assert np.isfinite(float(pipe.edm_train_step(batch)["loss"]))
    pipe.prepare_distillation(distillation_N=6)
    assert np.isfinite(float(pipe.cd_train_step(batch)["loss"]))
    assert np.isfinite(float(pipe.ct_train_step(batch)["loss"]))
    obs = np.random.randn(3, ds.o_dim).astype(np.float32)
    for model, steps in [("edm", 3), ("edm_heun", 3), ("cd", 2), ("ct", 1)]:
        act = pipe.act(obs, model=model, num_candidates=4, sampling_steps=steps)
        assert act.shape == (3, ds.a_dim) and act.abs().max() <= 1.0 + 1e-5

"""The port's EDM, Karras-ODE and consistency-model engines against the JAX
package's.

Same seeded weights (a `DQLMlp` backbone; its params and a different EMA
in the JAX layout, carried in by the converter), same data, and the JAX
programs' own draws replayed as the port's explicit `noise`:

- EDM and Karras-ODE training: `rng, sub = split(state.rng)`, then the
  loss's `k_noise, _, _ = split(sub, 3)` and `k_t, k_eps = split(k_noise)`;
  sigma from the engine's training distribution at `k_t`;
- consistency training: `k_idx, k_eps, _, _ = split(sub, 4)`, the pair
  index `categorical(k_idx, log(max(p, 1e-37)))`; distillation:
  `k_t, k_eps, _ = split(sub, 3)`, the teacher's eps from `split(k_eps)[1]`;
- samplers: `k_init, k_scan = split(rng)`, the consistency sampler's
  per-step draws `rng, k = split(rng)` from `k_scan`.

Tolerance: 1e-5 absolute / 1e-4 relative for losses, gradient norms,
parameters after 3 steps and samples (the sums differ only in order).
The smoke tests of tests/test_edm_rf_cm.py and the table goldens and
oracle tests of tests/test_karras_ode.py are mirrored on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import cleandiffuser_tpu.diffusion as jdiff
from cleandiffuser_tpu.classifier import QGPOClassifier as JaxQGPOClassifier
from cleandiffuser_tpu.nn_classifier import QGPONNClassifier as JaxQGPONN
from cleandiffuser_tpu.nn_condition import IdentityCondition as JaxIdentity
from cleandiffuser_tpu.nn_diffusion import DQLMlp as JaxDQLMlp
import cleandiffuser_tpu_torch.diffusion as tdiff
from cleandiffuser_tpu_torch.classifier import QGPOClassifier
from cleandiffuser_tpu_torch.diffusion.consistency_model import pseudo_huber_loss
from cleandiffuser_tpu_torch.nn_classifier import QGPONNClassifier
from cleandiffuser_tpu_torch.nn_condition import IdentityCondition
from cleandiffuser_tpu_torch.nn_diffusion import DQLMlp
from cleandiffuser_tpu_torch.utils.jax_params import (
    agent_params_of,
    load_agent_params,
    load_jax_params,
)
from test_torch_dql import _np, _seeded, _t

torch.set_num_threads(1)

OBS, ACT, B = 7, 3, 8
ATOL, RTOL = 1e-5, 1e-4
KARRAS = ("VEODE", "VPODE", "EDMDDIM")


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close_tree(got, want, tol=ATOL):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(_np(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, atol=tol, rtol=RTOL, err_msg=jax.tree_util.keystr(path))


def _pair(name, seed=1, **kw):
    """A JAX engine and the port's on the same seeded params and EMA."""
    J, P = getattr(jdiff, name), getattr(tdiff, name)
    jeng = J(JaxDQLMlp(obs_dim=OBS, act_dim=ACT, emb_dim=16), JaxIdentity(dropout=0.0), **kw)
    jeng.init(jnp.zeros((2, ACT)), jnp.zeros((2, OBS)))
    teng = P(DQLMlp(OBS, ACT, emb_dim=16), IdentityCondition(dropout=0.0), **kw, device="cpu")
    params, ema = _seeded(jeng.state.params, seed), _seeded(jeng.state.ema_params, seed + 1)
    jeng.state = jeng.state.replace(params=_jt(params), ema_params=_jt(ema))
    load_agent_params(teng.params, params)
    load_agent_params(teng.ema_params, ema)
    return jeng, teng


def _data(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
            rng.standard_normal((n, OBS)).astype(np.float32))


def _edm_draws(jeng, x0):
    """The draws of the JAX engine's next EDM-family update."""
    _, sub = jax.random.split(jeng.state.rng)
    k_noise, _, _ = jax.random.split(sub, 3)
    k_t, k_eps = jax.random.split(k_noise)
    if isinstance(jeng, jdiff.KarrasODE):
        t = jeng.sample_noise_distribution(k_t, x0.shape[0])
    else:
        t = jnp.exp(jax.random.normal(k_t, (x0.shape[0],)) * jeng.P_std + jeng.P_mean)
    return _t(t), _t(jax.random.normal(k_eps, x0.shape)), None


def _train_pair(name, steps=3, **kw):
    jeng, teng = _pair(name, **kw)
    logs = []
    for i in range(steps):
        x0, cond = _data(10 + i)
        noise = _edm_draws(jeng, x0)
        lj = jeng.update(jnp.asarray(x0), jnp.asarray(cond))
        lt = teng.update(torch.from_numpy(x0), torch.from_numpy(cond), noise=noise)
        logs.append(({k: float(v) for k, v in lj.items()}, {k: float(v) for k, v in lt.items()}))
    return jeng, teng, logs


@pytest.fixture(scope="module")
def trained():
    """EDM and the three Karras ODEs, 3 updates each on both packages."""
    return {name: _train_pair(name) for name in ("ContinuousEDM",) + KARRAS}


@pytest.mark.parametrize("name", ("ContinuousEDM",) + KARRAS)
def test_three_updates_match_jax(trained, name):
    jeng, teng, logs = trained[name]
    for lj, lt in logs:
        assert set(lt) == set(lj) == {"loss", "grad_norm"}
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    _close_tree(agent_params_of(teng.params), jeng.state.params)
    _close_tree(agent_params_of(teng.ema_params), jeng.state.ema_params)
    assert teng.step == int(jeng.state.step) == 3


def test_edm_preconditioning_matches_jax_and_the_closed_forms():
    jeng, teng = _pair("ContinuousEDM", sigma_data=0.5)
    sigma = np.asarray([0.002, 0.3, 1.0, 80.0], np.float32)
    s = torch.from_numpy(sigma)
    for fn in ("c_skip", "c_out", "c_in", "c_noise"):
        np.testing.assert_allclose(getattr(teng, fn)(s).numpy(),
                                   np.asarray(getattr(jeng, fn)(jnp.asarray(sigma))),
                                   rtol=1e-6, err_msg=fn)
    cs, co, ci = teng.c_skip(s).numpy(), teng.c_out(s).numpy(), teng.c_in(s).numpy()
    np.testing.assert_allclose(cs[0], 1.0, atol=1e-4)  # low noise: skip ~ 1
    assert cs[-1] < 1e-4  # high noise: skip ~ 0
    np.testing.assert_allclose(ci, 1 / np.sqrt(0.25 + sigma**2), rtol=1e-5)
    np.testing.assert_allclose(co, sigma * 0.5 / np.sqrt(0.25 + sigma**2), rtol=1e-5)
    # the denoiser's identity: D = c_skip x + c_out F(c_in x, c_noise)
    x = torch.randn(4, ACT)
    sig = torch.full((4,), 0.7)
    with torch.no_grad():
        F_ = teng.params["diffusion"](teng.c_in(sig)[:, None] * x, teng.c_noise(sig), None)
        np.testing.assert_allclose(teng.D(teng.params, x, sig).numpy(),
                                   (teng.c_skip(sig)[:, None] * x
                                    + teng.c_out(sig)[:, None] * F_).numpy(), rtol=1e-6)


def _classifier_pair(seed=30):
    jcls = JaxQGPOClassifier(JaxQGPONN(obs_dim=OBS, act_dim=ACT, emb_dim=16, hidden_dims=(32,)))
    jcls.init(jnp.zeros((2, ACT)), jnp.zeros((2,)), jnp.zeros((2, OBS)))
    tcls = QGPOClassifier(QGPONNClassifier(OBS, ACT, 16, hidden_dims=(32,)), device="cpu")
    ema = _seeded(jcls.state.ema_params, seed)
    jcls.state = jcls.state.replace(ema_params=_jt(ema))
    load_jax_params(tcls.ema_params, ema["params"])
    return jcls, tcls


SAMPLE_CASES = {
    "euler_cond": dict(solver="euler", cfg_mode="cond", w_cfg=1.0),
    "heun_cond": dict(solver="heun", cfg_mode="cond", w_cfg=1.0),
    "euler_mix": dict(solver="euler", cfg_mode="mix", w_cfg=1.5),
    "heun_uncond": dict(solver="heun", cfg_mode="uncond", w_cfg=0.0),
    "euler_cg": dict(solver="euler", cfg_mode="cond", w_cfg=1.0, w_cg=0.5),
    "heun_cg_mix": dict(solver="heun", cfg_mode="mix", w_cfg=1.3, w_cg=0.2),
}


@pytest.fixture(scope="module")
def samplers():
    """Per engine, the JAX and the port's engine on the same weights, with
    the same energy net as their classifier and clipping to [-1, 1], built
    once for the module."""
    built = {}

    def get(name):
        if name not in built:
            jeng, teng = _pair(name, x_max=np.ones(ACT), x_min=-np.ones(ACT))
            jeng.classifier, teng.classifier = _classifier_pair()
            built[name] = (jeng, teng)
        return built[name]

    return get


def _sample_pair(engines, case, steps=4):
    """One sample through both samplers with JAX's initial draw; returns
    (port, JAX) samples and log p's (None without guidance)."""
    c = dict(SAMPLE_CASES[case])
    w_cg = c.pop("w_cg", 0.0)
    jeng, teng = engines
    use_cg = w_cg != 0.0
    cls_j = jeng.classifier.state.ema_params if use_cg else None
    cls_t = teng.classifier.ema_params if use_cg else None
    _, cond = _data(3, 6)
    prior = np.zeros((6, ACT), np.float32)
    key = jax.random.PRNGKey(7)
    jfn = jeng.build_sample_fn(solver=c["solver"], sample_steps=steps, cfg_mode=c["cfg_mode"],
                               use_cg=use_cg, final_logp=use_cg)
    want, jlog = jfn(jeng.state.ema_params, cls_j, key, jnp.asarray(prior), jnp.asarray(cond),
                     None, jnp.asarray(cond) if use_cg else None, c["w_cfg"], w_cg, 0.8)
    k_init, _ = jax.random.split(key)
    tfn = teng.build_sample_fn(solver=c["solver"], sample_steps=steps, cfg_mode=c["cfg_mode"],
                               use_cg=use_cg, final_logp=use_cg)
    with torch.no_grad():
        got, tlog = tfn(teng.ema_params, None, torch.from_numpy(prior), torch.from_numpy(cond),
                        w_cfg=c["w_cfg"], temperature=0.8,
                        noise=_t(jax.random.normal(k_init, prior.shape)), cls_params=cls_t,
                        condition_cg=torch.from_numpy(cond) if use_cg else None, w_cg=w_cg)
    return got, np.asarray(want), tlog.get("log_p"), jlog.get("log_p")


@pytest.mark.parametrize("name", ("ContinuousEDM",) + KARRAS)
@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sampler_matches_jax(name, case, samplers):
    got, want, lp_t, lp_j = _sample_pair(samplers(name), case)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    if lp_j is not None:
        np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=ATOL, rtol=RTOL)


def test_edm_diffusion_x_steps_and_history_match_jax():
    jeng, teng = _pair("ContinuousEDM")
    _, cond = _data(4, 5)
    prior = np.zeros((5, ACT), np.float32)
    key = jax.random.PRNGKey(3)
    jfn = jeng.build_sample_fn(solver="heun", sample_steps=3, cfg_mode="cond",
                               diffusion_x_sampling_steps=2, preserve_history=True)
    want, jlog = jfn(jeng.state.ema_params, None, key, jnp.asarray(prior), jnp.asarray(cond),
                     None, None, 1.0, 0.0, 1.0)
    tfn = teng.build_sample_fn(solver="heun", sample_steps=3, cfg_mode="cond",
                               diffusion_x_sampling_steps=2, preserve_history=True)
    with torch.no_grad():
        got, tlog = tfn(teng.ema_params, None, torch.from_numpy(prior), torch.from_numpy(cond),
                        w_cfg=1.0, noise=_t(jax.random.normal(jax.random.split(key)[0],
                                                              prior.shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tlog["sample_history"].numpy(),
                               np.asarray(jlog["sample_history"]), atol=ATOL, rtol=RTOL)


def test_edm_update_classifier_uses_log_sigma_over_4():
    """The classifier trains on x0 noised as in training at log(sigma) / 4:
    the loss of one CEP-free classifier step on both packages."""
    teng = tdiff.ContinuousEDM(DQLMlp(OBS, ACT, emb_dim=16), IdentityCondition(0.0),
                               device="cpu")
    seen = {}

    class Spy:
        def update(self, xt, t, y):
            seen.update(xt=xt, t=t, y=y)
            return {}

    teng.classifier = Spy()
    x0 = torch.randn(B, ACT)
    sigma, eps = torch.rand(B) + 0.1, torch.randn(B, ACT)
    teng.update_classifier(x0, "c", noise=(sigma, eps))
    torch.testing.assert_close(seen["xt"], x0 + sigma[:, None] * eps)
    torch.testing.assert_close(seen["t"], torch.log(sigma) / 4.0)
    vp = tdiff.VPODE(DQLMlp(OBS, ACT, emb_dim=16), device="cpu")
    vp.classifier = Spy()
    vp.update_classifier(x0, "c", noise=(sigma, eps))
    torch.testing.assert_close(seen["t"], vp.c_noise(sigma))


# ---------------------------------------------------------------------------
# Karras-ODE tables (tests/test_karras_ode.py's goldens, on the port)
def _karras(name, **kw):
    return getattr(tdiff, name)(DQLMlp(3, 2), device="cpu", **kw)


def test_karras_tables_and_weights_equal_jax():
    for name in KARRAS:
        teng = _karras(name)
        jeng = getattr(jdiff, name)(JaxDQLMlp(obs_dim=3, act_dim=2))
        for N in (1, 5, 10):
            for a, b in zip(teng.ode_tables(N), jeng.ode_tables(N)):
                np.testing.assert_array_equal(a, b)
            tabs = teng.ode_tables(N)
            for a, b in zip(teng.ode_weights(*tabs), jeng.ode_weights(*tabs)):
                np.testing.assert_array_equal(a, b)


def test_ve_tables_golden_port():
    t, sigma, scale = _karras("VEODE", sigma_min=0.02, sigma_max=100.0).ode_tables(10)
    assert len(sigma) == 11
    np.testing.assert_allclose(sigma[0], 100.0, rtol=1e-6)
    np.testing.assert_allclose(sigma[-1], 0.02, rtol=1e-6)
    r = sigma[1:] / sigma[:-1]
    np.testing.assert_allclose(r, r[0], rtol=1e-5)
    np.testing.assert_allclose(t, sigma**2, rtol=1e-6)
    np.testing.assert_allclose(scale, 1.0)


def test_vp_tables_golden_port():
    t, sigma, scale = _karras("VPODE", beta_min=0.1, beta_max=20.0).ode_tables(8)
    beta_d = 20.0 - 0.1
    np.testing.assert_allclose(sigma, np.sqrt(np.exp(0.5 * beta_d * t**2 + 0.1 * t) - 1.0),
                               rtol=1e-6)
    np.testing.assert_allclose(scale, 1.0 / np.sqrt(1.0 + sigma**2), rtol=1e-6)
    assert t[0] == 1.0 and np.isclose(t[-1], 1e-3)
    np.testing.assert_allclose(scale**2 * (1 + sigma**2), 1.0, rtol=1e-6)


def test_edmddim_tables_golden_port():
    eng = _karras("EDMDDIM", diffusion_steps=100, j0=8)
    t, sigma, scale = eng.ode_tables(10)
    assert np.all(np.diff(sigma) < 0) and np.all(sigma > 0)
    np.testing.assert_allclose(t, sigma)
    np.testing.assert_allclose(scale, 1.0)
    u = eng._u
    j = np.arange(100 + 1)
    bar = np.sin(j / (100 * (0.008 + 1)) * np.pi / 2.0) ** 2
    tmp = np.maximum(bar[:-1] / bar[1:], 0.001)
    np.testing.assert_allclose((u[:-1] ** 2 + 1.0) * tmp[:-1], u[1:] ** 2 + 1.0, rtol=1e-5)


class _Oracle(nn.Module):
    """F such that the engine's D(x; sigma) is x0 exactly."""

    def __init__(self, engine, x0):
        super().__init__()
        self.engine, self.x0 = engine, x0

    def forward(self, xin, tn, emb=None):
        e = self.engine
        inv = {tdiff.VEODE: lambda v: 2.0 * torch.exp(v),
               tdiff.VPODE: lambda v: e._sigma_of_t(v / (e.diffusion_steps - 1)),
               tdiff.EDMDDIM: lambda v: v}[type(e)]
        sigma = inv(tn)
        ci, cs, co = (f(sigma)[:, None] for f in (e.c_in, e.c_skip, e.c_out))
        return (self.x0 - cs * (xin / ci)) / co


def _oracle_pair(name, x0_np, batch):
    """The JAX test's oracle engine and the port's, and the initial draw the
    JAX engine's `sample` makes (its next sample key)."""
    from test_karras_ode import _Oracle as JaxOracle
    from test_karras_ode import _make

    jeng = _make(getattr(jdiff, name), nn_diffusion=JaxOracle(_make(getattr(jdiff, name)),
                                                              jnp.asarray(x0_np)))
    jeng.init(jnp.zeros((batch, 2)))
    key = jeng.next_sample_rng()
    teng = getattr(tdiff, name)(_Oracle(_karras(name), torch.from_numpy(x0_np)), device="cpu")
    draw = _t(jax.random.normal(jax.random.split(key)[0], (batch, 2)))
    return jeng, teng, key, draw


@pytest.mark.parametrize("name,steps,atol", [("VEODE", 50, 0.08), ("VPODE", 50, 0.08),
                                             ("EDMDDIM", 50, 0.15)])
def test_oracle_ode_converges_to_x0_port(name, steps, atol):
    """tests/test_karras_ode.py's oracle convergence on the port, from the
    initial draw the JAX test's engine makes; the port's sample also
    equals the JAX engine's."""
    x0 = np.random.default_rng(0).standard_normal((1, 2)).astype(np.float32)
    jeng, teng, key, draw = _oracle_pair(name, x0, 4)
    want, _ = jeng.sample(jnp.zeros((4, 2)), solver="euler", sample_steps=steps, rng=key)
    out, _ = teng.sample(torch.zeros((4, 2)), solver="euler", sample_steps=steps, noise=draw)
    np.testing.assert_allclose(out.numpy(), np.tile(x0, (4, 1)), atol=atol)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_oracle_heun_tightens_euler_port():
    x0 = np.random.default_rng(1).standard_normal((1, 2)).astype(np.float32)
    _, teng, _, _ = _oracle_pair("VEODE", x0, 8)
    draw = _t(jax.random.normal(jax.random.split(jax.random.PRNGKey(0))[0], (8, 2)))
    err = {}
    for solver in ("euler", "heun"):
        out, _ = teng.sample(torch.zeros((8, 2)), solver=solver, sample_steps=12, noise=draw)
        err[solver] = float(np.abs(out.numpy() - x0).max())
    assert err["heun"] <= err["euler"] + 1e-6


# ---------------------------------------------------------------------------
# Consistency model
CM_KW = dict(s0=4, s1=8, curriculum_cycle=6)


def _cm_draws_training(jcm, x0):
    _, sub = jax.random.split(jcm.state.rng)
    k_idx, k_eps, _, _ = jax.random.split(sub, 4)
    logits = jnp.log(jnp.maximum(jcm.cur_logger.p_padded, 1e-37))
    idx = jax.random.categorical(k_idx, logits, shape=(x0.shape[0],))
    return _t(idx), _t(jax.random.normal(k_eps, x0.shape)), None


def _cm_draws_distillation(jcm, x0):
    _, sub = jax.random.split(jcm.state.rng)
    k_t, k_eps, _ = jax.random.split(sub, 3)
    idx = jax.random.randint(k_t, (x0.shape[0],), 0, jcm.distillation_N)
    return _t(idx), _t(jax.random.normal(jax.random.split(k_eps)[1], x0.shape))


@pytest.fixture(scope="module")
def cm_runs():
    """Consistency training (5 steps, across a curriculum stage) and
    distillation (3 steps) on both packages."""
    out = {}
    jcm, tcm = _pair("ContinuousConsistencyModel", seed=40, **CM_KW)
    logs, ks = [], []
    for i in range(5):
        x0, cond = _data(20 + i)
        noise = _cm_draws_training(jcm, x0)
        ks.append((tcm.cur_logger.Nk, jcm.cur_logger.Nk))
        lj = jcm.update(jnp.asarray(x0), jnp.asarray(cond), loss_type="training")
        lt = tcm.update(torch.from_numpy(x0), torch.from_numpy(cond), loss_type="training",
                        noise=noise)
        logs.append(({k: float(v) for k, v in lj.items()}, {k: float(v) for k, v in lt.items()}))
    out["training"] = (jcm, tcm, logs, ks)

    jedm, tedm = _pair("ContinuousEDM", seed=50, x_max=np.ones(ACT), x_min=-np.ones(ACT))
    jcm, tcm = _pair("ContinuousConsistencyModel", seed=60, x_max=np.ones(ACT),
                     x_min=-np.ones(ACT))
    jcm.prepare_distillation(jedm, distillation_N=6)
    tcm.prepare_distillation(tedm, distillation_N=6)
    _close_tree(agent_params_of(tcm.params), jedm.state.params)
    logs = []
    for i in range(3):
        x0, cond = _data(30 + i)
        noise = _cm_draws_distillation(jcm, x0)
        lj = jcm.update(jnp.asarray(x0), jnp.asarray(cond), loss_type="distillation")
        lt = tcm.update(torch.from_numpy(x0), torch.from_numpy(cond), loss_type="distillation",
                        noise=noise)
        logs.append(({k: float(v) for k, v in lj.items()}, {k: float(v) for k, v in lt.items()}))
    out["distillation"] = (jcm, tcm, logs, None)
    return out


@pytest.mark.parametrize("loss_type", ["training", "distillation"])
def test_consistency_updates_match_jax(cm_runs, loss_type):
    jcm, tcm, logs, ks = cm_runs[loss_type]
    for lj, lt in logs:
        assert set(lt) == set(lj)
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    _close_tree(agent_params_of(tcm.params), jcm.state.params)
    _close_tree(agent_params_of(tcm.ema_params), jcm.state.ema_params)
    if ks is not None:
        # the curriculum doubles N(k) within the 5 steps (N before each
        # step), on both sides
        assert [p for p, _ in ks] == [j for _, j in ks]
        assert ks[0][0] < ks[-1][0]
        assert tcm.cur_logger.k == jcm.cur_logger.k == 5


def test_curriculum_tables_equal_jax():
    jl = jdiff.CMCurriculumLogger(s0=10, s1=160, curriculum_cycle=2000)
    tl = tdiff.CMCurriculumLogger(s0=10, s1=160, curriculum_cycle=2000)
    for k in (0, 1, 400, 401, 1500, 1999):
        jl.update_k(k)
        tl.update_k(k)
        assert tl.Nk == jl.Nk
        np.testing.assert_array_equal(tl.sigmas_padded, np.asarray(jl.sigmas_padded))
        np.testing.assert_array_equal(tl.p_padded, np.asarray(jl.p_padded))
        assert tl.curriculum_process == jl.curriculum_process


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_consistency_sampler_matches_jax(steps):
    jcm, tcm = _pair("ContinuousConsistencyModel", seed=70, x_max=np.ones(ACT),
                     x_min=-np.ones(ACT))
    _, cond = _data(5, 6)
    prior = np.zeros((6, ACT), np.float32)
    key = jax.random.PRNGKey(11)
    want, _ = jcm.build_sample_fn(steps, "cond", 1)(
        jcm.state.ema_params, None, key, jnp.asarray(prior), jnp.asarray(cond), None, None,
        1.0, 0.0, 0.9)
    k_init, k = jax.random.split(key)
    per = []
    for _ in range(steps):  # (steps - 1) re-injections and one diffusion-x step
        k, sub = jax.random.split(k)
        per.append(np.asarray(jax.random.normal(sub, prior.shape)))
    noise = (_t(jax.random.normal(k_init, prior.shape)), _t(np.stack(per)))
    with torch.no_grad():
        got, _ = tcm.build_sample_fn(steps, "cond", 1)(
            tcm.ema_params, None, torch.from_numpy(prior), torch.from_numpy(cond),
            temperature=0.9, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_pseudo_huber_loss():
    a, b = torch.tensor([0.0, 3.0]), torch.tensor([4.0, 3.0])
    torch.testing.assert_close(pseudo_huber_loss(a, b, 0.0), torch.tensor([4.0, 0.0]))
    torch.testing.assert_close(pseudo_huber_loss(a, b, 3.0), torch.tensor([2.0, 0.0]))


# ---------------------------------------------------------------------------
# tests/test_edm_rf_cm.py's smoke tests on the port
def _port(name, **kw):
    return getattr(tdiff, name)(DQLMlp(OBS, ACT, emb_dim=16), IdentityCondition(dropout=0.0),
                                device="cpu", **kw)


def test_edm_update_and_sample_port():
    engine = _port("ContinuousEDM")
    x0, cond = (torch.from_numpy(a) for a in _data(1))
    assert np.isfinite(float(engine.update(x0, cond)["loss"]))
    for solver in ("euler", "heun"):
        out, log = engine.sample(torch.zeros((4, ACT)), solver=solver, sample_steps=4,
                                 condition_cfg=cond[:4], w_cfg=1.0)
        assert out.shape == (4, ACT) and torch.isfinite(out).all()
        assert log["log_p"] is None


def test_cm_training_then_sample_port():
    engine = _port("ContinuousConsistencyModel", **CM_KW)
    x0, cond = (torch.from_numpy(a) for a in _data(2))
    for _ in range(3):
        assert np.isfinite(float(engine.update(x0, cond, loss_type="training")["loss"]))
    assert engine.cur_logger.k == 3
    out, _ = engine.sample(torch.zeros((4, ACT)), sample_steps=3, condition_cfg=cond[:4])
    assert out.shape == (4, ACT) and torch.isfinite(out).all()
    out1, _ = engine.sample(torch.zeros((4, ACT)), sample_steps=1)
    assert torch.isfinite(out1).all()


def test_cm_distillation_port():
    edm = _port("ContinuousEDM")
    x0, cond = (torch.from_numpy(a) for a in _data(3))
    edm.update(x0, cond)
    cm = _port("ContinuousConsistencyModel")
    cm.prepare_distillation(edm, distillation_N=6)
    for a, b in zip(cm.params.parameters(), edm.params.parameters()):
        assert torch.equal(a, b) and a is not b
    assert np.isfinite(float(cm.update(x0, cond, loss_type="distillation")["loss"]))
    out, _ = cm.sample(torch.zeros((4, ACT)), sample_steps=2, condition_cfg=cond[:4])
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError):
        cm.sample(torch.zeros((4, ACT)), w_cg=1.0)


@pytest.mark.parametrize("prop", [dict(sigma_data=0.7), dict(rho=5.0),
                                  dict(x_max=np.ones(ACT))])
def test_cm_distillation_property_mismatch_raises_port(prop):
    edm = _port("ContinuousEDM", **prop)
    cm = _port("ContinuousConsistencyModel")
    with pytest.raises(ValueError, match="differ"):
        cm.prepare_distillation(edm)
    with pytest.raises(ValueError, match="prepare_distillation"):
        cm.update(torch.zeros(2, ACT), torch.zeros(2, OBS), loss_type="distillation")


def test_legacy_aliases_name_the_same_engines_as_jax():
    pairs = {"DDPM": "DiscreteDiffusionSDE", "EDM": "ContinuousEDM",
             "DDIM": "DiscreteDiffusionSDE", "DPMSolver": "ContinuousDiffusionSDE",
             "DPMSolverDiscrete": "DiscreteDiffusionSDE"}
    for alias, engine in pairs.items():
        assert getattr(tdiff, alias) is getattr(tdiff, engine)
        assert getattr(jdiff, alias).__name__ == engine
    assert issubclass(tdiff.VPODE, tdiff.KarrasODE) and issubclass(tdiff.KarrasODE,
                                                                    tdiff.ContinuousEDM)
    assert tdiff.ContinuousEDM(DQLMlp(OBS, ACT), device="cpu").supported_solvers == [
        "euler", "heun"]

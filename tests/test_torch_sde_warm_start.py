"""The SDE engines' warm start and history (diffusion/diffusionsde.py)
against the JAX package's, on the same seeded weights and the same draws
(the JAX sampler's own, replayed from its key splits: the initial row is
the warm start's draw).

- Both engines x ddpm / ddim / ode_dpmsolver++_2M / sde_dpmsolver++_2M,
  through `sample(..., warm_start_reference=..., preserve_history=True)`
  with CFG "mix", an inpainting mask and clipping: the sample and its
  history (every step before the final clipping) within 1e-5 of the JAX
  values' scale; the discrete engine also with Diffusion-X steps.
- `fused_update` on the warm tables: each step's (c_xt, c_eps, c_noise) are
  the ddpm coefficients of the JAX engine's warm tables (float32, 1e-6).
- A small DD (`DiT1d` with `use_pallas_block=True`, whose plain twin runs
  on the CPU) warm-started from a cold plan: within 1e-5 of JAX's.
- The JAX package's own sampler cases (tests/test_diffusion_sde.py,
  history, inpainting, clipping, Diffusion-X, warm start, classifier
  guidance), on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleandiffuser_tpu.diffusion as jdiffusion
import cleandiffuser_tpu.nn_condition as jcond
import cleandiffuser_tpu.nn_diffusion as jnn
from cleandiffuser_tpu.pipelines.dd import DDPipeline as JaxDDPipeline
from cleandiffuser_tpu_torch import diffusion as tdiffusion
from cleandiffuser_tpu_torch import nn_condition as tcond
from cleandiffuser_tpu_torch import nn_diffusion as tnn
from cleandiffuser_tpu_torch.classifier import CumRewClassifier
from cleandiffuser_tpu_torch.diffusion import diffusionsde
from cleandiffuser_tpu_torch.diffusion.vp_solvers import ddpm_coefficients
from cleandiffuser_tpu_torch.nn_classifier import MLPNNClassifier
from cleandiffuser_tpu_torch.pipelines import DDPipeline
from cleandiffuser_tpu_torch.utils.jax_params import load_agent_params
from jax_shaped_init import shaped_inits

torch.set_num_threads(2)
TOL = 1e-5
OBS, ACT, B, STEPS, LEVEL = 7, 3, 4, 4, 0.5
SOLVERS = ["ddpm", "ddim", "ode_dpmsolver++_2M", "sde_dpmsolver++_2M"]
FIX_MASK = np.array([1.0, 0.0, 0.0], np.float32)
X_BOUND = 1.5


def _seeded(tree, seed, scale=None):
    """Seeded normals: kernels at std 1/sqrt(fan-in) (all axes but the
    last) and vectors at 0.1, or every leaf at `scale`."""
    rng = np.random.default_rng(seed)

    def fill(a):
        z = rng.standard_normal(np.shape(a))
        if scale is not None:
            return (z * scale).astype(np.float32)
        if np.ndim(a) >= 2:
            return (z / np.sqrt(np.prod(np.shape(a)[:-1]))).astype(np.float32)
        return (z * 0.1).astype(np.float32)

    return jax.tree_util.tree_map(fill, jax.device_get(tree))


def _jax_noise(rng, shape, steps):
    """The JAX sampler's draws: k_init, k_scan = split(rng); then
    rng, k_noise = split(rng) at every step."""
    k_init, k = jax.random.split(rng)
    init = np.array(jax.random.normal(k_init, shape))
    per_step = []
    for _ in range(steps):
        k, k_noise = jax.random.split(k)
        per_step.append(np.asarray(jax.random.normal(k_noise, shape)))
    return torch.from_numpy(init), torch.from_numpy(np.stack(per_step))


def _close(got, want, label=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=label)


_ENGINES = {}


def _engines(kind):
    """A JAX engine and the port's with the same seeded params and EMA,
    built once per module."""
    if kind not in _ENGINES:
        extra = dict(fix_mask=FIX_MASK, x_max=np.full(ACT, X_BOUND, np.float32),
                     x_min=np.full(ACT, -X_BOUND, np.float32))
        J = jdiffusion.DiscreteDiffusionSDE if kind == "discrete" else \
            jdiffusion.ContinuousDiffusionSDE
        T = tdiffusion.DiscreteDiffusionSDE if kind == "discrete" else \
            tdiffusion.ContinuousDiffusionSDE
        steps = dict(diffusion_steps=32) if kind == "discrete" else {}
        jeng = J(jnn.DQLMlp(obs_dim=OBS, act_dim=ACT, emb_dim=16),
                 jcond.IdentityCondition(dropout=0.0), **steps, **extra)
        with shaped_inits():  # every leaf is seeded below
            jeng.init(jnp.zeros((B, ACT)), jnp.zeros((B, OBS)))
        params, ema = _seeded(jeng.state.params, 1), _seeded(jeng.state.ema_params, 2)
        jeng.state = jeng.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                                        ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
        teng = T(tnn.DQLMlp(OBS, ACT, 16), tcond.IdentityCondition(dropout=0.0), **steps,
                 **extra, device="cpu")
        load_agent_params(teng.params, params)
        load_agent_params(teng.ema_params, ema)
        _ENGINES[kind] = (jeng, teng)
    return _ENGINES[kind]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    prior = np.zeros((B, ACT), np.float32)
    prior[:, 0] = rng.standard_normal(B)
    ref = rng.standard_normal((B, ACT)).astype(np.float32)
    cond = rng.standard_normal((B, OBS)).astype(np.float32)
    return prior, ref, cond


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_warm_start_with_history_matches_jax(kind, solver):
    jeng, teng = _engines(kind)
    prior, ref, cond = _inputs()
    x_steps = 2 if kind == "discrete" else 0
    kw = dict(solver=solver, sample_steps=STEPS, w_cfg=1.5, warm_start_forward_level=LEVEL,
              preserve_history=True, diffusion_x_sampling_steps=x_steps)
    key = jax.random.PRNGKey(7)
    want, wlog = jeng.sample(jnp.asarray(prior), condition_cfg=jnp.asarray(cond),
                             warm_start_reference=jnp.asarray(ref), rng=key, **kw)
    noise = _jax_noise(key, prior.shape, STEPS + x_steps)
    with torch.no_grad():
        got, glog = teng.sample(torch.from_numpy(prior), condition_cfg=torch.from_numpy(cond),
                                warm_start_reference=torch.from_numpy(ref), noise=noise, **kw)
    hist = glog["sample_history"]
    assert hist.shape == (B, STEPS + x_steps, ACT) and glog["log_p"] is None
    _close(got.numpy(), want, "sample")
    _close(hist.numpy(), wlog["sample_history"], "history")
    # the history is the plan before the final clipping; the mask pins the prior
    torch.testing.assert_close(got, hist[:, -1].clamp(-X_BOUND, X_BOUND), rtol=0, atol=0)
    np.testing.assert_array_equal(hist[:, :, 0].numpy(),
                                  np.repeat(prior[:, None, 0], STEPS + x_steps, 1))
    # a warm start is not the cold sampler: the reference moves the states
    with torch.no_grad():
        _, cold = teng.sample(torch.from_numpy(prior), condition_cfg=torch.from_numpy(cond),
                              noise=noise, **kw)
    assert (cold["sample_history"][:, 0] - hist[:, 0]).abs().max() > 0.1


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_warm_tables_and_fused_update_coefficients_match_jax(kind, monkeypatch):
    """The warm level's grid and forward level equal JAX's; with
    `fused_update`, every ddpm step takes its coefficients from the warm
    tables (the step recorded through a stand-in for the kernel's op)."""
    jeng, teng = _engines(kind)
    jt, ja, js = (np.asarray(a) for a in jeng._sample_tables("uniform", STEPS, LEVEL))
    tt, ta, ts_ = teng._sample_tables("uniform", STEPS, LEVEL)
    np.testing.assert_array_equal(tt.numpy(), jt) if kind == "discrete" else \
        np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-6)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-6)
    np.testing.assert_allclose(ts_.numpy(), js, rtol=1e-6)
    np.testing.assert_allclose(teng._forward_level(LEVEL),
                               [float(v) for v in jeng._forward_level(LEVEL)], rtol=1e-6)
    ja_t, js_t = torch.from_numpy(ja), torch.from_numpy(js)
    stds = torch.cat([torch.zeros(1), js_t[:-1] / js_t[1:]
                      * torch.sqrt(1 - (ja_t[1:] / ja_t[:-1]) ** 2)])
    want = [ddpm_coefficients(i, ja_t, js_t, stds) for i in range(STEPS, 0, -1)]
    seen = []
    real_op = diffusionsde.solver_update_op

    def recording_op(xt, eps, coefs, seed):
        seen.append(coefs)
        return real_op(xt, eps, coefs, seed)

    monkeypatch.setattr(diffusionsde, "solver_update_op", recording_op)
    prior, ref, cond = _inputs(1)
    with torch.no_grad():
        x0, log = teng.sample(torch.from_numpy(prior), solver="ddpm", sample_steps=STEPS,
                              condition_cfg=torch.from_numpy(cond), w_cfg=1.5,
                              warm_start_reference=torch.from_numpy(ref),
                              warm_start_forward_level=LEVEL, preserve_history=True,
                              fused_update=True, generator=torch.Generator().manual_seed(0))
    assert len(seen) == STEPS and torch.isfinite(x0).all()
    assert log["sample_history"].shape == (B, STEPS, ACT)
    np.testing.assert_allclose(np.array(seen), np.array(want), rtol=1e-6, atol=1e-7)


def test_dd_warm_plan_matches_jax():
    """A small DD plan (ddpm, CFG, the first state pinned) warm-started at
    0.3 from a cold plan of the port, with history, through each package's
    engine `sample`."""
    cfg = dict(obs_dim=5, act_dim=3, horizon=8, emb_dim=32, d_model=32, n_heads=4, depth=2,
               sampling_steps=4, w_cfg=2.0, target_return=0.95, temperature=0.5)
    E = 3
    with shaped_inits():  # every leaf is seeded below
        jpipe = JaxDDPipeline(**cfg, use_pallas_block=True)
    # at 0.1, as tests/test_torch_dd_slice.py seeds DD
    params = _seeded(jpipe.agent.state.params, 3, 0.1)
    ema, inv = _seeded(jpipe.agent.state.ema_params, 4, 0.1), _seeded(jpipe.invdyn.params, 5, 0.1)
    jpipe.agent.state = jpipe.agent.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
    tpipe = DDPipeline(**cfg, use_pallas_block=True, device="cpu")
    tpipe.load_jax_params(params, ema, inv)
    assert all(b.use_kernel for b in tpipe.agent.ema_params["diffusion"].blocks)
    obs = np.random.default_rng(6).standard_normal((E, 5)).astype(np.float32)
    cold, info = tpipe.act(obs, generator=torch.Generator().manual_seed(0))
    ref = info["traj"].numpy()
    prior = np.zeros_like(ref)
    prior[:, 0] = obs
    cond = np.full((E, 1), cfg["target_return"], np.float32)
    kw = dict(solver="ddpm", sample_steps=4, w_cfg=2.0, temperature=0.5,
              warm_start_forward_level=0.3, preserve_history=True)
    key = jax.random.PRNGKey(8)
    want, wlog = jpipe.agent.sample(jnp.asarray(prior), condition_cfg=jnp.asarray(cond),
                                    warm_start_reference=jnp.asarray(ref), rng=key, **kw)
    with torch.no_grad():
        got, glog = tpipe.agent.sample(torch.from_numpy(prior),
                                       condition_cfg=torch.from_numpy(cond),
                                       warm_start_reference=torch.from_numpy(ref),
                                       noise=_jax_noise(key, prior.shape, 4), **kw)
    assert np.abs(np.asarray(want)[:, 1:]).max() > 0.1
    _close(got.numpy(), want, "plan")
    _close(glog["sample_history"].numpy(), wlog["sample_history"], "history")
    np.testing.assert_array_equal(got[:, 0].numpy(), obs)


# ---------------------------------------------------------------------------
# The JAX package's sampler cases (tests/test_diffusion_sde.py), on the port
def _port_engine(**kw):
    return tdiffusion.DiscreteDiffusionSDE(tnn.DQLMlp(OBS, ACT, 16),
                                           tcond.IdentityCondition(dropout=0.0),
                                           diffusion_steps=32, device="cpu", **kw)


def _x0(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, ACT)).astype(
        np.float32))


def test_port_sample_history():
    engine = _port_engine()
    engine.update(_x0(2))
    with torch.no_grad():
        _, log = engine.sample(torch.zeros(2, ACT), solver="ddpm", sample_steps=5,
                               preserve_history=True)
    assert log["sample_history"].shape == (2, 5, ACT)


def test_port_fix_mask_pins_prior():
    engine = _port_engine(fix_mask=FIX_MASK)
    engine.update(_x0(4))
    prior = torch.tensor([[5.0, 0.0, 0.0]]).repeat(4, 1)
    with torch.no_grad():
        out, _ = engine.sample(prior, solver="ddpm", sample_steps=4)
    np.testing.assert_allclose(out[:, 0].numpy(), 5.0, atol=1e-5)


def test_port_clip_prediction():
    engine = _port_engine(x_max=torch.ones(ACT), x_min=-torch.ones(ACT))
    engine.update(_x0(4))
    with torch.no_grad():
        out, _ = engine.sample(torch.zeros(4, ACT), solver="ddpm", sample_steps=4)
    assert torch.all(out.abs() <= 1.0 + 1e-5)


def test_port_diffusion_x_steps():
    engine = _port_engine()
    engine.update(_x0(2))
    with torch.no_grad():
        out, log = engine.sample(torch.zeros(2, ACT), solver="ddpm", sample_steps=4,
                                 diffusion_x_sampling_steps=3, preserve_history=True)
    assert torch.isfinite(out).all() and log["sample_history"].shape == (2, 7, ACT)


def test_port_warm_start():
    engine = _port_engine()
    engine.update(_x0(2))
    with torch.no_grad():
        out, _ = engine.sample(torch.zeros(2, ACT), solver="ddim", sample_steps=4,
                               warm_start_reference=torch.ones(2, ACT) * 0.3,
                               warm_start_forward_level=0.5)
    assert torch.isfinite(out).all()


def test_port_classifier_guided_sampling():
    classifier = CumRewClassifier(MLPNNClassifier(ACT, 1, 16, (32,)), device="cpu")
    engine = _port_engine(classifier=classifier)
    x0 = _x0(4)
    R = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 1)).astype(np.float32))
    engine.update(x0)
    xt, t, _ = engine.add_noise(x0, generator=torch.Generator().manual_seed(0))
    classifier.update(xt, t, R)
    with torch.no_grad():
        out, log = engine.sample(torch.zeros(4, ACT), solver="ddpm", sample_steps=4,
                                 condition_cg=R, w_cg=1.0)
    assert torch.isfinite(out).all() and log["log_p"].shape == (4, 1)

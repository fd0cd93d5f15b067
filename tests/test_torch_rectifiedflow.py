"""The PyTorch port's rectified-flow engines against the JAX package's.

Same weights (seeded numpy normals in the JAX layout, carried in by the
converter), same inputs and the same draws go through
`cleandiffuser_tpu.diffusion.{Discrete,Continuous}RectifiedFlow` and the
port's counterparts (diffusion/rectifiedflow.py) on a DQLMlp backbone:

- the loss, with the draws the JAX loss takes from its key
  (`k_t, k_x1, k_cond, _ = split(rng, 4)`; the condition's keep-mask read
  back as the rows the JAX condition zeroes), with and without a reflow x1;
- 3 updates (params, EMA and losses), with and without a reflow x1;
- samples on the uniform and quad schedules, under CFG "mix" and
  "uncond", with temperature and fix_mask inpainting, plus a given x1, warm
  start, extra diffusion-x steps and history, the initial draw being the
  JAX sampler's `k_init, _ = split(rng)`;
- the JAX package's own engine checks (tests/test_edm_rf_cm.py), on the port.

Tolerance: float32 on both sides, sums in another order: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.diffusion import (
    ContinuousRectifiedFlow as JaxContinuousRF,
    DiscreteRectifiedFlow as JaxDiscreteRF,
)
from cleandiffuser_tpu.nn_condition import IdentityCondition as JaxIdentityCondition
from cleandiffuser_tpu.nn_diffusion import DQLMlp as JaxDQLMlp
from cleandiffuser_tpu_torch.diffusion import ContinuousRectifiedFlow, DiscreteRectifiedFlow
from cleandiffuser_tpu_torch.nn_condition import IdentityCondition
from cleandiffuser_tpu_torch.nn_diffusion import DQLMlp
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, load_agent_params

torch.set_num_threads(1)

OBS, ACT, B = 7, 3, 8
TOL = 1e-5
T_STEPS = 32
ENGINES = {"discrete": (JaxDiscreteRF, DiscreteRectifiedFlow),
           "continuous": (JaxContinuousRF, ContinuousRectifiedFlow)}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _seeded(tree, seed):
    """Normals at a Dense init's scale (1 / sqrt(fan-in)); biases 0.1."""
    rng = np.random.default_rng(seed)
    scale = lambda a: 1 / np.sqrt(a.shape[0]) if a.ndim >= 2 else 0.1
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * scale(a)).astype(np.float32), _np(tree))


def _pair(kind, fix_mask=None, dropout=0.25):
    """(JAX engine, port engine) on the same seeded params and EMA."""
    jcls, tcls = ENGINES[kind]
    kw = {"diffusion_steps": T_STEPS} if kind == "discrete" else {}
    jeng = jcls(JaxDQLMlp(obs_dim=OBS, act_dim=ACT, emb_dim=16),
                JaxIdentityCondition(dropout=dropout), fix_mask=fix_mask, **kw)
    jeng.init(jnp.zeros((1, ACT)), jnp.zeros((1, OBS)))
    params, ema = _seeded(jeng.state.params, 1), _seeded(jeng.state.ema_params, 2)
    jeng.state = jeng.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                                    ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
    teng = tcls(DQLMlp(OBS, ACT, emb_dim=16), IdentityCondition(dropout=dropout),
                fix_mask=fix_mask, device="cpu", **kw)
    load_agent_params(teng.params, params)
    load_agent_params(teng.ema_params, ema)
    return jeng, teng


def _data(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, ACT)).astype(np.float32),
            rng.standard_normal((B, OBS)).astype(np.float32),
            rng.standard_normal((B, ACT)).astype(np.float32))


def _loss_draws(jeng, key, x0, cond):
    """The draws the JAX loss takes from `key`: (t, x1, keep)."""
    k_t, k_x1, k_cond, _ = jax.random.split(key, 4)
    if isinstance(jeng, JaxDiscreteRF):
        t = jax.random.randint(k_t, (B,), 0, jeng.diffusion_steps)
    else:
        t = jax.random.uniform(k_t, (B,))
    x1 = jax.random.normal(k_x1, x0.shape)
    emb = np.asarray(jeng.apply_condition(jeng.state.params, jnp.asarray(cond), train=True,
                                          rng=k_cond))
    keep = (np.abs(emb).sum(-1) > 0).astype(np.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in (t, x1, keep))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("reflow", [False, True])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_loss_matches_jax(kind, reflow):
    fix = np.array([1.0, 0.0, 0.0], np.float32)
    jeng, teng = _pair(kind, fix_mask=fix)
    x0, cond, x1 = _data(3)
    key = jax.random.PRNGKey(7)
    noise = _loss_draws(jeng, key, x0, cond)
    jx1 = jnp.asarray(x1) if reflow else None
    want = float(jeng.loss_fn(jeng.state.params, key, jnp.asarray(x0), jnp.asarray(cond),
                              None, jx1))
    with torch.no_grad():
        got = float(teng.loss_fn(teng.params, _t(x0), _t(cond), noise=noise,
                                 x1=_t(x1) if reflow else None))
    assert noise[2].min() == 0 and noise[2].max() == 1  # both keep-mask cases drawn
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)


@pytest.mark.parametrize("reflow", [False, True])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_three_updates_match_jax(kind, reflow):
    jeng, teng = _pair(kind)
    for step in range(3):
        x0, cond, x1 = _data(10 + step)
        _, sub = jax.random.split(jeng.state.rng)
        noise = _loss_draws(jeng, sub, x0, cond)
        jl = jeng.update(jnp.asarray(x0), jnp.asarray(cond),
                         x1=jnp.asarray(x1) if reflow else None)
        tl = teng.update(_t(x0), _t(cond), noise=noise, x1=_t(x1) if reflow else None)
        np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=TOL, atol=1e-7)
    for got, want in ((teng.params, jeng.state.params), (teng.ema_params, jeng.state.ema_params)):
        got_l = jax.tree_util.tree_leaves_with_path(agent_params_of(got))
        want_l = jax.tree_util.tree_leaves_with_path(_np(want))
        assert [p for p, _ in got_l] == [p for p, _ in want_l]
        for (path, a), (_, b) in zip(got_l, want_l):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=jax.tree_util.keystr(path))
    assert teng.step == int(jeng.state.step) == 3


def _sample_both(jeng, teng, key, prior, **kw):
    k_init, _ = jax.random.split(key)
    draw = torch.from_numpy(np.array(jax.random.normal(k_init, prior.shape)))
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want, wlog = jeng.sample(jnp.asarray(prior), rng=key, **jkw)
    with torch.no_grad():
        got, glog = teng.sample(_t(prior), noise=draw, **tkw)
    return got, np.asarray(want), glog, wlog


@pytest.mark.parametrize("cfg", ["mix", "uncond"])
@pytest.mark.parametrize("schedule", ["uniform", "quad"])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_samples_match_jax(kind, schedule, cfg):
    """5 Euler steps under temperature 0.7 with the first action dim
    pinned to the prior's (inpainting)."""
    fix = np.array([1.0, 0.0, 0.0], np.float32)
    jeng, teng = _pair(kind, fix_mask=fix)
    rng = np.random.default_rng(5)
    prior = np.zeros((6, ACT), np.float32)
    prior[:, 0] = rng.uniform(-1, 1, 6)
    cond = rng.standard_normal((6, OBS)).astype(np.float32)
    w = 1.5 if cfg == "mix" else 0.0
    got, want, _, _ = _sample_both(
        jeng, teng, jax.random.PRNGKey(11), prior, sample_steps=5,
        sample_step_schedule=schedule, temperature=0.7, condition_cfg=cond, w_cfg=w)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.numpy()[:, 0], prior[:, 0])


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_sample_options_match_jax(kind):
    """A given x1 (cond mode), warm start with extra diffusion-x steps and
    the sample history, and clipping to [x_min, x_max]."""
    jeng, teng = _pair(kind)
    rng = np.random.default_rng(6)
    prior = np.zeros((4, ACT), np.float32)
    cond = rng.standard_normal((4, OBS)).astype(np.float32)
    x1 = rng.standard_normal((4, ACT)).astype(np.float32)
    got, want, _, _ = _sample_both(jeng, teng, jax.random.PRNGKey(1), prior, x1=x1,
                                   sample_steps=3, condition_cfg=cond, w_cfg=1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)

    ref = rng.standard_normal((4, ACT)).astype(np.float32)
    got, want, glog, wlog = _sample_both(
        jeng, teng, jax.random.PRNGKey(2), prior, sample_steps=4,
        warm_start_reference=ref, warm_start_forward_level=0.5,
        diffusion_x_sampling_steps=2, preserve_history=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(glog["sample_history"].numpy(),
                               np.asarray(wlog["sample_history"]), rtol=TOL, atol=TOL)

    for eng in (jeng, teng):
        lo, hi = -0.2 * np.ones(ACT, np.float32), 0.3 * np.ones(ACT, np.float32)
        eng.x_min = jnp.asarray(lo) if eng is jeng else _t(lo)
        eng.x_max = jnp.asarray(hi) if eng is jeng else _t(hi)
    got, want, _, _ = _sample_both(jeng, teng, jax.random.PRNGKey(3), prior, sample_steps=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert got.min() >= -0.2 and got.max() <= 0.3


# --- the JAX package's own engine checks (tests/test_edm_rf_cm.py), on the port
@pytest.mark.parametrize("cls", [DiscreteRectifiedFlow, ContinuousRectifiedFlow])
def test_port_rf_update_and_sample(cls):
    kwargs = {"diffusion_steps": 32} if cls is DiscreteRectifiedFlow else {}
    engine = cls(DQLMlp(OBS, ACT, emb_dim=16), IdentityCondition(dropout=0.0), device="cpu",
                 **kwargs)
    rng = np.random.default_rng(0)
    x0, cond = _t(rng.standard_normal((8, ACT))), _t(rng.standard_normal((8, OBS)))
    assert torch.isfinite(engine.update(x0, cond)["loss"])
    with torch.no_grad():
        out, _ = engine.sample(torch.zeros((4, ACT)), sample_steps=4, condition_cfg=cond[:4],
                               w_cfg=1.0)
    assert out.shape == (4, ACT) and torch.isfinite(out).all()
    x1 = _t(rng.standard_normal((8, ACT)))
    assert torch.isfinite(engine.update(x0, cond, x1=x1)["loss"])


def test_port_rf_one_step_straight_flow():
    """A perfectly straight flow recovers x0 in one Euler step."""
    x0_true = _t(np.random.default_rng(1).standard_normal((1, ACT)))

    class OracleVel(torch.nn.Module):
        def forward(self, x, t, emb=None):
            tt = t[:, None].to(torch.float32)
            x1 = (x - (1 - tt) * x0_true) / torch.clamp(tt, min=1e-6)
            return x0_true - x1

    engine = ContinuousRectifiedFlow(OracleVel(), device="cpu")
    out, _ = engine.sample(torch.zeros((4, ACT)), sample_steps=1)
    np.testing.assert_allclose(out.numpy(), np.tile(x0_true.numpy(), (4, 1)), atol=1e-3)


def test_classifier_guidance_refused():
    with pytest.raises(ValueError, match="classifier-guidance"):
        ContinuousRectifiedFlow(DQLMlp(OBS, ACT), classifier=object(), device="cpu")

"""bf16 sampling and training on every engine family: tests/test_bf16_sampling.py
on the port, and the port against the JAX package.

The JAX package's own gate, ported whole: `DQLMlp` with an `MLPCondition`
on the ddpm, EDM, rectified-flow and consistency engines samples with
`bf16_sampling` within max 0.02 and mean 0.005 of the sample's scale of the
f32 sample (same draws); `bf16_training` gives a loss within 5 % of the f32
loss and an update that leaves the master weights f32; the config keys
reach the engines through `setup_mesh`.

Against the JAX package, on the same seeded weights and the JAX samplers'
own draws replayed as explicit noise, with the bf16 flags set: the four
engines with `DQLMlp` and, for the engines whose samplers cast the backbone
alone (EDM, a Karras ODE, rectified flow, consistency), `DiT1d` with an
`MLPCondition`, within PLAN_TOL of the sample's scale; the bf16 training
loss within LOSS_TOL. The reference's EDM, rectified-flow and consistency
samplers cast `params["diffusion"]` only and its Karras ODEs cast nothing up
front (the backbone in `apply_diffusion`), so the condition runs f32 there;
only the SDE sampler casts the whole tree (`diffusionsde.py:273-278`). The
port casts the same parts (`DiffusionModel.bf16_params`). The JAX side is
jitted with XLA's excess precision off (test_torch_bf16_backbones.py
`jit_exact`), which makes every bf16 rounding its source asks for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleandiffuser_tpu.diffusion as jdiff
from cleandiffuser_tpu.diffusion.basic import DiffusionModel as JaxDiffusionModel
from cleandiffuser_tpu.nn_condition import MLPCondition as JaxMLPCondition
from cleandiffuser_tpu.nn_diffusion import DiT1d as JaxDiT1d
from cleandiffuser_tpu.nn_diffusion import DQLMlp as JaxDQLMlp
import cleandiffuser_tpu_torch.diffusion as tdiff
from cleandiffuser_tpu_torch.diffusion.basic import DiffusionModel
from cleandiffuser_tpu_torch.nn_condition import MLPCondition
from cleandiffuser_tpu_torch.nn_diffusion import DiT1d, DQLMlp
from cleandiffuser_tpu_torch.parallel import setup_mesh
from cleandiffuser_tpu_torch.utils.jax_params import load_agent_params
from test_torch_bf16 import _seeded
from test_torch_bf16_backbones import jit_exact
from test_torch_dql import _seeded as _seeded_dql

torch.set_num_threads(1)

OBS, ACT, B = 5, 3, 8
# the JAX package's bf16 against f32 bounds (tests/test_bf16_sampling.py:67-70, :105)
BF16_MAX, BF16_MEAN, BF16_LOSS_RTOL = 0.02, 0.005, 0.05
# port against JAX, both bf16 (tests/test_torch_bf16.py's limits): samples,
# max |diff| over the scale (measured at most 1.2e-6, the DiT on the EDM's
# Heun steps); losses, relative (measured at most 2.8e-7). Before the
# samplers cast what the reference's cast, the condition's bf16 weights put
# the DiT's samples 3.5e-4 (VE ODE) to 3.4e-3 (consistency) away.
PLAN_TOL = 1e-5
LOSS_TOL = 1e-5
# DQL's served request, port against JAX in bf16: the first ddpm level
# divides f32 rounding by alpha (0.0084) before the clip, in both packages
# (measured max 2.5e-4 of scale, mean 3.6e-7)
DQL_REQUEST_TOL = 1e-3

# name: (engine, constructor kwargs, build_sample_fn kwargs)
ENGINES = {
    "ddpm": ("DiscreteDiffusionSDE", dict(diffusion_steps=5),
             dict(solver="ddpm", sample_steps=5, cfg_mode="cond", final_logp=False)),
    "edm": ("ContinuousEDM", {},
            dict(solver="heun", sample_steps=4, cfg_mode="cond", final_logp=False)),
    "rf": ("ContinuousRectifiedFlow", {}, dict(sample_steps=4, cfg_mode="cond")),
    "cm": ("ContinuousConsistencyModel", {}, dict(sample_steps=2, cfg_mode="cond")),
    # a Karras ODE whose network time log(sigma / 2) stays small: the VP
    # ODE's (up to 999) puts the DiT's Fourier angles near 1e5, where the two
    # packages' float32 sin and cos already differ by 6e-5 of the sample
    "veode": ("VEODE", {}, dict(solver="euler", sample_steps=4, cfg_mode="cond",
                                final_logp=False)),
}
GATE = ("ddpm", "edm", "rf", "cm")  # the JAX package's gate


@pytest.fixture(autouse=True)
def _reset_flags():
    """No test leaves a class flag set, in either package."""
    yield
    for cls in (DiffusionModel, JaxDiffusionModel):
        cls.bf16_sampling = cls.bf16_training = False


def _rel(a, b):
    """max and mean |a - b| over the scale of b (at least 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    return np.abs(a - b).max() / scale, np.abs(a - b).mean() / scale


# ---------------------------------------------------------------------------
# tests/test_bf16_sampling.py on the port
def _port_engine(name):
    cls, kw, _ = ENGINES[name]
    g = torch.Generator().manual_seed(0)
    # the backbone's condition input is the MLPCondition's 16 outputs (flax
    # infers it; the JAX gate's obs_dim only sizes the zeros for no condition)
    eng = getattr(tdiff, cls)(DQLMlp(16, ACT, emb_dim=16, generator=g),
                              MLPCondition(OBS, 16, (16,), generator=g), device="cpu", **kw)
    cond = torch.from_numpy(np.random.RandomState(0).randn(B, OBS).astype(np.float32))
    return eng, torch.zeros(B, ACT), cond


def _port_sample(eng, prior, cond, **skw):
    with torch.no_grad():
        x, _ = eng.build_sample_fn(**skw)(eng.ema_params, torch.Generator().manual_seed(3),
                                          prior, condition_cfg=cond, w_cfg=1.0)
    return x.numpy()


@pytest.mark.parametrize("name", GATE)
def test_port_bf16_sample_close_to_f32(name):
    eng, prior, cond = _port_engine(name)
    skw = ENGINES[name][2]
    x32 = _port_sample(eng, prior, cond, **skw)
    eng.bf16_sampling = True
    x16 = _port_sample(eng, prior, cond, **skw)
    assert x16.dtype == np.float32  # solver math and output stay f32
    d_max, d_mean = _rel(x16, x32)
    assert 0 < d_max < BF16_MAX and d_mean < BF16_MEAN, (d_max, d_mean)


def test_port_config_key_reaches_engines_via_setup_mesh():
    assert DiffusionModel.bf16_sampling is False
    assert setup_mesh({"n_devices": 1, "bf16_sampling": True}) is None
    eng, prior, cond = _port_engine("ddpm")
    assert eng.bf16_sampling is True
    assert np.isfinite(_port_sample(eng, prior, cond, **ENGINES["ddpm"][2])).all()


@pytest.mark.parametrize("name", ("ddpm", "edm", "rf"))
def test_port_bf16_training_loss_tracks_f32(name):
    """Same draws; the loss within 5 % of f32; an update runs and leaves the
    master weights, the EMA and Adam's moments f32."""
    eng, _, cond = _port_engine(name)
    x0 = torch.from_numpy(np.random.RandomState(1).randn(B, ACT).astype(np.float32))
    loss = lambda: float(eng.loss_fn(eng.params, x0, cond,
                                     generator=torch.Generator().manual_seed(7)))
    loss32 = loss()
    DiffusionModel.bf16_training = True
    loss16 = loss()
    assert np.isfinite(loss16) and loss16 != loss32
    assert abs(loss16 - loss32) / max(abs(loss32), 1e-3) < BF16_LOSS_RTOL, (loss16, loss32)
    log = eng.update(x0, cond)
    assert np.isfinite(float(log["loss"]))
    assert all(p.dtype == torch.float32 for p in eng.params.parameters())
    assert all(p.dtype == torch.float32 for p in eng.ema_params.parameters())
    assert all(v.dtype == torch.float32 for s in eng.optimizer.optimizer.state.values()
               for v in s.values() if v.is_floating_point() and v.dim() > 0)


def test_port_bf16_training_config_key_via_setup_mesh():
    assert DiffusionModel.bf16_training is False
    assert setup_mesh({"n_devices": 1, "bf16_training": True}) is None
    eng, _, _ = _port_engine("ddpm")
    assert eng.bf16_training is True


# ---------------------------------------------------------------------------
# against the JAX package
def _backbones(kind):
    if kind == "dql":
        return (JaxDQLMlp(obs_dim=OBS, act_dim=ACT, emb_dim=16), DQLMlp(16, ACT, emb_dim=16),
                (B, ACT))
    kw = dict(in_dim=ACT, emb_dim=16, d_model=32, n_heads=2, depth=1,
              timestep_emb_type="fourier", use_pallas_block=True)
    return JaxDiT1d(**kw), DiT1d(**kw), (6, 4, ACT)


@pytest.fixture(scope="module")
def pairs():
    """(JAX engine, port engine, prior, cond) on the same seeded params and
    EMA (the condition's dropout 0: the loss draws no keep-mask), built once
    per (backbone, engine) for the module."""
    built = {}

    def get(kind, name):
        if (kind, name) not in built:
            cls, kw, _ = ENGINES[name]
            jnet, tnet, shape = _backbones(kind)
            jeng = getattr(jdiff, cls)(
                jnet, JaxMLPCondition(in_dim=OBS, out_dim=16, hidden_dims=(16,), dropout=0.0),
                rng=0, **kw)
            teng = getattr(tdiff, cls)(tnet, MLPCondition(OBS, 16, (16,), dropout=0.0),
                                       device="cpu", **kw)
            prior = np.zeros(shape, np.float32)
            cond = np.random.RandomState(0).randn(shape[0], OBS).astype(np.float32)
            jeng.init(jnp.asarray(prior), jnp.asarray(cond))
            params, ema = _seeded(jeng.state.params, 1, 0.2), _seeded(jeng.state.ema_params, 2, 0.2)
            jeng.state = jeng.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                                            ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
            load_agent_params(teng.params, params)
            load_agent_params(teng.ema_params, ema)
            built[(kind, name)] = (jeng, teng, prior, cond)
        return built[(kind, name)]

    return get


def _chain_draws(key, shape, steps):
    """The JAX samplers' draws: k_init, k_scan = split(key); then k, sub =
    split(k) per step from k_scan."""
    k_init, k = jax.random.split(key)
    init = torch.from_numpy(np.array(jax.random.normal(k_init, shape)))
    per = []
    for _ in range(steps):
        k, sub = jax.random.split(k)
        per.append(np.asarray(jax.random.normal(sub, shape)))
    return init, (torch.from_numpy(np.stack(per)) if per else None)


def _sample_both(pair, name, bf16):
    jeng, teng, prior, cond = pair
    skw = ENGINES[name][2]
    key = jax.random.PRNGKey(3)
    jeng.bf16_sampling = teng.bf16_sampling = bf16
    jfn = jeng.build_sample_fn(**skw)
    run = lambda p: jfn(p, None, key, jnp.asarray(prior), condition_cfg=jnp.asarray(cond),
                        w_cfg=1.0)[0]
    want = np.asarray(jit_exact(run, jeng.state.ema_params)(jeng.state.ema_params))
    steps = {"ddpm": skw["sample_steps"], "cm": skw["sample_steps"] - 1}.get(name, 0)
    init, per = _chain_draws(key, prior.shape, steps)
    with torch.no_grad():
        got, _ = teng.build_sample_fn(**skw)(
            teng.ema_params, None, torch.from_numpy(prior), condition_cfg=torch.from_numpy(cond),
            w_cfg=1.0, noise=init if per is None else (init, per))
    return got.numpy(), want


SAMPLE_CASES = [("dql", n) for n in GATE] + [("dit", n) for n in ("edm", "veode", "rf", "cm")]


@pytest.mark.parametrize("kind,name", SAMPLE_CASES, ids=[f"{k}-{n}" for k, n in SAMPLE_CASES])
def test_bf16_sample_matches_jax(pairs, kind, name):
    pair = pairs(kind, name)
    got, want = _sample_both(pair, name, True)
    assert got.dtype == np.float32 and np.isfinite(want).all()
    d_max, _ = _rel(got, want)
    assert d_max < PLAN_TOL, d_max
    # the bf16 path moved the sample, within the JAX package's bounds, in both
    got32, want32 = _sample_both(pair, name, False)
    for g16, g32 in ((got, got32), (want, want32)):
        d_max, d_mean = _rel(g16, g32)
        assert 1e-5 < d_max < BF16_MAX and d_mean < BF16_MEAN, (d_max, d_mean)
    # what the sampler cast: the backbone, and the condition in the SDE
    # sampler only, as the reference's samplers do
    view = pair[1]._bf16_copies[(pair[1].ema_params, name == "ddpm")]
    assert all(p.dtype == torch.bfloat16 for p in view["diffusion"].parameters())
    cond_dtypes = {p.dtype for p in view["condition"].parameters()}
    assert cond_dtypes == ({torch.bfloat16} if name == "ddpm" else {torch.float32})
    if name != "ddpm":
        assert view["condition"] is pair[1].ema_params["condition"]


def _loss_draws(jeng, key, x0):
    """The draws the JAX loss takes from `key`: (t or sigma, noise, keep)."""
    if isinstance(jeng, jdiff.ContinuousRectifiedFlow):
        k_t, k_x1, _, _ = jax.random.split(key, 4)
        t, eps = jax.random.uniform(k_t, (x0.shape[0],)), jax.random.normal(k_x1, x0.shape)
    else:
        k_noise, _, _ = jax.random.split(key, 3)
        k_t, k_eps = jax.random.split(k_noise)
        if isinstance(jeng, jdiff.ContinuousEDM):
            t = jnp.exp(jax.random.normal(k_t, (x0.shape[0],)) * jeng.P_std + jeng.P_mean)
        else:
            t = jax.random.randint(k_t, (x0.shape[0],), 0, jeng.diffusion_steps)
        eps = jax.random.normal(k_eps, x0.shape)
    keep = np.ones(x0.shape[0], np.float32)  # the condition's dropout is 0
    return tuple(torch.from_numpy(np.array(a)) for a in (t, eps, keep))


@pytest.mark.parametrize("name", ("ddpm", "edm", "rf"))
def test_bf16_training_loss_matches_jax(pairs, name):
    jeng, teng, _, cond = pairs("dql", name)
    x0 = np.random.RandomState(1).randn(B, ACT).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jeng.bf16_training = teng.bf16_training = True
    want = float(jit_exact(lambda p: jeng.loss_fn(p, key, jnp.asarray(x0), jnp.asarray(cond)),
                           jeng.state.params)(jeng.state.params))
    got = float(teng.loss_fn(teng.params, torch.from_numpy(x0), torch.from_numpy(cond),
                             noise=_loss_draws(jeng, key, x0)))
    assert abs(got - want) / abs(want) < LOSS_TOL, (got, want)


def test_dql_served_request_bf16_gap_is_the_references():
    """DQL's actor at the shipped width (`DQLMlp`, 5 ddpm steps predicting
    eps, actions clipped to [-1, 1]) sampling a served request's 2,500
    candidates (50 envs x 50), seeded weights, the JAX draws: in bf16 the
    port is the JAX package within DQL_REQUEST_TOL, and bf16 moves both
    packages' candidates from f32 alike. That move's mean is within the JAX
    package's bound, but its max is not: the first level divides the
    network's bf16 error by alpha (0.0084) before the clip, and the
    reference's own request moves by 0.175 of scale (a few candidates
    near the clip; chip_smoke.py reads DQL's max only, for this reason)."""
    from cleandiffuser_tpu.nn_condition import IdentityCondition as JaxIdentity
    from cleandiffuser_tpu_torch.nn_condition import IdentityCondition

    O, A, R = 17, 6, 2500
    kw = dict(diffusion_steps=5, predict_noise=True, x_max=np.ones(A), x_min=-np.ones(A))
    jeng = jdiff.DiscreteDiffusionSDE(JaxDQLMlp(obs_dim=O, act_dim=A, emb_dim=64),
                                      JaxIdentity(dropout=0.0), rng=0, **kw)
    teng = tdiff.DiscreteDiffusionSDE(DQLMlp(O, A, emb_dim=64), IdentityCondition(dropout=0.0),
                                      device="cpu", **kw)
    prior = np.zeros((R, A), np.float32)
    cond = np.random.RandomState(0).randn(R, O).astype(np.float32)
    jeng.init(jnp.asarray(prior[:2]), jnp.asarray(cond[:2]))
    ema = _seeded_dql(jeng.state.ema_params, 2)
    load_agent_params(teng.ema_params, ema)
    jema = jax.tree_util.tree_map(jnp.asarray, ema)
    skw = ENGINES["ddpm"][2]
    key = jax.random.PRNGKey(3)
    init, per = _chain_draws(key, prior.shape, skw["sample_steps"])
    out = {}
    for bf16 in (False, True):
        jeng.bf16_sampling = teng.bf16_sampling = bf16
        jfn = jeng.build_sample_fn(**skw)
        run = lambda p: jfn(p, None, key, jnp.asarray(prior), condition_cfg=jnp.asarray(cond),
                            w_cfg=1.0, temperature=0.5)[0]
        with torch.no_grad():
            got, _ = teng.build_sample_fn(**skw)(
                teng.ema_params, None, torch.from_numpy(prior),
                condition_cfg=torch.from_numpy(cond), w_cfg=1.0, temperature=0.5,
                noise=(init, per))
        out[bf16] = (np.asarray(jit_exact(run, jema)(jema)), got.numpy())
    d_max, d_mean = _rel(out[True][1], out[True][0])
    assert d_max < DQL_REQUEST_TOL and d_mean < PLAN_TOL, (d_max, d_mean)
    gaps = [_rel(out[True][side], out[False][side]) for side in (0, 1)]
    assert abs(gaps[0][0] - gaps[1][0]) < DQL_REQUEST_TOL, gaps
    for g_max, g_mean in gaps:
        assert g_max > BF16_MAX and g_mean < BF16_MEAN, gaps

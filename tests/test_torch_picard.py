"""The port's parallel-in-time (Picard) DDIM sampler against the JAX package's.

`BaseDiffusionSDE.sample_parallel` on both SDE engines (`DQLMlp` with an
`MLPCondition`, tests/test_parallel_sampler.py's engines) at N = 12 grid
points, on the same seeded weights (carried into the port by the
converter) and the JAX sampler's own initial draw, `k_init` of
`split(rng)`, passed as `noise`: at K = N, N / 2 and 4 sweeps, with CFG in
uncond, cond and mix modes; with a fix mask, which pins exactly; the last
sweep's residual; under `bf16_sampling` (the JAX side compiled with XLA's
excess precision off, test_torch_bf16_backbones.py `jit_exact`); and the
DD plan's sampler (`DiT1d` with the flat fused-block layout, CFG mix)
through Picard against JAX's. Then the port's K = N Picard against the
port's sequential DDIM (tests/test_parallel_sampler.py's bound).

Tolerances: TOL = 1e-5 of the sample's scale (max |x|, at least 1) for
f32 against JAX: both compute in float32 on the same tables and draws,
and differ in the order of float32 sums in the network's products (read
at most 3.1e-7). bf16 against JAX: BF16_TOL = 0.02 of the scale, the JAX
package's bf16 bound (tests/test_bf16_sampling.py:67-70; read at most
1.9e-7). K = N against sequential
DDIM: atol 2e-4 / rtol 1e-3 and a residual below 1e-4
(tests/test_parallel_sampler.py:47-49).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleandiffuser_tpu.diffusion as jdiff
from cleandiffuser_tpu.diffusion.basic import DiffusionModel as JaxDiffusionModel
from cleandiffuser_tpu.nn_condition import MLPCondition as JaxMLPCondition
from cleandiffuser_tpu.nn_diffusion import DQLMlp as JaxDQLMlp
from cleandiffuser_tpu.pipelines.dd import DDPipeline as JaxDDPipeline
import cleandiffuser_tpu_torch.diffusion as tdiff
from cleandiffuser_tpu_torch.diffusion.basic import DiffusionModel
from cleandiffuser_tpu_torch.nn_condition import MLPCondition
from cleandiffuser_tpu_torch.nn_diffusion import DQLMlp
from cleandiffuser_tpu_torch.pipelines import DDPipeline
from cleandiffuser_tpu_torch.utils.jax_params import load_agent_params
from jax_shaped_init import shaped_inits
from test_torch_bf16 import _seeded
from test_torch_dql import _seeded as _seeded_fan_in
from test_torch_bf16_backbones import jit_exact

torch.set_num_threads(1)

OBS, ACT, B, N = 5, 3, 8, 12
TOL = 1e-5
BF16_TOL = 0.02
SEQ_ATOL, SEQ_RTOL, SEQ_RESID = 2e-4, 1e-3, 1e-4
ENGINES = {"discrete": ("DiscreteDiffusionSDE", {"diffusion_steps": N}),
           "continuous": ("ContinuousDiffusionSDE", {})}
CFG_W = {"uncond": 0.0, "cond": 1.0, "mix": 1.5}


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    for cls in (DiffusionModel, JaxDiffusionModel):
        cls.bf16_sampling = False


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _pair(name, fix_mask=None):
    """(JAX engine, port engine, prior, cond) on the same seeded params and EMA."""
    cls, kw = ENGINES[name]
    jeng = getattr(jdiff, cls)(
        JaxDQLMlp(obs_dim=16, act_dim=ACT, emb_dim=16),
        JaxMLPCondition(in_dim=OBS, out_dim=16, hidden_dims=(16,), dropout=0.0),
        fix_mask=fix_mask, rng=0, **kw)
    teng = getattr(tdiff, cls)(DQLMlp(16, ACT, emb_dim=16),
                               MLPCondition(OBS, 16, (16,), dropout=0.0), fix_mask=fix_mask,
                               device="cpu", **kw)
    prior = (np.zeros((B, ACT), np.float32) if fix_mask is None else
             np.random.RandomState(2).randn(B, ACT).astype(np.float32))
    cond = np.random.RandomState(0).randn(B, OBS).astype(np.float32)
    jeng.init(jnp.asarray(prior), jnp.asarray(cond))
    params, ema = _seeded_fan_in(jeng.state.params, 1), _seeded_fan_in(jeng.state.ema_params, 2)
    jeng.state = jeng.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                                    ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
    load_agent_params(teng.params, params)
    load_agent_params(teng.ema_params, ema)
    return jeng, teng, prior, cond


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(name, fix_mask=None):
        key = (name, fix_mask is not None)
        if key not in built:
            built[key] = _pair(name, fix_mask)
        return built[key]

    return get


def _xT(key, shape):
    """The JAX sampler's initial draw: `k_init, _ = split(rng)`."""
    k_init, _ = jax.random.split(key)
    return torch.from_numpy(np.array(jax.random.normal(k_init, shape)))


def _both(pair, K, cfg, seed=3, temperature=1.0):
    jeng, teng, prior, cond = pair
    key = jax.random.PRNGKey(seed)
    use_cond = cfg != "uncond"
    want, wlog = jeng.sample_parallel(
        jnp.asarray(prior), sample_steps=N, picard_iters=K, temperature=temperature,
        condition_cfg=jnp.asarray(cond) if use_cond else None, w_cfg=CFG_W[cfg], rng=key)
    with torch.no_grad():
        got, glog = teng.sample_parallel(
            torch.from_numpy(prior), sample_steps=N, picard_iters=K, temperature=temperature,
            condition_cfg=torch.from_numpy(cond) if use_cond else None, w_cfg=CFG_W[cfg],
            noise=_xT(key, prior.shape))
    return (got.numpy(), float(glog["picard_residual"]), np.asarray(want),
            float(wlog["picard_residual"]))


CASES = [(e, k, c) for e in ENGINES for k in (N, N // 2, 4) for c in CFG_W]


@pytest.mark.parametrize("engine,K,cfg", CASES, ids=[f"{e}-K{k}-{c}" for e, k, c in CASES])
def test_picard_matches_jax(pairs, engine, K, cfg):
    got, g_res, want, w_res = _both(pairs(engine), K, cfg)
    assert got.shape == (B, ACT) and np.isfinite(want).all()
    assert np.abs(want).max() > 0.1  # not a trivially matching sample
    assert _rel(got, want) < TOL, _rel(got, want)
    # the last sweep's residual, a difference of two sweeps' states: its
    # rounding is at the states' scale, which the sample's stands for
    assert abs(g_res - w_res) <= TOL * max(np.abs(want).max(), 1.0), (g_res, w_res)


def test_picard_residual_falls_with_sweeps(pairs):
    """The residual shrinks as K grows and is 0 up to rounding at K = N (the
    triangular system has converged); the temperature scales the draw."""
    res = [_both(pairs("discrete"), K, "mix", temperature=0.5)[1] for K in (4, N // 2, N)]
    assert res[0] > res[1] > res[2] and res[2] < SEQ_RESID, res


@pytest.mark.parametrize("engine", ENGINES)
def test_picard_fix_mask_pins_exactly(pairs, engine):
    fix_mask = np.zeros((ACT,), np.float32)
    fix_mask[0] = 1.0
    jeng, teng, prior, cond = pair = pairs(engine, fix_mask)
    got, _, want, _ = _both(pair, 4, "cond", seed=1)
    np.testing.assert_array_equal(got[:, 0], prior[:, 0])
    assert _rel(got, want) < TOL, _rel(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_picard_bf16_matches_jax(pairs, engine):
    jeng, teng, prior, cond = pairs(engine)
    key = jax.random.PRNGKey(4)
    jeng.bf16_sampling = teng.bf16_sampling = True
    fn = jeng.build_parallel_sample_fn(sample_steps=N, picard_iters=6, cfg_mode="mix")
    run = lambda p: fn(p, key, jnp.asarray(prior), jnp.asarray(cond), None, 1.5)[0]
    want = np.asarray(jit_exact(run, jeng.state.ema_params)(jeng.state.ema_params))
    with torch.no_grad():
        got, _ = teng.sample_parallel(torch.from_numpy(prior), sample_steps=N, picard_iters=6,
                                      condition_cfg=torch.from_numpy(cond), w_cfg=1.5,
                                      noise=_xT(key, prior.shape))
        teng.bf16_sampling = False
        got32, _ = teng.sample_parallel(torch.from_numpy(prior), sample_steps=N,
                                        picard_iters=6, condition_cfg=torch.from_numpy(cond),
                                        w_cfg=1.5, noise=_xT(key, prior.shape))
    assert got.dtype == torch.float32 and np.isfinite(want).all()
    assert _rel(got.numpy(), want) < BF16_TOL, _rel(got.numpy(), want)
    # bf16 moved the sample (the network ran on the bf16 copy)
    assert _rel(got.numpy(), got32.numpy()) > 1e-5
    view = teng._bf16_copies[(teng.ema_params, True)]
    assert all(p.dtype == torch.bfloat16 for p in view["diffusion"].parameters())


@pytest.mark.parametrize("engine", ENGINES)
def test_picard_full_sweeps_equal_port_ddim(pairs, engine):
    _, teng, prior, cond = pairs(engine)
    xT = _xT(jax.random.PRNGKey(3), prior.shape)
    p, c = torch.from_numpy(prior), torch.from_numpy(cond)
    with torch.no_grad():
        x_seq, _ = teng.sample(p, solver="ddim", sample_steps=N, condition_cfg=c, w_cfg=1.0,
                               noise=(xT, None))
        x_par, log = teng.sample_parallel(p, sample_steps=N, picard_iters=N, condition_cfg=c,
                                          w_cfg=1.0, noise=xT)
    np.testing.assert_allclose(x_par.numpy(), x_seq.numpy(), atol=SEQ_ATOL, rtol=SEQ_RTOL)
    assert float(log["picard_residual"]) < SEQ_RESID


def test_picard_draws_from_the_generator(pairs):
    """Without `noise` the draw comes from the generator: the same seed gives
    the same sample, another seed another."""
    _, teng, prior, cond = pairs("continuous")
    run = lambda s: teng.sample_parallel(
        torch.from_numpy(prior), sample_steps=N, picard_iters=2,
        condition_cfg=torch.from_numpy(cond), w_cfg=1.0,
        generator=torch.Generator().manual_seed(s))[0]
    with torch.no_grad():
        a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# the DD plan's sampler through Picard
DD_CFG = dict(obs_dim=5, act_dim=3, horizon=8, emb_dim=32, d_model=32, n_heads=2, depth=1,
              sampling_steps=4, w_cfg=2.0, target_return=0.95, temperature=0.5)
E = 4


@pytest.mark.parametrize("K", (DD_CFG["sampling_steps"], 2))
def test_dd_plan_through_picard_matches_jax(K):
    """DD's engine (continuous, linear schedule, x0 prediction, the first
    state pinned) and `DiT1d` with the flat block layout, which runs K1's
    plain version on the CPU in both packages: the Picard plan with DD's
    prior, return condition, CFG weight and temperature."""
    with shaped_inits():
        jpipe = JaxDDPipeline(**DD_CFG, use_pallas_block=True)
    ema = _seeded(jpipe.agent.state.ema_params, 2)
    tpipe = DDPipeline(**DD_CFG, use_pallas_block=True, device="cpu")
    load_agent_params(tpipe.agent.ema_params, ema)
    steps, H, O = DD_CFG["sampling_steps"], DD_CFG["horizon"], DD_CFG["obs_dim"]
    obs = np.random.default_rng(4).standard_normal((E, O)).astype(np.float32)
    prior = np.zeros((E, H, O), np.float32)
    prior[:, 0] = obs
    cond = np.full((E, 1), DD_CFG["target_return"], np.float32)
    key = jax.random.PRNGKey(5)
    jfn = jax.jit(jpipe.agent.build_parallel_sample_fn(sample_steps=steps, picard_iters=K,
                                                       cfg_mode="mix"))
    want, wlog = jfn(jax.tree_util.tree_map(jnp.asarray, ema), key, jnp.asarray(prior),
                     jnp.asarray(cond), None, DD_CFG["w_cfg"], DD_CFG["temperature"])
    tfn = tpipe.agent.build_parallel_sample_fn(sample_steps=steps, picard_iters=K,
                                               cfg_mode="mix")
    with torch.no_grad():
        got, glog = tfn(tpipe.agent.ema_params, None, torch.from_numpy(prior),
                        torch.from_numpy(cond), None, DD_CFG["w_cfg"], DD_CFG["temperature"],
                        _xT(key, prior.shape))
    want = np.asarray(want)
    assert np.abs(want[:, 1:]).max() > 0.1
    assert _rel(got.numpy(), want) < TOL, _rel(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, 0], obs)
    w_res = float(wlog["picard_residual"])
    assert abs(float(glog["picard_residual"]) - w_res) <= TOL * max(np.abs(want).max(), 1.0)

"""The port's Diffusion Policy and DiffusionBC pipelines against the JAX
package's, on the same seeded weights, batches and draws.

The pipelines fix their backbones' widths; here they run narrow on both
sides (a stand-in for the class in each package's pipeline module): the
Chi U-Net at model_dim 32, dim_mult (1, 2) (shipped 256, (1, 2, 2)), the
ChiTransformer at d_model 64 with 2 layers (256, 4), DBC's DiT at d_model
64, 4 heads, depth 2 (384, 12, 6) and the PearceTransformer at
trans_emb_dim 16, 4 heads (64, 16); DP's DiT and the PearceMlp at their
shipped widths.

- Sampling with the JAX sampler's draws injected (`k_init, k_scan =
  split(rng)`, then `rng, k_noise = split(rng)` per step; EDM's initial
  draw): every backbone on every engine (DP: ddpm, edm; DBC: ddpm, ddim,
  edm, and Diffusion-X steps on each). Both samplers also run in float64
  (weights, draws and schedule tables widened, each package's float32
  casts widened, the JAX draws taken at 32 bits): the two float64 samples
  within 1e-9. The port's float32 sample is within 1e-5 absolute / 1e-4
  relative of JAX's, or, where float32 rounding alone is larger (the JAX
  sample itself more than 1e-5 from JAX's float64 run), the port's
  distance from JAX's float64 run within twice the JAX sample's: with 4
  ddpm steps the first level's alpha is 0.0084, and 1 / alpha amplifies the
  network's rounding ~120x (the JAX sample's float32 error reached 6.4e-5
  there, the port's 9.4e-5).
- 3 training steps with the JAX update's draws replayed (`_, sub =
  split(rng)`, `k_noise, k_cond, _ = split(sub, 3)`, `k_t, k_eps =
  split(k_noise)`; DBC's DiT condition's keep-mask read from the JAX
  condition's zeroed rows; the ChiTransformer's dropout masks injected on
  both sides, the JAX update retraced per step so each takes its own):
  the first step's gradient in float64 on both sides within 1e-9 of the
  largest element; losses and grad norms within 1e-5 / 1e-4 per step,
  then params and EMA by the Adam rule of PERF.md section 6: every
  element within 2 lr per step, and all but a 1e-4 share of the elements
  within 1e-5 / 1e-4, leaving out the elements whose gradient is zero in
  exact arithmetic (below 1e-9 of the largest in JAX's float64 gradient:
  the attention's key and value biases, and in the PearceTransformer every
  bias before its token BatchNorm), which Adam moves by lr either way on
  float32 rounding noise in each package.
- `evaluate_on_device` over 2 chunks (DP) and 3 env steps (DBC) from the
  JAX rollout's reset states with its per-chunk sampler draws: the returns
  within 2 coverage points of 2,048 per env step.
- `load_jax_checkpoint` of the file the JAX pipeline's `save` wrote, and
  the port's own checkpoint round trip.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleandiffuser_tpu.pipelines.dbc as jdbc
import cleandiffuser_tpu.pipelines.dp as jdp
import cleandiffuser_tpu_torch.pipelines.dbc as tdbc
import cleandiffuser_tpu_torch.pipelines.dp as tdp
from cleandiffuser_tpu.dataset import PushTStateDataset as JaxPushTState
from cleandiffuser_tpu.dataset import ReplayBuffer as JaxReplayBuffer
from cleandiffuser_tpu.env.pusht_jax import PushTEnvJax
from cleandiffuser_tpu.nn_diffusion import ChiTransformer as JaxChiTransformer
from cleandiffuser_tpu.nn_diffusion import ChiUNet1d as JaxChiUNet
from cleandiffuser_tpu.nn_diffusion import DiT1d as JaxDiT
from cleandiffuser_tpu.nn_diffusion import PearceTransformer as JaxPearceTransformer
from cleandiffuser_tpu_torch.dataset import PushTStateDataset, generate_pusht_demos
from cleandiffuser_tpu_torch.env.pusht import PushTEnv
from cleandiffuser_tpu.utils import schedules as jax_schedules
from cleandiffuser_tpu_torch.utils import schedules as port_schedules
from cleandiffuser_tpu_torch.nn_diffusion import (
    ChiTransformer,
    ChiUNet1d,
    DiT1d,
    PearceTransformer,
    chitransformer,
)
from cleandiffuser_tpu_torch.utils.jax_params import (
    _flatten_blocks,
    agent_params_of,
    load_agent_params,
)
from test_torch_dql import _np, _sampler_noise, _seeded, _t
from test_torch_edm_cm import _close_tree, _jt
from test_torch_imitation_backbones import _FlaxMasks
from test_torch_sfbc import FLIP_SHARE
from jax_shaped_init import shaped_inits

import flax.linen.attention as flax_attention
import flax.linen.stochastic as flax_stochastic

torch.set_num_threads(2)

OBS, ACT, H, TO, TA, B = 5, 2, 8, 2, 4, 3
ATOL, RTOL = 1e-5, 1e-4
F64_TOL = 1e-9
LR = 1e-3
COV_STEP = 2 / 2048 / 0.95  # 2 coverage points, as a reward


def _narrow(cls, **fixed):
    return lambda **kw: cls(**{**kw, **fixed})


@pytest.fixture(scope="module", autouse=True)
def small_backbones():
    mp = pytest.MonkeyPatch()
    mp.setattr(jdp, "ChiUNet1d", _narrow(JaxChiUNet, model_dim=32, emb_dim=32, dim_mult=(1, 2)))
    mp.setattr(tdp, "ChiUNet1d", _narrow(ChiUNet1d, model_dim=32, emb_dim=32, dim_mult=(1, 2)))
    mp.setattr(jdp, "ChiTransformer", _narrow(JaxChiTransformer, d_model=64, num_layers=2))
    mp.setattr(tdp, "ChiTransformer", _narrow(ChiTransformer, d_model=64, num_layers=2))
    mp.setattr(jdbc, "DiT1d", _narrow(JaxDiT, d_model=64, n_heads=4, depth=2))
    mp.setattr(tdbc, "DiT1d", _narrow(DiT1d, d_model=64, n_heads=4, depth=2))
    mp.setattr(jdbc, "PearceTransformer", _narrow(JaxPearceTransformer, trans_emb_dim=16, nhead=4))
    mp.setattr(tdbc, "PearceTransformer", _narrow(PearceTransformer, trans_emb_dim=16, nhead=4))
    yield
    mp.undo()


def _cfg(kind, nn, diffusion, x_steps=0):
    if kind == "dp":
        return dict(obs_dim=OBS, action_dim=ACT, horizon=H, obs_steps=TO, action_steps=TA,
                    nn=nn, diffusion=diffusion, sample_steps=3, lr=LR, gradient_steps=10,
                    ema_rate=0.9)
    return dict(obs_dim=OBS, action_dim=ACT, obs_steps=TO, action_steps=2 if nn == "dit" else 1,
                nn=nn, diffusion=diffusion, emb_dim=16, sample_steps=4,
                diffusion_x_sampling_steps=x_steps, lr=LR, gradient_steps=10, ema_rate=0.9)


_PAIRS = {}


def _pair(kind, nn, diffusion, x_steps=0):
    """A JAX pipeline and the port's with the same seeded params and EMA
    (each pair built once per module and re-seeded at every call)."""
    key = (kind, nn, diffusion, x_steps)
    if key not in _PAIRS:
        J, P = (jdp.DPPipeline, tdp.DPPipeline) if kind == "dp" else (jdbc.DBCPipeline,
                                                                      tdbc.DBCPipeline)
        cfg = _cfg(kind, nn, diffusion, x_steps)
        # every leaf is seeded below: the JAX build takes its nets' param
        # shapes without compiling their inits (tests/jax_shaped_init.py)
        with shaped_inits():
            _PAIRS[key] = (J(**cfg), P(**cfg, device="cpu"))
    jp, tp = _PAIRS[key]
    st = jp.agent.state
    params, ema = _seeded(st.params, 1), _seeded(st.ema_params, 2)
    jp.agent.state = st.replace(params=_jt(params), ema_params=_jt(ema))
    load_agent_params(tp.agent.params, params)
    load_agent_params(tp.agent.ema_params, ema)
    return jp, tp


def _sample_draws(pipe, key, shape, steps):
    if pipe.diffusion_kind == "edm":
        k_init, _ = jax.random.split(key)
        return _t(jax.random.normal(k_init, shape))
    return _sampler_noise(key, shape, steps)


def _obs(seed, n=B):
    return np.random.default_rng(seed).uniform(-1, 1, (n, TO, OBS)).astype(np.float32)


@contextlib.contextmanager
def _jax_x64():
    """JAX in float64 on the float32 runs' draws: every `jax.random` draw
    is taken at 32 bits and widened, and the packages' float32 casts widen
    too."""
    normal, uniform, randint = jax.random.normal, jax.random.uniform, jax.random.randint
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal", lambda k, shape=(), dtype=None:
               normal(k, shape, np.float32).astype(np.float64))
    mp.setattr(jax.random, "uniform", lambda k, shape=(), dtype=None, minval=0.0, maxval=1.0:
               uniform(k, shape, np.float32, minval, maxval).astype(np.float64))
    mp.setattr(jax.random, "randint", lambda k, shape, minval, maxval, dtype=None:
               randint(k, shape, minval, maxval, np.int32))
    mp.setattr(jnp, "float32", jnp.float64)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        mp.undo()


def _cosine_tables(schedules, agent):
    """A discrete engine's (alpha, sigma), the pipelines' cosine schedule,
    built anew by `schedules` (run in float64)."""
    t = schedules.uniform_discretization(agent.diffusion_steps, agent.epsilon)
    return schedules.SUPPORTED_NOISE_SCHEDULES["cosine"]["forward"](t)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jax_f64_sample(jp, method, nobs, key):
    """The JAX pipeline's `act_chunk` / `act` in float64 on a float64 copy
    of its EMA weights and the float32 run's draws: the float32 samples'
    common reference."""
    agent = jp.agent
    st, tables = agent.state, {k: getattr(agent, k) for k in ("alpha", "sigma")
                               if hasattr(agent, k)}
    jp._fn_cache.clear()
    try:
        with _jax_x64():
            agent.state = st.replace(ema_params=_f64(st.ema_params))
            if tables:
                agent.alpha, agent.sigma = _cosine_tables(jax_schedules, agent)
            out = getattr(jp, method)(jnp.asarray(nobs, np.float64), key)
            assert out.dtype == np.float64
            return np.asarray(out)
    finally:
        agent.state = st
        for k, v in tables.items():
            setattr(agent, k, v)
        jp._fn_cache.clear()


def _f64_sample(tp, nobs, noise):
    """The port's sampler in float64 on a float64 copy of its EMA weights
    (the executed part)."""
    agent = copy.deepcopy(tp.agent)
    agent.ema_params.double()
    agent.x_max, agent.x_min = (None if v is None else v.double()
                                for v in (tp.agent.x_max, tp.agent.x_min))
    d = lambda v: v.double() if isinstance(v, torch.Tensor) else tuple(u.double() for u in v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "float32", torch.float64)
        mp.setattr(port_schedules, "_F32", torch.float64)
        if hasattr(agent, "alpha"):
            agent.alpha, agent.sigma = _cosine_tables(port_schedules, agent)
        out, _ = agent.build_sample_fn(**tp.sample_kw)(
            agent.ema_params, None, torch.zeros(tp.prior_shape(nobs.shape[0]), dtype=torch.float64),
            condition_cfg=tp.condition_of(torch.from_numpy(nobs).double()), w_cfg=1.0,
            noise=d(noise))
    return tp.executed(out).numpy()


def _assert_sample_close(jp, tp, method, nobs, key, noise, got, want):
    """The port's float64 sampler within F64_TOL of JAX's on the same
    weights and draws; and the port's float32 sample within ATOL / RTOL of
    JAX's, or, where the JAX sample's own float32 error against JAX's
    float64 run exceeds ATOL, the port's error against that run within
    twice the JAX sample's."""
    ref64 = _jax_f64_sample(jp, method, nobs, key)
    port64 = _f64_sample(tp, nobs, noise)
    np.testing.assert_allclose(port64, ref64, atol=F64_TOL, rtol=0)
    if np.allclose(got, want, atol=ATOL, rtol=RTOL):
        return
    jax_err, port_err = np.abs(want - ref64).max(), np.abs(got - ref64).max()
    assert jax_err > ATOL and port_err <= 2 * jax_err, (np.abs(got - want).max(), jax_err,
                                                        port_err)


DP_CASES = [(nn, d) for nn in ("chi_unet", "chi_transformer", "dit") for d in ("ddpm", "edm")]
DBC_CASES = ([(nn, d, 0) for nn in ("pearce_mlp", "pearce_transformer", "dit")
              for d in ("ddpm", "ddim", "edm")]
             + [("pearce_mlp", d, 2) for d in ("ddpm", "ddim", "edm")] + [("dit", "ddim", 2)])


@pytest.mark.parametrize("nn,diffusion", DP_CASES)
def test_dp_act_chunk_matches_jax(nn, diffusion):
    jp, tp = _pair("dp", nn, diffusion)
    nobs, key = _obs(0), jax.random.PRNGKey(3)
    want = np.asarray(jp.act_chunk(jnp.asarray(nobs), key))
    noise = _sample_draws(tp, key, (B, H, ACT), 3)
    got = tp.act_chunk(nobs, noise=noise).numpy()
    assert got.shape == (B, TA, ACT)
    _assert_sample_close(jp, tp, "act_chunk", nobs, key, noise, got, want)


@pytest.mark.parametrize("nn,diffusion,x_steps", DBC_CASES)
def test_dbc_act_matches_jax(nn, diffusion, x_steps):
    jp, tp = _pair("dbc", nn, diffusion, x_steps)
    nobs, key = _obs(1), jax.random.PRNGKey(4)
    shape = (B, tp.Ta, ACT) if tp.chunked else (B, ACT)
    want = np.asarray(jp.act(jnp.asarray(nobs), key))
    noise = _sample_draws(tp, key, shape, 4 + x_steps)
    got = tp.act(nobs, noise=noise).numpy()
    assert got.shape == (B, ACT)
    _assert_sample_close(jp, tp, "act", nobs, key, noise, got, want)


@pytest.mark.parametrize("diffusion", ["ddpm", "ddim"])
def test_diffusion_x_steps_run_the_network(diffusion):
    """With 2 Diffusion-X steps a 4-step sample calls the network 6 times,
    the last three at the last level's t."""
    _, tp = _pair("dbc", "pearce_mlp", diffusion, 2)
    ts = []
    hook = tp.agent.ema_params["diffusion"].register_forward_hook(
        lambda m, args, out: ts.append(args[1][0].item()))
    tp.act(_obs(2))
    hook.remove()
    assert len(ts) == 6 and ts[-3:] == [ts[-1]] * 3 and ts[:4] == sorted(ts[:4], reverse=True)


# ---------------------------------------------------------------- training
def _batch(rng):
    return {"obs": {"state": rng.uniform(-1, 1, (B, H, OBS)).astype(np.float32)},
            "action": rng.uniform(-1, 1, (B, H, ACT)).astype(np.float32)}


def _x_and_cond(tp, batch):
    """The denoised target and the condition the pipeline trains on."""
    if isinstance(tp, tdbc.DBCPipeline):
        return tp._x_and_cond(batch)
    return (torch.from_numpy(batch["action"]),
            tp.condition_of(torch.from_numpy(batch["obs"]["state"])))


def _train_draws(jp, tp, batch, dtype=np.float32):
    """The JAX pipeline's next update's draws, as the port's `noise`
    (EDM's levels computed in `dtype` from the float32 normal draw)."""
    agent, st = jp.agent, jp.agent.state
    _, sub = jax.random.split(st.rng)
    k_noise, k_cond, _ = jax.random.split(sub, 3)
    k_t, k_eps = jax.random.split(k_noise)
    x, cond = (v.numpy() for v in _x_and_cond(tp, batch))
    if tp.diffusion_kind == "edm":
        z = np.asarray(jax.random.normal(k_t, (B,)), dtype)
        t = np.exp(z * dtype(agent.P_std) + dtype(agent.P_mean))
    else:
        t = jax.random.randint(k_t, (B,), 0, agent.diffusion_steps)
    keep = None
    if tp.agent.params["condition"].dropout > 0:
        train = np.asarray(agent.apply_condition(st.params, jnp.asarray(cond), train=True,
                                                 rng=k_cond))
        keep = _t((np.abs(train).sum(-1) > 0).astype(np.float32))
    eps = np.asarray(jax.random.normal(k_eps, x.shape), np.float32).astype(dtype)
    return _t(t), _t(eps), keep


def _jax_f64_grads(jp, tp, batch, masks):
    """The JAX pipeline's next update's gradient in float64, on a float64
    copy of its params and the float32 run's draws and dropout masks (a
    flax tree in the port's layout)."""
    agent, st = jp.agent, jp.agent.state
    _, sub = jax.random.split(st.rng)
    x, cond = (np.asarray(v.numpy(), np.float64) for v in _x_and_cond(tp, batch))
    tables = (agent.alpha, agent.sigma) if hasattr(agent, "alpha") else None
    try:
        with _jax_x64(), pytest.MonkeyPatch.context() as mp:
            if masks:
                jm = _FlaxMasks(list(masks))
                mp.setattr(flax_attention, "random", jm)
                mp.setattr(flax_stochastic, "random", jm)
            if tables:
                agent.alpha, agent.sigma = _cosine_tables(jax_schedules, agent)
            g = jax.jit(jax.grad(lambda p: agent.loss_fn(p, sub, jnp.asarray(x),
                                                         jnp.asarray(cond))))(_f64(st.params))
            g = jax.tree_util.tree_map(np.asarray, g)
    finally:
        if tables:
            agent.alpha, agent.sigma = tables
    return _flatten_blocks(g)


def _port_f64_grads(tp, batch, noise, masks):
    """The port's gradient of the same loss in float64, on a float64 copy
    of its params, the same draws and dropout masks (a flax tree)."""
    agent = copy.deepcopy(tp.agent)
    agent.params.double()
    x, cond = _x_and_cond(tp, batch)
    d = lambda v: v.double() if v is not None and v.is_floating_point() else v
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "float32", torch.float64)
        mp.setattr(port_schedules, "_F32", torch.float64)
        if masks:
            tm = list(masks)
            mp.setattr(chitransformer, "dropout_keep",
                       lambda shape, rate, g, dev: torch.from_numpy(tm.pop(0)))
        if hasattr(agent, "alpha"):
            agent.alpha, agent.sigma = _cosine_tables(port_schedules, agent)
            agent._alpha_dev, agent._sigma_dev = agent.alpha, agent.sigma
        agent.loss_fn(agent.params, x.double(), cond.double(), noise=tuple(d(v) for v in noise),
                      generator=torch.Generator().manual_seed(0)).backward()
    grads = copy.deepcopy(agent.params)
    with torch.no_grad():
        for g, p in zip(grads.parameters(), agent.params.parameters()):
            g.copy_(torch.zeros_like(p) if p.grad is None else p.grad)  # None: detached
    return agent_params_of(grads)


def _close_adam_rule(got, want, exempt, steps=3):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(_flatten_blocks(_np(want)))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    beyond, total = 0, 0
    for (path, a), (_, b), e in zip(got_l, want_l, jax.tree_util.tree_leaves(exempt)):
        np.testing.assert_allclose(a, b, atol=2 * LR * steps, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        beyond += int(((np.abs(a - b) > ATOL + RTOL * np.abs(b)) & ~e).sum())
        total += a.size
    assert beyond <= FLIP_SHARE * total, f"{beyond} of {total} elements beyond {ATOL}"


def _dropout_layers(tp):
    """(decoder layers, MLP width) of a ChiTransformer backbone, else (0, 0)."""
    net = tp.agent.params["diffusion"]
    if not isinstance(net, chitransformer.ChiTransformer):
        return 0, 0
    return len(net.decoder), net.decoder[0].dense1.out_features


TRAIN_CASES = [("dp", "chi_unet", "ddpm"), ("dp", "chi_transformer", "ddpm"),
               ("dp", "dit", "edm"), ("dbc", "pearce_mlp", "ddpm"), ("dbc", "dit", "ddpm"),
               ("dbc", "pearce_transformer", "edm")]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    runs = {}
    mp = pytest.MonkeyPatch()
    try:
        for case in TRAIN_CASES:
            jp, tp = _pair(*case)
            rng = np.random.default_rng(6)
            logs, ckpt = [], str(tmp_path_factory.mktemp("dpdbc") / "_".join(case))
            for i in range(3):
                batch = _batch(rng)
                noise = _train_draws(jp, tp, batch)
                n, width = _dropout_layers(tp)
                masks = []  # the ChiTransformer's dropout: the same masks on both sides
                for _ in range(n):
                    masks += [rng.uniform(size=(H, H)) < 0.7,
                              rng.uniform(size=(H, 1 + TO)) < 0.7,
                              rng.uniform(size=(B, H, width)) < 0.7]
                if i == 0:
                    grads64 = (_jax_f64_grads(jp, tp, batch, masks),
                               _port_f64_grads(tp, batch,
                                               _train_draws(jp, tp, batch, np.float64), masks))
                if n:
                    jm, tm = list(masks), list(masks)
                    mp.setattr(flax_attention, "random", _FlaxMasks(jm))
                    mp.setattr(flax_stochastic, "random", _FlaxMasks(jm))
                    mp.setattr(chitransformer, "dropout_keep",
                               lambda shape, rate, g, d, tm=tm: torch.from_numpy(tm.pop(0)))
                    jp.agent._fn_cache.clear()  # retrace: the masks enter at trace time
                lj = jp.train_step(jax.tree_util.tree_map(jnp.asarray, batch))
                lt = tp.train_step(batch, noise=noise)
                if n:
                    assert not jm and not tm  # every dropout site took its mask
                    mp.undo()
                logs.append(({k: float(v) for k, v in lj.items()},
                             {k: float(v) for k, v in lt.items()}))
            jp.save(ckpt)
            runs[case] = (jp, tp, logs, ckpt, grads64)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("case", TRAIN_CASES, ids=["_".join(c) for c in TRAIN_CASES])
def test_three_training_steps_match_jax(trained, case):
    jp, tp, logs, _, (jax_g, port_g) = trained[case]
    # the first step's gradient in float64 on both sides
    top = max(np.abs(a).max() for a in jax.tree_util.tree_leaves(jax_g))
    got_l, want_l = (jax.tree_util.tree_leaves_with_path(g) for g in (port_g, jax_g))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, atol=F64_TOL * top, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    exempt = jax.tree_util.tree_map(lambda a: np.abs(a) <= 1e-9 * top, jax_g)
    for lj, lt in logs:
        assert set(lt) == set(lj) == {"loss", "grad_norm"}
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    st = jp.agent.state
    # a DiT's blocks: the port's flat layout against the nested flax one
    _close_adam_rule(agent_params_of(tp.agent.params), st.params, exempt)
    _close_adam_rule(agent_params_of(tp.agent.ema_params), st.ema_params, exempt)
    assert tp.agent.step == int(st.step) == 3


@pytest.mark.parametrize("case", TRAIN_CASES[:1] + TRAIN_CASES[4:5],
                         ids=["dp_chi_unet", "dbc_dit"])
def test_jax_checkpoint_loads_and_port_checkpoint_round_trips(trained, case, tmp_path):
    jp, _, _, ckpt, _ = trained[case]
    fresh = (tdp.DPPipeline if case[0] == "dp" else tdbc.DBCPipeline)(
        **_cfg(*case), rng=5, device="cpu")
    fresh.load_jax_checkpoint(ckpt)
    st = jp.agent.state
    _close_tree(agent_params_of(fresh.agent.params), _flatten_blocks(st.params), tol=1e-7)
    _close_tree(agent_params_of(fresh.agent.ema_params), _flatten_blocks(st.ema_params), tol=1e-7)
    assert fresh.agent.step == 3 and fresh.agent.optimizer.count == 3
    fresh.save(str(tmp_path / "ckpt"))
    again = (tdp.DPPipeline if case[0] == "dp" else tdbc.DBCPipeline)(
        **_cfg(*case), rng=6, device="cpu")
    again.load(str(tmp_path / "ckpt"))
    for a, b in zip(again.agent.params.parameters(), fresh.agent.params.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert again.agent.step == 3


# ---------------------------------------------------------------- evaluation
@pytest.fixture(scope="module")
def datasets():
    rb = generate_pusht_demos(n_episodes=3, max_steps=40, seed=0)
    jrb = JaxReplayBuffer.create_from_data(dict(rb.data), rb.episode_ends)
    return (JaxPushTState(jrb, horizon=H, pad_before=TO - 1, pad_after=TA - 1),
            PushTStateDataset(rb, horizon=H, pad_before=TO - 1, pad_after=TA - 1, device="cpu"))


def _eval_draws(key, n_samples, shape, steps):
    """The JAX rollout's draws: its reset key, then one sampler key per
    chunk (or env step)."""
    r, k_reset = jax.random.split(key)
    draws = []
    for _ in range(n_samples):
        r, k_s = jax.random.split(r)
        draws.append(_sampler_noise(k_s, shape, steps))
    return k_reset, draws


def _reset_state(k_reset, n):
    s, _ = PushTEnvJax().reset(k_reset, n)
    return torch.from_numpy(np.concatenate([np.asarray(s.agent_pos), np.asarray(s.block_pos),
                                            np.asarray(s.block_angle)[:, None]], -1))


@pytest.mark.parametrize("kind", ["dp", "dbc"])
def test_evaluate_on_device_matches_jax(datasets, kind):
    jds, tds = datasets
    n_envs, key = 3, jax.random.PRNGKey(8)
    if kind == "dp":
        jp, tp = _pair("dp", "chi_unet", "ddpm")
        steps, n_samples, shape = 2 * TA, 2, (n_envs, H, ACT)
    else:
        jp, tp = _pair("dbc", "pearce_mlp", "ddpm")
        steps, n_samples, shape = 3, 3, (n_envs, ACT)
    k_reset, draws = _eval_draws(key, n_samples, shape, 3 if kind == "dp" else 4)
    want = jp.evaluate_on_device(PushTEnvJax(), jds.normalizer, num_envs=n_envs,
                                 max_episode_steps=steps, rng=key)
    got = tp.evaluate_on_device(PushTEnv(device="cpu"), tds.normalizer, num_envs=n_envs,
                                max_episode_steps=steps, reset_to_state=_reset_state(k_reset,
                                                                                     n_envs),
                                noise=draws)
    per_step = steps * COV_STEP if kind == "dp" else COV_STEP
    np.testing.assert_allclose(got[0], want[0], atol=per_step)
    np.testing.assert_allclose(got[1], want[1], atol=COV_STEP)

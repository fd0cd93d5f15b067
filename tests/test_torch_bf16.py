"""bf16 sampling and bf16 training: the PyTorch port against the JAX package.

Same weights (seeded numpy normals in the JAX layout, the Fourier
frequencies at their N(0, 16^2) scale), same inputs and the same random
draws (the JAX sampler's and update's own, replayed as explicit noise) go
through both packages with the bf16 flags set:

- a Decision Diffuser plan (`ContinuousDiffusionSDE`, `DiT1d` with the fused
  block, Fourier time, `MLPCondition`, CFG "mix") and a `DiscreteDiffusionSDE`
  ddpm plan ("cond");
- the `bf16_training` loss, one update's gradient norm and the params after
  it (master weights, Adam moments and EMA f32);
- the DiT block's plain version on the same bf16 inputs, mixed (f32 x and
  mod, bf16 weights) and all-bf16.

Also: `setup_mesh` sets the class flags (and a test resets them), and a bf16
flag with the Janner U-Net raises.

Tolerances. Both packages make the same bf16 casts of params and inputs
(round to nearest even, bit for bit) and round the same products to bf16;
what differs is the order of f32 sums and, where a sum is taken in bf16 (a
bias's gradient, the all-bf16 block), a result a bf16 ulp or two apart.
Each limit below gives the reading it was set from (on a CPU). None
is looser than the JAX package's own bf16 against f32 bounds
(tests/test_bf16_sampling.py: max 0.02 and mean 0.005 of the sample's
scale, loss 5 %), which the bf16 against f32 checks here keep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.diffusion.basic import DiffusionModel as JaxDiffusionModel
from cleandiffuser_tpu.diffusion.diffusionsde import DiscreteDiffusionSDE as JaxDiscrete
from cleandiffuser_tpu.nn_condition import MLPCondition as JaxMLPCondition
from cleandiffuser_tpu.nn_diffusion.dit import DiT1d as JaxDiT1d
from cleandiffuser_tpu.ops.dit_block import dit_block_reference as jax_dit_block_reference
from cleandiffuser_tpu.pipelines.dd import DDPipeline as JaxDDPipeline
from cleandiffuser_tpu_torch.diffusion import DiscreteDiffusionSDE
from cleandiffuser_tpu_torch.diffusion.basic import DiffusionModel, bf16_cast
from cleandiffuser_tpu_torch.nn_condition import MLPCondition
from cleandiffuser_tpu_torch.nn_diffusion import DiT1d
from cleandiffuser_tpu_torch.ops.dit_block import dit_block_reference
from cleandiffuser_tpu_torch.parallel import setup_mesh
from cleandiffuser_tpu_torch.pipelines import DDPipeline, DiffuserPipeline
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, load_agent_params

torch.set_num_threads(1)

DD_CFG = dict(obs_dim=5, act_dim=3, horizon=8, emb_dim=32, d_model=64, n_heads=4, depth=2,
              sampling_steps=4, w_cfg=2.0, target_return=0.95, temperature=0.5)
E = 4
# the JAX package's bf16-against-f32 bounds (tests/test_bf16_sampling.py:67-70, :105)
BF16_MAX, BF16_MEAN, BF16_LOSS_RTOL = 0.02, 0.005, 0.05
# port against JAX, both bf16, the JAX side run op by op (`jax.disable_jit`):
# under jit, XLA's CPU compiler drops a convert pair f32 -> bf16 -> f32 where
# it sees one (excess precision), so a jitted JAX program skips some of the
# bf16 roundings its source asks for, and lands ~1e-3 of scale away from
# both. Plans, max |diff| / scale (measured 4.8e-7 DD, 2.9e-7 ddpm); losses
# (measured 1.2e-7 relative); the gradient norm (measured 7.1e-6: a bias's
# gradient, see the update test).
PLAN_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_NORM_TOL = 1e-4
# the block, port against JAX: mixed, f32 math on the same bf16-rounded
# weights (measured 2.6e-7 of max |out|); all-bf16 is held to the bf16
# bounds above (measured max 8.4e-3 and mean 7.4e-4 of max |out|)
BLOCK_MIXED_TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_flags():
    """No test leaves a class flag set, in either package."""
    yield
    for cls in (DiffusionModel, JaxDiffusionModel):
        cls.bf16_sampling = cls.bf16_training = False


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _seeded(tree, seed, std=0.1):
    """Seeded normals; Fourier frequencies at the init's N(0, 16^2)."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * std).astype(np.float32), _numpy_tree(tree))
    fourier = out.get("diffusion", {}).get("params", {}).get("FourierEmbedding_0")
    if fourier is not None:
        fourier["freqs"] = (rng.standard_normal(fourier["freqs"].shape) * 16).astype(np.float32)
    return out


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


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


def _rel(a, b):
    """max and mean |a - b| over the scale of b (at least 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    return np.abs(a - b).max() / scale, np.abs(a - b).mean() / scale


@pytest.fixture(scope="module")
def dd_plans():
    """One DD plan per (package, precision), same weights, key and noise."""
    jpipe = JaxDDPipeline(**DD_CFG, use_pallas_block=True)
    ema = _seeded(jpipe.agent.state.ema_params, 2)
    inv = _seeded(jpipe.invdyn.params, 3)
    tpipe = DDPipeline(**DD_CFG, use_pallas_block=True, device="cpu")
    tpipe.load_jax_params(ema, ema, inv)
    obs = np.random.default_rng(4).standard_normal((E, DD_CFG["obs_dim"])).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    cond = jnp.ones((E, 1)) * DD_CFG["target_return"]
    noise = _jax_noise(rng, (E, DD_CFG["horizon"], DD_CFG["obs_dim"]), DD_CFG["sampling_steps"])
    out = {}
    try:
        for bf16 in (False, True):
            jpipe.agent.bf16_sampling = tpipe.agent.bf16_sampling = bf16
            with jax.disable_jit():
                _, traj_j = jpipe._make_plan_fn(E)(_jt(ema), _jt(inv), rng, jnp.asarray(obs),
                                                   cond)
            _, info = tpipe.act(obs, noise=noise)
            out[bf16] = (np.asarray(traj_j), info["traj"].numpy())
    finally:
        jpipe.agent.bf16_sampling = tpipe.agent.bf16_sampling = False
    return dict(out=out, tpipe=tpipe)


def test_dd_bf16_plan_matches_jax(dd_plans):
    traj_j, traj_t = dd_plans["out"][True]
    assert traj_t.dtype == np.float32  # solver math and output stay f32
    assert np.abs(traj_j[:, 1:]).max() > 0.1
    d_max, _ = _rel(traj_t, traj_j)
    assert d_max < PLAN_TOL, d_max


def test_dd_bf16_plan_is_not_the_f32_plan(dd_plans):
    """bf16 moves the plan (so the comparison above is of the bf16 path),
    within the JAX package's own bf16 against f32 bounds, in both packages."""
    for side in (0, 1):
        d_max, d_mean = _rel(dd_plans["out"][True][side], dd_plans["out"][False][side])
        assert 1e-4 < d_max < BF16_MAX and d_mean < BF16_MEAN, (side, d_max, d_mean)


def test_sampler_casts_params_once_per_call(dd_plans):
    """The sampler's bf16 copy of the EMA (backbone and condition, the
    Fourier frequencies too) is filled once per call and is the reference's
    `bf16_cast` of the f32 params, bit for bit; the f32 params stay f32."""
    agent = dd_plans["tpipe"].agent
    copies = list(agent._bf16_copies.values())
    assert len(copies) == 1
    for name, want in bf16_cast(agent.ema_params).items():
        got = dict(copies[0].named_parameters())[name]
        assert got.dtype == torch.bfloat16 and torch.equal(got, want), name
    got_jax = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)),
        agent_params_of(agent.ema_params))
    got_port = agent_params_of(copies[0].float())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got_port),
                                 jax.tree_util.tree_leaves_with_path(got_jax)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    copies[0].to(torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in agent.ema_params.parameters())


def _ddpm_engines():
    kw = dict(in_dim=3, emb_dim=16, d_model=32, n_heads=2, depth=1, timestep_emb_type="fourier",
              use_pallas_block=True)
    jeng = JaxDiscrete(JaxDiT1d(**kw), JaxMLPCondition(in_dim=5, out_dim=16, hidden_dims=(16,)),
                       diffusion_steps=5, rng=0)
    prior = jnp.zeros((6, 4, 3))
    cond = np.random.RandomState(0).randn(6, 5).astype(np.float32)
    jeng.init(prior, jnp.asarray(cond))
    ema = _seeded(jeng.state.ema_params, 7, std=0.2)
    teng = DiscreteDiffusionSDE(DiT1d(**kw), MLPCondition(5, 16, (16,)), diffusion_steps=5,
                                device="cpu")
    load_agent_params(teng.ema_params, ema)
    return jeng, teng, ema, prior, cond


def test_ddpm_bf16_plan_matches_jax():
    jeng, teng, ema, prior, cond = _ddpm_engines()
    skw = dict(solver="ddpm", sample_steps=5, cfg_mode="cond", final_logp=False)
    rng = jax.random.PRNGKey(3)
    noise = _jax_noise(rng, prior.shape, 5)
    out = {}
    for bf16 in (False, True):
        jeng.bf16_sampling = teng.bf16_sampling = bf16
        with jax.disable_jit():
            x_j, _ = jeng.build_sample_fn(**skw)(_jt(ema), None, rng, prior,
                                                 condition_cfg=jnp.asarray(cond), w_cfg=1.0)
        x_t, _ = teng.build_sample_fn(**skw)(teng.ema_params, None, torch.zeros(prior.shape),
                                             condition_cfg=torch.from_numpy(cond), w_cfg=1.0,
                                             noise=noise)
        out[bf16] = (np.asarray(x_j), x_t.numpy())
    assert out[True][1].dtype == np.float32
    d_max, _ = _rel(out[True][1], out[True][0])
    assert d_max < PLAN_TOL, d_max
    d_max, d_mean = _rel(out[True][1], out[False][1])
    assert 1e-4 < d_max < BF16_MAX and d_mean < BF16_MEAN, (d_max, d_mean)


@pytest.fixture(scope="module")
def bf16_training():
    """The DD loss with bf16_training (and without) on the same params,
    batch and draws in both packages, then one update each."""
    from test_torch_dd_train import CFG, _batch, _jax_draws

    jpipe = JaxDDPipeline(**CFG, use_pallas_block=True)
    params, ema = _seeded(jpipe.agent.state.params, 1), _seeded(jpipe.agent.state.ema_params, 2)
    jpipe.agent.state = jpipe.agent.state.replace(params=_jt(params), ema_params=_jt(ema))
    tpipe = DDPipeline(**CFG, use_pallas_block=True, device="cpu")
    load_agent_params(tpipe.agent.params, params)
    load_agent_params(tpipe.agent.ema_params, ema)
    batch = _batch(np.random.default_rng(4))
    noise, sub, cond = _jax_draws(jpipe, batch)
    obs = jnp.asarray(batch["obs"]["state"])
    losses = {}
    try:
        for bf16 in (False, True):
            jpipe.agent.bf16_training = tpipe.agent.bf16_training = bf16
            with jax.disable_jit():
                loss_j = float(jpipe.agent.loss_fn(jpipe.agent.state.params, sub, obs, cond))
            losses[bf16] = (
                loss_j,
                float(tpipe.agent.loss_fn(tpipe.agent.params, torch.from_numpy(np.asarray(obs)),
                                          torch.from_numpy(np.asarray(cond)), noise=noise)))
        with jax.disable_jit():
            log_j = jpipe.agent.update(obs, cond)
        log_t = tpipe.agent.update(torch.from_numpy(np.asarray(obs)),
                                   torch.from_numpy(np.asarray(cond)), noise=noise)
    finally:
        jpipe.agent.bf16_training = tpipe.agent.bf16_training = False
    return dict(losses=losses, log_j=log_j, log_t=log_t, jpipe=jpipe, tpipe=tpipe, cfg=CFG)


def test_bf16_training_loss_matches_jax(bf16_training):
    l_j, l_t = bf16_training["losses"][True]
    assert abs(l_t - l_j) / abs(l_j) < LOSS_TOL, (l_t, l_j)
    # and tracks f32 within the JAX package's bound, in both packages
    for side in (0, 1):
        l16, l32 = bf16_training["losses"][True][side], bf16_training["losses"][False][side]
        assert l16 != l32 and abs(l16 - l32) / abs(l32) < BF16_LOSS_RTOL, (side, l16, l32)


def test_bf16_training_update_matches_jax(bf16_training):
    """One update: loss and gradient norm as JAX's; master weights, Adam
    moments and the EMA f32 and as JAX's."""
    from test_torch_dd_train import _assert_tree_close, _port_view

    log_j, log_t = bf16_training["log_j"], bf16_training["log_t"]
    for k, tol in (("loss", LOSS_TOL), ("grad_norm", GRAD_NORM_TOL)):
        assert log_t[k].dtype == torch.float32
        np.testing.assert_allclose(float(log_t[k]), float(log_j[k]), rtol=tol, err_msg=k)
    agent, st = bf16_training["tpipe"].agent, bf16_training["jpipe"].agent.state
    opt = agent.optimizer.optimizer
    for p in agent.params.parameters():
        assert p.dtype == torch.float32 and opt.state[p]["exp_avg"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in agent.ema_params.parameters())
    _assert_tree_close(agent_params_of(agent.params), st.params)
    _assert_tree_close(agent_params_of(agent.ema_params), st.ema_params)
    # the moments carry the gradients, which come back through the bf16 cast:
    # a bias's gradient sums the batch in bf16, where the two packages' sums
    # land a few bf16 ulps of the partial sums apart (measured: x_proj's
    # bias, 0.0078 where its largest is 0.71). Held per tensor to BF16_MAX
    # of its largest entry (measured 0.011), the second moment as its root.
    adam = st.opt_state[0][0]
    mu, nu = _port_view(agent.params, adam.mu), _port_view(agent.params, adam.nu)
    for name, p in agent.params.named_parameters():
        for got, want in ((opt.state[p]["exp_avg"], mu[name]),
                          (opt.state[p]["exp_avg_sq"].sqrt(), nu[name].sqrt())):
            want = want.detach()
            assert (got - want).abs().max() <= BF16_MAX * want.abs().max(), name


def _block_inputs(seed, B=3, H=8, D=64):
    rng = np.random.default_rng(seed)
    shapes = [(B, H, D), (B, 6 * D), (D, 3 * D), (3 * D,), (D, D), (D,), (D, 4 * D), (4 * D,),
              (4 * D, D), (D,)]
    stds = [1.0, 0.5, D ** -0.5, 0.1, D ** -0.5, 0.1, D ** -0.5, 0.1, (4 * D) ** -0.5, 0.1]
    return [(rng.standard_normal(s) * std).astype(np.float32) for s, std in zip(shapes, stds)]


@pytest.mark.parametrize("route", ["mixed", "bf16"])
def test_block_reference_matches_jax(route):
    """The port's plain block promotes as jnp does: on the same bf16 weights
    (and bf16 x and mod for all-bf16) it computes what JAX's computes, in
    x's type."""
    arrays = _block_inputs(11)
    # weights and biases bf16; x and mod too for all-bf16 (both casts round
    # to nearest even)
    bf16 = [i >= 2 or route == "bf16" for i in range(len(arrays))]
    jin = [jnp.asarray(a, jnp.bfloat16) if b else jnp.asarray(a) for a, b in zip(arrays, bf16)]
    tin = [torch.from_numpy(a).to(torch.bfloat16) if b else torch.from_numpy(a)
           for a, b in zip(arrays, bf16)]
    want = jax_dit_block_reference(*jin, n_heads=4)
    got = dit_block_reference(*tin, n_heads=4)
    want_dtype = torch.bfloat16 if route == "bf16" else torch.float32
    assert got.dtype == want_dtype and str(want.dtype) == str(want_dtype).split(".")[-1]
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    if route == "mixed":
        assert diff.max() / scale < BLOCK_MIXED_TOL, diff.max() / scale
    else:
        # every operation rounds to bf16 in both, but jnp and torch round
        # inside some (softmax, GELU, reductions) at other points
        assert diff.max() / scale < BF16_MAX and diff.mean() / scale < BF16_MEAN, (
            diff.max() / scale, diff.mean() / scale)


def test_setup_mesh_sets_the_class_flags():
    """The config keys reach every engine through the class; a key left out
    leaves the flag as it was; more than one device raises."""
    assert DiffusionModel.bf16_sampling is False and DiffusionModel.bf16_training is False
    assert setup_mesh({"n_devices": 1, "bf16_sampling": True}) is None
    eng = DiscreteDiffusionSDE(DiT1d(3, 16, 32, 2, 1), device="cpu")
    assert eng.bf16_sampling is True and eng.bf16_training is False
    setup_mesh({"bf16_training": True})
    assert eng.bf16_sampling is True and eng.bf16_training is True
    DiffusionModel.bf16_sampling = DiffusionModel.bf16_training = False
    assert eng.bf16_sampling is False and eng.bf16_training is False
    with pytest.raises(NotImplementedError, match="queue 1, item 10"):
        setup_mesh({"n_devices": 2})


def test_config_loader_takes_the_bf16_keys():
    """`bf16_sampling=true` and `bf16_training=true` override configs/dd/*,
    which do not carry them, and reach the engines through setup_mesh."""
    from pathlib import Path

    from cleandiffuser_tpu_torch.utils.config import load_config

    root = Path(__file__).resolve().parents[1]
    args = load_config(root / "configs/dd/mujoco", "mujoco",
                       overrides=["bf16_sampling=true", "bf16_training=true"])
    assert args.bf16_sampling is True and args.bf16_training is True
    setup_mesh(args)
    assert DiffusionModel.bf16_sampling and DiffusionModel.bf16_training
    plain = load_config(root / "configs/dd/mujoco", "mujoco")
    assert plain.get("bf16_sampling", False) is False


@pytest.mark.parametrize("flag", ["bf16_sampling", "bf16_training"])
def test_bf16_flag_with_the_janner_unet_raises(flag):
    """Diffuser's U-Net runs K3, which has no bf16 route: a bf16 flag raises
    on every device rather than running another path."""
    pipe = DiffuserPipeline(obs_dim=3, act_dim=2, horizon=8, model_dim=8, dim_mult=(1, 2),
                            diffusion_steps=5, sampling_steps=2, device="cpu")
    setattr(pipe.agent, flag, True)
    obs = np.zeros((2, 3), np.float32)
    batch = {"obs": {"state": np.zeros((2, 8, 3), np.float32)},
             "act": np.zeros((2, 8, 2), np.float32), "val": np.zeros((2, 1), np.float32)}
    with pytest.raises(NotImplementedError, match="Janner U-Net"):
        if flag == "bf16_sampling":
            pipe.act(obs, num_candidates=2)
        else:
            pipe.train_step(batch)

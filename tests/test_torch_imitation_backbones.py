"""The port's imitation backbones and condition against the JAX package's,
on the same seeded weights (the JAX param tree converted by
utils/jax_params.py) and inputs, within 1e-5 absolute / 1e-4 relative:
ChiUNet1d (global and local condition, FiLM with and without scale),
ChiTransformer (causal target mask, memory mask t >= s - 1; in training
its dropout masks recorded and injected on both sides: a stand-in for
flax's Bernoulli draw and for the port's `dropout_keep` hand out the same
keep-masks in the modules' draw order), PearceMlp, PearceTransformer (its
token BatchNorm on the batch's statistics in training and sampling alike,
a reference quirk the port keeps) and PearceObsCondition. Each converted
tree also comes back out of the port unchanged (`jax_params_of`)."""

import flax.linen.attention as flax_attention
import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.nn_condition import PearceObsCondition as JaxPearceObs
from cleandiffuser_tpu.nn_diffusion import ChiTransformer as JaxChiTransformer
from cleandiffuser_tpu.nn_diffusion import ChiUNet1d as JaxChiUNet
from cleandiffuser_tpu.nn_diffusion import PearceMlp as JaxPearceMlp
from cleandiffuser_tpu.nn_diffusion import PearceTransformer as JaxPearceTransformer
from cleandiffuser_tpu_torch.nn_condition import PearceObsCondition
from cleandiffuser_tpu_torch.nn_diffusion import (
    ChiTransformer,
    ChiUNet1d,
    PearceMlp,
    PearceTransformer,
    chitransformer,
)
from cleandiffuser_tpu_torch.utils.jax_params import jax_params_of, load_jax_params
from test_torch_dql import _np, _seeded

torch.set_num_threads(1)

B, ACT, OBS, TO, TA = 4, 2, 5, 2, 8
ATOL, RTOL = 1e-5, 1e-4


def _inputs(seed, x_shape, emb_shape, T=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(x_shape).astype(np.float32),
            rng.integers(0, T, (x_shape[0],)).astype(np.int32),
            rng.standard_normal(emb_shape).astype(np.float32))


def _pair(jmod, tmod, inputs, seed=1, **apply_kw):
    """Seeded JAX params loaded into the port module; both outputs."""
    x, t, e = inputs
    params = _seeded(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(e))["params"], seed)
    load_jax_params(tmod, params)
    jt = jax.tree_util.tree_map(jnp.asarray, params)
    out_j = np.asarray(jmod.apply({"params": jt}, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(e), **apply_kw))
    with torch.no_grad():
        out_t = tmod(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(e)).numpy()
    back = jax.tree_util.tree_leaves_with_path(jax_params_of(tmod))
    want = jax.tree_util.tree_leaves_with_path(_np(params))
    assert [p for p, _ in back] == [p for p, _ in want]
    for (path, a), (_, b) in zip(back, want):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    return out_j, out_t, params


@pytest.mark.parametrize("global_cond,scale", [(True, True), (False, True), (True, False)])
def test_chi_unet_matches_jax(global_cond, scale):
    kw = dict(act_dim=ACT, obs_dim=OBS, To=TO, model_dim=16, emb_dim=16, kernel_size=5,
              cond_predict_scale=scale, obs_as_global_cond=global_cond, dim_mult=(1, 2, 2))
    emb_shape = (B, TO, OBS) if global_cond else (B, TA, OBS)
    out_j, out_t, _ = _pair(JaxChiUNet(**kw), ChiUNet1d(**kw), _inputs(0, (B, TA, ACT),
                                                                        emb_shape))
    assert out_t.shape == (B, TA, ACT)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=RTOL)


CT = dict(act_dim=ACT, obs_dim=OBS, Ta=TA, To=TO, d_model=16, nhead=2, num_layers=2)


@pytest.mark.parametrize("n_cond_layers", [0, 1])
def test_chi_transformer_matches_jax(n_cond_layers):
    kw = dict(CT, n_cond_layers=n_cond_layers)
    out_j, out_t, _ = _pair(JaxChiTransformer(**kw), ChiTransformer(**kw),
                            _inputs(1, (B, TA, ACT), (B, TO, OBS)))
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=RTOL)


def test_chi_transformer_masks():
    """The prediction for action token i reads no later token: changing
    the actions from token 5 on leaves tokens 0-4 as they were; the memory
    mask lets token t read condition tokens s <= t + 1 only."""
    net = ChiTransformer(**CT, generator=torch.Generator().manual_seed(0))
    x, t, e = (torch.from_numpy(a) for a in _inputs(2, (B, TA, ACT), (B, TO, OBS)))
    with torch.no_grad():
        base = net(x, t, e)
        x2 = x.clone()
        x2[:, 5:] += 1.0
        moved = net(x2, t, e)
        e2 = e.clone()
        e2[:, 1] += 1.0  # condition token s = 2: read from action token 1 on
        cond_moved = net(x, t, e2)
    torch.testing.assert_close(moved[:, :5], base[:, :5], atol=0, rtol=0)
    assert (moved[:, 5:] - base[:, 5:]).abs().max() > 0
    torch.testing.assert_close(cond_moved[:, :1], base[:, :1], atol=0, rtol=0)
    assert (cond_moved[:, 1:] - base[:, 1:]).abs().max() > 0


class _FlaxMasks:
    """flax's `random` module with `bernoulli` handing out the injected
    keep-masks in draw order (each reshaped to the shape flax asks for)."""

    def __init__(self, masks):
        self.masks = masks

    def bernoulli(self, rng, p, shape):
        assert np.isclose(p, 1.0 - CT_DROP)
        return jnp.asarray(self.masks.pop(0)).reshape(shape)

    def __getattr__(self, name):
        return getattr(jax.random, name)


CT_DROP = 0.3


def test_chi_transformer_training_dropout_matches_jax(monkeypatch):
    """Training forward with the dropout of p_drop_attn 0.3: per decoder
    layer a (Ta, Ta) self-attention mask, a (Ta, 1 + To) cross-attention
    mask and a (B, Ta, 4 d_model) MLP mask, the same on both sides; and
    the gradient of a loss through it."""
    kw = dict(CT, p_drop_attn=CT_DROP)
    jmod, tmod = JaxChiTransformer(**kw), ChiTransformer(**kw)
    x, t, e = _inputs(3, (B, TA, ACT), (B, TO, OBS))
    params = _seeded(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(e))["params"], 4)
    load_jax_params(tmod, params)
    rng = np.random.default_rng(5)
    masks = []
    for _ in range(CT["num_layers"]):
        masks += [rng.uniform(size=(TA, TA)) < 1 - CT_DROP,
                  rng.uniform(size=(TA, 1 + TO)) < 1 - CT_DROP,
                  rng.uniform(size=(B, TA, 4 * CT["d_model"])) < 1 - CT_DROP]
    jmasks, tmasks = list(masks), list(masks)
    stand_in = _FlaxMasks(jmasks)
    monkeypatch.setattr(flax_attention, "random", stand_in)
    monkeypatch.setattr(flax_stochastic, "random", stand_in)

    def port_keep(shape, rate, generator, device):
        assert rate == CT_DROP
        m = torch.from_numpy(tmasks.pop(0))
        assert tuple(m.shape) == tuple(shape)
        return m

    monkeypatch.setattr(chitransformer, "dropout_keep", port_keep)

    def jloss(p):
        out = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(e),
                         train=True, rngs={"dropout": jax.random.PRNGKey(1)})
        return (out ** 2).mean(), out

    (lj, out_j), gj = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    out_t = tmod(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(e), train=True)
    lt = (out_t ** 2).mean()
    lt.backward()
    assert not jmasks and not tmasks  # every site took its mask
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lt.item(), float(lj), atol=ATOL, rtol=RTOL)
    grads = {k: p.grad for k, p in tmod.named_parameters()}
    twin = ChiTransformer(**kw)
    with torch.no_grad():
        for k, p in twin.named_parameters():
            p.copy_(grads[k])
    got = jax.tree_util.tree_leaves_with_path(jax_params_of(twin))
    want = jax.tree_util.tree_leaves(_np(gj))
    for (path, a), b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=jax.tree_util.keystr(path))
    # without train the same weights give the sampling forward (no draw)
    with torch.no_grad():
        det = tmod(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(e))
    assert (det - out_t.detach()).abs().max() > 1e-4


def test_chi_transformer_dropout_rate():
    """The port's own draws: every mask keeps ~70 % (moment test over the
    generator's draws)."""
    keep = chitransformer.dropout_keep((400, 500), CT_DROP, torch.Generator().manual_seed(0),
                                       "cpu")
    assert abs(keep.float().mean().item() - (1 - CT_DROP)) < 5e-3


def test_pearce_mlp_matches_jax():
    kw = dict(act_dim=ACT, To=TO, emb_dim=16, hidden_dim=32)
    out_j, out_t, _ = _pair(JaxPearceMlp(**kw), PearceMlp(**kw),
                            _inputs(6, (B, ACT), (B, TO, 16), T=50))
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("train", [False, True])
def test_pearce_transformer_matches_jax_in_both_modes(train):
    kw = dict(act_dim=ACT, To=TO, emb_dim=16, trans_emb_dim=8, nhead=4)
    inputs = _inputs(7, (B, ACT), (B, TO, 16), T=50)
    out_j, out_t, params = _pair(JaxPearceTransformer(**kw), PearceTransformer(**kw), inputs,
                                 train=train)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=RTOL)
    # batch statistics: row 0's output moves when the other rows change
    x, t, e = inputs
    x2 = x.copy()
    x2[1:] += 1.0
    jmod = JaxPearceTransformer(**kw)
    other = np.asarray(jmod.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                  jnp.asarray(x2), jnp.asarray(t), jnp.asarray(e), train=train))
    tmod = PearceTransformer(**kw)
    load_jax_params(tmod, params)
    with torch.no_grad():
        other_t = tmod(torch.from_numpy(x2), torch.from_numpy(t), torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(other_t, other, atol=ATOL, rtol=RTOL)
    assert np.abs(other_t[0] - out_t[0]).max() > 1e-4


@pytest.mark.parametrize("flatten", [False, True])
def test_pearce_obs_condition_matches_jax(flatten):
    jmod = JaxPearceObs(obs_dim=OBS, emb_dim=16, flatten=flatten, dropout=0.0)
    tmod = PearceObsCondition(obs_dim=OBS, emb_dim=16, flatten=flatten, dropout=0.0)
    obs = np.random.default_rng(8).standard_normal((B, TO, OBS)).astype(np.float32)
    params = _seeded(jmod.init(jax.random.PRNGKey(0), jnp.asarray(obs))["params"], 9)
    load_jax_params(tmod, params)
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    for m in (None, mask):
        out_j = np.asarray(jmod.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                      jnp.asarray(obs), mask=None if m is None else
                                      jnp.asarray(m)))
        with torch.no_grad():
            out_t = tmod(torch.from_numpy(obs),
                         mask=None if m is None else torch.from_numpy(m)).numpy()
        assert out_t.shape == ((B, TO * 16) if flatten else (B, TO, 16))
        np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=RTOL)

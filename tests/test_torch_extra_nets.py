"""The port's modules that no pipeline uses, against the JAX package's, on
the same seeded weights (flax layout, carried in by utils/jax_params.py)
and inputs:

- utils/blocks.py: `SoftLowerBound`, `SoftUpperBound`, `FeedForward`,
  `MultiHeadAttention` (no mask, an (i, j) and a (b, i, j) mask; the
  attention map detached), `Transformer` under `generate_causal_mask`;
- utils/embeddings.py `SinusoidalEmbedding`, utils/tensors.py
  `dict_apply`, `loop_dataloader`, `count_parameters`,
  `report_parameters`;
- nn_condition/base.py `LinearCondition`, `MLPSieveObsCondition`,
  `FourierCondition`, `PositionalCondition` (with a caller's keep-mask);
- `MlpNNDiffusion`, `DiT1Ref`, `MLPNNClassifier`, `HalfDiT1d`;
- invdynamic/mlp.py `ResInvDynamic` and `EnsembleMlpInvDynamic`: the
  forward and three updates.

Each module: the forward, a loss (mean squared distance to a seeded
target) and its gradient with respect to every parameter and to the
input, each within 1e-5 of the JAX value's scale (max |JAX value|; float32
on both sides, sums in another order). The updates: losses within 1e-5
relative and the params within 1e-5. `FourierCondition`'s frequencies
shrink under AdamW's decay from the first step as JAX's do (within 1e-6
relative: torch multiplies by 1 - lr wd, optax subtracts lr wd p).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleandiffuser_tpu.nn_classifier as jcls
import cleandiffuser_tpu.nn_condition as jcond
import cleandiffuser_tpu.nn_diffusion as jdiff
import cleandiffuser_tpu.utils.blocks as jblocks
from cleandiffuser_tpu.diffusion import DiscreteDiffusionSDE as JaxDiscreteSDE
from cleandiffuser_tpu.invdynamic import EnsembleMlpInvDynamic as JaxEnsembleInv
from cleandiffuser_tpu.invdynamic import ResInvDynamic as JaxResInv
from cleandiffuser_tpu.utils.embeddings import SinusoidalEmbedding as JaxSinusoidal
from cleandiffuser_tpu_torch import nn_classifier as tcls
from cleandiffuser_tpu_torch import nn_condition as tcond
from cleandiffuser_tpu_torch import nn_diffusion as tdiff
from cleandiffuser_tpu_torch import utils as tutils
from cleandiffuser_tpu_torch.diffusion import DiscreteDiffusionSDE
from cleandiffuser_tpu_torch.invdynamic import EnsembleMlpInvDynamic, ResInvDynamic
from cleandiffuser_tpu_torch.utils.jax_params import (
    _flatten_blocks,
    agent_params_of,
    jax_params_of,
    load_agent_params,
    load_jax_params,
)
from jax_shaped_init import shaped_inits

torch.set_num_threads(2)
TOL = 1e-5
B, H = 3, 5


def _seeded(tree, seed):
    """Every leaf refilled with seeded normals: kernels at std 1/sqrt(fan-in)
    (all axes but the last), norm scales 1 + 0.1 N, other vectors 0.1 N,
    Fourier frequencies N(0, 4)."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        z = rng.standard_normal(np.shape(a))
        name = jax.tree_util.keystr(path)
        if name.endswith("['freqs']"):
            return (z * 2.0).astype(np.float32)
        if np.ndim(a) >= 2:
            return (z / np.sqrt(np.prod(np.shape(a)[:-1]))).astype(np.float32)
        return (z * 0.1 + (1.0 if name.endswith("['scale']") else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _params(jmod, args, seed):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    return _seeded(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                          shapes["params"]), seed)


def _grads_as_flax(tmod):
    """The port's parameter gradients as a flax tree (0 where none)."""
    saved = [p.detach().clone() for p in tmod.parameters()]
    with torch.no_grad():
        for p in tmod.parameters():
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
        tree = jax_params_of(tmod)
        for p, v in zip(tmod.parameters(), saved):
            p.copy_(v)
    return tree


def _close(got, want, label):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1e-30), err_msg=label)


def _close_trees(got, want, label):
    """Leaf by leaf; a nested `DiTBlock_i` of `want` read in the port's
    flat layout (a linear regrouping, so gradients regroup alike). An
    attention key bias's gradient is 0 in exact arithmetic (the softmax
    ignores a shift shared by all keys) and rounding noise in either
    package: it is held to 1e-5 of the largest gradient of the tree."""
    leaves = jax.tree_util.tree_leaves_with_path(_flatten_blocks(want))
    tree_scale = max(np.abs(np.asarray(leaf)).max() for _, leaf in leaves)
    for path, leaf in leaves:
        node = got
        for k in path:
            node = node[k.key]
        name = jax.tree_util.keystr(path)
        if name.endswith("['key']['bias']"):
            np.testing.assert_allclose(node, leaf, rtol=0, atol=TOL * tree_scale,
                                       err_msg=f"{label} {name}")
        else:
            _close(node, leaf, f"{label} {name}")


def _check(jmod, tmod, args, seed=0, pick=lambda o: o, kw=None, tkw=None, grad_args=(0,)):
    """The module check of the module note; `pick` takes the compared
    output from a module's result, `grad_args` the float inputs the input
    gradient is taken for."""
    kw, tkw = kw or {}, tkw or {}
    params = _params(jmod, args, seed)
    load_jax_params(tmod, params)
    out_shape = jax.eval_shape(lambda: pick(jmod.apply({"params": params}, *args, **kw)))
    target = np.random.default_rng(seed + 100).standard_normal(out_shape.shape).astype(
        np.float32)

    def jloss(p, *a):
        out = pick(jmod.apply({"params": p}, *a, **kw))
        return ((out - target) ** 2).mean(), out

    argnums = (0,) + tuple(1 + i for i in grad_args)
    (want_loss, want_out), want_g = jax.jit(jax.value_and_grad(jloss, argnums, has_aux=True))(
        params, *args)
    targs = [torch.tensor(np.asarray(a)) for a in args]
    for i in grad_args:
        targs[i].requires_grad_(True)
    out = pick(tmod(*targs, **tkw))
    loss = ((out - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    _close(out.detach().numpy(), want_out, "forward")
    _close(loss.item(), want_loss, "loss")
    _close_trees(_grads_as_flax(tmod), want_g[0], "param grad")
    for i, g in zip(grad_args, want_g[1:]):
        _close(targs[i].grad.numpy(), g, f"input {i} grad")
    return out


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# utils/blocks.py
@pytest.mark.parametrize("kind", ["lower", "upper"])
def test_soft_bounds_match_jax(kind):
    jmod = jblocks.SoftLowerBound(-1.5) if kind == "lower" else jblocks.SoftUpperBound(2.0)
    tmod = tutils.SoftLowerBound(-1.5) if kind == "lower" else tutils.SoftUpperBound(2.0)
    x = _x(4, 6) * 3
    want, vjp = jax.vjp(lambda a: jmod.apply({}, a), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tmod(xt)
    out.backward(torch.ones_like(out))
    _close(out.detach().numpy(), want, "forward")
    _close(xt.grad.numpy(), vjp(jnp.ones_like(want))[0], "grad")


def test_feed_forward_matches_jax():
    _check(jblocks.FeedForward(16, 2), tutils.FeedForward(16, 2), (_x(B, H, 16),))


def test_block_dropout_is_flax_dropout():
    """The blocks' dropout in training (the reference's rates, 0 by
    default): each entry kept with probability 1 - rate from the given
    generator and scaled by 1 / (1 - rate); the identity at sampling."""
    x = torch.ones(64, 64)
    out = tutils.dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = out != 0
    assert torch.all(out[kept] == 1 / 0.75) and 0.65 < kept.float().mean() < 0.85
    assert tutils.dropout(x, 0.25, False) is x
    ffn = tutils.FeedForward(16, 2, dropout=0.5)
    h = torch.from_numpy(_x(B, H, 16))
    a, b = (ffn(h, train=True, generator=torch.Generator().manual_seed(s)) for s in (0, 1))
    assert not torch.equal(a, b) and torch.equal(ffn(h), ffn(h))


@pytest.mark.parametrize("mask", ["none", "2d", "3d"])
def test_multi_head_attention_matches_jax(mask):
    q, k, v = _x(B, H, 16, seed=1), _x(B, 7, 16, seed=2), _x(B, 7, 16, seed=3)
    if mask == "none":
        m = None
    else:
        rng = np.random.default_rng(4)
        m = (rng.random((H, 7) if mask == "2d" else (B, H, 7)) > 0.3).astype(np.float32)
        m[..., 0] = 1.0  # every query keeps a key
    jmod, tmod = jblocks.MultiHeadAttention(16, 4), tutils.MultiHeadAttention(16, 4)
    kw = {"mask": None if m is None else jnp.asarray(m)}
    tkw = {"mask": None if m is None else torch.from_numpy(m)}
    _check(jmod, tmod, (q, k, v), pick=lambda o: o[0], kw=kw, tkw=tkw, grad_args=(0, 1, 2))
    # the attention map, detached; masked keys get no weight
    params = _params(jmod, (q, k, v), 0)
    _, want_map = jmod.apply({"params": params}, q, k, v, **kw)
    _, got_map = tmod(*(torch.from_numpy(a).requires_grad_() for a in (q, k, v)), **tkw)
    assert not got_map.requires_grad
    _close(got_map.numpy(), want_map, "attention map")
    if m is not None:
        assert np.all(got_map.numpy()[np.broadcast_to(
            (m[None, None] if m.ndim == 2 else m[:, None]) == 0, got_map.shape)] == 0)


def test_transformer_with_causal_mask_matches_jax():
    L = 6
    np.testing.assert_array_equal(tutils.generate_causal_mask(L).numpy(),
                                  np.asarray(jblocks.generate_causal_mask(L)))
    jmod, tmod = jblocks.Transformer(16, 2, 2), tutils.Transformer(16, 2, 2)
    kw = {"mask": jblocks.generate_causal_mask(L)}
    tkw = {"mask": tutils.generate_causal_mask(L)}
    _check(jmod, tmod, (_x(B, L, 16),), pick=lambda o: o[0], kw=kw, tkw=tkw)
    # one attention map per layer, lower triangular
    maps = tmod(torch.from_numpy(_x(B, L, 16)), **tkw)[1]
    assert len(maps) == 2 and all(torch.equal(m, m.tril()) for m in maps)


# ---------------------------------------------------------------------------
# utils/embeddings.py, utils/tensors.py
def test_sinusoidal_embedding_and_tensor_helpers_match_jax():
    import cleandiffuser_tpu.utils.tensors as jtensors

    t = np.arange(7, dtype=np.float32) * 1.5
    want = np.asarray(JaxSinusoidal(12).apply({}, jnp.asarray(t)))
    _close(tutils.SinusoidalEmbedding(12)(torch.from_numpy(t)).numpy(), want, "sinusoidal")
    d = {"a": np.ones(3), "b": {"c": np.arange(4.0)}}
    got, ref = tutils.dict_apply(d, lambda v: v * 2), jtensors.dict_apply(d, lambda v: v * 2)
    np.testing.assert_array_equal(got["b"]["c"], ref["b"]["c"])
    loop = tutils.loop_dataloader([1, 2])
    assert [next(loop) for _ in range(5)] == [1, 2, 1, 2, 1]
    jnet = jdiff.MlpNNDiffusion(x_dim=3, emb_dim=8, hidden_dims=(16,))
    params = _params(jnet, (jnp.zeros((1, 3)), jnp.zeros((1,))), 0)
    tnet = tdiff.MlpNNDiffusion(3, 8, (16,))
    assert (tutils.count_parameters(tnet) == tutils.count_parameters(params)
            == jtensors.count_parameters(params) == 3 * 0 + (11 * 16 + 16) + (16 * 3 + 3))


def test_report_parameters_prints_the_largest(capsys):
    total = tutils.report_parameters(tcond.LinearCondition(4, 8), topk=1)
    out = capsys.readouterr().out
    assert total == 40 and "Total parameters: 0.04 k" in out and "dense.weight: 0.03 k" in out


# ---------------------------------------------------------------------------
# nn_condition/base.py
CONDITIONS = {
    "linear": (lambda: jcond.LinearCondition(in_dim=4, out_dim=8),
               lambda: tcond.LinearCondition(4, 8), (B, 4)),
    "mlp_sieve": (lambda: jcond.MLPSieveObsCondition(o_dim=4, emb_dim=6, hidden_dim=16),
                  lambda: tcond.MLPSieveObsCondition(4, 6, 16), (B, 2, 4)),
    "fourier": (lambda: jcond.FourierCondition(out_dim=8, hidden_dim=16),
                lambda: tcond.FourierCondition(8, 16), (B, 1)),
    "positional": (lambda: jcond.PositionalCondition(out_dim=8, hidden_dim=16),
                   lambda: tcond.PositionalCondition(8, 16), (B, 1)),
}


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("name", CONDITIONS)
def test_condition_matches_jax(name, with_mask):
    jmake, tmake, shape = CONDITIONS[name]
    x = _x(*shape, seed=5)
    m = np.array([1.0, 0.0, 1.0], np.float32) if with_mask else None
    kw = {"mask": None if m is None else jnp.asarray(m)}
    tkw = {"mask": None if m is None else torch.from_numpy(m)}
    out = _check(jmake(), tmake(), (x,), kw=kw, tkw=tkw)
    if with_mask:
        assert torch.all(out[1] == 0) and torch.any(out[0] != 0)


def test_fourier_condition_freqs_get_no_gradient():
    cond = tcond.FourierCondition(8, 16)
    cond(torch.rand(5, 1)).sum().backward()
    assert isinstance(cond.freqs, torch.nn.Parameter)
    assert cond.freqs.grad is None and cond.dense1.weight.grad is not None


def test_fourier_condition_freqs_decay_as_in_jax():
    """AdamW with weight decay from step 0, on an engine whose condition is
    a `FourierCondition` (dropout 0: every row kept, no draw): the
    frequencies shrink by (1 - lr wd) per step in both packages, and the
    losses agree. The JAX update's draws (t, eps) are replayed."""
    lr, wd, steps, n = 1e-2, 0.5, 3, 6
    optim = {"lr": lr, "weight_decay": wd}
    jeng = JaxDiscreteSDE(jdiff.MlpNNDiffusion(x_dim=3, emb_dim=8, hidden_dims=(16,)),
                          jcond.FourierCondition(out_dim=8, hidden_dim=16, dropout=0.0),
                          diffusion_steps=10, optim_params=optim)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((n, 3)).astype(np.float32) for _ in range(steps)]
    cs = [rng.standard_normal((n, 1)).astype(np.float32) for _ in range(steps)]
    with shaped_inits():  # every leaf the updates read is seeded below
        jeng.init(jnp.asarray(xs[0]), jnp.asarray(cs[0]))
    params = _seeded(jax.device_get(jeng.state.params), 1)
    jeng.state = jeng.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    teng = DiscreteDiffusionSDE(tdiff.MlpNNDiffusion(3, 8, (16,)),
                                tcond.FourierCondition(8, 16, dropout=0.0),
                                diffusion_steps=10, optim_params=optim, device="cpu")
    load_agent_params(teng.params, params)
    freqs0 = params["condition"]["params"]["freqs"]
    for x, c in zip(xs, cs):
        _, sub = jax.random.split(jeng.state.rng)
        k_t, k_eps = jax.random.split(jax.random.split(sub, 3)[0])
        t = jax.random.randint(k_t, (n,), 0, jeng.diffusion_steps)
        eps = jax.random.normal(k_eps, x.shape)
        lj = float(jeng.update(jnp.asarray(x), jnp.asarray(c))["loss"])
        lt = float(teng.update(torch.from_numpy(x), torch.from_numpy(c),
                               noise=(torch.from_numpy(np.array(t)).long(),
                                      torch.from_numpy(np.array(eps)), None))["loss"])
        np.testing.assert_allclose(lt, lj, rtol=TOL)
    want = np.asarray(jeng.state.params["condition"]["params"]["freqs"])
    got = agent_params_of(teng.params)["condition"]["params"]["freqs"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(want, freqs0 * (1 - lr * wd) ** steps, rtol=1e-6)


# ---------------------------------------------------------------------------
# backbones and classifiers
def test_mlp_nn_diffusion_matches_jax():
    x, t, emb = _x(B, 3), np.array([1.0, 5.0, 9.0], np.float32), _x(B, 8, seed=1)
    _check(jdiff.MlpNNDiffusion(x_dim=3, emb_dim=8, hidden_dims=(16, 16)),
           tdiff.MlpNNDiffusion(3, 8, (16, 16)), (x, t, emb), grad_args=(0, 2))


def test_dit1ref_matches_jax():
    x, t, emb = _x(B, 6, 2 * 3), np.array([0.1, 0.5, 0.9], np.float32), _x(B, 8, seed=1)
    jmod = jdiff.DiT1Ref(in_dim=3, emb_dim=8, d_model=16, n_heads=2, depth=2)
    tmod = tdiff.DiT1Ref(3, 8, 16, 2, 2)
    out = _check(jmod, tmod, (x, t, emb), grad_args=(0, 2))
    # the reference half passes through unchanged
    np.testing.assert_array_equal(out[..., :3].detach().numpy(), x[..., :3])
    assert not any(b.use_kernel for b in tmod.blocks)


def test_mlp_nn_classifier_matches_jax():
    x, t = _x(B, 3), np.array([0, 4, 7], np.int32)
    _check(jcls.MLPNNClassifier(x_dim=3, out_dim=2, emb_dim=8, hidden_dims=(16,)),
           tcls.MLPNNClassifier(3, 2, 8, (16,)), (x, t))


def test_half_dit1d_matches_jax():
    x, t, y = _x(B, 6, 4), np.array([0.2, 0.4, 0.8], np.float32), _x(B, 16, seed=1)
    tmod = tcls.HalfDiT1d(4, 1, 16, d_model=16, n_heads=2, depth=2)
    _check(jcls.HalfDiT1d(in_dim=4, out_dim=1, emb_dim=16, d_model=16, n_heads=2, depth=2),
           tmod, (x, t, y), grad_args=(0, 2))
    assert not any(b.use_kernel for b in tmod.blocks)


# ---------------------------------------------------------------------------
# inverse dynamics
O, A, N = 5, 2, 16


def _inv_pair(kind):
    if kind == "res":
        jinv = JaxResInv(O, A, 16, n_blocks=2, rng=1)
        tinv = ResInvDynamic(O, A, 16, n_blocks=2, device="cpu")
    else:
        jinv = JaxEnsembleInv(O, A, n_models=3, hidden_dim=16, rng=1)
        tinv = EnsembleMlpInvDynamic(O, A, n_models=3, hidden_dim=16, device="cpu")
    params = _seeded(jax.device_get(jinv.params), 7)
    jinv.params = jax.tree_util.tree_map(jnp.asarray, params)
    jinv.opt_state = jinv.tx.init(jinv.params)
    load_jax_params(tinv.net, params["params"])
    return jinv, tinv


@pytest.mark.parametrize("kind", ["res", "ensemble"])
def test_inverse_dynamics_predict_and_updates_match_jax(kind):
    jinv, tinv = _inv_pair(kind)
    rng = np.random.default_rng(8)
    o, o2 = _x(6, O, seed=9), _x(6, O, seed=10)
    _close(tinv.predict(torch.from_numpy(o), torch.from_numpy(o2)).numpy(),
           jinv.predict(jnp.asarray(o), jnp.asarray(o2)), "predict")
    for _ in range(3):
        o, o2 = (rng.standard_normal((N, O)).astype(np.float32) for _ in range(2))
        a = rng.uniform(-1, 1, (N, A)).astype(np.float32)
        want = float(jinv.update(jnp.asarray(o), jnp.asarray(a), jnp.asarray(o2))["loss"])
        got = float(tinv.update(*(torch.from_numpy(v) for v in (o, a, o2)))["loss"])
        np.testing.assert_allclose(got, want, rtol=TOL)
    _close_trees(jax_params_of(tinv.net), jax.device_get(jinv.params["params"]), "params")
    if kind == "ensemble":
        # one stacked parameter axis under one Adam; predict = the heads' mean
        assert tinv.net.l1.kernel.shape == (3, 2 * O, 16)
        assert len(tinv.optimizer.optimizer.param_groups[0]["params"]) == 6
        heads = tinv.net(torch.cat([torch.from_numpy(o), torch.from_numpy(o2)], -1))
        torch.testing.assert_close(tinv.predict(torch.from_numpy(o), torch.from_numpy(o2)),
                                   heads.mean(0))

"""bf16 on every backbone and condition: the PyTorch port against the JAX
package, on the same numpy-seeded weights (the JAX param tree converted by
utils/jax_params.py) and inputs.

What is held, per module, with the casts the engines make (the JAX package's
`apply_diffusion`: params `bf16_cast`, x and the condition embedding cast to
bf16, t as given; its SDE sampler also casts the condition's params, whose
input stays f32):

- the forward under `bf16_sampling`, port against JAX, max |diff| over the
  output's scale (at least 1) within BF16_PARITY_TOL, and the bf16 output
  is not the f32 one (so the comparison is of the bf16 path);
- under `bf16_training`, the loss mean((out - target)^2) within LOSS_TOL
  and the global norm of its gradient, f32 at the f32 params through the
  differentiable cast, within GRAD_NORM_TOL (relative);
- the conditions (`MLPCondition`, `PearceObsCondition`,
  `MultiImageObsCondition`) on bf16 params with their f32 input, as the SDE
  sampler runs them (under `bf16_training` the reference casts no
  condition: tests/test_torch_bf16_sampling.py holds that loss);
- K3's plain version (ops/film_resblock.py `film_resblock_reference`) on
  mixed (f32 x and emb, bf16 weights) and all-bf16 operands against
  `cleandiffuser_tpu/ops/film_resblock.py` `film_resblock_reference`.

The JAX side is jitted with XLA's `xla_allow_excess_precision` off
(`jit_exact`): with it on (the default), XLA's CPU compiler drops f32 ->
bf16 -> f32 convert pairs and skips roundings the source asks for
(tests/test_torch_bf16.py runs JAX op by op instead, `jax.disable_jit`,
which the option matches within 2.4e-7 of scale on the Janner U-Net at ~1/15
of the time). JAX params come from `jax.eval_shape` of the module's init,
every leaf seeded. Where both packages round the same values to bf16 (the
port's layers promote and round as flax's do, utils/blocks.py), what is left
is the order of f32 sums. Each tolerance gives the reading it was set from,
on this host's CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.diffusion.basic import bf16_cast as jax_bf16_cast
from cleandiffuser_tpu.nn_condition import MLPCondition as JaxMLPCondition
from cleandiffuser_tpu.nn_condition import PearceObsCondition as JaxPearceObs
from cleandiffuser_tpu.nn_condition import images as jimages
from cleandiffuser_tpu.nn_diffusion import ChiTransformer as JaxChiTransformer
from cleandiffuser_tpu.nn_diffusion import ChiUNet1d as JaxChiUNet
from cleandiffuser_tpu.nn_diffusion import DQLMlp as JaxDQLMlp
from cleandiffuser_tpu.nn_diffusion import DVInvMlp as JaxDVInvMlp
from cleandiffuser_tpu.nn_diffusion import IDQLMlp as JaxIDQLMlp
from cleandiffuser_tpu.nn_diffusion import JannerUNet1d as JaxJannerUNet
from cleandiffuser_tpu.nn_diffusion import PearceMlp as JaxPearceMlp
from cleandiffuser_tpu.nn_diffusion import PearceTransformer as JaxPearceTransformer
from cleandiffuser_tpu.nn_diffusion import SfBCUNet as JaxSfBCUNet
from cleandiffuser_tpu.ops.film_resblock import film_resblock_reference as jax_film_reference
from cleandiffuser_tpu_torch.diffusion.basic import bf16_cast
from cleandiffuser_tpu_torch.nn_condition import MLPCondition, PearceObsCondition
from cleandiffuser_tpu_torch.nn_condition import images as timages
from cleandiffuser_tpu_torch.nn_diffusion import (
    ChiTransformer,
    ChiUNet1d,
    DQLMlp,
    DVInvMlp,
    IDQLMlp,
    JannerUNet1d,
    PearceMlp,
    PearceTransformer,
    SfBCUNet,
)
from cleandiffuser_tpu_torch.ops.film_resblock import film_resblock_reference
from cleandiffuser_tpu_torch.utils.jax_params import load_jax_params
from test_torch_dql import _seeded as _seeded_leaves

torch.set_num_threads(1)

B, OBS, ACT, H, TO, TA = 4, 5, 3, 8, 2, 8
# the JAX package's bf16 against f32 bounds (tests/test_bf16_sampling.py:67-70, :105)
BF16_MAX, BF16_MEAN, BF16_LOSS_RTOL = 0.02, 0.005, 0.05
# port against JAX, both bf16 (tests/test_torch_bf16.py's limits): outputs,
# max |diff| over the scale (measured at most 7.0e-7, the Janner U-Net with
# linear attention; the conditions 1.5e-7); losses, relative (measured at
# most 4.1e-7); the gradient norm, relative (measured at most 3.9e-5, the
# Chi transformer: gradients that sum bf16 products in another order)
BF16_PARITY_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_NORM_TOL = 1e-4


def _rel(a, b):
    """max and mean |a - b| over the scale of b (at least 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    return np.abs(a - b).max() / scale, np.abs(a - b).mean() / scale


def jit_exact(fn, *args):
    """fn jitted and compiled with XLA's excess precision off: every bf16
    rounding the program asks for is made. Returns the compiled callable."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _seeded(module, *args, seed=1):
    """The module's params, every leaf seeded (test_torch_dql's rule), from
    the init's shapes alone."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return _seeded_leaves(zeros, seed)


def _bf16(a):
    return None if a is None else jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.bfloat16), a)


def _torch(a, dtype=None):
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _torch(v, dtype) for k, v in a.items()}
    t = torch.from_numpy(np.asarray(a))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


# ---------------------------------------------------------------------------
# backbones: (JAX module, port module, x, t, emb, apply kwargs), built small
def _inputs(seed, x_shape, emb_shape, T=10, int_t=True):
    rng = np.random.default_rng(seed)
    t = (rng.integers(0, T, (x_shape[0],)).astype(np.int32) if int_t
         else rng.uniform(0.05, 1.0, (x_shape[0],)).astype(np.float32))
    emb = None if emb_shape is None else rng.standard_normal(emb_shape).astype(np.float32)
    return rng.standard_normal(x_shape).astype(np.float32), t, emb


def _janner(attention, use_kernel, with_emb):
    kw = dict(in_dim=ACT + OBS, model_dim=16, emb_dim=16, dim_mult=(1, 2), attention=attention)
    return (JaxJannerUNet(**kw), JannerUNet1d(**kw, use_pallas_block=use_kernel),
            _inputs(0, (B, H, ACT + OBS), (B, 16) if with_emb else None))


def _chi_unet():
    kw = dict(act_dim=ACT, obs_dim=OBS, To=TO, model_dim=16, emb_dim=16, kernel_size=5,
              cond_predict_scale=True, obs_as_global_cond=True, dim_mult=(1, 2))
    return JaxChiUNet(**kw), ChiUNet1d(**kw), _inputs(1, (B, TA, ACT), (B, TO, OBS))


def _chi_transformer():
    kw = dict(act_dim=ACT, obs_dim=OBS, Ta=TA, To=TO, d_model=16, nhead=2, num_layers=2)
    return JaxChiTransformer(**kw), ChiTransformer(**kw), _inputs(2, (B, TA, ACT), (B, TO, OBS))


def _pearce_mlp():
    kw = dict(act_dim=ACT, To=TO, emb_dim=16, hidden_dim=32)
    return JaxPearceMlp(**kw), PearceMlp(**kw), _inputs(3, (B, ACT), (B, TO, 16))


def _pearce_transformer():
    kw = dict(act_dim=ACT, To=TO, emb_dim=16, trans_emb_dim=16, nhead=2)
    return (JaxPearceTransformer(**kw), PearceTransformer(**kw),
            _inputs(4, (B, ACT), (B, TO, 16)))


def _dql():
    return (JaxDQLMlp(obs_dim=OBS, act_dim=ACT, emb_dim=16), DQLMlp(OBS, ACT, emb_dim=16),
            _inputs(5, (B, ACT), (B, OBS)))


def _idql(final_mish):
    kw = dict(obs_dim=OBS, act_dim=ACT, emb_dim=16, hidden_dim=32, n_blocks=2, dropout=0.0,
              final_mish=final_mish)
    return JaxIDQLMlp(**kw), IDQLMlp(**kw), _inputs(6, (B, ACT), (B, OBS))


def _dv_inv():
    kw = dict(obs_dim=OBS, act_dim=ACT, emb_dim=16, hidden_dim=32)
    return JaxDVInvMlp(**kw), DVInvMlp(**kw), _inputs(7, (B, ACT), (B, 2 * OBS))


def _sfbc():
    kw = dict(act_dim=ACT, emb_dim=16, hidden_dims=(32, 16))
    return (JaxSfBCUNet(**kw), SfBCUNet(**kw),
            _inputs(8, (B, ACT), (B, 16), int_t=False))


BACKBONES = {
    # the fused block's plain version with a condition embedding; the
    # flax-style blocks with linear attention and none
    "janner-kernel-twin": lambda: _janner(False, True, True),
    "janner-attention": lambda: _janner(True, False, False),
    "chi_unet": _chi_unet,
    "chi_transformer": _chi_transformer,
    "pearce_mlp": _pearce_mlp,
    "pearce_transformer": _pearce_transformer,
    "dql_mlp": _dql,
    "idql_mlp": lambda: _idql(False),
    "new_idql_mlp": lambda: _idql(True),
    "dv_inv_mlp": _dv_inv,
    "sfbc_unet": _sfbc,
}


@pytest.fixture(scope="module")
def backbone_runs():
    """Per backbone: the f32 and bf16 forwards and the bf16_training loss
    and gradient norm in both packages, computed once for the module."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = _run_backbone(*BACKBONES[name]())
        return runs[name]

    return get


def _run_backbone(jmod, tmod, inputs):
    x, t, emb = inputs
    jx, jt, je = (None if a is None else jnp.asarray(a) for a in (x, t, emb))
    params = _seeded(jmod, jx, jt, je)
    load_jax_params(tmod, params)
    target = jnp.asarray(np.random.default_rng(9).standard_normal(x.shape).astype(np.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    def jloss(p):
        pred = jmod.apply({"params": jax_bf16_cast(p)}, jx.astype(jnp.bfloat16), jt,
                          _bf16(je)).astype(jnp.float32)
        return jnp.mean((pred - target) ** 2), pred

    j32 = np.asarray(jax.jit(lambda p: jmod.apply({"params": p}, jx, jt, je))(jp))
    grad_fn = jax.value_and_grad(jloss, has_aux=True)
    (l_j, j16), g_j = jit_exact(grad_fn, jp)(jp)
    gn_j = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(g_j))))
    with torch.no_grad():
        t32 = tmod(_torch(x), _torch(t), _torch(emb)).numpy()
    pred = torch.func.functional_call(
        tmod, bf16_cast(tmod), (_torch(x, torch.bfloat16), _torch(t),
                                _torch(emb, torch.bfloat16))).to(torch.float32)
    l_t = ((pred - _torch(np.asarray(target))) ** 2).mean()
    l_t.backward()
    gn_t = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in tmod.parameters()
                                if p.grad is not None)))
    return dict(f32=(j32, t32), bf16=(np.asarray(j16), pred.detach().numpy()),
                loss=(float(l_j), float(l_t.detach())), grad_norm=(gn_j, gn_t),
                grad_dtypes={p.grad.dtype for p in tmod.parameters() if p.grad is not None})


@pytest.mark.parametrize("name", list(BACKBONES))
def test_bf16_forward_matches_jax(name, backbone_runs):
    run = backbone_runs(name)
    j16, t16 = run["bf16"]
    assert t16.dtype == np.float32 and np.isfinite(t16).all()
    d_max, _ = _rel(t16, j16)
    assert d_max < BF16_PARITY_TOL, d_max
    # the bf16 path moved the output in both (so the comparison is of the
    # bf16 path); how far is the reference's own: up to 2.8e-2 of scale here
    # (PearceTransformer: its token BatchNorms amplify), so the JAX package's
    # bf16 against f32 bounds are held on its engines' samples instead
    # (test_torch_bf16_sampling.py)
    for side in (0, 1):
        assert _rel(run["bf16"][side], run["f32"][side])[0] > 1e-5, side


@pytest.mark.parametrize("name", list(BACKBONES))
def test_bf16_training_loss_and_grad_norm_match_jax(name, backbone_runs):
    run = backbone_runs(name)
    (l_j, l_t), (g_j, g_t) = run["loss"], run["grad_norm"]
    assert run["grad_dtypes"] == {torch.float32}  # gradients reach the f32 masters f32
    assert abs(l_t - l_j) / abs(l_j) < LOSS_TOL, (l_t, l_j)
    assert abs(g_t - g_j) / g_j < GRAD_NORM_TOL, (g_t, g_j)


# ---------------------------------------------------------------------------
# conditions: the SDE sampler's cast (bf16 params, the f32 condition as given)
IMG, CROP = 24, 20
SHAPE_META = {"obs": {"cam": {"shape": [3, IMG, IMG], "type": "rgb"},
                      "pos": {"shape": [3], "type": "low_dim"}}}


def _conditions(name):
    rng = np.random.default_rng(10)
    if name == "mlp":
        return (JaxMLPCondition(in_dim=OBS, out_dim=16, hidden_dims=(16,)),
                MLPCondition(OBS, 16, (16,)), rng.standard_normal((B, OBS)).astype(np.float32))
    if name == "pearce_obs":
        return (JaxPearceObs(obs_dim=OBS, emb_dim=16), PearceObsCondition(OBS, 16),
                rng.standard_normal((B, TO, OBS)).astype(np.float32))
    kw = dict(emb_dim=16, crop_shape=(CROP, CROP), use_seq=True, keep_horizon_dims=True)
    obs = {"cam": rng.uniform(0, 1, (2, TO, 3, IMG, IMG)).astype(np.float32),
           "pos": rng.standard_normal((2, TO, 3)).astype(np.float32)}
    return (jimages.MultiImageObsCondition(shape_meta=SHAPE_META, **kw),
            timages.MultiImageObsCondition(SHAPE_META, **kw), obs)


@pytest.mark.parametrize("name", ["mlp", "pearce_obs", "multi_image"])
def test_condition_on_bf16_params_matches_jax(name):
    """A condition on its bf16-cast params with its f32 input, as the SDE
    sampler runs it under `bf16_sampling`: f32 out, port against JAX within
    BF16_PARITY_TOL (measured at most 1.5e-7), and moved
    from the f32 output within the JAX package's bounds."""
    jmod, tmod, obs = _conditions(name)
    jobs = jax.tree_util.tree_map(jnp.asarray, obs)
    params = _seeded(jmod, jobs)
    load_jax_params(tmod, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    j16 = np.asarray(jit_exact(lambda p: jmod.apply({"params": jax_bf16_cast(p)}, jobs), jp)(jp))
    j32 = np.asarray(jax.jit(lambda p: jmod.apply({"params": p}, jobs))(jp))
    with torch.no_grad():
        t16 = torch.func.functional_call(tmod, bf16_cast(tmod), (_torch(obs),))
    assert t16.dtype == torch.float32
    d_max, _ = _rel(t16.numpy(), j16)
    assert d_max < BF16_PARITY_TOL, d_max
    d_max, d_mean = _rel(j16, j32)
    assert 1e-5 < d_max < BF16_MAX and d_mean < BF16_MEAN, (d_max, d_mean)


# ---------------------------------------------------------------------------
# K3's plain version against the JAX package's on bf16 and mixed operands
def _film_operands(Cin, Cout, types, seed=11, H=8, K=5):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0, mean=0.0: (mean + rng.standard_normal(s) * std).astype(np.float32)
    args = [f(B, H, Cin), f(B, Cout, std=0.5), f(K, Cin, Cout, std=(K * Cin) ** -0.5),
            f(Cout, std=0.1), f(Cout, std=0.1, mean=1.0), f(Cout, std=0.1),
            f(K, Cout, Cout, std=(K * Cout) ** -0.5), f(Cout, std=0.1),
            f(Cout, std=0.1, mean=1.0), f(Cout, std=0.1)]
    if Cin != Cout:
        args += [f(Cin, Cout, std=Cin ** -0.5), f(Cout, std=0.1)]
    bf16 = [i >= 2 or types[i] == "bf16" for i in range(len(args))]
    jin = [jnp.asarray(a, jnp.bfloat16) if b else jnp.asarray(a) for a, b in zip(args, bf16)]
    tin = [_torch(a, torch.bfloat16) if b else _torch(a) for a, b in zip(args, bf16)]
    return jin, tin


# x and emb types: mixed (the U-Net's later blocks), the first block's
# (bf16 x, f32 FiLM term) and all-bf16
FILM_TYPES = [("f32", "f32"), ("bf16", "f32"), ("bf16", "bf16")]


@pytest.mark.parametrize("types", FILM_TYPES, ids=["mixed", "bf16-x", "all-bf16"])
@pytest.mark.parametrize("Cin,Cout", [(23, 32), (32, 32)], ids=["skip", "identity"])
def test_film_block_reference_matches_jax(types, Cin, Cout):
    """On BF16 weights the port's plain version computes, in the promoted
    type of x and emb, what `cleandiffuser_tpu/ops/film_resblock.py`
    `film_resblock_reference` computes on the same operands (eps 1e-5, the
    JAX version's): within BF16_PARITY_TOL with f32 x and emb (both f32
    math on the BF16 weights; measured 3.6e-7 of max |out|); with BF16 x
    the port rounds as flax's block does (each conv, norm and Mish in BF16)
    where the JAX reference keeps its convs' f32 accumulators, so it is held
    to the JAX package's bf16 bounds (measured max 7.5e-3 and mean 7.3e-4)."""
    jin, tin = _film_operands(Cin, Cout, types)
    kw = dict(K=5, groups=8)
    want = np.asarray(jit_exact(lambda *a: jax_film_reference(*a, **kw), *jin)(*jin),
                      np.float32)
    got = film_resblock_reference(*tin, **kw, eps=1e-5)
    assert got.dtype == torch.promote_types(tin[0].dtype, tin[1].dtype)
    d_max, d_mean = _rel(got.float().numpy(), want)
    if types == ("f32", "f32"):
        assert d_max < BF16_PARITY_TOL, d_max
    else:
        assert d_max < BF16_MAX and d_mean < BF16_MEAN, (d_max, d_mean)

"""The port's Janner U-Net pieces (ops/film_resblock.py,
nn_diffusion/jannerunet.py, nn_classifier/half_nets.py, classifier/base.py)
against the JAX package's, on the same numpy-seeded weights and inputs.

On the CPU the fused block runs its plain PyTorch version; the CUDA kernel
itself is held against that plain version in tests/test_torch_kernels.py,
on a GPU. Tolerances: both sides compute in float32 and differ in the
order of sums (conv taps, GroupNorm statistics: flax takes E[x^2]-E[x]^2,
the port two passes); measured gaps are ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.classifier import CumRewClassifier as JaxCumRewClassifier
from cleandiffuser_tpu.classifier import MSEClassifier as JaxMSEClassifier
from cleandiffuser_tpu.nn_classifier import HalfJannerUNet1d as JaxHalfJannerUNet1d
from cleandiffuser_tpu.nn_diffusion import jannerunet as jax_unet
from cleandiffuser_tpu.ops.film_resblock import film_resblock_reference as jax_film_reference
from cleandiffuser_tpu_torch.classifier import CumRewClassifier, MSEClassifier
from cleandiffuser_tpu_torch.nn_classifier import HalfJannerUNet1d
from cleandiffuser_tpu_torch.nn_diffusion import jannerunet as unet
from cleandiffuser_tpu_torch.ops import film_resblock as ops
from cleandiffuser_tpu_torch.ops import film_resblock_vjp as vjp
from cleandiffuser_tpu_torch.utils.jax_params import jax_params_of, load_jax_params

torch.set_num_threads(1)

TOL = 1e-5
B, H = 3, 8


def _np(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _seeded(tree, seed, std=0.3):
    """Every leaf refilled with seeded normals: fresh GroupNorm scales (1)
    and biases (0) would hide a swapped or misplaced leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: _np(rng, *np.shape(a), std=std), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _film_inputs(Cin, Cout, K, film_scale, skip, seed=0):
    rng = np.random.default_rng(seed)
    x = _np(rng, B, H, Cin)
    emb = _np(rng, B, 2 * Cout if film_scale else Cout, std=0.5)
    ws = [_np(rng, K, Cin, Cout, std=(K * Cin) ** -0.5), _np(rng, Cout, std=0.1),
          1 + _np(rng, Cout, std=0.1), _np(rng, Cout, std=0.1),
          _np(rng, K, Cout, Cout, std=(K * Cout) ** -0.5), _np(rng, Cout, std=0.1),
          1 + _np(rng, Cout, std=0.1), _np(rng, Cout, std=0.1)]
    sk = [_np(rng, Cin, Cout, std=Cin ** -0.5), _np(rng, Cout, std=0.1)] if skip else [None, None]
    return x, emb, ws, sk


@pytest.mark.parametrize("film_scale", [False, True], ids=["film-add", "film-scale"])
@pytest.mark.parametrize("Cin,skip", [(5, True), (16, False)], ids=["skip-conv", "identity"])
def test_plain_version_matches_jax_reference(film_scale, Cin, skip):
    """torch film_resblock_reference == JAX film_resblock_reference, whose
    GroupNorm eps is 1e-5, in both FiLM modes, with and without a skip."""
    Cout, K = 16, 5
    x, emb, ws, sk = _film_inputs(Cin, Cout, K, film_scale, skip)
    want = jax_film_reference(
        jnp.asarray(x), jnp.asarray(emb), *map(jnp.asarray, ws),
        *(None if a is None else jnp.asarray(a) for a in sk),
        K=K, groups=4, film_scale=film_scale)
    got = ops.film_resblock_reference(
        torch.from_numpy(x), torch.from_numpy(emb), *map(torch.from_numpy, ws),
        *(None if a is None else torch.from_numpy(a) for a in sk),
        K=K, groups=4, film_scale=film_scale, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("skip", [True, False], ids=["skip-conv", "identity"])
def test_fused_block_backward_is_the_plain_gradient(skip):
    """`_FusedFiLMResBlock`'s backward (autograd through the plain version,
    recomputed from the saved inputs) gives the plain version's gradients,
    and None for inputs that need none; exercised through its backward
    alone (the forward needs a GPU)."""
    Cin, Cout, K = (5 if skip else 16), 16, 5
    x, emb, ws, sk = _film_inputs(Cin, Cout, K, False, skip)
    config = dict(K=K, groups=4, film_scale=False, eps=1e-6)
    args = [None if a is None else torch.from_numpy(a).requires_grad_(i != 0)
            for i, a in enumerate((x, emb, *ws, *sk))]  # x needs no gradient here

    class Ctx:
        saved_tensors = [None if a is None else a.detach() for a in args]
        needs_input_grad = tuple(a is not None and a.requires_grad for a in args) + (False,)

    Ctx.config = config
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((B, H, Cout))
                         .astype(np.float32))
    got = ops._FusedFiLMResBlock.backward(Ctx, g)
    ops.film_resblock_reference(*args, **config).backward(g)
    assert len(got) == 13 and got[0] is None and got[-1] is None
    for a, gr in zip(args[1:], got[1:-1]):
        if a is None:
            assert gr is None
        else:
            torch.testing.assert_close(gr, a.grad, atol=0, rtol=0)


class _Holder(torch.nn.Module):
    """One port module under a given flax name."""

    def __init__(self, name, module):
        super().__init__()
        self.m = module
        self.JAX_NAMES = {"m": name}


def _flax_vs_port(jmod, port, inputs, seed, name=None, *, kw=None):
    """Init the flax module, reseed its params, load them into the port
    module, and return (flax output, port output, seeded params)."""
    args = [jnp.asarray(a) for a in inputs]
    params = _seeded(jmod.init(jax.random.PRNGKey(0), *args), seed)
    want = np.asarray(jmod.apply(_jax(params), *args, **(kw or {})))
    holder = _Holder(name or f"{type(jmod).__name__}_0", port)
    load_jax_params(holder, {holder.JAX_NAMES["m"]: params["params"]})
    got = port(*(torch.from_numpy(a) for a in inputs))
    return want, got.detach().numpy(), params


@pytest.mark.parametrize("use_kernel", [False, True], ids=["flax-style", "fused-plain"])
@pytest.mark.parametrize("Cin,Cout,K", [(5, 16, 5), (16, 16, 3), (32, 8, 5)],
                         ids=["skip-K5", "identity-K3", "skip-2groups"])
def test_residual_block_matches_flax(use_kernel, Cin, Cout, K):
    """ResidualBlock1d (eps 1e-6, groups min(8, C/4)) on converted weights,
    through the flax-style layers and through the fused block's plain
    version."""
    rng = np.random.default_rng(1)
    x, emb = _np(rng, B, H, Cin), _np(rng, B, 12)
    jm = jax_unet.ResidualBlock1d(Cout, 12, K)
    port = unet.ResidualBlock1d(Cin, Cout, 12, K, use_kernel=use_kernel)
    want, got, params = _flax_vs_port(jm, port, (x, emb), 2)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    names = set(params["params"])
    assert names == {"Conv_0", "GroupNorm_0", "Dense_0", "Conv_1", "GroupNorm_1"} | (
        {"Conv_2"} if Cin != Cout else set())


def test_downsample_matches_flax():
    rng = np.random.default_rng(3)
    want, got, _ = _flax_vs_port(jax_unet.Downsample1d(12), unet.Downsample1d(12),
                                 (_np(rng, B, H, 12),), 4)
    assert got.shape == (B, H // 2, 12)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_upsample_matches_flax_through_the_flip():
    """flax ConvTranspose(4, stride 2, SAME) == torch ConvTranspose1d(4, 2, 1)
    on the K-flipped kernel; without the flip the outputs differ by O(1)."""
    rng = np.random.default_rng(5)
    x = _np(rng, B, H, 12)
    port = unet.Upsample1d(12)
    want, got, params = _flax_vs_port(jax_unet.Upsample1d(12), port, (x,), 6)
    assert got.shape == (B, 2 * H, 12)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    kernel = params["params"]["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(port.conv.weight.detach().numpy(),
                                  kernel[::-1].transpose(1, 2, 0))
    # the export undoes the flip
    np.testing.assert_array_equal(
        jax_params_of(_Holder("U", port))["U"]["ConvTranspose_0"]["kernel"], kernel)
    with torch.no_grad():  # the kernel copied without the flip
        port.conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(1, 2, 0))))
        unflipped = port(torch.from_numpy(x)).numpy()
    assert np.abs(unflipped - want).max() > 0.1


def test_converter_round_trips_conv_transpose():
    holder = _Holder("Upsample1d_0", unet.Upsample1d(6, torch.Generator().manual_seed(0)))
    tree = jax_params_of(holder)
    fresh = _Holder("Upsample1d_0", unet.Upsample1d(6, torch.Generator().manual_seed(1)))
    load_jax_params(fresh, tree)
    for a, b in zip(holder.state_dict().values(), fresh.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_linear_attention_matches_flax():
    rng = np.random.default_rng(7)
    want, got, _ = _flax_vs_port(jax_unet.LinearAttention(16), unet.LinearAttention(16),
                                 (_np(rng, B, H, 16),), 8)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


UNET = dict(model_dim=16, emb_dim=16, dim_mult=(1, 2), kernel_size=5)


@pytest.mark.parametrize("variant", ["plain", "fused", "attention", "layernorm"])
def test_jannerunet_matches_flax(variant):
    """The whole U-Net at model_dim 16, dim_mult (1, 2), horizon 8, on
    converted weights, with integer timesteps and a condition embedding."""
    rng = np.random.default_rng(9)
    D = 7
    x, emb = _np(rng, B, H, D), _np(rng, B, 16, std=0.3)
    t = np.array([0, 7, 19], np.int32)
    opts = dict(attention=variant == "attention",
                norm_type="layernorm" if variant == "layernorm" else "groupnorm")
    jm = jax_unet.JannerUNet1d(in_dim=D, **UNET, **opts)
    port = unet.JannerUNet1d(D, **UNET, **opts, use_pallas_block=variant == "fused")
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb))
    params = _seeded(jm.init(jax.random.PRNGKey(0), *args), 10, std=0.2)
    want = np.asarray(jm.apply(_jax(params), *args))
    load_jax_params(port, params["params"])
    got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(emb)).detach().numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # and the export is the flax tree's structure, leaf for leaf
    exported = jax_params_of(port)
    assert jax.tree_util.tree_structure(exported) == \
        jax.tree_util.tree_structure(params["params"])
    for a, b in zip(jax.tree_util.tree_leaves(exported),
                    jax.tree_util.tree_leaves(params["params"])):
        np.testing.assert_array_equal(a, b)


def test_jannerunet_fused_block_counts_no_launch_on_cpu():
    """With use_pallas_block on a CPU tensor every block takes the plain
    version: the kernel's launch count does not move."""
    net = unet.JannerUNet1d(7, **UNET, use_pallas_block=True)
    before = ops.fused_film_resblock.launches
    net(torch.zeros(2, H, 7), torch.zeros(2, dtype=torch.int32))
    assert ops.fused_film_resblock.launches == before


def _half_unet(seed=11, use_pallas_block=False):
    rng = np.random.default_rng(seed)
    D = 7
    x = _np(rng, B, H, D)
    t = np.array([0, 5, 19], np.int32)
    jm = JaxHalfJannerUNet1d(horizon=H, in_dim=D, out_dim=1, model_dim=16, emb_dim=16,
                             dim_mult=(1, 2), kernel_size=3)
    params = _seeded(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t)), seed + 1,
                     std=0.2)
    port = HalfJannerUNet1d(H, D, 1, kernel_size=3, model_dim=16, emb_dim=16, dim_mult=(1, 2),
                            use_pallas_block=use_pallas_block)
    load_jax_params(port, params["params"])
    return jm, params, port, x, t


def test_half_jannerunet_matches_flax():
    jm, params, port, x, t = _half_unet()
    want = np.asarray(jm.apply(_jax(params), jnp.asarray(x), jnp.asarray(t)))
    got = port(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
    assert got.shape == (B, 1) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind,use_pallas_block", [("cumrew", False), ("mse", False),
                                                    ("cumrew", True), ("mse", True)],
                         ids=["cumrew", "mse", "cumrew-vjp-op", "mse-vjp-op"])
def test_classifier_gradients_match_jax_grad(kind, use_pallas_block):
    """logp and d logp / dx of the classifier against the JAX classifier's
    `gradients` (jax.grad), on the same weights; from inside no_grad, as the
    sampler calls it. 1e-5 on the gradient: a backward pass through the
    same float32 math. With `use_pallas_block` the blocks go through
    `film_resblock_vjp_op` (on the CPU its closed-form plain versions), and
    none takes the plain block."""
    jm, params, port, x, t = _half_unet(13, use_pallas_block)
    plain_before = vjp.film_resblock_vjp_op.plain_backward
    c = np.random.default_rng(14).standard_normal((B, 1)).astype(np.float32)
    if kind == "cumrew":
        jc, tc = JaxCumRewClassifier(jm), CumRewClassifier(port, device="cpu")
    else:
        jc, tc = JaxMSEClassifier(jm, temperature=2.0), MSEClassifier(port, temperature=2.0, device="cpu")
    lp_j, g_j = jc.gradients(_jax(params), jnp.asarray(x), jnp.asarray(t), jnp.asarray(c))
    with torch.no_grad():
        lp_t, g_t = tc.gradients(tc.inference_params, torch.from_numpy(x),
                                 torch.from_numpy(t), torch.from_numpy(c))
    assert not (lp_t.requires_grad or g_t.requires_grad)
    assert np.abs(np.asarray(g_j)).max() > 1e-3
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=TOL, rtol=TOL)
    assert vjp.film_resblock_vjp_op.plain_backward == plain_before


# ---------------------------------------------------------------------------
# The classifier's block differentiated with respect to x (ops/film_resblock_vjp.py)

# (H, Cin, Cout, K) of the ten residual blocks of the shipped Diffuser's
# classifier (HalfJannerUNet1d: obs 17 + act 6 = 23 channels in, model_dim 32,
# dim_mult (1, 2, 2, 2), the two mid blocks at K = 5)
CLASSIFIER_BLOCKS = [(32, 23, 32, 3), (32, 32, 32, 3), (16, 32, 64, 3), (16, 64, 64, 3),
                     (8, 64, 128, 3), (8, 128, 128, 3), (4, 128, 256, 3), (4, 256, 256, 3),
                     (4, 256, 128, 5), (2, 128, 64, 5)]
CLASSIFIER_IDS = [f"h{h}-{i}-{o}-k{k}" for h, i, o, k in CLASSIFIER_BLOCKS]


def _vjp_case(shape, seed=21):
    """Seeded f32 inputs of a classifier block (groups as the net builds
    them) and a cotangent of its output."""
    H_, Cin, Cout, K = shape
    x, emb, ws, sk = _film_inputs(Cin, Cout, K, False, Cin != Cout, seed)
    x = _np(np.random.default_rng(seed), B, H_, Cin)
    g = _np(np.random.default_rng(seed + 1), B, H_, Cout)
    return x, emb, ws, sk, g, dict(K=K, groups=min(8, Cout // 4))


def _input_grad_args(ws, sk):
    """The input gradient's weights, from the block's: w1, g1s, g1b, w2,
    g2s, g2b, wskip."""
    return (ws[0], ws[2], ws[3], ws[4], ws[6], ws[7], sk[0])


@pytest.mark.parametrize("shape", CLASSIFIER_BLOCKS, ids=CLASSIFIER_IDS)
def test_vjp_plain_version_matches_autograd(shape):
    """The kernels' plain versions at each classifier block shape: the
    forward (its output, and n1, n2 as GroupNorm's normalised values) equals
    `film_resblock_reference`, and the closed-form input gradient from its
    residuals equals autograd through `film_resblock_reference`."""
    x, emb, ws, sk, g, kw = _vjp_case(shape)
    t = lambda a: None if a is None else torch.from_numpy(a)
    xt = t(x).requires_grad_(True)
    args = (t(emb), *map(t, ws), *map(t, sk))
    ref = ops.film_resblock_reference(xt, *args, **kw, eps=1e-6)
    (want,) = torch.autograd.grad(ref, xt, t(g))
    out, res = vjp.film_resblock_vjp_forward_reference(t(x), *args, **kw, eps=1e-6)
    torch.testing.assert_close(out, ref.detach(), atol=TOL, rtol=TOL)
    n1, r1, n2, r2 = res
    assert n1.shape == n2.shape == out.shape and r1.shape == r2.shape == (B, kw["groups"])
    # a normalised group has mean 0 and mean square var / (var + eps) ~ 1
    grouped = n2.reshape(B, shape[0], kw["groups"], -1)
    np.testing.assert_allclose(grouped.mean(dim=(1, 3)).numpy(), 0, atol=1e-5)
    np.testing.assert_allclose((grouped ** 2).mean(dim=(1, 3)).numpy(), 1, atol=1e-3)
    got = vjp.film_resblock_input_grad_reference(t(g), *res, *map(t, _input_grad_args(ws, sk)),
                                                 **kw)
    assert np.abs(want.numpy()).max() > 0.1
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", CLASSIFIER_BLOCKS, ids=CLASSIFIER_IDS)
def test_vjp_plain_version_matches_jax_vjp(shape):
    """The plain forward and input gradient against `jax.vjp` of the JAX
    package's `film_resblock_reference` (GroupNorm eps 1e-5) on the same
    inputs and cotangent."""
    x, emb, ws, sk, g, kw = _vjp_case(shape, seed=22)
    jargs = [jnp.asarray(emb), *map(jnp.asarray, ws),
             *(None if a is None else jnp.asarray(a) for a in sk)]
    want_out, pullback = jax.vjp(lambda xx: jax_film_reference(xx, *jargs, **kw), jnp.asarray(x))
    (want,) = pullback(jnp.asarray(g))
    t = lambda a: None if a is None else torch.from_numpy(a)
    out, res = vjp.film_resblock_vjp_forward_reference(t(x), t(emb), *map(t, ws), *map(t, sk),
                                                       **kw, eps=1e-5)
    got = vjp.film_resblock_input_grad_reference(t(g), *res, *map(t, _input_grad_args(ws, sk)),
                                                 **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_vjp_op_routes_by_what_needs_a_gradient():
    """`film_resblock_vjp_op` on the CPU: only x needing a gradient takes the
    autograd Function (its closed-form input gradient, the caller's plain
    block never called); nothing needing one, the plain forward; a weight
    needing one, the caller's plain block, counted in `plain_backward`
    only while x needs a gradient too. No kernel counter moves."""
    x, emb, ws, sk, g, kw = _vjp_case((8, 16, 32, 3))
    t = lambda a: None if a is None else torch.from_numpy(a)
    args = [t(emb), *map(t, ws), *map(t, sk)]
    counters = lambda: (vjp.fused_film_resblock_vjp_forward.launches,
                        vjp.fused_film_resblock_input_grad.launches, ops.fused_film_resblock.launches)
    before, plain_before = counters(), vjp.film_resblock_vjp_op.plain_backward

    def never():
        raise AssertionError("the plain block was taken")

    xt = t(x).requires_grad_(True)
    out = vjp.film_resblock_vjp_op(xt, *args, **kw, eps=1e-6, plain=never)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("_FiLMResBlockVJP")
    (got,) = torch.autograd.grad(out, xt, t(g))
    ref = ops.film_resblock_reference(xt, *args, **kw, eps=1e-6)
    (want,) = torch.autograd.grad(ref, xt, t(g))
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    with torch.no_grad():
        out0 = vjp.film_resblock_vjp_op(xt, *args, **kw, eps=1e-6, plain=never)
    torch.testing.assert_close(out0, ref.detach(), atol=TOL, rtol=TOL)
    assert vjp.film_resblock_vjp_op.plain_backward == plain_before

    args[2].requires_grad_(True)  # b1
    calls = []
    plain = lambda: calls.append(1) or ops.film_resblock_reference(xt, *args, **kw, eps=1e-6)
    vjp.film_resblock_vjp_op(xt, *args, **kw, eps=1e-6, plain=plain)
    assert calls == [1] and vjp.film_resblock_vjp_op.plain_backward == plain_before + 1
    vjp.film_resblock_vjp_op(t(x), *args, **kw, eps=1e-6, plain=plain)  # x needs none
    assert calls == [1, 1] and vjp.film_resblock_vjp_op.plain_backward == plain_before + 1
    assert counters() == before


def test_half_jannerunet_vjp_blocks_match_flax():
    """`HalfJannerUNet1d(use_pallas_block=True)`: every residual block goes
    through `film_resblock_vjp_op`, and the net's forward still matches
    flax's on the same weights, with and without grad on x."""
    jm, params, port, x, t = _half_unet(use_pallas_block=True)
    assert all(b.vjp_kernel and not b.use_kernel for b in port.blocks) and len(port.blocks) == 6
    want = np.asarray(jm.apply(_jax(params), jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    port.requires_grad_(False)
    got = port(torch.from_numpy(x).requires_grad_(True), torch.from_numpy(t))
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=TOL)


def test_classifier_update_with_the_flag_is_unchanged():
    """The classifier's own training (`update`) with `use_pallas_block` takes
    the plain block (the weights need gradients): the same loss, gradients
    and updated weights, bit for bit, as the net built without the flag;
    `plain_backward` counts the blocks whose input needed a gradient."""
    rng = np.random.default_rng(30)
    xs = torch.from_numpy(_np(rng, B, H, 7))
    t = torch.tensor([1, 4, 9])
    R = torch.from_numpy(_np(rng, B, 1))
    runs = []
    for flag in (False, True):
        _, _, port, _, _ = _half_unet(17, use_pallas_block=flag)
        clf = CumRewClassifier(port, device="cpu")
        plain_before = vjp.film_resblock_vjp_op.plain_backward
        grads = list(torch.autograd.grad(clf.loss(clf.params, xs, t, R),
                                         list(clf.params.parameters())))
        logs = [clf.update(xs, t, R)["loss"] for _ in range(2)]
        # the net's input needs no gradient in training, every later block's
        # input does: 5 of the 6 blocks counted in each of the 3 forwards
        assert vjp.film_resblock_vjp_op.plain_backward - plain_before == (15 if flag else 0)
        runs.append((logs, grads, [p.detach().clone() for p in clf.params.parameters()]))
    (l0, g0, p0), (l1, g1, p1) = runs
    for a, b in zip(l0 + g0 + p0, l1 + g1 + p1):
        torch.testing.assert_close(a, b, atol=0, rtol=0)

"""The port's image condition encoders (nn_condition/images.py) against the
JAX package's, on the same seeded weights and images.

- `_ResBlock2d` with and without downsampling (the 1x1 stride-2 skip at
  both parities of H), `SpatialSoftmax` (H != W, a learned temperature),
  the GN-ResNet18 and `MultiImageObsCondition` (two rgb keys and a low_dim
  key, `use_seq` on and off; 40 x 40 images cropped to 36, where the
  ResNet ends at 2 x 2): the forward in float32 within 1e-5 of the
  output's scale, or, where float32 rounding decides, the port's distance
  from JAX's float64 run within twice JAX's own and within 1e-5 of the
  scale (unless JAX's own exceeds that: the ResNet's depth rounds ~1e-5
  of the scale in either package); both float64 runs within 1e-9 of the
  scale.
- Training mode with the crops injected on both sides (a stand-in for the
  JAX module's `random_crop`; the port's `CROP_KEY` entry): the forward as
  above, and the gradient of a loss on it in float64 on both sides within
  1e-9 of the largest element, with every conv's gradient non-zero.
- `random_crop` at JAX's own offsets (its `split` / `randint` draws)
  equals JAX's crop exactly, on (B, C, H, W) and (B, T, C, H, W);
  `center_crop` too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleandiffuser_tpu.nn_condition.images as jimages
from cleandiffuser_tpu_torch.nn_condition import images as timages
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, load_jax_params
from test_torch_dp_dbc_image import _JaxCrops, _seeded

torch.set_num_threads(2)

TOL, F64_TOL = 1e-5, 1e-9
IMG, CROP, B, TO = 40, 36, 2, 2
SHAPE_META = {"obs": {"cam_b": {"shape": [3, IMG, IMG], "type": "rgb"},
                      "cam_a": {"shape": [3, IMG, IMG], "type": "rgb"},
                      "pos": {"shape": [3], "type": "low_dim"}}}


def _jax_run(module, params, *args, f64=False, **kw):
    """module.apply on `params` in float32, or in float64 (params and
    inputs widened) with float64 enabled."""
    if not f64:
        return np.asarray(jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))(
            params, *args))
    w = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
    with jax.enable_x64(True):
        return np.asarray(jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))(
            w(params), *w(args)))


def _assert_forward_close(got, want, got64, want64):
    """The module note's forward rule."""
    scale = np.abs(want64).max()
    np.testing.assert_allclose(got64, want64, atol=F64_TOL * scale, rtol=0)
    if np.abs(got - want).max() <= TOL * scale:
        return
    # float32 rounding decides: the port held to JAX's float64 run
    jax_err, port_err = np.abs(want - want64).max(), np.abs(got - want64).max()
    assert port_err <= 2 * jax_err and (port_err <= TOL * scale or jax_err > TOL * scale), (
        np.abs(got - want).max(), jax_err, port_err, scale)


def _params(module, *args):
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, *args))
    return _seeded(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                          shapes["params"]), 3)


def _pair_forward(jmod, tmod, x_nhwc):
    """JAX on NHWC, the port on NCHW; outputs compared by the forward rule."""
    params = _params(jmod, jnp.asarray(x_nhwc))
    load_jax_params(tmod, params)
    x = torch.from_numpy(np.moveaxis(x_nhwc, -1, 1).copy())
    got = tmod(x).detach().numpy()
    got64 = tmod.double()(x.double()).detach().numpy()
    return got, got64, _jax_run(jmod, params, x_nhwc), _jax_run(jmod, params, x_nhwc, f64=True)


@pytest.mark.parametrize("downsample,h", [(False, 10), (True, 10), (True, 9)])
def test_resblock_matches_jax(downsample, h):
    c_in, c_out = 16, 32 if downsample else 16
    x = np.random.default_rng(0).standard_normal((B, h, h + 2, c_in)).astype(np.float32)
    jmod = jimages._ResBlock2d(c_out, downsample)
    got, got64, want, want64 = _pair_forward(jmod, timages.ResBlock2d(c_in, c_out, downsample),
                                             x)
    want, want64 = np.moveaxis(want, -1, 1), np.moveaxis(want64, -1, 1)
    assert got.shape == want.shape == (B, c_out, (h + 1) // 2 if downsample else h,
                                       (h + 3) // 2 if downsample else h + 2)
    _assert_forward_close(got, want, got64, want64)


def test_spatial_softmax_matches_jax():
    x = np.random.default_rng(1).standard_normal((B, 3, 5, 4)).astype(np.float32) * 3
    jmod, tmod = jimages.SpatialSoftmax(), timages.SpatialSoftmax()
    params = {"temperature": np.array([0.7], np.float32)}
    load_jax_params(tmod, params)
    got = tmod(torch.from_numpy(np.moveaxis(x, -1, 1).copy())).detach().numpy()
    want = _jax_run(jmod, params, x)
    assert got.shape == want.shape == (B, 4, 2)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # x runs along W (the first coordinate), y along H
    peak = np.full((1, 3, 5, 1), -50.0, np.float32)
    peak[0, 0, 4, 0] = 50.0
    kp = tmod(torch.from_numpy(np.moveaxis(peak, -1, 1).copy())).detach().numpy()[0, 0]
    np.testing.assert_allclose(kp, [1.0, -1.0], atol=1e-6)


def test_resnet18_matches_jax():
    x = np.random.default_rng(2).uniform(0, 1, (B, CROP, CROP, 3)).astype(np.float32)
    jmod = jimages.ResNet18(CROP, 3, 32)
    params = _params(jmod, jnp.asarray(np.moveaxis(x, -1, 1)))
    tmod = timages.ResNet18(3, 32)
    load_jax_params(tmod, params)
    xc = np.moveaxis(x, -1, 1).copy()
    got = tmod(torch.from_numpy(xc)).detach().numpy()
    got64 = tmod.double()(torch.from_numpy(xc).double()).detach().numpy()
    want, want64 = _jax_run(jmod, params, xc), _jax_run(jmod, params, xc, f64=True)
    assert got.shape == want.shape == (B, 32)
    _assert_forward_close(got, want, got64, want64)


def _obs(seed, seq: bool):
    rng = np.random.default_rng(seed)
    lead = (B, TO) if seq else (B,)
    return {"cam_a": rng.uniform(0, 1, lead + (3, IMG, IMG)).astype(np.float32),
            "cam_b": rng.uniform(0, 1, lead + (3, IMG, IMG)).astype(np.float32),
            "pos": rng.standard_normal(lead + (3,)).astype(np.float32)}


def _modules(seq: bool):
    kw = dict(emb_dim=16, crop_shape=(CROP, CROP), use_seq=seq, keep_horizon_dims=True)
    jmod = jimages.MultiImageObsCondition(shape_meta=SHAPE_META, **kw)
    return jmod, timages.MultiImageObsCondition(SHAPE_META, **kw)


@pytest.mark.parametrize("seq", [False, True])
def test_multi_image_condition_matches_jax(seq):
    jmod, tmod = _modules(seq)
    obs = _obs(3, seq)
    params = _params(jmod, jax.tree_util.tree_map(jnp.asarray, obs))
    assert set(params) == {"ResNet18_0", "ResNet18_1", "Dense_0", "Dense_1"}
    load_jax_params(tmod, params)
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    got = tmod(tobs).detach().numpy()
    got64 = tmod.double()({k: v.double() for k, v in tobs.items()}).detach().numpy()
    want, want64 = _jax_run(jmod, params, obs), _jax_run(jmod, params, obs, f64=True)
    assert got.shape == want.shape == ((B, TO, 16) if seq else (B, 16))
    _assert_forward_close(got, want, got64, want64)
    # the port's layout carries back to flax's
    back = jax.tree_util.tree_leaves_with_path(agent_params_of(
        torch.nn.ModuleDict({"c": tmod.float()}))["c"]["params"])
    assert [p for p, _ in back] == [p for p, _ in jax.tree_util.tree_leaves_with_path(params)]


def test_training_crops_and_float64_gradient_match_jax():
    """Training mode, crops injected: the forward, then d/dparams of
    sum(out * w) in float64 on both sides."""
    jmod, tmod = _modules(True)
    obs = _obs(4, True)
    params = _params(jmod, jax.tree_util.tree_map(jnp.asarray, obs))
    load_jax_params(tmod, params)
    rng = np.random.default_rng(5)
    crops = {k: (rng.integers(0, IMG - CROP + 1, B * TO), rng.integers(0, IMG - CROP + 1, B * TO))
             for k in ("cam_a", "cam_b")}
    weights = rng.standard_normal((B, TO, 16))
    jax_crops = _JaxCrops()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jimages, "random_crop", jax_crops)
        rngs = {"dropout": jax.random.PRNGKey(7)}
        jax_crops.queue += [crops["cam_a"], crops["cam_b"]]  # the rgb keys' sorted order
        want = _jax_run(jmod, params, obs, train=True, rngs=rngs)
        with jax.enable_x64(True):
            w64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
            jax_crops.queue += [crops["cam_a"], crops["cam_b"]] * 2
            apply = lambda p: jmod.apply({"params": p}, w64(obs), train=True, rngs=rngs)
            want64, grads = jax.jit(lambda p: (apply(p), jax.grad(
                lambda q: (apply(q) * weights).sum())(p)))(w64(params))
            want64 = np.asarray(want64)
        assert not jax_crops.queue
    cond = {k: torch.from_numpy(v) for k, v in obs.items()}
    got = tmod({**cond, timages.CROP_KEY: crops}, train=True).detach().numpy()
    tmod.double()
    out64 = tmod({**{k: v.double() for k, v in cond.items()}, timages.CROP_KEY: crops},
                 train=True)
    (out64 * torch.from_numpy(weights)).sum().backward()
    _assert_forward_close(got, want, out64.detach().numpy(), want64)
    port_g = {k: p.grad for k, p in tmod.named_parameters()}
    grads = jax.tree_util.tree_map(np.asarray, grads)
    tree = agent_params_of(torch.nn.ModuleDict({"c": _with_grads(tmod, port_g)}))["c"]["params"]
    top = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(grads))
    got_l, want_l = (jax.tree_util.tree_leaves_with_path(t) for t in (tree, grads))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, atol=F64_TOL * top, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        if "Conv" in jax.tree_util.keystr(path):
            assert np.abs(b).max() > 0, jax.tree_util.keystr(path)


def _with_grads(module, grads):
    """A copy of `module` whose parameters hold `grads`."""
    import copy

    out = copy.deepcopy(module)
    with torch.no_grad():
        for k, p in out.named_parameters():
            p.copy_(grads[k])
    return out


@pytest.mark.parametrize("shape", [(3, 3, 12, 10), (2, 2, 3, 12, 10)])
def test_random_crop_at_jax_offsets_is_exact(shape):
    img = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jimages.random_crop(key, jnp.asarray(img), 7, 5))
    kh, kw = jax.random.split(key)
    b = shape[0]
    top = np.asarray(jax.random.randint(kh, (b,), 0, shape[-2] - 7 + 1))
    left = np.asarray(jax.random.randint(kw, (b,), 0, shape[-1] - 5 + 1))
    got = timages.random_crop(torch.from_numpy(img), 7, 5, offsets=(top, left)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timages.center_crop(torch.from_numpy(img), 7, 5).numpy(),
                                  np.asarray(jimages.center_crop(jnp.asarray(img), 7, 5)))
    # drawn from a generator: within range, per sample
    g = torch.Generator().manual_seed(0)
    drawn = timages.random_crop(torch.from_numpy(img), 7, 5, generator=g)
    assert drawn.shape == shape[:-2] + (7, 5)

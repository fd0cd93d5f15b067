"""The image encoders that no pipeline uses (nn_condition/images.py)
against the JAX package's, on the same seeded weights and images, sized as
tests/test_image_conditions.py sizes them (64 px, batch 2):

- `ResNet18ImageCondition` on 4D and 5D input, with a keep-mask;
- `ResNet18MultiViewImageCondition` on 5D and 6D input (one ResNet18 per
  view);
- `SmallStem` and `EarlyConvViTMultiViewImageCondition` (2 views, To 2,
  lowdim tokens, the readout out): the forward and the gradient with
  respect to the images and the lowdim input;
- the average-pool head of the GN-ResNet18 at 224 px, batch 1 (the
  smallest size whose final map reaches the 7 x 7 pool), and the error at
  64 px, where the reference's init fails too.

Each within 1e-4 of the JAX value's scale (max |JAX value|): float32 on
both sides, convolutions summed in another order through ~20 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleandiffuser_tpu.nn_condition.images as jimages
from cleandiffuser_tpu_torch.nn_condition import images as timages
from cleandiffuser_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(2)
TOL = 1e-4
IMG, B = 64, 2


def _seeded(tree, seed):
    """Seeded normals: kernels at std 1/sqrt(fan-in) (all axes but the
    last), norm scales 1 + 0.1 N, other vectors 0.1 N (the zero-initialised
    token embeddings included)."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        z = rng.standard_normal(np.shape(a))
        name = jax.tree_util.keystr(path)
        if np.ndim(a) >= 2 and not name.endswith("_emb']") and "view_emb" not in name:
            return (z / np.sqrt(np.prod(np.shape(a)[:-1]))).astype(np.float32)
        return (z * 0.1 + (1.0 if name.endswith("['scale']") else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _params(jmod, args, seed=0):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    return _seeded(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                          shapes["params"]), seed)


def _close(got, want, label=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=label)


def _images(*shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _pair(jmod, tmod, args, seed=0):
    params = _params(jmod, args, seed)
    load_jax_params(tmod, params)
    return params


def test_resnet18_image_condition_matches_jax():
    jmod = jimages.ResNet18ImageCondition(image_sz=IMG, in_channel=3, emb_dim=32)
    tmod = timages.ResNet18ImageCondition(IMG, 3, 32)
    x5 = _images(B, 2, 3, IMG, IMG)
    params = _pair(jmod, tmod, (x5,))
    run = jax.jit(lambda p, x, m: jmod.apply({"params": p}, x, mask=m))
    mask = np.array([1.0, 0.0], np.float32)
    with torch.no_grad():
        got5 = tmod(torch.from_numpy(x5), mask=torch.from_numpy(mask))
        got4 = tmod(torch.from_numpy(x5[:, 0]))
    assert got5.shape == (B, 2, 32) and got4.shape == (B, 32)
    _close(got5.numpy(), run(params, x5, mask), "5D")
    assert torch.all(got5[1] == 0)
    # the 4D input is the 5D input's first frame, through the same net
    _close(got4.numpy(), run(params, x5, np.ones(B, np.float32))[:, 0], "4D")


def test_resnet18_multiview_condition_matches_jax():
    jmod = jimages.ResNet18MultiViewImageCondition(image_sz=IMG, in_channel=3, emb_dim=16,
                                                   n_views=2)
    tmod = timages.ResNet18MultiViewImageCondition(IMG, 3, 16, 2)
    x6 = _images(B, 2, 2, 3, IMG, IMG, seed=1)
    params = _pair(jmod, tmod, (x6,))
    want6 = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(params, x6)
    with torch.no_grad():
        got6 = tmod(torch.from_numpy(x6))
        got5 = tmod(torch.from_numpy(x6[:, :, 1]))
    assert got6.shape == (B, 2, 2, 16) and got5.shape == (B, 2, 16)
    _close(got6.numpy(), want6, "6D")
    _close(got5.numpy(), np.asarray(want6)[:, :, 1], "5D")
    # one net per view
    assert not torch.equal(tmod.nets[0].dense2.weight, tmod.nets[1].dense2.weight)


def test_small_stem_matches_jax():
    jmod = jimages.SmallStem(d_model=32)
    tmod = timages.SmallStem(3, 32)
    x = _images(B, 3, IMG, IMG, seed=2)
    params = _pair(jmod, tmod, (x,))
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(params, x)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (B, 16, 32)  # 64 px: four stride-2 convs to 4 x 4 tokens
    _close(got.numpy(), want)


def test_early_conv_vit_matches_jax():
    jmod = jimages.EarlyConvViTMultiViewImageCondition(
        image_sz=(IMG, IMG), in_channels=(3, 3), lowdim_sz=9, To=2, d_model=64, nhead=4,
        num_layers=2)
    tmod = timages.EarlyConvViTMultiViewImageCondition(
        (IMG, IMG), (3, 3), lowdim_sz=9, To=2, d_model=64, nhead=4, num_layers=2)
    image = _images(B, 2, 2, 3, IMG, IMG, seed=3)
    lowdim = np.random.default_rng(4).standard_normal((B, 2, 9)).astype(np.float32)
    params = _pair(jmod, tmod, ({"image": image, "lowdim": lowdim},))
    w = np.random.default_rng(5).standard_normal((B, 64)).astype(np.float32)

    def loss(p, image, lowdim):
        out = jmod.apply({"params": p}, {"image": image, "lowdim": lowdim})
        return (out * w).sum(), out

    (_, want), (g_img, g_low) = jax.jit(jax.value_and_grad(loss, (1, 2), has_aux=True))(
        params, image, lowdim)
    ti, tl = (torch.from_numpy(a).requires_grad_() for a in (image, lowdim))
    got = tmod({"image": ti, "lowdim": tl})
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (B, 64)
    _close(got.detach().numpy(), want, "readout")
    _close(ti.grad.numpy(), g_img, "image grad")
    _close(tl.grad.numpy(), g_low, "lowdim grad")
    # the readout sees every token under the causal mask: each view moves it
    with torch.no_grad():
        moved = tmod({"image": ti.detach() * torch.tensor([1.0, 0.5])[None, :, None, None,
                                                                      None, None],
                      "lowdim": tl.detach()})
    assert (moved - got.detach()).abs().max() > 1e-3


def test_average_pool_head_matches_jax():
    jmod = jimages.ResNet18(image_sz=224, in_channel=3, emb_dim=16, use_spatial_softmax=False)
    tmod = timages.ResNet18(3, 16, image_sz=224, use_spatial_softmax=False)
    x = _images(1, 3, 224, 224, seed=6)
    params = _pair(jmod, tmod, (x,))
    assert params["Dense_0"]["kernel"].shape == (512, 16)  # the 7 x 7 map pooled to 1 x 1
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(params, x)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    _close(got.numpy(), want)
    assert timages.resnet18_final_size(224) == 7 and timages.resnet18_final_size(256) == 8
    # the reference's init fails below a 7 x 7 final map; so does the port's
    small = jimages.ResNet18(image_sz=IMG, in_channel=3, emb_dim=16, use_spatial_softmax=False)
    with pytest.raises(ZeroDivisionError):
        jax.eval_shape(lambda: small.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, IMG, IMG))))
    with pytest.raises(ValueError, match="7 x 7"):
        timages.ResNet18(3, 16, image_sz=IMG, use_spatial_softmax=False)

"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked `gpu` and skips without a CUDA device. This file
imports no JAX, so it runs on a machine that has only PyTorch; there, skip
the repository's conftest (which sets up JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q

TF32 is off in every comparison, so both sides compute in full float32.
"""

import numpy as np
import pytest
import torch

from cleandiffuser_tpu_torch.nn_diffusion import DiT1d, JannerUNet1d
from cleandiffuser_tpu_torch.ops import dit_block as ops
from cleandiffuser_tpu_torch.ops import film_resblock as film
from cleandiffuser_tpu_torch.ops import solver_update as su

# the same f32 math on both sides, summed in another order: a few 1e-6
# relative at these widths
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, H, D, seed=7):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32)).to(dev)
    return f(B, H, D), f(B, 6 * D), [f(D, 3 * D), f(3 * D), f(D, D), f(D),
                                     f(D, 4 * D), f(4 * D), f(4 * D, D), f(D)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 8, 64, 4), (6, 20, 96, 3), (3, 40, 64, 2),
                                   (100, 32, 320, 10), (3200, 32, 320, 10), (2, 33, 64, 2),
                                   (133, 32, 320, 10), (3, 20, 320, 5), (100, 64, 320, 10),
                                   (133, 64, 320, 10)],
                         ids=["test-size", "ragged-H", "H-over-32", "plan-size", "candidate-batch",
                              "one-row-into-a-new-pass", "one-block-past-a-wave", "head-dim-64",
                              "antmaze-horizon", "one-cluster-past-a-wave"])
def test_dit_block_kernel_matches_plain(cuda, shape):
    """H > 32 runs on a cluster of two thread blocks of 32 rows, which read
    each other's keys and values: H = 33 puts one row into the second."""
    B, H, D, NH = shape
    x, mod, ws = _inputs(cuda, B, H, D)
    before = ops.fused_dit_block.launches
    out = ops.fused_dit_block(x, mod, *ws, n_heads=NH)
    torch.cuda.synchronize()
    assert ops.fused_dit_block.launches == before + 1
    torch.testing.assert_close(out, ops.dit_block_reference(x, mod, *ws, n_heads=NH),
                               atol=TOL, rtol=TOL)


@pytest.mark.gpu
def test_dit_block_kernel_rejects_what_it_does_not_take(cuda):
    x, mod, ws = _inputs(cuda, 2, 8, 64)
    with pytest.raises(TypeError):
        ops.fused_dit_block(x.double(), mod, *ws, n_heads=4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_dit_block(x.transpose(0, 1).contiguous().transpose(0, 1), mod, *ws, n_heads=4)
    with pytest.raises(ValueError, match="multiple"):
        ops.fused_dit_block(x, mod, *ws, n_heads=3)
    with pytest.raises(ValueError, match="at most 320"):
        # 352 columns would need 242 KB of shared memory per thread block
        xl, modl, wsl = _inputs(cuda, 1, 8, 352)
        ops.fused_dit_block(xl, modl, *wsl, n_heads=11)
    with pytest.raises(ValueError, match="head dim"):
        ops.fused_dit_block(x, mod, *ws, n_heads=16)
    with pytest.raises(ValueError, match="at most 64"):
        xl, modl, wsl = _inputs(cuda, 1, 72, 64)
        ops.fused_dit_block(xl, modl, *wsl, n_heads=4)


def _precision_inputs(dev, B, H, D, seed=0):
    """x + 10 and weights of mean 0.05 (std fan_in^-0.5): LN subtracts a
    large common offset and every product is a long same-sign sum."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std, mean=0.0: torch.from_numpy(
        (mean + rng.standard_normal(s) * std).astype(np.float32)).to(dev)
    x = f(B, H, D, std=1.0) + 10.0
    ws = [f(D, 3 * D, std=D ** -0.5, mean=0.05), f(3 * D, std=0.1),
          f(D, D, std=D ** -0.5, mean=0.05), f(D, std=0.1),
          f(D, 4 * D, std=D ** -0.5, mean=0.05), f(4 * D, std=0.1),
          f(4 * D, D, std=(4 * D) ** -0.5, mean=0.05), f(D, std=0.1)]
    return x, f(B, 6 * D, std=0.5), ws


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(100, 32, 320, 10), (6, 20, 96, 3), (10, 64, 320, 10)],
                         ids=["plan-size", "ragged-H", "antmaze-horizon"])
def test_dit_block_kernel_precision_case(cuda, shape):
    """Held to the plain version in float64, within 1e-4 of max |ref|:
    here plain f32 itself misses float64 by ~4e-5 of it element by element
    (1e-4 per element cannot hold on either side). Emulated on the CPU
    (tests/test_torch_dit_tf32.py), the block in 3xTF32 lands at ~4e-5 and
    one TF32 product at ~9e-4, so a 1xTF32 kernel fails here."""
    B, H, D, NH = shape
    x, mod, ws = _precision_inputs(cuda, B, H, D)
    out = ops.fused_dit_block(x, mod, *ws, n_heads=NH)
    ref = ops.dit_block_reference(x.double(), mod.double(), *(w.double() for w in ws), n_heads=NH)
    err = (out.double() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL, err


@pytest.mark.gpu
def test_dit1d_through_kernel_matches_plain_with_gradient(cuda):
    """A DiT1d whose blocks launch the kernel against the same net on the
    plain version: outputs, and the gradients the autograd Function's
    plain-version backward gives."""
    gen = torch.Generator().manual_seed(0)
    nets = [DiT1d(5, 32, 64, 4, 2, timestep_emb_type="fourier", use_pallas_block=k,
                  generator=torch.Generator().manual_seed(0)) for k in (True, False)]
    rng = np.random.default_rng(1)
    with torch.no_grad():  # non-zero adaLN weights, identical in both nets
        for p_k, p_p in zip(nets[0].parameters(), nets[1].parameters()):
            v = torch.from_numpy((rng.standard_normal(p_k.shape) * 0.1).astype(np.float32))
            p_k.copy_(v)
            p_p.copy_(v)
    nets = [n.to(cuda) for n in nets]
    x = torch.randn(4, 8, 5, generator=gen).to(cuda)
    t = torch.rand(4, generator=gen).to(cuda)
    outs, grads = [], []
    for net in nets:
        before = ops.fused_dit_block.launches
        out = net(x, t, None)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([p.grad for p in net.parameters()])
        assert ops.fused_dit_block.launches - before == (2 if net is nets[0] else 0)
    torch.testing.assert_close(outs[0], outs[1], atol=TOL, rtol=TOL)
    for g_k, g_p in zip(*grads):  # None for the Fourier frequencies in both
        torch.testing.assert_close(g_k, g_p, atol=1e-3, rtol=1e-3)


def _max_rel_diff(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


@pytest.mark.gpu
def test_dit1d_gradients_through_kernel_at_training_shape(cuda):
    """DD's training shape: a DiT1d at full width (d_model 320, 10 heads,
    depth 2) on a batch of 64 x 32, through the kernel's autograd Function
    against the plain block: the loss, and the gradient of every parameter.
    The backward recomputes the plain block, so the two differ only through
    the forward's ~1e-5 (upstream gradients and each block's input); 1e-3
    of each gradient's largest entry leaves margin, and a wiring error (a
    gradient for the wrong input) is O(1). The key bias's gradient is
    rounding noise in both (softmax ignores it), so it is held in absolute
    terms, to 1e-3 of the largest gradient of its block."""
    nets = [DiT1d(17, 128, 320, 10, 2, timestep_emb_type="fourier", use_pallas_block=k,
                  generator=torch.Generator().manual_seed(0)) for k in (True, False)]
    rng = np.random.default_rng(2)
    with torch.no_grad():  # non-zero adaLN weights, identical in both nets
        for p_k, p_p in zip(nets[0].parameters(), nets[1].parameters()):
            fan = p_k.shape[0] if p_k.dim() == 2 else 10.0
            v = rng.standard_normal(p_k.shape) / np.sqrt(fan)
            p_k.copy_(torch.from_numpy(v.astype(np.float32)))
            p_p.copy_(p_k)
    nets = [n.to(cuda) for n in nets]
    x = torch.from_numpy(rng.standard_normal((64, 32, 17)).astype(np.float32)).to(cuda)
    target = torch.from_numpy(rng.standard_normal((64, 32, 17)).astype(np.float32)).to(cuda)
    t = torch.from_numpy(rng.uniform(0, 1, 64).astype(np.float32)).to(cuda)
    losses = []
    for net in nets:
        before = ops.fused_dit_block.launches
        loss = ((net(x, t, None) - target) ** 2).mean()
        loss.backward()
        losses.append(loss.detach())
        assert ops.fused_dit_block.launches - before == (2 if net is nets[0] else 0)
    torch.testing.assert_close(losses[0], losses[1], atol=0, rtol=1e-5)
    D = 320
    for (name, p_k), p_p in zip(nets[0].named_parameters(), nets[1].parameters()):
        if name.endswith("freqs"):  # no gradient reaches them, in either net
            assert p_k.grad is None and p_p.grad is None
            continue
        if name.endswith("bqkv"):
            block_max = p_p.grad.abs().max()
            assert (p_k.grad[D:2 * D] - p_p.grad[D:2 * D]).abs().max() <= 1e-3 * block_max, name
            p_k.grad[D:2 * D] = p_p.grad[D:2 * D]
        assert _max_rel_diff(p_k.grad, p_p.grad) < 1e-3, name


# ---------------------------------------------------------------------------
# K1's BF16 route: BF16 weights and biases, f32 or BF16 x and mod
# The JAX package's bound for its bf16 kernel against the plain block
# (tests/test_pallas_ops.py:136): the BF16 MMAs round each product's
# activations to bf16, which the mixed plain version does not
BF16_TOL = 5e-2


def _unit_inputs(dev, B, H, D, seed=7):
    """Inputs at a trained DiT block's scales: x of unit std, mod of 0.5,
    weights of std fan_in^-1/2, biases of 0.1 (BF16_TOL is the bf16 error's
    bound for such inputs; it is not a bound relative to larger ones)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std: torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32)).to(dev)
    return f(B, H, D, std=1.0), f(B, 6 * D, std=0.5), [
        f(D, 3 * D, std=D ** -0.5), f(3 * D, std=0.1), f(D, D, std=D ** -0.5), f(D, std=0.1),
        f(D, 4 * D, std=D ** -0.5), f(4 * D, std=0.1), f(4 * D, D, std=(4 * D) ** -0.5),
        f(D, std=0.1)]


def _typed(x, mod, ws, route):
    """The inputs in the route's types: "f32" as they are, "mixed" with
    BF16 weights and biases, "bf16" all BF16."""
    if route == "f32":
        return x, mod, ws
    ws = [w.to(torch.bfloat16) for w in ws]
    if route == "bf16":
        x, mod = x.to(torch.bfloat16), mod.to(torch.bfloat16)
    return x, mod, ws


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["f32", "mixed", "bf16"])
@pytest.mark.parametrize("shape", [(4, 8, 64, 4), (6, 20, 96, 3), (100, 32, 320, 10),
                                   (2, 33, 64, 2), (100, 64, 320, 10)],
                         ids=["test-size", "ragged-H", "plan-size", "one-row-into-a-new-pass",
                              "antmaze-horizon"])
def test_dit_block_routes_match_plain(cuda, route, shape):
    """`dit_block_op` launches the route the types name, once, on its own
    counter; the output has x's type and holds to the plain version on the
    same inputs (f32: TOL; BF16 weights: BF16_TOL). D = 320 takes D / 32 =
    10 stages per product, D = 96 an odd 3."""
    B, H, D, NH = shape
    x, mod, ws = _typed(*_unit_inputs(cuda, B, H, D), route)
    counts = (ops.fused_dit_block.launches, ops.fused_dit_block_bf16.launches)
    with torch.no_grad():
        out = ops.dit_block_op(x, mod, *ws, n_heads=NH)
    torch.cuda.synchronize()
    bf16_route = route != "f32"
    assert (ops.fused_dit_block.launches - counts[0],
            ops.fused_dit_block_bf16.launches - counts[1]) == (int(not bf16_route),
                                                               int(bf16_route))
    assert out.dtype == x.dtype and out.shape == x.shape
    ref = ops.dit_block_reference(x, mod, *ws, n_heads=NH)
    tol = BF16_TOL if bf16_route else TOL
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_dit_block_bf16_route_rejects_other_types(cuda):
    """Exactly three type combinations: f32 weights with BF16 x, BF16
    weights with x and mod of different types, and mixed weight types
    raise; each wrapper takes only its own route."""
    x, mod, ws = _inputs(cuda, 2, 8, 64)
    wb = [w.to(torch.bfloat16) for w in ws]
    with pytest.raises(TypeError):
        ops.dit_block_op(x.to(torch.bfloat16), mod.to(torch.bfloat16), *ws, n_heads=4)
    with pytest.raises(TypeError):
        ops.dit_block_op(x.to(torch.bfloat16), mod, *wb, n_heads=4)
    with pytest.raises(TypeError):
        ops.dit_block_op(x, mod, *wb[:-1], ws[-1], n_heads=4)
    with pytest.raises(TypeError):
        ops.fused_dit_block(x, mod, *wb, n_heads=4)
    with pytest.raises(TypeError):
        ops.fused_dit_block_bf16(x, mod, *ws, n_heads=4)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["mixed", "bf16"])
def test_dit_block_bf16_gradients_through_kernel(cuda, route):
    """`_FusedDiTBlock` with BF16 weights: the forward launches the BF16
    route; the backward is autograd through the plain version on the same
    inputs, so the gradients equal the plain version's (BF16 for BF16
    inputs) up to the order of sums, and come back in each input's type."""
    x, mod, ws = _typed(*_unit_inputs(cuda, 64, 32, 320), route)
    inputs = [a.clone().requires_grad_(True) for a in (x, mod, *ws)]
    g = torch.randn(inputs[0].shape, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    g = g.to(inputs[0].dtype)
    before = ops.fused_dit_block_bf16.launches
    out = ops.dit_block_op(*inputs, n_heads=10)
    assert ops.fused_dit_block_bf16.launches == before + 1
    got = torch.autograd.grad(out, inputs, g)
    want = torch.autograd.grad(ops.dit_block_reference(*inputs, n_heads=10), inputs, g)
    # the same plain backward on the same inputs; cuBLAS may sum in another
    # order from one call to the next, which moves a BF16 gradient by an ulp
    # (2^-8 of an entry)
    for a, b, inp in zip(got, want, inputs):
        assert a.dtype == b.dtype == inp.dtype
        assert (a.float() - b.float()).abs().max() <= 1e-2 * b.float().abs().max()


@pytest.mark.gpu
def test_dit1d_bf16_sampling_and_training_launch_the_bf16_route(cuda):
    """An engine with `bf16_sampling` and `bf16_training`: every DiT block
    of a plan and of a training step launches the BF16 route and none the
    f32 one; the params, the EMA and the optimizer state stay f32."""
    from cleandiffuser_tpu_torch.diffusion import ContinuousDiffusionSDE

    net = DiT1d(5, 32, 64, 4, 2, timestep_emb_type="fourier", use_pallas_block=True,
                generator=torch.Generator().manual_seed(0))
    eng = ContinuousDiffusionSDE(net, device=cuda)
    eng.bf16_sampling = eng.bf16_training = True
    counts = (ops.fused_dit_block.launches, ops.fused_dit_block_bf16.launches)
    x, _ = eng.build_sample_fn(sample_steps=3)(eng.ema_params, torch.Generator(cuda).manual_seed(0),
                                               torch.zeros(4, 8, 5, device=cuda))
    eng.update(torch.randn(4, 8, 5, device=cuda))
    torch.cuda.synchronize()
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
    assert (ops.fused_dit_block.launches - counts[0],
            ops.fused_dit_block_bf16.launches - counts[1]) == (0, 3 * 2 + 2)
    assert all(p.dtype == torch.float32 for p in eng.params.parameters())
    assert all(p.dtype == torch.float32 for p in eng.ema_params.parameters())
    assert all(v.dtype == torch.float32 for s in eng.optimizer.optimizer.state.values()
               for v in s.values() if v.is_floating_point() and v.dim() > 0)


# ---------------------------------------------------------------------------
# K3: the fused FiLM residual block
def _film_inputs(dev, B, H, Cin, Cout, K, film_scale, seed=3, x_offset=0.0, w_mean=0.0):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0, mean=0.0: torch.from_numpy(
        (mean + rng.standard_normal(s) * std).astype(np.float32)).to(dev)
    x = f(B, H, Cin) + x_offset
    emb = f(B, 2 * Cout if film_scale else Cout, std=0.5)
    ws = [f(K, Cin, Cout, std=(K * Cin) ** -0.5, mean=w_mean), f(Cout, std=0.1),
          1 + f(Cout, std=0.1), f(Cout, std=0.1),
          f(K, Cout, Cout, std=(K * Cout) ** -0.5, mean=w_mean), f(Cout, std=0.1),
          1 + f(Cout, std=0.1), f(Cout, std=0.1)]
    skip = [f(Cin, Cout, std=Cin ** -0.5), f(Cout, std=0.1)] if Cin != Cout else [None, None]
    return x, emb, ws, skip


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (7, 32, 23, 32, 5, 8, False), (6, 32, 32, 32, 5, 8, False), (5, 4, 512, 128, 5, 8, False),
    (9, 4, 256, 256, 5, 8, False), (3, 8, 256, 64, 5, 8, False), (11, 16, 128, 32, 5, 8, False),
    (4, 8, 16, 16, 3, 4, True), (5, 16, 23, 48, 3, 8, True)],
    ids=["cin23", "h32", "cin512", "c256", "h8-skip", "ragged-B", "film-scale",
         "cout48-film-scale"])
def test_film_resblock_kernel_matches_plain(cuda, shape):
    """Shapes of the shipped U-Net (Cin = 23 is not a multiple of 4) and
    others, at a batch that does not fill the last thread block, both FiLM
    modes, with and without the skip conv; eps 1e-6 as the U-Net uses."""
    B, H, Cin, Cout, K, G, film_scale = shape
    x, emb, ws, skip = _film_inputs(cuda, B, H, Cin, Cout, K, film_scale)
    kw = dict(K=K, groups=G, film_scale=film_scale, eps=1e-6)
    before = film.fused_film_resblock.launches
    out = film.fused_film_resblock(x, emb, *ws, *skip, **kw)
    torch.cuda.synchronize()
    assert film.fused_film_resblock.launches == before + 1
    torch.testing.assert_close(out, film.film_resblock_reference(x, emb, *ws, *skip, **kw),
                               atol=TOL, rtol=TOL)


def _check_film(dev, B, H, Cin, Cout, K=5, G=8, **inputs):
    x, emb, ws, skip = _film_inputs(dev, B, H, Cin, Cout, K, False, **inputs)
    kw = dict(K=K, groups=G, eps=1e-6)
    before = film.fused_film_resblock.launches
    out = film.fused_film_resblock(x, emb, *ws, *skip, **kw)
    torch.cuda.synchronize()
    assert film.fused_film_resblock.launches == before + 1
    torch.testing.assert_close(out, film.film_resblock_reference(x, emb, *ws, *skip, **kw),
                               atol=TOL, rtol=TOL)


# (H, Cin, Cout) of the 14 distinct residual blocks of the shipped Diffuser
# U-Net (obs 17 + act 6 = 23 channels in, model_dim 32, dim_mult (1, 2, 2, 2))
UNET_SHAPES = [(32, 23, 32), (32, 32, 32), (16, 32, 64), (16, 64, 64), (8, 64, 128),
               (8, 128, 128), (4, 128, 256), (4, 256, 256), (4, 512, 128), (4, 128, 128),
               (8, 256, 64), (8, 64, 64), (16, 128, 32), (16, 32, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", UNET_SHAPES, ids=[f"h{h}-{i}-{o}" for h, i, o in UNET_SHAPES])
def test_film_resblock_kernel_at_unet_shapes(cuda, shape):
    """Every block shape of the shipped U-Net, at a batch of one full thread
    block (64 rows: 64 / H samples) and 3 samples of a second."""
    H, Cin, Cout = shape
    _check_film(cuda, 64 // H + 3, H, Cin, Cout)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(17, 4, 256, 256), (5, 8, 256, 512)],
                         ids=["64-rows", "32-rows-cout512"])
def test_film_resblock_kernel_one_sample_into_a_new_tile(cuda, shape):
    """A batch that ends one sample into a new thread block: 16 samples of
    H = 4 fill a 64-row block, 4 samples of H = 8 a 32-row one (Cout > 256)."""
    _check_film(cuda, *shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(5, 4, 512, 128), (7, 32, 23, 32)], ids=["cin512", "cin23"])
def test_film_resblock_kernel_precision_case(cuda, shape):
    """x + 10 and conv weights of mean 0.05: the conv outputs share a large
    mean, which GroupNorm subtracts, so any rounding of the products is
    amplified. Emulated on the CPU (tests/test_torch_film_tf32.py), the
    block in 3xTF32 misses float64 by ~1e-5 at cin512 and ~2e-6 at cin23,
    10x and more inside the 1e-4 tolerance; one TF32 product misses by
    ~6e-3 and ~8e-3, so a 1xTF32 kernel fails here."""
    _check_film(cuda, *shape, x_offset=10.0, w_mean=0.05)


@pytest.mark.gpu
def test_film_resblock_kernel_rejects_shapes_it_does_not_tile(cuda):
    """Cout must be a multiple of 8 (the MMA's n) and H must divide the
    rows of a thread block, which owns whole samples."""
    x, emb, ws, skip = _film_inputs(cuda, 2, 8, 16, 20, 5, False)
    with pytest.raises(ValueError, match="multiple of 8"):
        film.fused_film_resblock(x, emb, *ws, *skip, K=5, groups=4)
    x, emb, ws, skip = _film_inputs(cuda, 2, 12, 16, 32, 5, False)
    with pytest.raises(ValueError, match="must divide"):
        film.fused_film_resblock(x, emb, *ws, *skip, K=5, groups=8)


@pytest.mark.gpu
def test_film_resblock_kernel_rejects_what_it_does_not_take(cuda):
    x, emb, ws, skip = _film_inputs(cuda, 2, 8, 16, 32, 5, False)
    kw = dict(K=5, groups=8)
    with pytest.raises(TypeError):
        film.fused_film_resblock(x.double(), emb, *ws, *skip, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        film.fused_film_resblock(x.transpose(0, 1).contiguous().transpose(0, 1), emb, *ws,
                                 *skip, **kw)
    with pytest.raises(ValueError, match="odd"):
        film.fused_film_resblock(x, emb, *ws, *skip, K=4, groups=8)
    with pytest.raises(RuntimeError, match="backward"):
        film.fused_film_resblock(x.requires_grad_(True), emb, *ws, *skip, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 23, 32), (4, 256, 256)], ids=["h32-23-32", "h4-256-256"])
def test_film_resblock_gradients_through_kernel(cuda, shape):
    """Two shipped U-Net block shapes at the training batch of 64: through
    `film_resblock_op` (the kernel's autograd Function: kernel forward,
    plain-version backward) against the plain version, the output and the
    gradient of every input, one launch; the kernel's own wrapper still
    raises on an input that needs a gradient."""
    H, Cin, Cout = shape
    x, emb, ws, skip = _film_inputs(cuda, 64, H, Cin, Cout, 5, False)
    inputs = [a.requires_grad_(True) for a in (x, emb, *ws, *skip) if a is not None]
    args = [x, emb, *ws, *skip]
    kw = dict(K=5, groups=8, eps=1e-6)
    g = torch.randn(64, H, Cout, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    before = film.fused_film_resblock.launches
    out = film.film_resblock_op(*args, **kw)
    assert film.fused_film_resblock.launches == before + 1
    ref = film.film_resblock_reference(*args, **kw)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    got = torch.autograd.grad(out, inputs, g)
    want = torch.autograd.grad(ref, inputs, g)
    # the same plain backward on the same inputs, but cuDNN may sum in
    # another order from one call to the next (measured: 4.8e-7 at most)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    with pytest.raises(RuntimeError, match="backward"):
        film.fused_film_resblock(*args, **kw)


@pytest.mark.gpu
def test_jannerunet_through_kernel_matches_plain(cuda):
    """A JannerUNet1d whose blocks launch the kernel against the same net on
    the flax-style path: 8 launches per call, one per residual block."""
    nets = [JannerUNet1d(7, model_dim=16, emb_dim=16, dim_mult=(1, 2), kernel_size=5,
                         use_pallas_block=k, generator=torch.Generator().manual_seed(0))
            for k in (True, False)]
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p_k, p_p in zip(nets[0].parameters(), nets[1].parameters()):
            v = torch.from_numpy((rng.standard_normal(p_k.shape) * 0.2).astype(np.float32))
            p_k.copy_(v)
            p_p.copy_(v)
    nets = [n.to(cuda) for n in nets]
    x = torch.from_numpy(rng.standard_normal((6, 8, 7)).astype(np.float32)).to(cuda)
    t = torch.tensor([0, 3, 7, 11, 15, 19], dtype=torch.int32, device=cuda)
    before = film.fused_film_resblock.launches
    with torch.no_grad():
        out_k, out_p = nets[0](x, t), nets[1](x, t)
    assert film.fused_film_resblock.launches - before == len(nets[0].blocks) == 8
    torch.testing.assert_close(out_k, out_p, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# K2: the fused solver update
@pytest.mark.gpu
def test_solver_update_kernel_without_noise_matches_plain(cuda):
    rng = np.random.default_rng(4)
    xt, eps = (torch.from_numpy(rng.standard_normal((100, 32, 23)).astype(np.float32)).to(cuda)
               for _ in range(2))
    coefs = (1.07, -0.31, 0.0)
    out = su.fused_solver_update(xt, eps, coefs, 1)
    torch.testing.assert_close(out, su.solver_update_reference(xt, eps, coefs),
                               atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_solver_update_kernel_noise_is_seeded_standard_normal(cuda):
    """z = (out - c_xt*xt - c_eps*eps) / c_noise over 2.4 M draws: mean and
    std within 5e-3 of N(0, 1) (about 7 standard errors); the seed fixes
    the draws."""
    rng = np.random.default_rng(5)
    xt, eps = (torch.from_numpy(rng.standard_normal((3200, 32, 23)).astype(np.float32)).to(cuda)
               for _ in range(2))
    coefs = (0.98, -0.05, 0.2)
    a = su.fused_solver_update(xt, eps, coefs, 11)
    torch.testing.assert_close(a, su.fused_solver_update(xt, eps, coefs, 11), atol=0, rtol=0)
    assert not torch.equal(a, su.fused_solver_update(xt, eps, coefs, 12))
    z = ((a.double() - coefs[0] * xt.double() - coefs[1] * eps.double()) / coefs[2])
    assert abs(z.mean().item()) < 5e-3 and abs(z.std().item() - 1) < 5e-3

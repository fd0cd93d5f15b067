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
from cleandiffuser_tpu_torch.pipelines import DiffuserPipeline
from cleandiffuser_tpu_torch.ops import dit_block as ops
from cleandiffuser_tpu_torch.ops import film_resblock as film
from cleandiffuser_tpu_torch.ops import film_resblock_vjp as vjp
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
def test_dit_block_autograd_at_antmaze_training_shape(cuda):
    """DD antmaze's training forward, (64, 64, 320) on 2-block clusters,
    through `dit_block_op` (kernel forward, plain-version backward) against
    the plain block: the output within TOL, one launch, and the gradient of
    every input within 1e-4 of its largest entry (the backward recomputes
    the plain block from the same inputs)."""
    x, mod, ws = _unit_inputs(cuda, 64, 64, 320)
    inputs = [t.requires_grad_(True) for t in (x, mod, *ws)]
    g = torch.randn(64, 64, 320, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    before = ops.fused_dit_block.launches
    out = ops.dit_block_op(*inputs, n_heads=10)
    assert ops.fused_dit_block.launches == before + 1
    ref = ops.dit_block_reference(*inputs, n_heads=10)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    for a, b in zip(torch.autograd.grad(out, inputs, g), torch.autograd.grad(ref, inputs, g)):
        assert _max_rel_diff(a, b) < 1e-4


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


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["mixed", "bf16"])
@pytest.mark.parametrize("shape", [(1, 32, 320, 10), (101, 32, 320, 10), (6, 20, 320, 10),
                                   (4, 33, 96, 3), (3, 64, 64, 2), (5, 20, 320, 5)],
                         ids=["one-trajectory", "ragged-last-tile", "three-per-tile",
                              "odd-heads-H-33", "D-64-H-64", "head-dim-64"])
def test_dit_block_bf16_route_tile_edges(cuda, route, shape):
    """The BF16 route's 64-row tiles at their edges: B = 1 (one tile, one
    trajectory), B = 101 (a last tile with one trajectory of two), H = 20
    (three trajectories a tile, rows 60-63 spare), H = 33 and 64 (one
    trajectory a tile) with D = 96 and 3 heads (two warpgroups' columns past
    D) and D = 64, and a head dim of 64."""
    B, H, D, NH = shape
    x, mod, ws = _typed(*_unit_inputs(cuda, B, H, D), route)
    before = ops.fused_dit_block_bf16.launches
    out = ops.fused_dit_block_bf16(x, mod, *ws, n_heads=NH)
    torch.cuda.synchronize()
    assert ops.fused_dit_block_bf16.launches == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    ref = ops.dit_block_reference(x, mod, *ws, n_heads=NH)
    torch.testing.assert_close(out.float(), ref.float(), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.gpu
def test_dit_block_bf16_route_replays_in_a_cuda_graph(cuda):
    """The route's tensor maps travel as kernel parameters, so a captured
    call replays: the replay on new inputs equals an eager call on them."""
    x, mod, ws = _typed(*_unit_inputs(cuda, 100, 32, 320), "mixed")
    x2, mod2, _ = _typed(*_unit_inputs(cuda, 100, 32, 320, seed=8), "mixed")
    ops.fused_dit_block_bf16(x, mod, *ws, n_heads=10)  # built and loaded before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.fused_dit_block_bf16(x, mod, *ws, n_heads=10)
    x.copy_(x2)
    mod.copy_(mod2)
    graph.replay()
    eager = ops.fused_dit_block_bf16(x2, mod2, *ws, n_heads=10)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 8, 352, 11), (1, 8, 288, 4), (1, 65, 64, 2)],
                         ids=["D-352", "head-dim-72", "H-65"])
def test_dit_block_bf16_route_rejects_what_it_does_not_take(cuda, shape):
    """CUDA tensors of a shape the kernel does not take raise ValueError
    before any launch: neither route's counter moves."""
    B, H, D, NH = shape
    x, mod, ws = _typed(*_unit_inputs(cuda, B, H, D), "mixed")
    counts = (ops.fused_dit_block.launches, ops.fused_dit_block_bf16.launches)
    with pytest.raises(ValueError):
        ops.fused_dit_block_bf16(x, mod, *ws, n_heads=NH)
    with pytest.raises(ValueError):
        ops.dit_block_op(x, mod, *ws, n_heads=NH)
    assert (ops.fused_dit_block.launches, ops.fused_dit_block_bf16.launches) == counts


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


# (H, Cin, Cout) of the distinct residual blocks of the shipped Diffuser and
# AdaptDiffuser U-Nets of the antmaze suite (obs 29 + act 8 = 37 channels in,
# model_dim 64, dim_mult (1, 2, 2, 2), horizon 64) and of the kitchen suite
# (obs 60 + act 9 = 69 in, horizon 32): channels 64 to 512, H = 64 at the top
ANTMAZE_UNET_SHAPES = [(64, 37, 64), (64, 64, 64), (32, 64, 128), (32, 128, 128),
                       (16, 128, 256), (16, 256, 256), (8, 256, 512), (8, 512, 512),
                       (8, 1024, 256), (8, 256, 256), (16, 512, 128), (16, 128, 128),
                       (32, 256, 64), (32, 64, 64)]
KITCHEN_UNET_SHAPES = [(32, 69, 64), (32, 64, 64), (16, 64, 128), (16, 128, 128),
                       (8, 128, 256), (8, 256, 256), (4, 256, 512), (4, 512, 512),
                       (4, 1024, 256), (4, 256, 256), (8, 512, 128), (8, 128, 128),
                       (16, 256, 64), (16, 64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ANTMAZE_UNET_SHAPES + KITCHEN_UNET_SHAPES,
                         ids=[f"antmaze-h{h}-{i}-{o}" for h, i, o in ANTMAZE_UNET_SHAPES]
                         + [f"kitchen-h{h}-{i}-{o}" for h, i, o in KITCHEN_UNET_SHAPES])
def test_film_resblock_kernel_at_model_dim_64_shapes(cuda, shape):
    """The antmaze and kitchen U-Nets' blocks: H = 64 runs one sample per
    64-row thread block, Cout = 512 four (H = 8) or eight (H = 4) samples
    per 32-row block, Cin = 1024 streams through the x ring; at two full
    thread blocks and 3 samples of a third."""
    H, Cin, Cout = shape
    rows = 32 if Cout > 256 else 64
    _check_film(cuda, 2 * rows // H + 3, H, Cin, Cout)


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
# The classifier's block differentiated with respect to x: the forward with
# residuals and the input gradient (ops/film_resblock_vjp.py)

# (H, Cin, Cout, K) of the ten residual blocks of the shipped Diffuser's
# classifier (HalfJannerUNet1d: 23 channels in, model_dim 32, dim_mult
# (1, 2, 2, 2), the mid blocks at K = 5)
CLASSIFIER_BLOCKS = [(32, 23, 32, 3), (32, 32, 32, 3), (16, 32, 64, 3), (16, 64, 64, 3),
                     (8, 64, 128, 3), (8, 128, 128, 3), (4, 128, 256, 3), (4, 256, 256, 3),
                     (4, 256, 128, 5), (2, 128, 64, 5)]
# 3xTF32 products against f32 ones, summed in another order, through two
# GroupNorm backwards: at most 1.0e-5 of the largest value at these shapes
# and the antmaze ones, measured on an H100; TOL leaves ten times that
VJP_TOL = TOL


def _vjp_inputs(dev, B, H, Cin, Cout, K):
    x, emb, ws, skip = _film_inputs(dev, B, H, Cin, Cout, K, False)
    gout = torch.randn(B, H, Cout, device=dev, generator=torch.Generator(dev).manual_seed(5))
    kw = dict(K=K, groups=min(8, Cout // 4), eps=1e-6)
    return x, emb, ws, skip, gout, kw


def _grad_weights(ws, skip):
    return (ws[0], ws[2], ws[3], ws[4], ws[6], ws[7], skip[0])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [3200, 37], ids=["plan-batch", "ragged-B"])
@pytest.mark.parametrize("shape", CLASSIFIER_BLOCKS,
                         ids=[f"h{h}-{i}-{o}-k{k}" for h, i, o, k in CLASSIFIER_BLOCKS])
def test_film_resblock_vjp_kernels_match_plain(cuda, shape, B):
    """Both kernels at every classifier block shape, at the plan's 3,200
    rows and at a batch that leaves the last thread block ragged: the
    forward's output and residuals, and the input gradient from them,
    against the plain versions (and autograd through the plain block); the
    forward without residuals gives the same output bits."""
    H, Cin, Cout, K = shape
    x, emb, ws, skip, gout, kw = _vjp_inputs(cuda, B, H, Cin, Cout, K)
    before = (vjp.fused_film_resblock_vjp_forward.launches,
              vjp.fused_film_resblock_input_grad.launches)
    out, res = vjp.fused_film_resblock_vjp_forward(x, emb, *ws, *skip, **kw)
    out0, none = vjp.fused_film_resblock_vjp_forward(x, emb, *ws, *skip, residuals=False, **kw)
    gw = _grad_weights(ws, skip)
    dx = vjp.fused_film_resblock_input_grad(gout, *res, *gw, K=K, groups=kw["groups"])
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, out0)
    assert (vjp.fused_film_resblock_vjp_forward.launches,
            vjp.fused_film_resblock_input_grad.launches) == (before[0] + 2, before[1] + 1)
    out_p, res_p = vjp.film_resblock_vjp_forward_reference(x, emb, *ws, *skip, **kw)
    torch.testing.assert_close(out, out_p, atol=VJP_TOL, rtol=VJP_TOL)
    for a, b in zip(res, res_p):
        torch.testing.assert_close(a, b, atol=VJP_TOL, rtol=VJP_TOL)
    want = vjp.film_resblock_input_grad_reference(gout, *res_p, *gw, K=K, groups=kw["groups"])
    torch.testing.assert_close(dx, want, atol=VJP_TOL, rtol=VJP_TOL)
    xr = x.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(film.film_resblock_reference(xr, emb, *ws, *skip, **kw), xr,
                                  gout)
    torch.testing.assert_close(dx, auto, atol=VJP_TOL, rtol=VJP_TOL)


@pytest.mark.gpu
def test_film_resblock_vjp_routes_by_requires_grad(cuda):
    """`film_resblock_vjp_op` on the card: x alone needing a gradient
    launches the forward with residuals and, in the backward, the input
    gradient; under no_grad the forward alone; a weight needing a gradient
    takes the caller's plain block, counted in `plain_backward`. K3's
    counter never moves."""
    x, emb, ws, skip, gout, kw = _vjp_inputs(cuda, 64, 8, 64, 128, 3)
    counts = lambda: (vjp.fused_film_resblock_vjp_forward.launches,
                      vjp.fused_film_resblock_input_grad.launches,
                      vjp.film_resblock_vjp_op.plain_backward, film.fused_film_resblock.launches)
    ref = lambda xx: film.film_resblock_reference(xx, emb, *ws, *skip, **kw)

    def never():
        raise AssertionError("the plain block was taken")

    c0 = counts()
    xr = x.clone().requires_grad_(True)
    out = vjp.film_resblock_vjp_op(xr, emb, *ws, *skip, **kw, plain=never)
    assert counts() == (c0[0] + 1, c0[1], c0[2], c0[3])
    (dx,) = torch.autograd.grad(out, xr, gout)
    assert counts() == (c0[0] + 1, c0[1] + 1, c0[2], c0[3])
    (want,) = torch.autograd.grad(ref(xr), xr, gout)
    torch.testing.assert_close(dx, want, atol=VJP_TOL, rtol=VJP_TOL)
    with torch.no_grad():
        out0 = vjp.film_resblock_vjp_op(xr, emb, *ws, *skip, **kw, plain=never)
    assert counts() == (c0[0] + 2, c0[1] + 1, c0[2], c0[3])
    torch.testing.assert_close(out0, out.detach(), atol=0, rtol=0)
    w1 = ws[0].clone().requires_grad_(True)
    out = vjp.film_resblock_vjp_op(xr, emb, w1, *ws[1:], *skip, **kw, plain=lambda: ref(xr))
    assert out.requires_grad and counts() == (c0[0] + 2, c0[1] + 1, c0[2] + 1, c0[3])


@pytest.mark.gpu
def test_film_resblock_vjp_kernels_reject_what_they_do_not_take(cuda):
    x, emb, ws, skip, gout, kw = _vjp_inputs(cuda, 4, 8, 16, 32, 3)
    fwd = vjp.fused_film_resblock_vjp_forward
    with pytest.raises(TypeError):
        fwd(x.double(), emb, *ws, *skip, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(x.transpose(0, 1).contiguous().transpose(0, 1), emb, *ws, *skip, **kw)
    with pytest.raises(ValueError, match="odd"):
        fwd(x, emb, *ws, *skip, K=4, groups=8, eps=1e-6)
    with pytest.raises(RuntimeError, match="gradient"):
        fwd(x.clone().requires_grad_(True), emb, *ws, *skip, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fwd(*(t.cpu() for t in (x, emb, *ws, *skip)), **kw)
    xh, embh, wsh, skiph, _, kwh = _vjp_inputs(cuda, 4, 12, 16, 32, 3)
    with pytest.raises(ValueError, match="divide"):  # 64 rows a block, H = 12
        fwd(xh, embh, *wsh, *skiph, **kwh)
    xw, embw, wsw, skipw, _, kww = _vjp_inputs(cuda, 2, 4, 16, 520, 3)
    with pytest.raises(ValueError, match="at most 512"):
        fwd(xw, embw, *wsw, *skipw, **kww)
    _, res = fwd(x, emb, *ws, *skip, **kw)
    grad = vjp.fused_film_resblock_input_grad
    gw = _grad_weights(ws, skip)
    with pytest.raises(ValueError, match="must be"):
        grad(gout[:, :4].contiguous(), *res, *gw, K=3, groups=8)
    with pytest.raises(ValueError, match="Cin"):
        grad(gout, *res, *gw[:-1], None, K=3, groups=8)
    with pytest.raises(TypeError):
        grad(gout.double(), *res, *gw, K=3, groups=8)


@pytest.mark.gpu
def test_diffuser_plan_through_the_vjp_kernels(cuda):
    """A `DiffuserPipeline.act` at the benchmark cell's size (50 envs x 64
    candidates, H 32, model_dim 32) with `use_pallas_block`: 200 input
    gradients and 210 forwards a plan (20 steps of 10 blocks, and the final
    log p under no_grad), no plain block, K3's 320; the same plan twice
    gives the same bits; against the same plan with the classifier's
    blocks plain, the candidates' log p within 1e-4 relative."""
    pipe = DiffuserPipeline(obs_dim=17, act_dim=6, horizon=32, model_dim=32, dim_mult=(1, 2, 2, 2),
                            predict_noise=False, use_pallas_block=True, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    obs = torch.randn(50, 17, generator=g, device=cuda)
    noise = (torch.randn(3200, 32, 23, generator=g, device=cuda),
             torch.randn(20, 3200, 32, 23, generator=g, device=cuda))
    counts = lambda: (vjp.fused_film_resblock_vjp_forward.launches,
                      vjp.fused_film_resblock_input_grad.launches,
                      vjp.film_resblock_vjp_op.plain_backward, film.fused_film_resblock.launches)
    c0 = counts()
    act, info = pipe.act(obs, 64, noise=noise)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, counts())] == [210, 200, 0, 320]
    act2, info2 = pipe.act(obs, 64, noise=noise)
    assert torch.equal(act, act2) and torch.equal(info["candidates"], info2["candidates"])
    assert torch.equal(info["candidate_logp"], info2["candidate_logp"])
    for b in pipe.classifier.ema_params.blocks:
        b.vjp_kernel = False
    _, plain = pipe.act(obs, 64, noise=noise)
    logp, want = info["candidate_logp"], plain["candidate_logp"]
    assert ((logp - want).abs().max() / want.abs().max()).item() < 1e-4


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


# ---------------------------------------------------------------------------
# K3's BF16 route: BF16 weights, biases and affine; x and emb f32 or BF16
# the route rounds each product's f32 activations to BF16, which the plain
# version does not where they are f32 (chip_smoke.py's bound for it, the JAX
# package's for its bf16 kernel)
BF16_TOL = 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("types", [("f32", "f32"), ("bf16", "f32"), ("bf16", "bf16"),
                                   ("f32", "bf16")])
@pytest.mark.parametrize("shape", [(7, 32, 23, 32, False), (9, 4, 256, 256, False),
                                   (5, 4, 512, 128, False), (5, 16, 23, 48, True),
                                   (3, 8, 1024, 256, False), (2, 64, 37, 64, False),
                                   (64, 4, 256, 256, False), (19, 4, 128, 256, False),
                                   (5, 4, 1024, 256, False), (3, 8, 512, 512, False),
                                   (4, 8, 256, 320, False)],
                         ids=["cin23", "c256", "cin512", "cout48-film-scale", "antmaze-cin1024",
                              "antmaze-h64", "batch64", "ragged-last-tile", "x-in-two-fills",
                              "cout512-two-warpgroups", "cout320-groups-across-warpgroups"])
def test_film_resblock_bf16_route_matches_plain(cuda, shape, types):
    """The U-Net's calls (its first block: BF16 x with an f32 FiLM term; the
    others f32 x) and all-BF16, against the plain version on the same
    operands: the output in the promoted type of x and emb, one launch of
    the BF16 route and none of the f32 one."""
    B, H, Cin, Cout, film_scale = shape
    x, emb, ws, skip = _film_inputs(cuda, B, H, Cin, Cout, 5, film_scale)
    cast = {"f32": torch.float32, "bf16": torch.bfloat16}
    x, emb = x.to(cast[types[0]]), emb.to(cast[types[1]])
    wb = [None if w is None else w.to(torch.bfloat16) for w in (*ws, *skip)]
    kw = dict(K=5, groups=8, film_scale=film_scale, eps=1e-6)
    before = (film.fused_film_resblock.launches, film.fused_film_resblock_bf16.launches)
    out = film.fused_film_resblock_bf16(x, emb, *wb, **kw)
    torch.cuda.synchronize()
    assert (film.fused_film_resblock.launches, film.fused_film_resblock_bf16.launches) == (
        before[0], before[1] + 1)
    ref = film.film_resblock_reference(x, emb, *wb, **kw)
    assert out.dtype == ref.dtype == torch.promote_types(x.dtype, emb.dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.gpu
def test_film_resblock_bf16_route_rejects_other_types(cuda):
    x, emb, ws, skip = _film_inputs(cuda, 2, 8, 16, 32, 5, False)
    wb = [w.to(torch.bfloat16) for w in (*ws, *skip)]
    kw = dict(K=5, groups=8)
    with pytest.raises(TypeError, match="go to fused_film_resblock"):
        film.fused_film_resblock_bf16(x, emb, *ws, *skip, **kw)  # all f32
    with pytest.raises(TypeError, match="go to fused_film_resblock_bf16"):
        film.fused_film_resblock(x, emb, *wb, **kw)
    with pytest.raises(TypeError, match="bfloat16 weights"):
        film.fused_film_resblock_bf16(x, emb, *wb[:-1], skip[1], **kw)  # one f32 bias
    with pytest.raises(TypeError, match="bfloat16 weights"):
        film.fused_film_resblock_bf16(x.half(), emb, *wb, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (2, 4, 32, 520)], ids=["h3", "cout520"])
def test_film_resblock_bf16_route_raises_on_a_shape_it_does_not_take(cuda, shape, monkeypatch):
    """A CUDA tensor the kernel does not take (H not dividing a tile's 64
    rows; Cout past 512) raises, from the kernel's wrapper and from the
    model's dispatcher alike, and never runs the plain version."""
    B, H, Cin, Cout = shape
    x, emb, ws, skip = _film_inputs(cuda, B, H, Cin, Cout, 5, False)
    wb = [None if w is None else w.to(torch.bfloat16) for w in (*ws, *skip)]
    kw = dict(K=5, groups=8)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(film, "film_resblock_reference", plain)
    before = film.fused_film_resblock_bf16.launches
    with pytest.raises(ValueError):
        film.fused_film_resblock_bf16(x, emb, *wb, **kw)
    with torch.no_grad(), pytest.raises(ValueError):
        film.film_resblock_op(x, emb, *wb, **kw)
    assert film.fused_film_resblock_bf16.launches == before


@pytest.mark.gpu
def test_jannerunet_bf16_sampling_and_training_launch_the_bf16_route(cuda):
    """A Janner U-Net engine with `bf16_sampling` and `bf16_training`: every
    residual block of a plan and of a training step launches K3's BF16 route
    and none the f32 one, against the plain blocks on the same bf16 copy
    within BF16_TOL of the plan's scale; params and EMA stay f32."""
    from cleandiffuser_tpu_torch.diffusion import DiscreteDiffusionSDE

    nets = [JannerUNet1d(7, model_dim=16, emb_dim=16, dim_mult=(1, 2), kernel_size=5,
                         use_pallas_block=k, generator=torch.Generator().manual_seed(0))
            for k in (True, False)]
    engs = [DiscreteDiffusionSDE(n, diffusion_steps=10, device=cuda) for n in nets]
    engs[1].ema_params.load_state_dict(engs[0].ema_params.state_dict())
    noise = (torch.randn(6, 8, 7, device=cuda), torch.randn(3, 6, 8, 7, device=cuda))
    counts = (film.fused_film_resblock.launches, film.fused_film_resblock_bf16.launches)
    xs = []
    for eng in engs:
        eng.bf16_sampling = eng.bf16_training = True
        with torch.no_grad():
            xs.append(eng.build_sample_fn(solver="ddpm", sample_steps=3)(
                eng.ema_params, None, torch.zeros(6, 8, 7, device=cuda), noise=noise)[0])
    engs[0].update(torch.randn(4, 8, 7, device=cuda))
    torch.cuda.synchronize()
    assert (film.fused_film_resblock.launches - counts[0],
            film.fused_film_resblock_bf16.launches - counts[1]) == (0, 3 * 8 + 8)
    assert xs[0].dtype == torch.float32 and torch.isfinite(xs[0]).all()
    scale = max(xs[1].abs().max().item(), 1.0)
    assert (xs[0] - xs[1]).abs().max().item() / scale < BF16_TOL
    assert all(p.dtype == torch.float32 for p in engs[0].params.parameters())
    assert all(p.dtype == torch.float32 for p in engs[0].ema_params.parameters())

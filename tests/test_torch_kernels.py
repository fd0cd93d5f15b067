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

from cleandiffuser_tpu_torch.nn_diffusion import DiT1d
from cleandiffuser_tpu_torch.ops import dit_block as ops

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
                                   (100, 32, 320, 10)],
                         ids=["test-size", "ragged-H", "H-over-32", "plan-size"])
def test_dit_block_kernel_matches_plain(cuda, shape):
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
    with pytest.raises(ValueError, match="shared memory"):
        xl, modl, wsl = _inputs(cuda, 1, 256, 64)
        ops.fused_dit_block(xl, modl, *wsl, n_heads=4)


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
    for g_k, g_p in zip(*grads):
        torch.testing.assert_close(g_k, g_p, atol=1e-3, rtol=1e-3)

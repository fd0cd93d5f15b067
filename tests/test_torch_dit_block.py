"""The port's fused DiT block (cleandiffuser_tpu_torch/ops/dit_block.py,
nn_diffusion/dit.py) against the JAX package's.

On the CPU the port's block runs its plain PyTorch version; the CUDA kernel
itself is held against that plain version in tests/test_torch_kernels.py,
on a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from cleandiffuser_tpu.nn_diffusion.dit import DiT1d as JaxDiT1d
from cleandiffuser_tpu.nn_diffusion.dit import DiTBlock as JaxDiTBlock
from cleandiffuser_tpu.nn_diffusion.dit import PallasDiTBlock as JaxPallasDiTBlock
from cleandiffuser_tpu.ops import dit_block as jax_ops
from cleandiffuser_tpu_torch.nn_diffusion import DiT1d, DiTBlock
from cleandiffuser_tpu_torch.ops import dit_block as ops
from cleandiffuser_tpu_torch.utils.jax_params import jax_params_of, load_jax_params

torch.set_num_threads(1)

B, H, D, NH = 4, 8, 64, 4


def _inputs(seed=0, B=B, H=H, D=D):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    ws = [f(D, 3 * D), f(3 * D), f(D, D), f(D), f(D, 4 * D), f(4 * D), f(4 * D, D), f(D)]
    return f(B, H, D), f(B, 6 * D), ws


def _seeded(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), tree)


class _OneBlock(nn.Module):
    """A single port block under the flax name of block 0."""

    JAX_NAMES = {"blocks": "PallasDiTBlock_{}"}

    def __init__(self, use_kernel):
        super().__init__()
        self.blocks = nn.ModuleList([DiTBlock(D, NH, use_kernel)])


def test_plain_version_matches_jax_reference():
    """torch dit_block_reference == JAX dit_block_reference, f32. 1e-5:
    the same float32 math, summed in another order."""
    x, mod, ws = _inputs()
    ref = jax_ops.dit_block_reference(jnp.asarray(x), jnp.asarray(mod),
                                      *map(jnp.asarray, ws), n_heads=NH)
    out = ops.dit_block_reference(torch.from_numpy(x), torch.from_numpy(mod),
                                  *map(torch.from_numpy, ws), n_heads=NH)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout", ["flat", "nested"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_block_matches_flax_block(layout, use_kernel):
    """The port's block, with weights carried across by the converter from
    flax `PallasDiTBlock` (flat) or `DiTBlock` (nested MHA), matches the flax
    block. 2e-5, the tolerance the JAX package holds its own two layouts
    to (tests/test_pallas_ops.py)."""
    cls = JaxPallasDiTBlock if layout == "flat" else JaxDiTBlock
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, H, D)).astype(np.float32) * 0.1
    te = rng.standard_normal((B, D)).astype(np.float32) * 0.1
    block = cls(D, NH)
    params = _seeded(block.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(te)), 2)
    want = np.asarray(block.apply(jax.tree_util.tree_map(jnp.asarray, params),
                                  jnp.asarray(x), jnp.asarray(te)))

    port = _OneBlock(use_kernel)
    load_jax_params(port, {f"{cls.__name__}_0": params["params"]})
    got = port.blocks[0](torch.from_numpy(x), torch.from_numpy(te))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=2e-5)


def test_pack_dit_block_params_matches_jax():
    """pack_dit_block_params (nested flax block -> kernel weight list) gives
    the JAX package's packing, exactly (reshapes and concatenations only)."""
    x = jnp.zeros((B, H, D))
    params = _seeded(JaxDiTBlock(D, NH).init(jax.random.PRNGKey(0), x, jnp.zeros((B, D))), 3)
    want = jax_ops.pack_dit_block_params(params["params"], D, NH)
    got = ops.pack_dit_block_params(params["params"], D, NH)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_identity_at_init(use_kernel):
    """adaLN-Zero: zero-init modulation makes a fresh block the identity and
    a fresh DiT1d output 0, exactly (x + 0 * finite)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, H, D)).astype(np.float32))
    block = DiTBlock(D, NH, use_kernel, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(block(x, torch.ones(B, D)), x, atol=0, rtol=0)
    net = DiT1d(5, 32, D, NH, 2, timestep_emb_type="fourier", use_pallas_block=use_kernel,
                generator=torch.Generator().manual_seed(0))
    out = net(torch.randn(B, H, 5, generator=torch.Generator().manual_seed(1)),
              torch.full((B,), 0.5), torch.zeros(B, 32))
    assert torch.count_nonzero(out) == 0


def test_dit1d_matches_flax():
    """The whole backbone (Fourier time embedding, condition embedding,
    positional features, 2 fused blocks, final layer) on converted weights.
    2e-5 as for the block."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, H, 5)).astype(np.float32)
    t = rng.uniform(0, 1, (B,)).astype(np.float32)
    emb = rng.standard_normal((B, 32)).astype(np.float32) * 0.1
    jnet = JaxDiT1d(in_dim=5, emb_dim=32, d_model=D, n_heads=NH, depth=2,
                    timestep_emb_type="fourier", use_pallas_block=True)
    params = _seeded(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(emb)), 5)
    want = np.asarray(jnet.apply(jax.tree_util.tree_map(jnp.asarray, params),
                                 jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb)))
    net = DiT1d(5, 32, D, NH, 2, timestep_emb_type="fourier", use_pallas_block=True)
    load_jax_params(net, params["params"])
    got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(emb))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=2e-5)
    # and the export is the flax tree's structure
    assert jax.tree_util.tree_structure(jax_params_of(net)) == \
        jax.tree_util.tree_structure(params["params"])


def test_kernel_wrapper_has_no_cpu_path():
    """The kernel launcher raises on a CPU tensor and counts nothing; the
    dispatcher sends CPU tensors to the plain version."""
    x, mod, ws = _inputs()
    args = [torch.from_numpy(a) for a in (x, mod, *ws)]
    before = ops.fused_dit_block.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_dit_block(*args, n_heads=NH)
    out = ops.dit_block_op(*args, n_heads=NH)
    torch.testing.assert_close(out, ops.dit_block_reference(*args, n_heads=NH), atol=0, rtol=0)
    assert ops.fused_dit_block.launches == before


def test_kernel_backward_is_the_plain_gradient():
    """The autograd Function's backward differentiates the plain version;
    exercised here through its backward alone (the forward needs a GPU)."""
    x, mod, ws = _inputs()
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x, mod, *ws)]

    class Ctx:
        saved_tensors = [a.detach() for a in args]
        n_heads = NH

    g = torch.from_numpy(np.random.default_rng(9).standard_normal(x.shape).astype(np.float32))
    got = ops._FusedDiTBlock.backward(Ctx, g)
    ops.dit_block_reference(*args, n_heads=NH).backward(g)
    assert got[-1] is None
    for a, gr in zip(args, got[:-1]):
        torch.testing.assert_close(gr, a.grad, atol=0, rtol=0)

"""Diffusion Veteran's and DiffuserLite's networks in the port against flax.

The same seeded numpy weights (in the flax layout, carried in by
utils/jax_params.py, which reshapes flax's attention kernels) and inputs
go through each flax module and its port:

- `DVHorizonCritic` with "pre" and "post" norm (multi-head attention with
  flax's (D, heads, head_dim) kernels, plain LayerNorms, tanh-GELU MLP, the
  sinusoidal position, token 0 out), and the params back out to flax;
- `DVInvMlp` (positional time embedding, conditioned on (s, s'));
- `IDQLVNet` (= `V`);
- `FancyMlpInvDynamic`: the forward, with and without LayerNorm; 3 updates
  with dropout, the JAX update's keep-masks read back from flax's
  intermediates; and a JAX `save` read by `load_jax_checkpoint`.

Tolerance: float32 on both sides, sums in another order: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cleandiffuser_tpu.invdynamic import FancyMlpInvDynamic as JaxFancyInv
from cleandiffuser_tpu.nn_diffusion import DVInvMlp as JaxDVInvMlp
from cleandiffuser_tpu.utils.blocks import DVHorizonCritic as JaxCritic
from cleandiffuser_tpu.utils.blocks import IDQLVNet as JaxIDQLVNet
from cleandiffuser_tpu_torch.invdynamic import FancyMlpInvDynamic
from cleandiffuser_tpu_torch.nn_diffusion import DVInvMlp
from cleandiffuser_tpu_torch.utils.blocks import DVHorizonCritic, IDQLVNet, V
from cleandiffuser_tpu_torch.utils.jax_params import jax_params_of, load_jax_params

torch.set_num_threads(1)
TOL = 1e-5


def _seeded(tree, seed):
    rng = np.random.default_rng(seed)

    def fill(a):
        scale = 1 / np.sqrt(a.shape[0]) if a.ndim >= 2 else 0.1
        return (rng.standard_normal(a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(lambda a: fill(np.asarray(a)), jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("norm_type", ["pre", "post"])
def test_dv_horizon_critic_matches_flax(norm_type):
    H, D_IN, D = 6, 5, 32
    jnet = JaxCritic(in_dim=D_IN, emb_dim=16, d_model=D, n_heads=4, depth=2, norm_type=norm_type)
    params = _seeded(jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, H, D_IN))), 1)
    x = np.random.default_rng(2).standard_normal((3, H, D_IN)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    tnet = DVHorizonCritic(D_IN, 16, D, 4, depth=2, norm_type=norm_type)
    load_jax_params(tnet, params["params"])
    with torch.no_grad():
        got = tnet(_t(x)).numpy()
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the attention's kernels go back out in flax's layout
    back = jax_params_of(tnet)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"]):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf, err_msg=jax.tree_util.keystr(path))


def test_dv_critic_rejects_unknown_norm():
    with pytest.raises(NotImplementedError):
        DVHorizonCritic(3, 8, 16, 2, depth=1, norm_type="mid")


def test_dv_inv_mlp_matches_flax():
    O, A = 6, 3
    jnet = JaxDVInvMlp(obs_dim=O, act_dim=A, emb_dim=64, hidden_dim=32)
    params = _seeded(jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, A)), jnp.zeros((1,)),
                               jnp.zeros((1, 2 * O))), 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, A)).astype(np.float32)
    t = rng.integers(0, 5, 5).astype(np.int32)
    emb = rng.standard_normal((5, 2 * O)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb)))
    tnet = DVInvMlp(O, A, emb_dim=64, hidden_dim=32)
    load_jax_params(tnet, params["params"])
    with torch.no_grad():
        got = tnet(_t(x), torch.from_numpy(t), _t(emb)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="condition"):
        tnet(_t(x), torch.from_numpy(t))


def test_idql_vnet_matches_flax():
    assert IDQLVNet is V
    jnet = JaxIDQLVNet(hidden_dim=32)
    params = _seeded(jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 7))), 5)
    obs = np.random.default_rng(6).standard_normal((4, 3, 7)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs)))
    tnet = IDQLVNet(7, 32)
    load_jax_params(tnet, params["params"])
    with torch.no_grad():
        np.testing.assert_allclose(tnet(_t(obs)).numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("add_norm", [False, True])
def test_fancy_invdyn_forward_matches_flax(add_norm):
    O, A = 5, 2
    jinv = JaxFancyInv(O, A, 32, jnp.tanh, add_norm=add_norm, add_dropout=True, rng=1)
    params = _seeded(jinv.params, 7)
    jinv.params = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(8)
    o, o2 = (rng.standard_normal((6, O)).astype(np.float32) for _ in range(2))
    tinv = FancyMlpInvDynamic(O, A, 32, add_norm=add_norm, add_dropout=True, device="cpu")
    load_jax_params(tinv.net, params["params"])
    np.testing.assert_allclose(tinv.predict(_t(o), _t(o2)).numpy(),
                               np.asarray(jinv.predict(jnp.asarray(o), jnp.asarray(o2))),
                               rtol=TOL, atol=TOL)
    # the tanh form of GELU, as flax's nn.gelu defaults to
    assert not torch.allclose(F.gelu(_t(o), approximate="tanh"), F.gelu(_t(o)))


def _jax_keep_mask(jinv, sub, o, o2):
    """flax's dropout keep-mask of the update that draws from `sub`: where
    the Dropout's output is non-zero."""
    oo = jnp.concatenate([jnp.asarray(o), jnp.asarray(o2)], -1)
    _, inter = jinv.net.apply(jinv.params, oo, train=True, rngs={"dropout": sub},
                              capture_intermediates=True)
    return torch.from_numpy(np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0)


def test_fancy_invdyn_updates_with_dropout_match_jax(tmp_path):
    O, A, N = 5, 2, 16
    jinv = JaxFancyInv(O, A, 32, jnp.tanh, add_dropout=True, rng=3)
    params = _seeded(jinv.params, 9)
    jinv.params = jax.tree_util.tree_map(jnp.asarray, params)
    tinv = FancyMlpInvDynamic(O, A, 32, add_dropout=True, device="cpu")
    load_jax_params(tinv.net, params["params"])
    rng = np.random.default_rng(10)
    for _ in range(3):
        o, o2 = (rng.standard_normal((N, O)).astype(np.float32) for _ in range(2))
        a = rng.uniform(-1, 1, (N, A)).astype(np.float32)
        _, sub = jax.random.split(jinv._rng)
        keep = _jax_keep_mask(jinv, sub, o, o2)
        assert 0 < keep.float().mean() < 1
        want = float(jinv.update(jnp.asarray(o), jnp.asarray(a), jnp.asarray(o2))["loss"])
        got = float(tinv.update(_t(o), _t(a), _t(o2), keep=keep)["loss"])
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)
    got_p = jax_params_of(tinv.net)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(jinv.params["params"])):
        node = got_p
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, leaf, rtol=TOL, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # the JAX save holds the params only; the port's Adam starts afresh
    jinv.save(str(tmp_path / "inv.pkl"))
    fresh = FancyMlpInvDynamic(O, A, 32, add_dropout=True, device="cpu")
    fresh.load_jax_checkpoint(str(tmp_path / "inv.pkl"))
    o = _t(rng.standard_normal((4, O)))
    torch.testing.assert_close(fresh.predict(o, o), tinv.predict(o, o))
    assert not fresh.optimizer.optimizer.state
    # the port's own checkpoint round trip
    tinv.save(str(tmp_path / "inv.pt"))
    back = FancyMlpInvDynamic(O, A, 32, add_dropout=True, device="cpu")
    back.load(str(tmp_path / "inv.pt"))
    torch.testing.assert_close(back.predict(o, o), tinv.predict(o, o))


def test_fancy_invdyn_draws_dropout_from_its_generator():
    inv_a = FancyMlpInvDynamic(4, 2, 16, add_dropout=True, device="cpu", rng=5)
    inv_b = FancyMlpInvDynamic(4, 2, 16, add_dropout=True, device="cpu", rng=5)
    inv_b.net.load_state_dict(inv_a.net.state_dict())
    o = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    a = torch.zeros(8, 2)
    la, lb = inv_a.update(o, a, o)["loss"], inv_b.update(o, a, o)["loss"]
    assert float(la) == float(lb)

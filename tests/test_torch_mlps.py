"""The port's MLP backbones and RL critics against the JAX package's flax
modules: `DQLMlp`, `IDQLMlp` / `NewIDQLMlp` (eval mode), `DQLCritic`
(`__call__`, `q1`, `q_min`), `TwinQ` (`both`, `__call__`), `V` and `Mlp`,
on the same seeded weights (the flax tree refilled with seeded normals and
carried in by utils/jax_params.py, which must read every leaf) and the same
inputs, within 1e-5 (float32 on both sides; the sums run in another order).
Also: train-mode dropout of `IDQLMlp` keeps about 1 - p of the entries,
scales them by 1 / (1 - p), draws its mask from the explicit generator,
and is off in eval mode and at p = 0.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cleandiffuser_tpu.nn_diffusion.mlps import DQLMlp as JaxDQLMlp
from cleandiffuser_tpu.nn_diffusion.mlps import IDQLMlp as JaxIDQLMlp
from cleandiffuser_tpu.utils import blocks as jblocks
from cleandiffuser_tpu_torch.nn_diffusion import DQLMlp, IDQLMlp, NewIDQLMlp
from cleandiffuser_tpu_torch.utils.blocks import DQLCritic, Mlp, TwinQ, V
from cleandiffuser_tpu_torch.utils.jax_params import jax_params_of, load_jax_params

torch.set_num_threads(1)

TOL = 1e-5
B, OBS, ACT = 8, 5, 3


def _seeded(tree, seed):
    rng = np.random.default_rng(seed)

    def fill(path, a):
        z = rng.standard_normal(a.shape)
        name = jax.tree_util.keystr(path)
        if a.ndim >= 2:
            z = z / np.sqrt(a.shape[0])
        elif name.endswith("['scale']"):
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _carry(jmod, tmod, *example, seed=0):
    """Init `jmod` on `example`, refill its params with seeded normals, load
    them into `tmod`; returns the JAX variables."""
    variables = {"params": _seeded(jmod.init(jax.random.PRNGKey(0), *example)["params"], seed)}
    load_jax_params(tmod, variables["params"])
    got = jax_params_of(tmod)
    want = jax.tree_util.tree_map(np.asarray, variables["params"])
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    return variables


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, ACT)).astype(np.float32)
    obs = rng.standard_normal((B, OBS)).astype(np.float32)
    t = rng.integers(0, 5, (B,)).astype(np.int32)
    return x, obs, t


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("with_obs", [True, False])
def test_dqlmlp_matches_flax(with_obs):
    x, obs, t = _inputs()
    jm = JaxDQLMlp(obs_dim=OBS, act_dim=ACT, emb_dim=16)
    tm = DQLMlp(OBS, ACT, emb_dim=16)
    v = _carry(jm, tm, x, t, obs)
    emb = obs if with_obs else None
    want = jm.apply(v, x, t, None if emb is None else jnp.asarray(emb))
    got = tm(torch.from_numpy(x), torch.from_numpy(t),
             None if emb is None else torch.from_numpy(emb))
    assert got.shape == (B, ACT)
    _close(got, want)


@pytest.mark.parametrize("final_mish", [False, True])
def test_idqlmlp_eval_matches_flax(final_mish):
    x, obs, t = _inputs(2)
    jm = JaxIDQLMlp(obs_dim=OBS, act_dim=ACT, emb_dim=16, hidden_dim=32, n_blocks=2,
                    dropout=0.1, final_mish=final_mish)
    kw = dict(obs_dim=OBS, act_dim=ACT, emb_dim=16, hidden_dim=32, n_blocks=2, dropout=0.1)
    tm = NewIDQLMlp(**kw) if final_mish else IDQLMlp(**kw)
    v = _carry(jm, tm, x, t, obs, seed=3)
    want = jm.apply(v, x, t, obs, train=False)
    got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(obs))
    _close(got, want)
    # train mode with p = 0 is eval mode
    tm.dropout = 0.0
    for blk in tm.blocks:
        blk.dropout = 0.0
    _close(tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(obs), train=True,
              generator=torch.Generator().manual_seed(0)), want)


def test_idqlmlp_dropout_in_training():
    """Each residual block's input: ~p of the entries zeroed, the rest
    scaled by 1 / (1 - p); the mask comes from the generator."""
    p = 0.25
    tm = IDQLMlp(OBS, ACT, emb_dim=16, hidden_dim=64, n_blocks=1, dropout=p,
                 generator=torch.Generator().manual_seed(0))
    seen = {}
    tm.blocks[0].norm.register_forward_hook(lambda m, i, o: seen.setdefault("h", i[0]))
    x = torch.randn(512, ACT, generator=torch.Generator().manual_seed(1))
    obs = torch.randn(512, OBS, generator=torch.Generator().manual_seed(2))
    t = torch.zeros(512, dtype=torch.int32)
    h_in = tm.proj(torch.cat([x, tm.time_mlp(tm.time_emb(t)), obs], -1)).detach()
    out = tm(x, t, obs, train=True, generator=torch.Generator().manual_seed(3))
    h = seen.pop("h").detach()
    zeroed = h == 0
    assert abs(zeroed.float().mean().item() - p) < 0.01  # 32768 entries: sd 0.0024
    torch.testing.assert_close(h[~zeroed], h_in[~zeroed] / (1 - p), rtol=1e-6, atol=1e-6)
    again = tm(x, t, obs, train=True, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    seen.clear()
    tm(x, t, obs)  # eval mode: no dropout
    torch.testing.assert_close(seen["h"], h_in, rtol=0, atol=0)


def test_dql_critic_matches_flax():
    _, obs, _ = _inputs(4)
    act = np.random.default_rng(5).uniform(-1, 1, (B, ACT)).astype(np.float32)
    jm = jblocks.DQLCritic(hidden_dim=32)
    tm = DQLCritic(OBS, ACT, 32)
    v = _carry(jm, tm, obs, act, seed=6)
    o, a = torch.from_numpy(obs), torch.from_numpy(act)
    q1, q2 = jm.apply(v, obs, act)
    got1, got2 = tm(o, a)
    _close(got1, q1)
    _close(got2, q2)
    assert got1.shape == (B, 1) and not np.allclose(np.asarray(q1), np.asarray(q2))
    _close(tm.q1(o, a), jm.apply(v, obs, act, method=jblocks.DQLCritic.q1))
    _close(tm.q_min(o, a), jm.apply(v, obs, act, method=jblocks.DQLCritic.q_min))


def test_twinq_and_v_match_flax():
    _, obs, _ = _inputs(7)
    act = np.random.default_rng(8).uniform(-1, 1, (B, ACT)).astype(np.float32)
    o, a = torch.from_numpy(obs), torch.from_numpy(act)
    jq, tq = jblocks.TwinQ(hidden_dim=32), TwinQ(OBS, ACT, 32)
    vq = _carry(jq, tq, obs, act, seed=9)
    for got, want in zip(tq.both(o, a), jq.apply(vq, obs, act, method=jblocks.TwinQ.both)):
        _close(got, want)
    _close(tq(o, a), jq.apply(vq, obs, act))
    jv, tv = jblocks.V(hidden_dim=32), V(OBS, 32)
    vv = _carry(jv, tv, obs, seed=10)
    _close(tv(o), jv.apply(vv, obs))


def test_mlp_matches_flax():
    _, obs, _ = _inputs(11)
    jm = jblocks.Mlp(hidden_dims=(16, 8), out_dim=4, activation=fnn.relu,
                     out_activation=jnp.tanh)
    tm = Mlp(OBS, (16, 8), 4, F.relu, torch.tanh)
    v = _carry(jm, tm, obs, seed=12)
    _close(tm(torch.from_numpy(obs)), jm.apply(v, obs))

"""The PyTorch port's Decision Diffuser plan against the JAX package's.

Same weights (seeded numpy normals in the JAX layout, carried into the
port by the converter), same observations and the same sampler noise (the
JAX sampler's own draws, replayed from its key splits) go through
`cleandiffuser_tpu.pipelines.dd.DDPipeline._make_plan_fn` and through the
port's `DDPipeline.act`; trajectory and action must agree. Both DiT block
layouts are covered: the flat fused-block layout (JAX
`use_pallas_block=True`, which runs its plain reference on the CPU) and
the nested flax layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines.dd import DDPipeline as JaxDDPipeline
from cleandiffuser_tpu_torch.pipelines import DDPipeline
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, jax_params_of

torch.set_num_threads(1)

CFG = dict(obs_dim=5, act_dim=3, horizon=8, emb_dim=32, d_model=64, n_heads=4, depth=2,
           sampling_steps=4, w_cfg=2.0, target_return=0.95, temperature=0.5)
E = 4
# Measured gap is ~1e-6: both sides compute in float32 with the same
# schedule tables and noise; what differs is the order of float32 sums in
# the matrix products and the LayerNorm variance (flax's nested block uses
# E[x^2] - E[x]^2).
TOL = 1e-5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _seeded(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), _numpy_tree(tree))


def _jax_noise(rng, shape, steps):
    """The JAX sampler's draws: k_init, k_scan = split(rng); then
    rng, k_noise = split(rng) at every step."""
    k_init, k = jax.random.split(rng)
    init = np.array(jax.random.normal(k_init, shape))
    per_step = []
    for _ in range(steps):
        k, k_noise = jax.random.split(k)
        per_step.append(np.asarray(jax.random.normal(k_noise, shape)))
    return init, np.stack(per_step)


@pytest.fixture(scope="module", params=["flat", "nested"])
def plans(request):
    flat = request.param == "flat"
    jpipe = JaxDDPipeline(**CFG, use_pallas_block=flat)
    params = _seeded(jpipe.agent.state.params, 1)
    ema = _seeded(jpipe.agent.state.ema_params, 2)
    inv = _seeded(jpipe.invdyn.params, 3)
    obs = np.random.default_rng(4).standard_normal((E, CFG["obs_dim"])).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    cond = jnp.ones((E, 1)) * CFG["target_return"]
    jax_tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    act_j, traj_j = jpipe._make_plan_fn(E)(jax_tree(ema), jax_tree(inv), rng,
                                           jnp.asarray(obs), cond)

    tpipe = DDPipeline(**CFG, use_pallas_block=flat)
    tpipe.load_jax_params(params, ema, inv)
    shape = (E, CFG["horizon"], CFG["obs_dim"])
    init, per_step = _jax_noise(rng, shape, CFG["sampling_steps"])
    act_t, info = tpipe.act(obs, noise=(torch.from_numpy(init), torch.from_numpy(per_step)))
    return dict(obs=obs, act_j=np.asarray(act_j), traj_j=np.asarray(traj_j),
                act_t=act_t.numpy(), traj_t=info["traj"].numpy(), tpipe=tpipe, jpipe=jpipe,
                ema=ema)


def test_plan_trajectory_matches_jax(plans):
    assert plans["traj_t"].shape == (E, CFG["horizon"], CFG["obs_dim"])
    # a plan of all zeros would match trivially
    assert np.abs(plans["traj_j"][:, 1:]).max() > 0.1
    np.testing.assert_allclose(plans["traj_t"], plans["traj_j"], atol=TOL, rtol=TOL)


def test_plan_action_matches_jax(plans):
    assert plans["act_t"].shape == (E, CFG["act_dim"])
    np.testing.assert_allclose(plans["act_t"], plans["act_j"], atol=TOL, rtol=TOL)


def test_plan_pins_first_state(plans):
    """Inpainting: row 0 of the plan is the observation, exactly."""
    np.testing.assert_array_equal(plans["traj_t"][:, 0], plans["obs"])


def test_converter_round_trip(plans):
    """Exporting the port's EMA params gives the JAX tree it was loaded
    from (in the flat block layout), leaf for leaf."""
    from cleandiffuser_tpu_torch.utils.jax_params import flat_from_nested

    def flat(tree):
        out = {}
        for k, v in tree.items():
            if k.startswith("DiTBlock_"):
                out["Pallas" + k] = flat_from_nested(v)
            else:
                out[k] = flat(v) if isinstance(v, dict) else v
        return out

    exported = agent_params_of(plans["tpipe"].agent.ema_params)
    want = flat(plans["ema"])
    got_leaves = jax.tree_util.tree_leaves_with_path(exported)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (_, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a, b)
    inv = jax_params_of(plans["tpipe"].invdyn.net)
    assert jax.tree_util.tree_structure(inv) == jax.tree_util.tree_structure(
        _numpy_tree(plans["jpipe"].invdyn.params["params"]))


def test_generator_sampling_is_seeded():
    """Without explicit noise the plan draws from the given generator:
    the same seed gives the same plan, another seed another plan."""
    tpipe = DDPipeline(**CFG)
    obs = np.random.default_rng(0).standard_normal((E, CFG["obs_dim"])).astype(np.float32)
    a1, i1 = tpipe.act(obs, generator=torch.Generator().manual_seed(3))
    a2, i2 = tpipe.act(obs, generator=torch.Generator().manual_seed(3))
    _, i3 = tpipe.act(obs, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(i1["traj"], i2["traj"], atol=0, rtol=0)
    assert not torch.equal(i1["traj"][:, 1:], i3["traj"][:, 1:])


def test_mlp_condition_matches_jax():
    """DD's return encoder on converted weights, with and without a
    sampling-time mask (1e-6: two small f32 matrix products); in training
    its label dropout zeroes a `dropout` share of rows, drawn from the given
    generator."""
    import flax.linen as fnn
    import torch.nn.functional as F

    from cleandiffuser_tpu.nn_condition import MLPCondition as JaxMLPCondition
    from cleandiffuser_tpu_torch.nn_condition import MLPCondition
    from cleandiffuser_tpu_torch.utils.jax_params import load_jax_params

    c = np.random.default_rng(8).uniform(0, 1, (6, 1)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    jm = JaxMLPCondition(in_dim=1, out_dim=32, hidden_dims=(32,), act=fnn.silu, dropout=0.25)
    key = jax.random.PRNGKey(0)
    params = _seeded(jm.init({"params": key, "dropout": key}, jnp.asarray(c)), 9)
    port = MLPCondition(1, 32, (32,), F.silu, dropout=0.25)
    load_jax_params(port, params["params"])
    for m in (None, mask):
        want = jm.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(c),
                        mask=None if m is None else jnp.asarray(m))
        got = port(torch.from_numpy(c), mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)

    big = torch.from_numpy(np.random.default_rng(10).uniform(0.1, 1, (4000, 1)).astype(np.float32))
    out = port(big, train=True, generator=torch.Generator().manual_seed(0))
    dropped = (out.abs().sum(-1) == 0).float().mean().item()
    assert abs(dropped - 0.25) < 0.03

"""The PyTorch port's Diffuser plan against the JAX package's.

Same weights (seeded numpy normals in the JAX layout, carried into the
port by the converter: the U-Net and its EMA, the classifier and its EMA),
same observations and the same sampler noise (the JAX sampler's own draws,
replayed from its key splits) go through
`cleandiffuser_tpu.pipelines.diffuser.DiffuserPipeline` and through the
port's `DiffuserPipeline.act`, at E = 2 environments x K = 3 candidates and
3 ddpm steps with classifier guidance. All candidate trajectories, their
final log p, the chosen index, the chosen plan and the actions must agree,
in both prediction forms (x0, the shipped config's, and eps), which take
the guidance gradient with different weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines.diffuser import DiffuserPipeline as JaxDiffuserPipeline
from cleandiffuser_tpu_torch.pipelines import DiffuserPipeline
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, jax_params_of
from jax_shaped_init import shaped_inits

torch.set_num_threads(1)

CFG = dict(obs_dim=5, act_dim=3, horizon=8, model_dim=16, dim_mult=(1, 2), diffusion_steps=20,
           sampling_steps=3, w_cg=1.0, temperature=0.5)
E, K = 2, 3
# Measured gap ~1e-6: float32 on both sides with the same schedule tables,
# noise and weights; sums are taken in another order (convs, GroupNorm
# statistics) and the classifier's gradient is a backward pass through them.
TOL = 1e-5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _seeded(tree, seed, std=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * std).astype(np.float32), _numpy_tree(tree))


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


@pytest.fixture(scope="module", params=["x0", "eps"])
def plans(request):
    predict_noise = request.param == "eps"
    # every leaf is seeded below: no compile of the nets' inits
    # (tests/jax_shaped_init.py)
    with shaped_inits():
        jpipe = JaxDiffuserPipeline(**CFG, predict_noise=predict_noise)
    weights = dict(params=_seeded(jpipe.agent.state.params, 1),
                   ema_params=_seeded(jpipe.agent.state.ema_params, 2),
                   cls_params=_seeded(jpipe.classifier.state.params, 3),
                   cls_ema_params=_seeded(jpipe.classifier.state.ema_params, 4))
    obs = np.random.default_rng(5).standard_normal((E, CFG["obs_dim"])).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    ema, cls_ema = jt(weights["ema_params"]), jt(weights["cls_ema_params"])
    act_j, best_j, logp_j = jpipe._make_plan_fn(E, K)(ema, cls_ema, rng, jnp.asarray(obs))

    # every candidate, from the JAX sampler the plan calls, same key
    D = CFG["obs_dim"] + CFG["act_dim"]
    prior = jnp.zeros((E, CFG["horizon"], D)).at[:, 0, :CFG["obs_dim"]].set(obs)
    prior = jnp.tile(prior, (K, 1, 1))
    sample_fn = jpipe.agent.build_sample_fn(solver="ddpm", sample_steps=CFG["sampling_steps"],
                                            cfg_mode="uncond", use_cg=True, final_logp=True)
    traj_all, log = jax.jit(sample_fn, static_argnames=())(
        ema, cls_ema, rng, prior, w_cg=CFG["w_cg"], temperature=CFG["temperature"])

    tpipe = DiffuserPipeline(**CFG, predict_noise=predict_noise, device="cpu")
    tpipe.load_jax_params(**weights)
    init, per_step = _jax_noise(rng, prior.shape, CFG["sampling_steps"])
    act_t, info = tpipe.act(obs, num_candidates=K,
                            noise=(torch.from_numpy(init), torch.from_numpy(per_step)))
    return dict(obs=obs, act_j=np.asarray(act_j), best_j=np.asarray(best_j),
                logp_j=np.asarray(logp_j),
                cand_j=np.asarray(traj_all).reshape(K, E, CFG["horizon"], D),
                cand_logp_j=np.asarray(log["log_p"]).reshape(K, E, -1).sum(-1),
                act_t=act_t.numpy(), info={k: v.numpy() for k, v in info.items()},
                tpipe=tpipe, jpipe=jpipe, weights=weights)


def test_candidates_and_logp_match_jax(plans):
    """All K*E sampled trajectories (classifier-guided at every step) and
    their final log p."""
    cand = plans["info"]["candidates"]
    assert cand.shape == plans["cand_j"].shape
    assert np.abs(plans["cand_j"][:, :, 1:]).max() > 0.1  # not trivially zero
    np.testing.assert_allclose(cand, plans["cand_j"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(plans["info"]["candidate_logp"], plans["cand_logp_j"],
                               atol=TOL, rtol=TOL)


def test_chosen_plan_matches_jax(plans):
    """Index, chosen plan, its log p and the action, against the JAX plan
    function itself."""
    idx = plans["info"]["idx"]
    np.testing.assert_array_equal(idx, plans["cand_logp_j"].argmax(0))
    np.testing.assert_allclose(plans["info"]["traj"], plans["best_j"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(plans["info"]["logp"], plans["logp_j"], atol=TOL, rtol=TOL)
    assert plans["act_t"].shape == (E, CFG["act_dim"])
    np.testing.assert_allclose(plans["act_t"], plans["act_j"], atol=TOL, rtol=TOL)


def test_classifier_guidance_moves_the_plan(plans):
    """With w_cg = 0 the same noise gives other trajectories: the guidance
    term is live in the comparison above."""
    tpipe = plans["tpipe"]
    tpipe.w_cg = 0.0
    try:
        shape = (K * E, CFG["horizon"], CFG["obs_dim"] + CFG["act_dim"])
        init, per_step = _jax_noise(jax.random.PRNGKey(6), shape, CFG["sampling_steps"])
        _, info = tpipe.act(plans["obs"], num_candidates=K,
                            noise=(torch.from_numpy(init), torch.from_numpy(per_step)))
    finally:
        tpipe.w_cg = CFG["w_cg"]
    assert np.abs(info["candidates"].numpy() - plans["info"]["candidates"]).max() > 1e-3


def test_plan_pins_first_state(plans):
    """Inpainting: the state part of row 0 is the observation, exactly."""
    np.testing.assert_array_equal(plans["info"]["traj"][:, 0, :CFG["obs_dim"]], plans["obs"])
    np.testing.assert_array_equal(plans["info"]["candidates"][:, :, 0, :CFG["obs_dim"]],
                                  np.broadcast_to(plans["obs"], (K, E, CFG["obs_dim"])))


def test_converter_round_trip(plans):
    """Exporting the port's parameters gives the JAX trees they were loaded
    from, leaf for leaf: U-Net, classifier, and both EMAs."""
    tpipe, w = plans["tpipe"], plans["weights"]
    pairs = [(agent_params_of(tpipe.agent.params), w["params"]),
             (agent_params_of(tpipe.agent.ema_params), w["ema_params"]),
             ({"params": jax_params_of(tpipe.classifier.params)}, w["cls_params"]),
             ({"params": jax_params_of(tpipe.classifier.ema_params)}, w["cls_ema_params"])]
    for got, want in pairs:
        got_leaves = jax.tree_util.tree_leaves_with_path(got)
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (_, a), (_, b) in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(a, b)


def test_discrete_tables_match_jax():
    """DiscreteDiffusionSDE's integer levels, exactly, and its alpha/sigma
    tables to a few ulps: the two libraries' float32 cos may differ by one,
    which sigma = sqrt(1 - alpha^2) amplifies where alpha is near 1."""
    # every leaf is seeded below: no compile of the nets' inits
    # (tests/jax_shaped_init.py)
    with shaped_inits():
        jpipe = JaxDiffuserPipeline(**CFG)
    tpipe = DiffuserPipeline(**CFG, device="cpu")
    for steps in (3, 20):
        want = jpipe.agent._sample_tables("uniform", steps, None)
        got = tpipe.agent._sample_tables("uniform", steps)
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), maxulp=4)


def test_generator_sampling_is_seeded():
    """Without explicit noise the plan draws from the given generator: the
    same seed gives the same plan, another seed another plan."""
    tpipe = DiffuserPipeline(**CFG, device="cpu")
    obs = np.random.default_rng(0).standard_normal((E, CFG["obs_dim"])).astype(np.float32)
    plan = lambda s: tpipe.act(obs, num_candidates=K, generator=torch.Generator().manual_seed(s))
    (a1, i1), (a2, i2), (_, i3) = plan(3), plan(3), plan(4)
    torch.testing.assert_close(i1["candidates"], i2["candidates"], atol=0, rtol=0)
    torch.testing.assert_close(a1, a2, atol=0, rtol=0)
    assert not torch.equal(i1["candidates"][:, :, 1:], i3["candidates"][:, :, 1:])


def test_fused_update_plan_on_the_cpu():
    """fused_update=True takes every ddpm step through solver_update_op (its
    plain version on the CPU, noise seeded per step from the generator):
    a valid, seeded plan; it takes no explicit noise."""
    tpipe = DiffuserPipeline(**CFG, fused_update=True, device="cpu")
    obs = np.random.default_rng(1).standard_normal((E, CFG["obs_dim"])).astype(np.float32)
    a1, i1 = tpipe.act(obs, num_candidates=K, generator=torch.Generator().manual_seed(0))
    a2, i2 = tpipe.act(obs, num_candidates=K, generator=torch.Generator().manual_seed(0))
    assert a1.shape == (E, CFG["act_dim"]) and torch.isfinite(i1["candidates"]).all()
    assert a1.abs().max() <= 1.0
    torch.testing.assert_close(i1["candidates"], i2["candidates"], atol=0, rtol=0)
    np.testing.assert_array_equal(i1["traj"][:, 0, :CFG["obs_dim"]].numpy(), obs)
    shape = (K * E, CFG["horizon"], CFG["obs_dim"] + CFG["act_dim"])
    noise = (torch.zeros(shape), torch.zeros((CFG["sampling_steps"],) + shape))
    with pytest.raises(ValueError, match="explicit noise"):
        tpipe.act(obs, num_candidates=K, noise=noise)
    with pytest.raises(ValueError, match="ddpm"):
        tpipe.agent.build_sample_fn(solver="ddim", fused_update=True)

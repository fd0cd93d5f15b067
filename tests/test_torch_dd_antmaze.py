"""The port's Decision Diffuser at the antmaze configs' settings against the
JAX package's: horizon 64 (K1 on 2-block clusters on the card; its plain
version here, as the JAX package's fused block runs its reference on the
CPU), the `ddim` solver, noise prediction and the value shift of 1.0 that
moves antmaze's returns (at most 0) into [0, 1].

Same weights (seeded numpy normals in the JAX layout), same batches and the
JAX update's own draws (`rng, sub = split(state.rng)`, `k_noise, k_cond, _ =
split(sub, 3)`, `k_t, k_eps = split(k_noise)`; the condition's keep-mask
read back from the rows the JAX condition zeroes) go through 3
`train_step`s of both packages; then one plan from the trained EMA with
the JAX sampler's draws replayed. Narrow widths (d_model 64, 2 heads,
depth 2) at the shipped horizon.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines.dd import DDPipeline as JaxDDPipeline
from cleandiffuser_tpu_torch.pipelines import DDPipeline
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, jax_params_of
from jax_shaped_init import shaped_inits

torch.set_num_threads(1)

CFG = dict(obs_dim=5, act_dim=3, horizon=64, emb_dim=32, d_model=64, n_heads=2, depth=2,
           solver="ddim", predict_noise=True, sampling_steps=4, w_cfg=2.5, target_return=0.3,
           return_scale=100.0, val_shift=1.0, temperature=0.5, ema_rate=0.9,
           diffusion_gradient_steps=5, lr=1e-3)
B, STEPS, E = 8, 3, 4
# float32 on both sides with the same weights and draws; sums in another
# order (matrix products, LayerNorm statistics, the softmax over 64 keys),
# ~1e-6 relative. Adam moves a param by ~lr whatever its gradient's size, so
# where a gradient is rounding noise in both packages (the DiT's key bias:
# softmax ignores it) the params differ by up to lr per step.
TOL = 1e-5
KEY_BIAS_TOL = CFG["lr"] * STEPS


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _seeded(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), _numpy_tree(tree))


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batch(rng):
    """Antmaze's values: discounted sums of -1 per step, at most 0."""
    H = CFG["horizon"]
    return {"obs": {"state": rng.standard_normal((B, H, CFG["obs_dim"])).astype(np.float32)},
            "act": rng.uniform(-1, 1, (B, H, CFG["act_dim"])).astype(np.float32),
            "val": rng.uniform(-100, 0, (B, 1)).astype(np.float32)}


def _jax_draws(jpipe, batch):
    agent, st = jpipe.agent, jpipe.agent.state
    _, sub = jax.random.split(st.rng)
    k_noise, k_cond, _ = jax.random.split(sub, 3)
    k_t, k_eps = jax.random.split(k_noise)
    t = jax.random.uniform(k_t, (B,), minval=agent.t_diffusion[0], maxval=agent.t_diffusion[1])
    eps = jax.random.normal(k_eps, batch["obs"]["state"].shape)
    cond = jnp.asarray(batch["val"]) / jpipe.return_scale + jpipe.val_shift
    train = np.asarray(agent.apply_condition(st.params, cond, train=True, rng=k_cond))
    keep = (np.abs(train).sum(-1) > 0).astype(np.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in (t, eps, keep))


def _jax_noise(rng, shape, steps):
    """The JAX sampler's draws: k_init, k_scan = split(rng); then
    rng, k_noise = split(rng) at every step."""
    k_init, k = jax.random.split(rng)
    init = np.array(jax.random.normal(k_init, shape))
    per_step = []
    for _ in range(steps):
        k, k_noise = jax.random.split(k)
        per_step.append(np.asarray(jax.random.normal(k_noise, shape)))
    return torch.from_numpy(init), torch.from_numpy(np.stack(per_step))


def _assert_tree_close(got, want):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(_numpy_tree(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    D = CFG["d_model"]
    for (path, a), (_, b) in zip(got_l, want_l):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bqkv']"):
            np.testing.assert_allclose(a[D:2 * D], b[D:2 * D], atol=KEY_BIAS_TOL, err_msg=name)
            a, b = a.copy(), b.copy()
            a[D:2 * D] = b[D:2 * D] = 0
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def run():
    # every leaf is seeded below: no compile of the nets' inits
    # (tests/jax_shaped_init.py)
    with shaped_inits():
        jpipe = JaxDDPipeline(**CFG, use_pallas_block=True)
    params, ema = _seeded(jpipe.agent.state.params, 1), _seeded(jpipe.agent.state.ema_params, 2)
    inv = _seeded(jpipe.invdyn.params, 3)
    jpipe.agent.state = jpipe.agent.state.replace(params=_jt(params), ema_params=_jt(ema))
    jpipe.invdyn.params = _jt(inv)
    tpipe = DDPipeline(**CFG, use_pallas_block=True, device="cpu")
    tpipe.load_jax_params(params, ema, inv)

    rng = np.random.default_rng(4)
    logs, keeps = {"jax": [], "port": []}, []
    for _ in range(STEPS):
        batch = _batch(rng)
        noise = _jax_draws(jpipe, batch)
        keeps.append(noise[2])
        logs["jax"].append({k: float(v) for k, v in
                            jpipe.train_step(jax.tree_util.tree_map(jnp.asarray, batch)).items()})
        logs["port"].append({k: float(v) for k, v in tpipe.train_step(batch, noise=noise).items()})

    obs = rng.standard_normal((E, CFG["obs_dim"])).astype(np.float32)
    key = jax.random.PRNGKey(5)
    cond = jnp.ones((E, 1)) * CFG["target_return"]
    act_j, traj_j = jpipe._make_plan_fn(E)(jpipe.agent.state.ema_params, jpipe.invdyn.params,
                                           key, jnp.asarray(obs), cond)
    noise = _jax_noise(key, (E, CFG["horizon"], CFG["obs_dim"]), CFG["sampling_steps"])
    act_t, info = tpipe.act(obs, noise=noise)
    return dict(jpipe=jpipe, tpipe=tpipe, logs=logs, keeps=keeps, obs=obs,
                act_j=np.asarray(act_j), traj_j=np.asarray(traj_j), act_t=act_t.numpy(),
                traj_t=info["traj"].numpy())


def test_losses_and_grad_norms_match_jax(run):
    for lj, lt in zip(run["logs"]["jax"], run["logs"]["port"]):
        assert set(lj) == set(lt) == {"loss", "grad_norm", "invdyn_loss"}
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=TOL, err_msg=k)
    keep = torch.cat(run["keeps"])
    assert 0 < keep.sum() < keep.numel()  # the label dropout is live


def test_state_after_three_steps_matches_jax(run):
    tpipe, st = run["tpipe"], run["jpipe"].agent.state
    _assert_tree_close(agent_params_of(tpipe.agent.params), st.params)
    _assert_tree_close(agent_params_of(tpipe.agent.ema_params), st.ema_params)
    _assert_tree_close(jax_params_of(tpipe.invdyn.net), run["jpipe"].invdyn.params["params"])
    assert tpipe.agent.step == int(st.step) == STEPS


def test_plan_from_the_trained_ema_matches_jax(run):
    """64 steps of horizon, ddim with noise prediction: the trajectory
    within TOL of its scale, and the action of the inverse dynamics. ddim's
    first step takes x0 = (x_t - sigma eps) / alpha at a small alpha, and
    untrained weights predict no eps that cancels x_t, so the plan leaves
    the data's range (|x| ~ 170 here) and float32 rounding grows with it:
    the trajectory is held to TOL x max |traj| (measured 8.7e-7 of it)."""
    assert run["traj_t"].shape == (E, CFG["horizon"], CFG["obs_dim"])
    scale = np.abs(run["traj_j"]).max()
    assert scale > 1.0
    np.testing.assert_allclose(run["traj_t"], run["traj_j"], atol=TOL * scale, rtol=TOL)
    np.testing.assert_allclose(run["act_t"], run["act_j"], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(run["traj_t"][:, 0], run["obs"])


def test_value_shift_moves_antmaze_returns_into_the_unit_interval(run):
    """The condition the engine trains on: val / 100 + 1, for returns in
    [-100, 0]."""
    tpipe = run["tpipe"]
    val = torch.tensor([[-100.0], [-37.0], [0.0]])
    cond = val / tpipe.return_scale + tpipe.val_shift
    torch.testing.assert_close(cond, torch.tensor([[0.0], [0.63], [1.0]]))

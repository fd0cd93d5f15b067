"""The port's AdaptDiffuser pipeline against the JAX package's (ports
tests/test_hier_pipelines.py:54-71).

Same weights (seeded numpy normals in the JAX layout: the U-Net, its EMA,
the classifier and its EMA), the same start states and the JAX sampler's
own draws, replayed from its key splits, go through
`cleandiffuser_tpu.pipelines.adaptdiffuser.AdaptDiffuserPipeline` and the
port's, built with the fused block on (its CPU path is K3's plain
version). `generate_and_filter` gives the same trajectories and log p
(within TOL) and, at a threshold between two of the log p values, the same
keep mask; 3 `finetune_step`s on the kept trajectories with the JAX
update's draws give the same losses and parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines.adaptdiffuser import AdaptDiffuserPipeline as JaxAdaptDiffuser
from cleandiffuser_tpu_torch.pipelines import AdaptDiffuserPipeline
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of
from jax_shaped_init import shaped_inits

torch.set_num_threads(1)

# the shipped configs' x0 prediction; a fast EMA and a short cosine, so that
# 3 fine-tuning steps move both
CFG = dict(obs_dim=5, act_dim=3, horizon=8, model_dim=16, dim_mult=(1, 2), diffusion_steps=20,
           sampling_steps=3, predict_noise=False, w_cg=1.0, temperature=0.5, ema_rate=0.9,
           diffusion_gradient_steps=5, lr=1e-3)
N, B, STEPS = 12, 6, 3
D = CFG["obs_dim"] + CFG["act_dim"]
# float32 on both sides with the same weights, tables and noise; sums in
# another order (convs, GroupNorm statistics, the classifier's backward):
# ~1e-6 measured in the Diffuser plan (tests/test_torch_diffuser_slice.py)
TOL = 1e-5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _seeded(tree, seed, std=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * std).astype(np.float32), _numpy_tree(tree))


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


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


def _jax_update_draws(jpipe, shape):
    """The JAX update's (t, eps): rng, sub = split(state.rng); k_noise =
    split(sub, 3)[0]; k_t, k_eps = split(k_noise)."""
    _, sub = jax.random.split(jpipe.agent.state.rng)
    k_t, k_eps = jax.random.split(jax.random.split(sub, 3)[0])
    t = jax.random.randint(k_t, (shape[0],), 0, CFG["diffusion_steps"])
    eps = jax.random.normal(k_eps, shape)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps)), None


def _assert_tree_close(got, want):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(_numpy_tree(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def pipes():
    # every leaf is seeded below: no compile of the nets' inits
    # (tests/jax_shaped_init.py)
    with shaped_inits():
        jpipe = JaxAdaptDiffuser(**CFG)
    w = [_seeded(t, s) for s, t in enumerate(
        (jpipe.agent.state.params, jpipe.agent.state.ema_params, jpipe.classifier.state.params,
         jpipe.classifier.state.ema_params), start=1)]
    jpipe.agent.state = jpipe.agent.state.replace(params=_jt(w[0]), ema_params=_jt(w[1]))
    jpipe.classifier.state = jpipe.classifier.state.replace(params=_jt(w[2]),
                                                            ema_params=_jt(w[3]))
    tpipe = AdaptDiffuserPipeline(**CFG, use_pallas_block=True, device="cpu")
    tpipe.load_jax_params(*w)
    obs = np.random.default_rng(5).standard_normal((N, CFG["obs_dim"])).astype(np.float32)
    return jpipe, tpipe, obs


@pytest.fixture(scope="module")
def generated(pipes):
    """Every trajectory and its log p (a threshold below all of them) from
    both packages, with the same draws."""
    jpipe, tpipe, obs = pipes
    key = jax.random.PRNGKey(6)
    traj_j, logp_j = jpipe.generate_and_filter(obs, -np.inf, rng=key)
    noise = _jax_noise(key, (N, CFG["horizon"], D), CFG["sampling_steps"])
    traj_t, logp_t = tpipe.generate_and_filter(obs, -np.inf, noise=noise)
    return dict(key=key, noise=noise, traj_j=traj_j, logp_j=logp_j, traj_t=traj_t.numpy(),
                logp_t=logp_t.numpy())


def test_generated_trajectories_and_logp_match_jax(generated, pipes):
    g, obs = generated, pipes[2]
    assert g["traj_t"].shape == g["traj_j"].shape == (N, CFG["horizon"], D)
    assert g["logp_t"].shape == g["logp_j"].shape == (N, 1)
    assert np.abs(g["traj_j"][:, 1:]).max() > 0.1  # not trivially zero
    np.testing.assert_allclose(g["traj_t"], g["traj_j"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(g["logp_t"], g["logp_j"], atol=TOL, rtol=TOL)
    # the first state is inpainted
    np.testing.assert_array_equal(g["traj_t"][:, 0, :CFG["obs_dim"]], obs)


def test_filter_keeps_the_same_trajectories(generated, pipes):
    """At a threshold between two log p values (at the widest gap near the
    median), both keep the same rows, in order."""
    jpipe, tpipe, obs = pipes
    lp = np.sort(generated["logp_j"][:, 0])
    gaps = lp[N // 4 + 1: 3 * N // 4 + 1] - lp[N // 4: 3 * N // 4]
    i = N // 4 + int(np.argmax(gaps))
    assert gaps.max() > 100 * TOL
    threshold = float((lp[i] + lp[i + 1]) / 2)
    traj_j, logp_j = jpipe.generate_and_filter(obs, threshold, rng=generated["key"])
    traj_t, logp_t = tpipe.generate_and_filter(obs, threshold, noise=generated["noise"])
    keep = generated["logp_j"][:, 0] > threshold
    assert 0 < keep.sum() < N
    assert traj_t.shape[0] == traj_j.shape[0] == keep.sum()
    np.testing.assert_allclose(traj_t.numpy(), generated["traj_j"][keep], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(traj_t.numpy(), traj_j, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(logp_t.numpy(), logp_j, atol=TOL, rtol=TOL)


def test_three_finetune_steps_match_jax(pipes, generated):
    """The diffusion update on the kept set, batches of B from a seeded
    numpy generator as the CLI draws them: losses, grad norms, then the
    U-Net's params and EMA. The classifier does not move."""
    jpipe, tpipe, _ = pipes
    buffer = generated["traj_j"]
    rng = np.random.default_rng(0)
    cls_before = {k: v.clone() for k, v in tpipe.classifier.params.state_dict().items()}
    for _ in range(STEPS):
        batch = buffer[rng.integers(0, N, B)]
        noise = _jax_update_draws(jpipe, batch.shape)
        lj = {k: float(v) for k, v in jpipe.finetune_step(batch).items()}
        lt = {k: float(v) for k, v in tpipe.finetune_step(batch, noise=noise).items()}
        assert set(lj) == set(lt) == {"loss", "grad_norm"}
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=TOL, err_msg=k)
    st = jpipe.agent.state
    assert tpipe.agent.step == int(st.step) == STEPS
    _assert_tree_close(agent_params_of(tpipe.agent.params), st.params)
    _assert_tree_close(agent_params_of(tpipe.agent.ema_params), st.ema_params)
    for k, v in tpipe.classifier.params.state_dict().items():
        assert torch.equal(v, cls_before[k]), k


def test_generation_is_seeded_and_cached_per_shape():
    """Without explicit noise the trajectories come from the given
    generator; one sampler per (rows, steps)."""
    tpipe = AdaptDiffuserPipeline(**CFG, device="cpu")
    obs = np.random.default_rng(1).standard_normal((4, CFG["obs_dim"])).astype(np.float32)
    a, _ = tpipe.generate_and_filter(obs, -np.inf, generator=torch.Generator().manual_seed(3))
    b, _ = tpipe.generate_and_filter(obs, -np.inf, generator=torch.Generator().manual_seed(3))
    c, _ = tpipe.generate_and_filter(obs, -np.inf, sampling_steps=2,
                                     generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a[:, 1:], c[:, 1:])
    assert sum(k[0] == "gen" for k in tpipe._plan_fns) == 2

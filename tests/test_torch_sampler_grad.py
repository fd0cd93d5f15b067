"""The port's sampler follows the caller's grad mode, as the JAX sampler is a
plain differentiable function (DQL's policy loss backpropagates through
it).

- On a small `DiscreteDiffusionSDE` (the DQL actor: `DQLMlp`, identity
  condition, actions clipped to [-1, 1]), the gradient of a fixed weighted
  sum of a 2-step ddpm sample with respect to the backbone's params equals
  `jax.grad` of the JAX sampler's same function, with the JAX sampler's own
  draws injected into the port's, for noise and for x0 prediction: every
  element within 1e-5 of the gradient's largest magnitude (float32 on both
  sides; see GRAD_TOL). The samples agree within 1e-5.
- The callers that only sample run under `torch.no_grad()`: the DQL, DD
  and Diffuser `act` outputs carry no grad.
- `fused_update` (K2 has no backward) with grad mode on raises; under
  `torch.no_grad()` it samples.
- The cosine schedule of `DiscreteDiffusionSDE` at T = 5 (DQL, IDQL) and
  T = 1000 (EDP) and its 5- and 15-step sampling tables equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.diffusion import DiscreteDiffusionSDE as JaxSDE
from cleandiffuser_tpu.nn_condition import IdentityCondition as JaxIdentity
from cleandiffuser_tpu.nn_diffusion import DQLMlp as JaxDQLMlp
from cleandiffuser_tpu_torch.diffusion import DiscreteDiffusionSDE
from cleandiffuser_tpu_torch.nn_condition import IdentityCondition
from cleandiffuser_tpu_torch.nn_diffusion import DQLMlp
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, load_agent_params

torch.set_num_threads(1)

TOL = 1e-5
# The gradient sums B x STEPS paths through the sampler. The first step
# starts at level T - 1, where the cosine schedule's alpha is 0.0084, and
# x0 = (xt - sigma * eps) / alpha amplifies a float32 rounding of xt or eps
# by 1 / alpha ~ 119: elements of a gradient of magnitude ~4 differ by up to
# ~1.4e-5 between the two packages (3.5e-6 of the largest). So each element
# is held within 1e-5 of the gradient's largest magnitude.
GRAD_TOL = 1e-5
B, OBS, ACT, T, STEPS = 6, 4, 3, 5, 2


def _engines(predict_noise):
    kw = dict(predict_noise=predict_noise, x_max=np.ones(ACT), x_min=-np.ones(ACT),
              diffusion_steps=T)
    jeng = JaxSDE(JaxDQLMlp(obs_dim=OBS, act_dim=ACT, emb_dim=16), JaxIdentity(dropout=0.0), **kw)
    jeng.init(jnp.zeros((1, ACT)), jnp.zeros((1, OBS)))
    rng = np.random.default_rng(0)
    # seeded weights at the init's scale: kernels 1 / sqrt(fan_in), biases
    # 0.1; some predictions leave the clip box
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * (0.1 if a.ndim == 1 else 1 / np.sqrt(
            a.shape[0]))).astype(np.float32), jeng.state.params)
    teng = DiscreteDiffusionSDE(DQLMlp(OBS, ACT, emb_dim=16), IdentityCondition(dropout=0.0),
                                device="cpu", **kw)
    load_agent_params(teng.params, params)
    return jeng, teng, params


def _jax_noise(key, shape, steps):
    """The JAX sampler's draws: k_init, k_scan = split(rng); then
    rng, k_noise = split(rng) at every step."""
    k_init, k = jax.random.split(key)
    init = np.asarray(jax.random.normal(k_init, shape))
    per = []
    for _ in range(steps):
        k, k_noise = jax.random.split(k)
        per.append(np.asarray(jax.random.normal(k_noise, shape)))
    return torch.from_numpy(init.copy()), torch.from_numpy(np.stack(per))


@pytest.mark.parametrize("predict_noise", [True, False])
def test_sample_gradient_matches_jax_grad(predict_noise):
    jeng, teng, params = _engines(predict_noise)
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((B, OBS)).astype(np.float32)
    w = rng.standard_normal((B, ACT)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jfn = jeng.build_sample_fn(solver="ddpm", sample_steps=STEPS, cfg_mode="cond",
                               final_logp=False)

    def objective(p):
        x, _ = jfn(p, None, key, jnp.zeros((B, ACT)), condition_cfg=jnp.asarray(obs), w_cfg=1.0)
        return (x * w).sum(), x

    (_, x_j), g_j = jax.value_and_grad(objective, has_aux=True)(jax.tree_util.tree_map(
        jnp.asarray, params))

    tfn = teng.build_sample_fn(solver="ddpm", sample_steps=STEPS, cfg_mode="cond",
                               final_logp=False)
    x_t, _ = tfn(teng.params, None, torch.zeros((B, ACT)), condition_cfg=torch.from_numpy(obs),
                 w_cfg=1.0, noise=_jax_noise(key, (B, ACT), STEPS))
    assert x_t.requires_grad
    (x_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x_t.detach().numpy(), np.asarray(x_j), atol=TOL, rtol=TOL)

    grads = {n: p.grad for n, p in teng.params.named_parameters()}
    assert all(g is not None for g in grads.values())
    view = {n: p.grad.numpy() for n, p in teng.params.named_parameters()}
    want = agent_params_of(_as_module_copy(teng, g_j))
    got = agent_params_of(_as_module_copy(teng, None, view))
    scale = max(np.abs(v).max() for v in view.values())
    assert scale > 1e-2
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL * scale, rtol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _as_module_copy(teng, jax_tree=None, by_name=None):
    """A copy of the engine's params holding a JAX tree (gradients) or the
    port's named tensors, for a leaf-by-leaf comparison in the flax layout."""
    import copy

    m = copy.deepcopy(teng.params)
    if jax_tree is not None:
        load_agent_params(m, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                                    jax_tree))
    else:
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(torch.from_numpy(by_name[n]))
    return m


def test_sampling_callers_record_no_graph():
    from cleandiffuser_tpu_torch.pipelines import DDPipeline, DiffuserPipeline, DQLPipeline

    obs = np.random.default_rng(2).standard_normal((2, OBS)).astype(np.float32)
    dql = DQLPipeline(OBS, ACT, diffusion_steps=2, sampling_steps=2, hidden_dim=16, device="cpu")
    for use_ema in (True, False):
        assert not dql.act(obs, num_candidates=3, use_ema=use_ema).requires_grad
    dd = DDPipeline(obs_dim=OBS, act_dim=ACT, horizon=4, emb_dim=16, d_model=32, n_heads=2,
                    depth=1, sampling_steps=2, device="cpu")
    act, info = dd.act(obs, use_ema=False)
    assert not act.requires_grad and not info["traj"].requires_grad
    diffuser = DiffuserPipeline(obs_dim=OBS, act_dim=ACT, horizon=8, model_dim=16,
                                dim_mult=(1, 2), diffusion_steps=4, sampling_steps=2,
                                device="cpu")
    act, info = diffuser.act(obs, num_candidates=2, use_ema=False)
    assert not act.requires_grad and not info["traj"].requires_grad


def test_fused_update_refuses_grad_mode():
    _, teng, _ = _engines(True)
    fn = teng.build_sample_fn(solver="ddpm", sample_steps=STEPS, cfg_mode="cond",
                              final_logp=False, fused_update=True)
    args = (teng.params, torch.Generator().manual_seed(0), torch.zeros((B, ACT)))
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args, condition_cfg=torch.zeros((B, OBS)))
    with torch.no_grad():
        x, _ = fn(*args, condition_cfg=torch.zeros((B, OBS)))
    assert x.shape == (B, ACT) and torch.isfinite(x).all()


@pytest.mark.parametrize("diffusion_steps,sample_steps", [(5, 5), (1000, 15)])
def test_discrete_cosine_schedule_matches_jax(diffusion_steps, sample_steps):
    kw = dict(diffusion_steps=diffusion_steps)
    jeng = JaxSDE(JaxDQLMlp(obs_dim=OBS, act_dim=ACT), JaxIdentity(dropout=0.0), **kw)
    teng = DiscreteDiffusionSDE(DQLMlp(OBS, ACT), IdentityCondition(dropout=0.0),
                                device="cpu", **kw)
    # alpha within two float32 steps at 1 (2.4e-7): torch's and XLA's cos
    # round a few of the 1000 levels differently. sigma = sqrt(1 - alpha^2)
    # turns such a step near alpha = 1 into a relative step of ~1.2e-7 /
    # sigma^2 (1.7e-5 read at sigma ~0.08), so sigma is held to 3e-5 relative.
    jt = jeng._sample_tables("uniform", sample_steps, None)
    tt = teng._sample_tables("uniform", sample_steps)
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
    for got, want in ((teng.alpha, jeng.alpha), (tt[1], jt[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2.4e-7)
    for got, want in ((teng.sigma, jeng.sigma), (tt[2], jt[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=0)

"""The PyTorch port's Diffusion Veteran pipeline against the JAX package's.

Each case builds the JAX `VeteranPipeline` at a small width, replaces every
component's weights with seeded numpy normals, writes its checkpoint
(`save`) and reads that pickle into the port's pipeline with
`load_jax_checkpoint` (planner, EMA, Adam moments and schedule, EV state,
critic or classifier, policy or inverse dynamics). Then:

- plans and actions: `act` with the JAX draws replayed as explicit noise
  (`k_plan, k_policy = split(rng)`, then each sampler's
  `k_init, k_scan = split(...)` and a key per step), for every guidance
  and selector (MCSS with the EV net and with the critic head, cfg, cg),
  the joint pipeline, goal inpainting at `gi_pin_idx`, `rebase_policy` and
  the MLP inverse dynamics; the candidate batch and its scores before the
  argmax against the JAX planner's and scorer's, and the same picks;
- 3 `train_step`s and 3 EV steps with the JAX updates' draws replayed
  (`rng, sub = split(state.rng)`, `k_noise, k_cond, _ = split(sub, 3)`,
  `k_t, k_eps = split(k_noise)`; cfg's keep-mask read back; cg's
  classifier input from `next_sample_rng`), every loss and the params after;
- the window (`make_train_scan`, `make_ev_train_scan`) equals its steps
  taken one by one, for the guidance x pipeline grid of
  tests/test_fused_rl_window.py:108-173;
- the port's own checkpoint round trip, and tests/test_hier_pipelines.py's
  Veteran checks (73-177) on the port.

Tolerance: float32 on both sides, 5 sampler steps: 1e-5 (plans, losses,
params after 3 Adam steps). The attention's key bias adds the same q.b_k to
every score of a query's row, which softmax ignores: its gradient is 0 in
exact arithmetic and rounding noise in both packages, which Adam turns into
steps of up to ~3 lr with the noise's sign. So the key biases (the
critic's and the planner DiT's) are held within KEY_BIAS_TOL. The seeded
critic amplifies its params' float32 rounding about a hundredfold (params
1e-7 apart give values 2e-5 apart), so after each step its params are
checked and then copied from the JAX pipeline: every step's value loss is
compared from the same critic.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines.veteran import VeteranPipeline as JaxVeteran
from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoTDDataset, DV_D4RLMuJoCoSeqDataset
from cleandiffuser_tpu_torch.dataset.fake import fake_d4rl_dataset, fake_d4rl_qlearning_dataset
from cleandiffuser_tpu_torch.pipelines import VeteranPipeline
from cleandiffuser_tpu_torch.utils.jax_params import load_agent_params, load_jax_params
from jax_shaped_init import shaped_inits

torch.set_num_threads(1)

TOL = 1e-5
O, A, H, E, K, B = 4, 2, 8, 2, 3, 6
PLAN_STEPS, POL_STEPS = 5, 3
BASE = dict(obs_dim=O, act_dim=A, planner_horizon=H, planner_emb_dim=32, planner_d_model=64,
            planner_depth=1, unet_dim=8, policy_hidden_dim=32, policy_diffusion_steps=POL_STEPS,
            policy_sampling_steps=POL_STEPS, planner_sampling_steps=PLAN_STEPS,
            gradient_steps=10, lr=2e-4, critic_lr=2e-4, temperature=0.8, w_cfg=1.3,
            target_return=0.7)
# Adam's largest step is (1 - b1) / sqrt(1 - b2) ~ 3.2 lr; 3 steps
KEY_BIAS_TOL = 3 * 3.2 * BASE["lr"]
CASES = {
    "mcss-ev": dict(),
    "mcss-critic": dict(mcss_selector="critic"),
    "cfg": dict(guidance_type="cfg"),
    "cg": dict(guidance_type="cg", planner_net="unet"),
    "joint": dict(pipeline_type="joint"),
    "goal-pin": dict(mcss_selector="critic", goal_inpaint=True, gi_pin_idx=3,
                     planner_solver="ddim"),
    "rebase": dict(rebase_policy=True),
    "mlp-invdyn": dict(use_diffusion_invdyn=False, use_weighted_regression=True),
}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax.device_get(tree))


def _seeded(tree, seed):
    """Normals at a Dense init's scale (1 / sqrt(fan-in)); vectors 0.2."""
    rng = np.random.default_rng(seed)

    def fill(a):
        scale = 1 / np.sqrt(np.prod(a.shape[:-1])) if a.ndim >= 2 else 0.2
        return jnp.asarray((rng.standard_normal(a.shape) * scale).astype(np.float32))

    return jax.tree_util.tree_map(fill, _np(tree))


def _seed_jax(jp, seed=0):
    pl = jp.planner
    pl.state = pl.state.replace(params=_seeded(pl.state.params, seed + 1),
                                ema_params=_seeded(pl.state.ema_params, seed + 2))
    if jp.critic is not None:
        jp.critic_params = _seeded(jp.critic_params, seed + 3)
    if pl.classifier is not None:
        c = pl.classifier
        c.state = c.state.replace(params=_seeded(c.state.params, seed + 4),
                                  ema_params=_seeded(c.state.ema_params, seed + 5))
    if jp.policy is not None:
        p = jp.policy
        p.state = p.state.replace(params=_seeded(p.state.params, seed + 6),
                                  ema_params=_seeded(p.state.ema_params, seed + 7))
    if jp.invdyn is not None:
        jp.invdyn.params = _seeded(jp.invdyn.params, seed + 8)
    jp.ev_state = jp.ev_state.replace(params=_seeded(jp.ev_state.params, seed + 9),
                                      target_params=_seeded(jp.ev_state.params, seed + 10))


_KEYS = ("_rng", "_sample_rng", "_root_rng")


def _parts(jp):
    return [p for p in (jp, jp.planner, jp.planner.classifier, jp.policy, jp.invdyn)
            if p is not None]


def _sample_keys(jp):
    """The JAX pipeline's keys that its checkpoint does not hold."""
    return [{k: getattr(p, k) for k in _KEYS if hasattr(p, k)} for p in _parts(jp)]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """`pair(case)`: the case's seeded JAX pipeline and a port pipeline that
    loaded the JAX checkpoint. Each JAX pipeline is built and seeded once for
    the module (its build compiles its init, the file's largest cost) and
    handed out restored from its checkpoint and its keys, so every test
    starts from the same state as a fresh build."""
    tmp, built = tmp_path_factory.mktemp("veteran_pairs"), {}

    def pair(case):
        cfg = {**BASE, **CASES[case]}
        if case not in built:
            # every leaf is seeded: the build takes its nets' param shapes
            # without compiling their inits (tests/jax_shaped_init.py)
            with shaped_inits():
                jp = JaxVeteran(**cfg, rng=0)
            _seed_jax(jp)
            path = str(tmp / f"{case}.pkl")
            jp.save(path)
            built[case] = (jp, path, _sample_keys(jp))
        jp, path, keys = built[case]
        jp.load(path)
        for part, saved in zip(_parts(jp), keys):
            part.__dict__.update(saved)
        tp = VeteranPipeline(**cfg, rng=0, device="cpu")
        tp.load_jax_checkpoint(path)
        return jp, tp

    return pair


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _sampler_noise(key, shape, steps):
    """The JAX SDE sampler's draws: k_init, k_scan = split(key); then
    k, k_noise = split(k) at every step."""
    k_init, k = jax.random.split(key)
    per_step = []
    for _ in range(steps):
        k, k_noise = jax.random.split(k)
        per_step.append(np.asarray(jax.random.normal(k_noise, shape)))
    return _t(jax.random.normal(k_init, shape)), _t(np.stack(per_step))


def _act_noise(jp, key):
    k_plan, k_policy = jax.random.split(key)
    rows = E if jp.guidance_type == "cfg" else E * K
    return {"plan": _sampler_noise(k_plan, (rows, H, jp.planner_dim), PLAN_STEPS),
            "policy": _sampler_noise(k_policy, (E, A), POL_STEPS)}


def _jax_candidates(jp, key, obs, goal=None):
    """The JAX planner's E*K candidates (env-major) and the scores it ranks
    them by, from the same key."""
    k_plan, _ = jax.random.split(key)
    gt, PD = jp.guidance_type, jp.planner_dim
    mask = None
    pin = jp.gi_pin_idx if jp.gi_pin_idx is not None else H - 1
    if goal is not None:
        mask = np.zeros((H, PD), np.float32)
        mask[0, :O] = 1.0
        mask[pin, :2] = 1.0
    fn = jp.planner.build_sample_fn(solver=jp.planner_solver, sample_steps=PLAN_STEPS,
                                    use_cg=gt == "cg", final_logp=gt == "cg", fix_mask=mask)
    prior = jnp.zeros((E * K, H, PD)).at[:, 0, :O].set(jnp.repeat(jnp.asarray(obs), K, 0))
    if goal is not None:
        prior = prior.at[:, pin, :2].set(jnp.repeat(jnp.asarray(goal), K, 0))
    cls = jp.planner.classifier.inference_params if gt == "cg" else None
    # jitted: one compile of the whole sampler, not one per op
    traj, log = jax.jit(lambda p, c, k, x: fn(p, c, k, x, w_cg=jp.w_cfg if gt == "cg" else 0.0,
                                               temperature=jp.temperature))(
        jp.planner.state.ema_params, cls, k_plan, prior)
    if gt == "cg":
        score = log["log_p"]
    elif jp.mcss_selector == "critic":
        score = jp.critic.apply(jp.critic_params, traj)
    else:
        score = jp.ev_net.apply(jp.ev_state.params, traj[..., :O])[:, 1:].sum(1)
    return np.asarray(traj).reshape(E, K, H, PD), np.asarray(score).reshape(E, K)


@pytest.mark.parametrize("case", list(CASES))
def test_plans_and_actions_match_jax(case, pairs):
    jp, tp = pairs(case)
    rng = np.random.default_rng(11)
    obs = rng.standard_normal((E, O)).astype(np.float32)
    goal = rng.standard_normal((E, 2)).astype(np.float32) if jp.goal_inpaint else None
    key = jax.random.PRNGKey(5)
    jact, jtraj = jp.act(obs, num_candidates=K, rng=key, goal_normed=goal)
    tact, info = tp.act(obs, num_candidates=K, goal_normed=goal, noise=_act_noise(jp, key))
    np.testing.assert_allclose(info["traj"].numpy(), np.asarray(jtraj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=TOL, atol=TOL)
    assert torch.isfinite(tact).all()
    if jp.policy is not None:  # clipped to [-1, 1]; the joint plan's action is not, in both
        assert tact.abs().max() <= 1.0
    if jp.guidance_type != "cfg":
        cand, score = _jax_candidates(jp, key, obs, goal)
        np.testing.assert_allclose(info["candidates"].numpy(), cand, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(info["scores"].numpy(), score, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(info["idx"].numpy(), score.argmax(-1))
    if goal is not None:
        np.testing.assert_array_equal(info["traj"][:, 3, :2].numpy(), goal)
    np.testing.assert_array_equal(info["traj"][:, 0, :O].numpy(), obs)


def _batch(rng):
    return {"obs": {"state": rng.standard_normal((B, H, O)).astype(np.float32)},
            "act": rng.uniform(-1, 1, (B, H, A)).astype(np.float32),
            "val": rng.uniform(-1, 1, (B, 1)).astype(np.float32)}


def _diffusion_draws(engine, x0, condition=None, discrete=False):
    """The draws the JAX engine's next update takes: (t, eps, keep)."""
    _, sub = jax.random.split(engine.state.rng)
    k_noise, k_cond, _ = jax.random.split(sub, 3)
    k_t, k_eps = jax.random.split(k_noise)
    n = x0.shape[0]
    if discrete:
        t = jax.random.randint(k_t, (n,), 0, engine.diffusion_steps)
    else:
        t = jax.random.uniform(k_t, (n,), minval=engine.t_diffusion[0],
                               maxval=engine.t_diffusion[1])
    eps = jax.random.normal(k_eps, x0.shape)
    keep = None
    if condition is not None:
        emb = np.asarray(engine.apply_condition(engine.state.params, jnp.asarray(condition),
                                                train=True, rng=k_cond))
        keep = _t((np.abs(emb).sum(-1) > 0).astype(np.float32))
    return torch.from_numpy(np.array(t)), _t(eps), keep


def _train_draws(jp, pb, qb):
    obs, act = pb["obs"]["state"], pb["act"]
    data = obs if jp.pipeline_type == "separate" else np.concatenate([obs, act], -1)
    noise = {"planner": _diffusion_draws(jp.planner, data,
                                         pb["val"] if jp.guidance_type == "cfg" else None)}
    if jp.guidance_type == "cg":
        k = jax.random.split(jp.planner._sample_rng)[1]
        k_t, k_eps = jax.random.split(k)
        pl = jp.planner
        noise["classifier"] = (
            _t(jax.random.uniform(k_t, (B,), minval=pl.t_diffusion[0], maxval=pl.t_diffusion[1])),
            _t(jax.random.normal(k_eps, data.shape)))
    if jp.policy is not None:
        t, eps, _ = _diffusion_draws(jp.policy, qb["act"][:, 0], discrete=True)
        noise["policy"] = (t, eps, None)
    return noise


def _is_key_bias(name):
    return name.endswith("attn.key.bias") or name.endswith(".bqkv")


def _assert_module_close(module, tree, load=load_jax_params):
    """`module`'s params against the JAX `tree` read into a copy of it
    (so either block layout compares); key biases within KEY_BIAS_TOL."""
    view = copy.deepcopy(module)
    load(view, _np(tree))
    want = view.state_dict()
    for name, got in module.state_dict().items():
        a, b = got.numpy().copy(), want[name].numpy().copy()
        if _is_key_bias(name):
            ks = slice(a.shape[-1] // 3, 2 * a.shape[-1] // 3) if name.endswith("bqkv") else ...
            np.testing.assert_allclose(a[ks], b[ks], atol=KEY_BIAS_TOL, err_msg=name)
            a[ks] = b[ks] = 0
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)


def _sync_critic(jp, tp):
    """Check the port's critic against the JAX one, then copy the JAX
    params in (the module note)."""
    _assert_module_close(tp.critic, jp.critic_params["params"])
    load_jax_params(tp.critic, _np(jp.critic_params["params"]))


@pytest.mark.parametrize("case", ["mcss-ev", "cfg", "cg", "joint", "mlp-invdyn"])
def test_three_train_steps_match_jax(case, pairs):
    jp, tp = pairs(case)
    rng = np.random.default_rng(21)
    for _ in range(3):
        pb, qb = _batch(rng), _batch(rng)
        noise = _train_draws(jp, pb, qb)
        jlog = jp.train_step(jax.tree_util.tree_map(jnp.asarray, pb),
                             jax.tree_util.tree_map(jnp.asarray, qb))
        tlog = tp.train_step(pb, qb, noise=noise)
        assert set(tlog) == set(jlog) == set(tp.log_keys())
        for k in jlog:
            np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=TOL, atol=1e-6,
                                       err_msg=k)
        if jp.critic is not None:
            _sync_critic(jp, tp)
    _assert_module_close(tp.planner.params, jp.planner.state.params, load_agent_params)
    _assert_module_close(tp.planner.ema_params, jp.planner.state.ema_params, load_agent_params)
    assert tp.planner.step == int(jp.planner.state.step) == 3
    if jp.critic is not None:
        _assert_module_close(tp.critic, jp.critic_params["params"])
    if jp.planner.classifier is not None:
        _assert_module_close(tp.planner.classifier.params,
                             jp.planner.classifier.state.params["params"])
    if jp.policy is not None:
        _assert_module_close(tp.policy.params, jp.policy.state.params, load_agent_params)
    if jp.invdyn is not None:
        _assert_module_close(tp.invdyn.net, jp.invdyn.params["params"])


def test_three_ev_steps_match_jax(pairs):
    jp, tp = pairs("mcss-ev")
    rng = np.random.default_rng(31)
    for _ in range(3):
        batch = {"obs": {"state": rng.standard_normal((B, O)).astype(np.float32)},
                 "next_obs": {"state": rng.standard_normal((B, O)).astype(np.float32)},
                 "rew": rng.standard_normal((B, 1)).astype(np.float32),
                 "tml": (rng.uniform(size=(B, 1)) < 0.3).astype(np.float32)}
        jlog = jp.train_expected_value_step(jax.tree_util.tree_map(jnp.asarray, batch))
        tlog = tp.train_expected_value_step(batch)
        for k in ("loss_v", "v_mean"):
            np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=TOL, atol=1e-6)
    _assert_module_close(tp.ev_net, jp.ev_state.params["params"])
    _assert_module_close(tp.ev_target, jp.ev_state.target_params["params"])


# --- windows against their steps (tests/test_fused_rl_window.py:108-173) ---
@pytest.fixture(scope="module")
def seq_dataset():
    raw = fake_d4rl_dataset("halfcheetah-medium-v2", n_steps=288, ep_len=48)
    return DV_D4RLMuJoCoSeqDataset(raw, horizon=8, stride=1, device="cpu")


def _small(ds, **kw):
    return VeteranPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, planner_horizon=8,
                           planner_emb_dim=16, planner_d_model=32, planner_depth=1, unet_dim=8,
                           policy_hidden_dim=32, policy_diffusion_steps=2, gradient_steps=100,
                           planner_sampling_steps=2, policy_sampling_steps=2, rng=0,
                           device="cpu", **kw)


def _same_modules(a, b):
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=n)


@pytest.mark.parametrize("guidance,pipeline_type", [
    ("MCSS", "separate"), ("cfg", "joint"), ("cg", "joint"), ("cg", "separate")])
def test_train_window_equals_its_steps(seq_dataset, guidance, pipeline_type):
    kw = dict(guidance_type=guidance, pipeline_type=pipeline_type,
              planner_net="unet" if guidance == "cg" else "transformer")
    seq, win = _small(seq_dataset, **kw), _small(seq_dataset, **kw)
    n_steps, batch = 3, 8
    g = torch.Generator().manual_seed(13)
    step = seq.step_fn(seq_dataset, batch)
    logs = [step(g) for _ in range(n_steps)]
    log = win.make_train_scan(seq_dataset, batch, n_steps)(torch.Generator().manual_seed(13))
    assert set(log) == set(win.log_keys())
    for k, v in log.items():
        want = sum(float(lg[k]) for lg in logs) / n_steps
        np.testing.assert_allclose(float(v), want, rtol=1e-6, err_msg=k)
    _same_modules(seq.planner.params, win.planner.params)
    assert win.planner.step == n_steps
    if guidance == "MCSS":
        _same_modules(seq.critic, win.critic)
    if guidance == "cg":
        _same_modules(seq.planner.classifier.params, win.planner.classifier.params)
    if pipeline_type == "separate":
        _same_modules(seq.policy.params, win.policy.params)
        assert win.policy.step == n_steps


def test_ev_window_matches_sequential_steps(seq_dataset):
    td = D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset("halfcheetah-medium-v2", n_steps=400,
                                                         ep_len=100), device="cpu")
    seq, win = _small(seq_dataset), _small(seq_dataset)
    g = torch.Generator().manual_seed(17)
    for _ in range(3):
        seq.train_expected_value_step(td.sample_batch(g, 8))
    log = win.make_ev_train_scan(td, 8, 3)(torch.Generator().manual_seed(17))
    assert set(log) == {"loss_v", "v_mean"} and all(torch.isfinite(v) for v in log.values())
    _same_modules(seq.ev_net, win.ev_net)
    _same_modules(seq.ev_target, win.ev_target)


# --- checkpoints and tests/test_hier_pipelines.py:73-177 on the port ---
def test_checkpoint_round_trip(seq_dataset, tmp_path):
    for kw in (dict(mcss_selector="critic"), dict(guidance_type="cg", planner_net="unet"),
               dict(use_diffusion_invdyn=False)):
        pipe = _small(seq_dataset, **kw)
        g = torch.Generator().manual_seed(0)
        pipe.step_fn(seq_dataset, 8)(g)
        pipe.save(str(tmp_path / "v.pkl"))
        back = _small(seq_dataset, **kw)
        back.load(str(tmp_path / "v.pkl"))
        obs = torch.randn(2, seq_dataset.o_dim, generator=torch.Generator().manual_seed(1))
        a1, i1 = pipe.act(obs, num_candidates=4, generator=torch.Generator().manual_seed(5))
        a2, i2 = back.act(obs, num_candidates=4, generator=torch.Generator().manual_seed(5))
        torch.testing.assert_close(a1, a2, rtol=0, atol=0)
        torch.testing.assert_close(i1["traj"], i2["traj"], rtol=0, atol=0)
        assert back.planner.step == pipe.planner.step == 1


@pytest.mark.parametrize("guidance", ["MCSS", "cfg", "cg"])
def test_port_veteran_trains_and_acts(guidance):
    raw = fake_d4rl_dataset(n_steps=1500, ep_len=150)
    ds = DV_D4RLMuJoCoSeqDataset(raw, horizon=8, max_path_length=150, device="cpu")
    td = D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset(n_steps=800, ep_len=150), device="cpu")
    pipe = VeteranPipeline(
        obs_dim=ds.o_dim, act_dim=ds.a_dim, planner_horizon=8, guidance_type=guidance,
        planner_net="transformer" if guidance != "cg" else "unet", planner_emb_dim=32,
        planner_d_model=64, unet_dim=16, gradient_steps=100, planner_sampling_steps=3,
        policy_sampling_steps=2, use_weighted_regression=(guidance == "MCSS"), device="cpu")
    g = torch.Generator().manual_seed(0)
    log = pipe.train_step(ds.sample_batch(g, 8), ds.sample_batch(g, 8))
    assert all(torch.isfinite(v) for v in log.values()), log
    assert torch.isfinite(pipe.train_expected_value_step(td.sample_batch(g, 32))["loss_v"])
    act, info = pipe.act(np.random.randn(2, ds.o_dim).astype(np.float32), num_candidates=4)
    assert act.shape == (2, ds.a_dim) and torch.isfinite(act).all()


@pytest.mark.parametrize("pin", [None, 3])
def test_port_goal_inpaint_pins_the_goal(seq_dataset, pin):
    pipe = _small(seq_dataset, mcss_selector="critic", goal_inpaint=True, gi_pin_idx=pin)
    pipe.step_fn(seq_dataset, 8)(torch.Generator().manual_seed(0))
    obs = np.random.default_rng(0).standard_normal((2, seq_dataset.o_dim)).astype(np.float32)
    goal = np.array([[0.5, -0.25], [1.0, 2.0]], np.float32)
    at = H - 1 if pin is None else pin
    act, info = pipe.act(obs, num_candidates=4, goal_normed=goal,
                         generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(info["traj"][:, at, :2].numpy(), goal)
    np.testing.assert_array_equal(info["traj"][:, 0, :seq_dataset.o_dim].numpy(), obs)
    assert torch.isfinite(act).all()
    if pin is not None:
        assert not np.allclose(info["traj"][:, -1, :2].numpy(), goal, atol=1e-3)
    _, free = pipe.act(obs, num_candidates=4, generator=torch.Generator().manual_seed(3))
    assert not np.allclose(free["traj"][:, at, :2].numpy(), goal, atol=1e-3)


def test_bad_options_raise():
    with pytest.raises(ValueError):
        VeteranPipeline(4, 2, guidance_type="nope", device="cpu")
    with pytest.raises(ValueError):
        VeteranPipeline(4, 2, planner_horizon=8, gi_pin_idx=8, device="cpu")


def test_checkpoint_of_another_generator_kind_loads(seq_dataset, tmp_path):
    """A checkpoint written with a generator of another kind (a CUDA
    generator's 16-byte state, read on the CPU) restores the weights and
    keeps the reader's stream."""
    pipe = _small(seq_dataset)
    pipe.step_fn(seq_dataset, 8)(torch.Generator().manual_seed(0))
    state = pipe.state_dict()
    for part in ("planner", "policy"):
        state[part]["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(state, tmp_path / "v.pkl")
    back = _small(seq_dataset)
    before = back.planner.generator.get_state()
    back.load(str(tmp_path / "v.pkl"))
    assert torch.equal(back.planner.generator.get_state(), before)
    for (n, a), (_, b) in zip(pipe.planner.params.state_dict().items(),
                              back.planner.params.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)

"""The port's PushT env and MPC expert (env/pusht.py, env/pusht_expert.py)
against the JAX package's.

- The mirrors of tests/test_pusht_physics.py and of the state and keypoint
  parts of tests/test_pusht_env.py, on the port.
- One `step` from 1,024 seeded states and actions (agents placed around
  the block, so most of them push it) against `PushTEnvJax.step`:
  positions within 1e-3 px, angles within 1e-5 rad, velocities within
  0.1 px/s (the position bound over a substep's dt), coverage as a count
  of the goal T's 2,048 grid points within 2; the contact, `sd <= 0` and `coverage > 0.95` tests are hard
  thresholds, so a state whose float32 op order flips one of them would
  part, and the test counts how many differ beyond these bounds (none may).
  Then 5 steps from 64 of them.
- The expert's `plan` with the JAX planner's CEM draws injected
  (`normal(k, (K, B, H, 2))` per iteration): the executed action and the
  next mean within 1e-3 px (the 4 seeded states' elites are apart).
- The mirror of tests/test_pusht_expert.py at its reduced budget, from the
  JAX rollout's reset states: at least half of 4 episodes solved in 100
  control steps; the trajectory shapes and ranges; the extraction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.env.pusht_expert import PushTExpertMPC as JaxMPC
from cleandiffuser_tpu.env.pusht_jax import PushTEnvJax, PushTKeypointEnvJax
from cleandiffuser_tpu.env.pusht_jax import PushTState as JaxState
from cleandiffuser_tpu_torch.env.pusht import (
    AGENT_R,
    CONTROL_HZ,
    GOAL_POSE,
    K_P,
    K_V,
    SIM_HZ,
    PushTEnv,
    PushTKeypointEnv,
    PushTState,
    sd_tee_local,
    world_to_block,
)
from cleandiffuser_tpu_torch.env.pusht_expert import (
    PushTExpertMPC,
    generate_pusht_expert_trajectories,
)

torch.set_num_threads(2)

# a velocity is a substep's displacement over dt = 0.01 s: the 1e-3 px
# position bound is 0.1 px/s
POS_TOL, ANGLE_TOL, VEL_TOL, COV_POINTS = 1e-3, 1e-5, 0.1, 2
FAST_MPC = dict(n_samples=96, n_iters=3)


def _state(agent, block, angle):
    t = lambda v: torch.tensor(np.asarray([v], np.float32))
    return PushTState(t(agent), torch.zeros(1, 2), t(block), t(angle))


@pytest.fixture(scope="module")
def env():
    return PushTEnv(device="cpu")


# ---------------------------------------------------------------- physics
def test_pd_control_matches_reference_recursion(env):
    state = _state([100.0, 100.0], [400.0, 400.0], 0.0)
    new_state, _, _, _ = env.step(state, torch.tensor([[180.0, 140.0]]))
    pos, vel, dt = np.array([100.0, 100.0]), np.zeros(2), 1.0 / SIM_HZ
    for _ in range(SIM_HZ // CONTROL_HZ):
        acc = K_P * (np.array([180.0, 140.0]) - pos) + K_V * (-vel)
        vel = vel + acc * dt
        pos = pos + vel * dt
    np.testing.assert_allclose(new_state.agent_pos[0].numpy(), pos, atol=1e-3)
    np.testing.assert_allclose(new_state.agent_vel[0].numpy(), vel, atol=1e-3)


def test_block_immobile_without_contact(env):
    state = _state([80.0, 80.0], [300.0, 300.0], 0.7)
    for tgt in ([120.0, 90.0], [60.0, 130.0], [100.0, 100.0]):
        state, _, _, _ = env.step(state, torch.tensor([tgt]))
    assert np.allclose(state.block_pos[0].numpy(), [300.0, 300.0])
    assert np.allclose(state.block_angle[0].item(), 0.7)


def test_penetration_bounded_under_hard_push(env):
    state = _state([256.0, 200.0], [256.0, 256.0], 0.0)
    for _ in range(20):
        state, _, _, _ = env.step(state, torch.tensor([[256.0, 300.0]]))
        sd = sd_tee_local(world_to_block(state.agent_pos, state.block_pos,
                                         state.block_angle))[0].item()
        assert sd > AGENT_R - 3.0, f"agent sank {AGENT_R - sd:.2f}px into the block"


def test_push_translates_block_along_push_direction(env):
    state = _state([256.0, 230.0], [256.0, 256.0], 0.0)
    for _ in range(10):
        state, _, _, _ = env.step(state, torch.tensor([[256.0, 330.0]]))
    dy = state.block_pos[0, 1].item() - 256.0
    dx = abs(state.block_pos[0, 0].item() - 256.0)
    assert dy > 10.0 and dx < dy


def test_coverage_metric_monotone_toward_goal(env):
    goal = GOAL_POSE
    assert env.coverage(_state([50.0, 50.0], goal[:2], float(goal[2])))[0].item() > 0.99
    covs = []
    for a in np.linspace(0.0, 1.0, 8):
        pose = goal + (1 - a) * np.array([60.0, -40.0, 0.5], np.float32)
        covs.append(env.coverage(_state([50.0, 50.0], pose[:2], float(pose[2])))[0].item())
    assert all(b >= a - 0.02 for a, b in zip(covs, covs[1:])), covs
    assert covs[-1] > 0.99 and covs[0] < 0.3


# ---------------------------------------------------------------- env
def test_reset_and_obs(env):
    state, obs = env.reset(torch.Generator().manual_seed(0), 4)
    o = obs.numpy()
    assert o.shape == (4, 5)
    assert np.all((o[:, 0] >= 50) & (o[:, 0] < 450)) and np.all((o[:, 2] >= 100) & (o[:, 2] < 400))
    assert np.all((o[:, 4] >= 0) & (o[:, 4] <= 2 * np.pi))


def test_step_moves_agent_toward_action(env):
    state, _ = env.reset(torch.Generator().manual_seed(0), 2)
    target = state.agent_pos + torch.tensor([40.0, 0.0])
    state2, obs2, rew, done = env.step(state, target)
    assert torch.all((target - state2.agent_pos).norm(dim=-1) < (target - state.agent_pos).norm(
        dim=-1))
    assert rew.shape == (2,) and done.shape == (2,) and torch.isfinite(obs2).all()


def test_coverage_perfect_at_goal(env):
    state = _state([450.0, 450.0], GOAL_POSE[:2], float(GOAL_POSE[2]))
    assert env.coverage(state)[0].item() > 0.999
    far = state._replace(block_pos=torch.tensor([[60.0, 60.0]]))
    assert env.coverage(far)[0].item() < 0.05


def test_pushing_moves_block(env):
    state = _state([256.0, 420.0], [256.0, 300.0], 0.0)
    for _ in range(30):
        state, _, _, _ = env.step(state, torch.tensor([[256.0, 200.0]]))
    assert (state.block_pos[0] - torch.tensor([256.0, 300.0])).norm().item() > 5.0


def test_keypoint_env_obs_matches_jax():
    kenv, jenv = PushTKeypointEnv(device="cpu"), PushTKeypointEnvJax()
    states, _ = _seeded_states(8)
    _, obs = kenv.reset(batch=8, reset_to_state=torch.from_numpy(states))
    _, jobs = jenv.reset(jax.random.PRNGKey(0), 8, jnp.asarray(states))
    assert obs.shape == (8, 20)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4)


def test_rollout_loop(env):
    """A 10-step rollout of 8 envs with random targets, all on tensors."""
    g = torch.Generator().manual_seed(0)
    state, _ = env.reset(g, 8)
    rews = []
    for _ in range(10):
        state, _, rew, _ = env.step(state, torch.rand((8, 2), generator=g) * 300 + 100)
        rews.append(rew)
    assert torch.stack(rews).shape == (10, 8) and torch.isfinite(torch.stack(rews)).all()


# ---------------------------------------------------------------- parity
def _seeded_states(n, seed=0):
    """n states with the agent within 80 px of the block (most push it),
    and a target 30-80 px from the agent."""
    rng = np.random.default_rng(seed)
    block = rng.uniform(150, 360, (n, 2))
    angle = rng.uniform(-np.pi, np.pi, (n, 1))
    agent = block + rng.uniform(-80, 80, (n, 2))
    states = np.concatenate([agent, block, angle], -1).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, n)
    actions = agent + np.stack([np.cos(ang), np.sin(ang)], -1) * rng.uniform(30, 80, (n, 1))
    return states, actions.astype(np.float32)


def _jax_state(states):
    s = jnp.asarray(states)
    return JaxState(s[:, :2], jnp.zeros((len(states), 2)), s[:, 2:4], s[:, 4])


def _gaps(tstate, jstate):
    return {"pos": np.abs(tstate.agent_pos.numpy() - np.asarray(jstate.agent_pos)).max(-1),
            "block": np.abs(tstate.block_pos.numpy() - np.asarray(jstate.block_pos)).max(-1),
            "angle": np.abs(tstate.block_angle.numpy() - np.asarray(jstate.block_angle)),
            "vel": np.abs(tstate.agent_vel.numpy() - np.asarray(jstate.agent_vel)).max(-1)}


def test_step_matches_jax_from_1024_states(env):
    jenv = PushTEnvJax()
    states, actions = _seeded_states(1024)
    state, _ = env.reset(batch=1024, reset_to_state=torch.from_numpy(states))
    ts, tobs, trew, tdone = env.step(state, torch.from_numpy(actions))
    js, jobs, jrew, jdone = jax.jit(jenv.step)(_jax_state(states), jnp.asarray(actions))
    moved = np.abs(np.asarray(js.block_pos) - states[:, 2:4]).max(-1) > 0
    assert moved.mean() > 0.3, "too few states push the block"
    g = _gaps(ts, js)
    bad = ((g["pos"] > POS_TOL) | (g["block"] > POS_TOL) | (g["angle"] > ANGLE_TOL)
           | (g["vel"] > VEL_TOL))
    assert not bad.any(), {k: float(v.max()) for k, v in g.items()}
    count_t = env.coverage_count(ts).numpy()
    count_j = np.round(np.asarray(jenv.coverage(js)) * 2048).astype(int)
    assert np.abs(count_t - count_j).max() <= COV_POINTS
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-3)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=COV_POINTS / 2048 / 0.95)
    kp_t = env.keypoints(ts).numpy()
    np.testing.assert_allclose(kp_t, np.asarray(jenv.keypoints(js)), atol=1e-3)


def test_short_rollout_matches_jax(env):
    jenv = PushTEnvJax()
    states, actions = _seeded_states(64, seed=1)
    state, _ = env.reset(batch=64, reset_to_state=torch.from_numpy(states))
    js = _jax_state(states)
    step = jax.jit(jenv.step)
    rng = np.random.default_rng(2)
    for _ in range(5):
        a = (states[:, :2] + rng.uniform(-60, 60, (64, 2))).astype(np.float32)
        state, _, _, _ = env.step(state, torch.from_numpy(a))
        js, _, _, _ = step(js, jnp.asarray(a))
    g = _gaps(state, js)
    assert g["pos"].max() <= POS_TOL and g["block"].max() <= POS_TOL, {
        k: float(v.max()) for k, v in g.items()}


def test_expert_plan_matches_jax_with_injected_noise():
    B = 4
    kw = dict(horizon=4, n_samples=24, n_elites=4, n_iters=2)
    jmpc, tmpc = JaxMPC(**kw), PushTExpertMPC(**kw, device="cpu")
    states, _ = _seeded_states(B, seed=3)
    js = _jax_state(states)
    mean = np.repeat(states[:, None, :2], kw["horizon"], axis=1)
    key = jax.random.PRNGKey(7)
    a_j, m_j = jax.jit(jmpc.plan)(js, jnp.asarray(mean), key)
    keys = jax.random.split(key, kw["n_iters"])
    noise = np.stack([np.asarray(jax.random.normal(k, (kw["n_samples"], B, kw["horizon"], 2)))
                      for k in keys])
    ts, _ = tmpc.env.reset(batch=B, reset_to_state=torch.from_numpy(states))
    a_t, m_t = tmpc.plan(ts, torch.from_numpy(mean), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=POS_TOL)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=POS_TOL)


@pytest.fixture(scope="module")
def expert_traj():
    jmpc = JaxMPC(**FAST_MPC)
    _, k_reset = jax.random.split(jax.random.PRNGKey(0))
    _, obs = jmpc.env.reset(k_reset, 4)  # the JAX rollout's reset states
    mpc = PushTExpertMPC(**FAST_MPC, device="cpu")
    traj = mpc.rollout(torch.Generator().manual_seed(0), 4, 100,
                       reset_to_state=torch.from_numpy(np.array(obs)))
    return {k: v.numpy() for k, v in traj.items()}


def test_mpc_solves_most_resets(expert_traj):
    success = expert_traj["done"].any(axis=0)
    assert success.sum() >= 2, f"only {success.sum()}/4 solved"
    assert expert_traj["reward"].max() == 1.0


def test_mpc_traj_shapes_and_ranges(expert_traj):
    T, B = 100, 4
    assert expert_traj["obs"].shape == (T, B, 5)
    assert expert_traj["action"].shape == (T, B, 2)
    assert expert_traj["keypoint"].shape == (T, B, 9, 2)
    assert expert_traj["action"].min() >= 5.0 and expert_traj["action"].max() <= 507.0
    assert np.isfinite(expert_traj["obs"]).all()


def test_expert_trajectory_extraction():
    eps, covs = generate_pusht_expert_trajectories(n_episodes=2, max_steps=30, seed=0,
                                                   mpc_kwargs=dict(FAST_MPC, exec_noise_prob=0.5),
                                                   device="cpu")
    assert len(covs) == 2 and all(0.0 <= c <= 1.0 for c in covs)
    for ep in eps:
        t = len(ep["state"])
        assert 0 < t <= 30 and ep["action"].shape == (t, 2) and ep["keypoint"].shape == (t, 9, 2)

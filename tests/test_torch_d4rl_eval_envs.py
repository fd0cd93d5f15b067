"""The port's d4rl-layout eval envs (env/d4rl_eval.py, env/kitchen.py) and
`make_eval_env_fns` for antmaze, maze2d and kitchen, against the JAX
package's.

Ports tests/test_d4rl_eval_envs.py: the 29, 4 and 60 dims, kitchen's
completion rule, the mapping, and the constants. The flattening, the
completion rule, the pinned reset options, the mapping and the constants
run on stub envs and need no gymnasium_robotics; the real envs'
cases skip without it, and there both packages' wrappers give the same
observations from the same seed.
"""

import sys
import types

import numpy as np
import pytest

from cleandiffuser_tpu.env import d4rl_eval as jeval
from cleandiffuser_tpu.env import kitchen as jkitchen
from cleandiffuser_tpu_torch.env import d4rl_eval, kitchen
from cleandiffuser_tpu_torch.pipelines import data_loading


def test_constants_equal_the_jax_modules():
    for name in ("ANTMAZE_GYM_IDS", "ANTMAZE_EVAL_CELLS", "MAZE2D_GYM_IDS",
                 "MAZE2D_EVAL_MAX_STEPS", "MAZE2D_EVAL_GOAL_CELL"):
        assert getattr(d4rl_eval, name) == getattr(jeval, name), name
    assert kitchen.ALL_KITCHEN_TASKS == jkitchen.ALL_KITCHEN_TASKS
    assert kitchen.D4RL_BONUS_THRESH == jkitchen.D4RL_BONUS_THRESH
    for table in ("D4RL_ELEMENT_INDICES", "D4RL_ELEMENT_GOALS"):
        got, want = getattr(kitchen, table), getattr(jkitchen, table)
        assert got.keys() == want.keys()
        for task in want:
            np.testing.assert_array_equal(got[task], want[task], err_msg=f"{table} {task}")
    # every antmaze task has its pinned eval cells, every maze2d task its goal
    assert d4rl_eval.ANTMAZE_EVAL_CELLS.keys() == d4rl_eval.ANTMAZE_GYM_IDS.keys()
    assert d4rl_eval.MAZE2D_EVAL_GOAL_CELL.keys() == d4rl_eval.MAZE2D_GYM_IDS.keys()


@pytest.fixture
def stub_robotics(monkeypatch):
    """A stand-in `gymnasium_robotics` module and recording env makers, so the
    mapping runs where gymnasium_robotics is not installed."""
    monkeypatch.setitem(sys.modules, "gymnasium_robotics", types.ModuleType("gymnasium_robotics"))
    made = []
    monkeypatch.setattr(d4rl_eval, "make_antmaze_env", lambda name: made.append(("ant", name)))
    monkeypatch.setattr(d4rl_eval, "make_maze2d_env", lambda name: made.append(("maze", name)))
    monkeypatch.setattr(kitchen, "make_kitchen_env", lambda tasks: made.append(("kit", tasks)))
    return made


def test_eval_env_fns_mapping(stub_robotics):
    for name, kind, arg in (
        ("antmaze-large-diverse-v2", "ant", "antmaze-large-diverse-v2"),
        ("maze2d-umaze-v1", "maze", "maze2d-umaze-v1"),
        ("kitchen-partial-v0", "kit", ["microwave", "kettle", "bottom burner", "light switch"]),
    ):
        fns = data_loading.make_eval_env_fns(name, 3)
        assert len(fns) == 3
        stub_robotics.clear()
        for fn in fns:
            fn()
        assert stub_robotics == [(kind, arg)] * 3, name


@pytest.mark.parametrize("env_name", ["antmaze-medium-play-v2", "maze2d-umaze-v1",
                                      "kitchen-mixed-v0"])
def test_eval_env_fns_raise_without_gymnasium_robotics(env_name, monkeypatch):
    """Where gymnasium_robotics is missing, the call raises and names it; no
    other env stands in."""
    monkeypatch.setitem(sys.modules, "gymnasium_robotics", None)
    with pytest.raises(ImportError, match="gymnasium_robotics"):
        data_loading.make_eval_env_fns(env_name, 2)


class _StubGoalEnv:
    """A goal env's dict observations: `achieved_goal` xy, `desired_goal` xy
    and a 105-dim Ant-v5 `observation` (the 27 d4rl dims, then 78 contact
    forces), or a 4-dim point-maze one. Records the reset kwargs."""

    def __init__(self, obs_dim):
        self.obs_dim, self.resets, self.t = obs_dim, [], 0

    def _obs(self):
        o = np.arange(self.obs_dim, dtype=np.float64) + self.t
        return {"achieved_goal": np.array([0.5, -1.5]) + self.t,
                "desired_goal": np.array([3.0, 4.0]), "observation": o}

    def reset(self, **kwargs):
        self.resets.append(kwargs)
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        return self._obs(), 1, False, False, {}


def test_antmaze_wrapper_flattens_and_pins_the_task():
    stub = _StubGoalEnv(105)
    cells = d4rl_eval.ANTMAZE_EVAL_CELLS["antmaze-medium-play-v2"]
    env = d4rl_eval.AntMazeD4RLWrapper(stub, eval_cells=cells)
    obs, _ = env.reset(seed=3, options=None)  # vector envs pass options=None
    assert obs.shape == (29,) and obs.dtype == np.float32
    np.testing.assert_array_equal(obs[:2], [0.5, -1.5])
    np.testing.assert_array_equal(obs[2:], np.arange(27))
    opts = stub.resets[-1]["options"]
    assert stub.resets[-1]["seed"] == 3
    np.testing.assert_array_equal(opts["goal_cell"], cells[0])
    np.testing.assert_array_equal(opts["reset_cell"], cells[1])
    obs, rew, term, trunc, _ = env.step(np.zeros(8))
    assert obs.shape == (29,) and rew == 1.0 and isinstance(rew, float)
    jenv = jeval.AntMazeD4RLWrapper(_StubGoalEnv(105), eval_cells=cells)
    jenv.reset()
    np.testing.assert_array_equal(obs, jenv.step(np.zeros(8))[0])


def test_pointmaze_wrapper_flattens_and_exposes_the_goal():
    stub = _StubGoalEnv(4)
    env = d4rl_eval.PointMazeD4RLWrapper(stub, goal_cell=(1, 1))
    obs, _ = env.reset(seed=0)
    assert obs.shape == (4,)
    np.testing.assert_array_equal(obs, np.arange(4))
    np.testing.assert_array_equal(env.goal, [3.0, 4.0])
    np.testing.assert_array_equal(stub.resets[-1]["options"]["goal_cell"], [1, 1])


class _StubFranka:
    """Minimal FrankaKitchen stand-in: 59-dim observation
    [qp 9 | qvel 9 | obj_qp 21 | obj_qvel 20], a controllable object block,
    and a `desired_goal` dict for the tasks it is given."""

    def __init__(self, goals=None):
        self.obj = np.zeros(21, np.float32)
        self.goals = goals or {}

    def _obs(self):
        o = np.zeros(59, np.float32)
        o[:9] = np.arange(1, 10)
        o[9:18] = -5.0  # velocities, dropped by the flattening
        o[18:39] = self.obj
        return {"observation": o, "desired_goal": dict(self.goals)}

    def reset(self, **kwargs):
        self.obj[:] = 0.0
        return self._obs(), {}

    def step(self, action):
        return self._obs(), 0.0, False, False, {}


def test_kitchen_flattening_is_the_d4rl_layout():
    """[robot qpos 9 | object qpos 21 | goal 30]: the velocities dropped,
    each task's goal scattered to its d4rl element indices."""
    goals = {t: kitchen.D4RL_ELEMENT_GOALS[t] for t in ("microwave", "kettle")}
    stub = _StubFranka(goals)
    stub.obj[:] = np.linspace(0, 1, 21)
    obs = kitchen.KitchenLowdimWrapper(stub, list(goals)).step(np.zeros(9))[0]
    assert obs.shape == (60,) and obs.dtype == np.float32
    np.testing.assert_array_equal(obs[:9], np.arange(1, 10))
    np.testing.assert_array_equal(obs[9:30], stub.obj)
    want = np.zeros(30, np.float32)
    for task, goal in goals.items():
        want[kitchen.D4RL_ELEMENT_INDICES[task]] = goal
    np.testing.assert_array_equal(obs[30:], want)


def test_kitchen_d4rl_completion_rule():
    """d4rl's rule: obs-distance < 0.3, +1 once per task, removal from the
    open set, termination when it is empty (tests/test_d4rl_eval_envs.py's
    case, on the port's wrapper)."""
    stub = _StubFranka()
    env = kitchen.KitchenLowdimWrapper(stub, ["microwave", "kettle"])
    obs, _ = env.reset()
    assert obs.shape == (60,)
    _, rew, term, _, info = env.step(np.zeros(9))
    assert rew == 0.0 and not term and info["completed_tasks"] == set()

    mw_obj_idx = kitchen.D4RL_ELEMENT_INDICES["microwave"] - 9
    stub.obj[mw_obj_idx] = kitchen.D4RL_ELEMENT_GOALS["microwave"]
    _, rew, term, _, info = env.step(np.zeros(9))
    assert rew == 1.0 and not term and info["completed_tasks"] == {"microwave"}
    _, rew, term, _, _ = env.step(np.zeros(9))
    assert rew == 0.0 and not term  # pays only once

    kt_obj_idx = kitchen.D4RL_ELEMENT_INDICES["kettle"] - 9
    stub.obj[kt_obj_idx] = kitchen.D4RL_ELEMENT_GOALS["kettle"]
    _, rew, term, _, info = env.step(np.zeros(9))
    assert rew == 1.0 and term
    assert info["completed_tasks"] == {"microwave", "kettle"}

    # a 0.3 norm ball: just inside counts, just outside does not
    env.reset()
    stub.obj[mw_obj_idx] = kitchen.D4RL_ELEMENT_GOALS["microwave"] + 0.29
    assert env.step(np.zeros(9))[1] == 1.0
    env.reset()
    stub.obj[mw_obj_idx] = kitchen.D4RL_ELEMENT_GOALS["microwave"] + 0.31
    assert env.step(np.zeros(9))[1] == 0.0


# ---------------------------------------------------------------------------
# the real envs (gymnasium_robotics)
def _same_rollout(env, jenv, seed, n=3):
    a, _ = env.reset(seed=seed)
    b, _ = jenv.reset(seed=seed)
    np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        act = rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
        got, want = env.step(act), jenv.step(act)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:4] == want[1:4]
    env.close()
    jenv.close()
    return a


def test_antmaze_wrapper_is_29_dim():
    pytest.importorskip("gymnasium_robotics")
    obs = _same_rollout(d4rl_eval.make_antmaze_env("antmaze-medium-play-v2"),
                        jeval.make_antmaze_env("antmaze-medium-play-v2"), seed=0)
    assert obs.shape == (29,) and np.isfinite(obs).all()


def test_maze2d_wrapper_is_4_dim():
    pytest.importorskip("gymnasium_robotics")
    env = d4rl_eval.make_maze2d_env("maze2d-umaze-v1")
    obs, _ = env.reset(seed=0)
    assert obs.shape == (4,) and env.goal.shape == (2,)
    env.close()
    _same_rollout(d4rl_eval.make_maze2d_env("maze2d-umaze-v1"),
                  jeval.make_maze2d_env("maze2d-umaze-v1"), seed=1)


def test_kitchen_wrapper_is_60_dim():
    pytest.importorskip("gymnasium_robotics")
    tasks = ["microwave", "kettle", "bottom burner", "light switch"]
    obs = _same_rollout(kitchen.make_kitchen_env(tasks), jkitchen.make_kitchen_env(tasks), seed=0)
    assert obs.shape == (60,) and np.count_nonzero(obs[30:]) > 0
    gym = pytest.importorskip("gymnasium")
    assert isinstance(kitchen.make_kitchen_env(["microwave"]), gym.Env)


def test_kitchen_constants_match_gymnasium_robotics():
    """gymnasium_robotics' FrankaKitchen derives from the same
    relay-policy-learning source as d4rl: the element indices, goals and
    threshold the port's wrapper uses are its own."""
    gr = pytest.importorskip("gymnasium_robotics.envs.franka_kitchen.kitchen_env")
    assert gr.BONUS_THRESH == kitchen.D4RL_BONUS_THRESH
    assert set(gr.OBS_ELEMENT_GOALS) == set(kitchen.D4RL_ELEMENT_GOALS)
    for task, goal in kitchen.D4RL_ELEMENT_GOALS.items():
        np.testing.assert_array_equal(gr.OBS_ELEMENT_GOALS[task], goal)
        np.testing.assert_array_equal(gr.OBS_ELEMENT_INDICES[task],
                                      kitchen.D4RL_ELEMENT_INDICES[task])

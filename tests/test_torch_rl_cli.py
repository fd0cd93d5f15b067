"""The port's DQL, IDQL and EDP D4RL CLIs (cleandiffuser_tpu_torch/cli/) on
MuJoCo, antmaze and kitchen, on the CPU (`platform=cpu`), at a small width
on the synthetic data, each config with its own keys.

- `mode=train` trains window by window, logs every window, saves `ckpt_4`
  and `ckpt_latest` under results/torch/<pipeline>/<env>/; DQL's
  `resume=true` resumes from `ckpt_latest`. `mode=inference` loads its own
  `ckpt_latest` and evaluates on gymnasium's MuJoCo env (2 envs, 1 episode;
  the episode length is lowered by a monkeypatch).
- Given the same config, the port's CLI and the JAX package's CLI
  (pipelines/*_d4rl_mujoco.py, its `pipeline(args)` run with the pipeline
  and the trainer stubbed) build datasets with identical arrays and pass
  their pipelines the same arguments.
- The antmaze and kitchen CLIs train 2 windows, save, and serve
  `ckpt_latest` through `d4rl_eval_loop` on gymnasium_robotics' eval envs
  (episodes cut short by a monkeypatch); they build the JAX CLIs' datasets
  and pass their pipelines the same arguments (defaults applied on both
  sides: `max_q_backup`, EDP's `predict_noise`).
- Without a CUDA device and without `platform=cpu`, the CLIs raise.
"""

import functools
import importlib.util
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cleandiffuser_tpu.utils.config import load_config as jax_load_config
from cleandiffuser_tpu_torch.cli import (
    dql_d4rl_antmaze,
    dql_d4rl_kitchen,
    dql_d4rl_mujoco,
    edp_d4rl_antmaze,
    edp_d4rl_kitchen,
    edp_d4rl_mujoco,
    idql_d4rl_antmaze,
    idql_d4rl_kitchen,
    idql_d4rl_mujoco,
    rl,
)
from cleandiffuser_tpu_torch.pipelines.data_loading import load_d4rl_qlearning_dataset
from cleandiffuser_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
COMMON = ["gradient_steps=4", "log_interval=2", "save_interval=4", "diffusion_steps=2",
          "sampling_steps=2", "batch_size=8"]
SMALL = {"dql": ["hidden_dim=32", *COMMON], "edp": ["hidden_dim=32", *COMMON],
         "idql": ["actor_hidden_dim=32", "critic_hidden_dim=32", *COMMON]}
CLI = {"dql": dql_d4rl_mujoco, "idql": idql_d4rl_mujoco, "edp": edp_d4rl_mujoco}
LOG_KEYS = {"dql": {"bc_loss", "q_loss", "critic_loss", "target_q_mean"},
            "edp": {"bc_loss", "q_loss", "critic_loss", "target_q_mean"},
            "idql": {"bc_loss", "q_loss", "v_loss"}}


@pytest.fixture(autouse=True)
def _synthetic_data_once(monkeypatch):
    """The CLIs' `load_d4rl_qlearning_dataset` (the synthetic 100k-step
    fallback) made once per env name for this file."""
    # EDP builds through DQL's `build`
    for cli in (dql_d4rl_mujoco, idql_d4rl_mujoco, dql_d4rl_antmaze, idql_d4rl_antmaze,
                dql_d4rl_kitchen, idql_d4rl_kitchen):
        monkeypatch.setattr(cli, "load_d4rl_qlearning_dataset", _load_once)


@functools.lru_cache(maxsize=None)
def _cached(env_name):
    return load_d4rl_qlearning_dataset(env_name)


def _load_once(env_name):
    return {k: v.copy() for k, v in _cached(env_name).items()}


def _config(family, *overrides):
    return load_config(CLI[family].CONFIG_DIR, "mujoco",
                       ["platform=cpu", *SMALL[family], *overrides])


def _run_dir(family):
    return Path(f"results/torch/{family}_d4rl_mujoco/halfcheetah-medium-v2")


def _train_logs(family):
    return [json.loads(s) for s in (_run_dir(family) / "train.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("family", list(CLI))
def test_rl_cli_trains_saves_and_evaluates_its_checkpoint(family, tmp_path, monkeypatch):
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    monkeypatch.chdir(tmp_path)
    CLI[family].pipeline(_config(family, "mode=train"))
    run = _run_dir(family)
    assert {p.name for p in run.glob("ckpt_*")} == {"ckpt_4.pt", "ckpt_latest.pt"}
    logs = _train_logs(family)
    assert [lg["gradient_steps"] for lg in logs] == [2, 4]
    assert all(LOG_KEYS[family] <= set(lg) and all(np.isfinite(lg[k]) for k in LOG_KEYS[family])
               for lg in logs)
    state = torch.load(run / "ckpt_latest.pt", weights_only=True)
    assert state["actor"]["step"] == 4 and state["critic"]["step"] == 4

    if family == "dql":
        CLI[family].pipeline(_config(family, "mode=train", "resume=true", "gradient_steps=6"))
        assert [lg["gradient_steps"] for lg in _train_logs(family)] == [2, 4, 6]
        monkeypatch.setattr(dql_d4rl_mujoco, "MAX_STEPS", 3)
    else:
        monkeypatch.setattr(rl, "d4rl_eval_loop", functools.partial(rl.d4rl_eval_loop, max_steps=3))
    CLI[family].pipeline(_config(family, "mode=inference", "num_envs=2", "num_episodes=1",
                                 "num_candidates=4"))
    scores = [json.loads(s) for s in (run / "inference.jsonl").read_text().splitlines()]
    assert len(scores) == 1 and np.isfinite(scores[0]["normalized_score_mean"])


def _jax_cli(family):
    path = ROOT / f"pipelines/{family}_d4rl_mujoco.py"
    spec = importlib.util.spec_from_file_location(f"jax_cli_{family}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family", list(CLI))
def test_rl_cli_builds_what_the_jax_cli_builds(family, tmp_path, monkeypatch):
    """The datasets' arrays and normaliser, and the pipelines' arguments
    (the port's adds `device`), from the same config."""
    monkeypatch.chdir(tmp_path)
    jcli, cli = _jax_cli(family), CLI[family]
    name = {"dql": "DQLPipeline", "idql": "IDQLPipeline", "edp": "EDPPipeline"}[family]
    built = {}

    def record(key, cls=None):
        def make(*a, **kw):
            built[key] = kw if cls is None else cls(*a, **kw)
            return built[key]
        return make

    monkeypatch.setattr(jcli, name, record("jax_pipe"))
    monkeypatch.setattr(jcli, "D4RLMuJoCoTDDataset", record("jax_data", jcli.D4RLMuJoCoTDDataset))
    monkeypatch.setattr(jcli, "rl_window_fn", lambda *a, **kw: None)
    monkeypatch.setattr(jcli, "train_loop", lambda *a, **kw: None)
    jcli.pipeline(jax_load_config(cli.CONFIG_DIR, "mujoco", ["mode=train", *SMALL[family]]))
    monkeypatch.setattr(cli, name, record("port_pipe"))
    dataset, _ = cli.build(_config(family), "cpu")

    jds = built["jax_data"]
    for key in ("obs", "next_obs", "act", "rew", "tml"):
        np.testing.assert_array_equal(getattr(dataset, key), getattr(jds, key), err_msg=key)
    for stat in ("mean", "std"):
        np.testing.assert_array_equal(getattr(dataset.get_normalizer(), stat),
                                      getattr(jds.get_normalizer(), stat))
    port_kw = dict(built["port_pipe"])
    assert port_kw.pop("device") == "cpu"
    assert port_kw == built["jax_pipe"]


@pytest.mark.parametrize("family", list(CLI))
def test_rl_cli_raises_without_a_cuda_device(family, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    args = load_config(CLI[family].CONFIG_DIR, "mujoco", ["mode=train"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI[family].pipeline(args)


# ---------------------------------------------------------------------------
# the antmaze and kitchen suites
SUITE_CLI = {("dql", "antmaze"): dql_d4rl_antmaze, ("dql", "kitchen"): dql_d4rl_kitchen,
             ("idql", "antmaze"): idql_d4rl_antmaze, ("idql", "kitchen"): idql_d4rl_kitchen,
             ("edp", "antmaze"): edp_d4rl_antmaze, ("edp", "kitchen"): edp_d4rl_kitchen}
ENV = {"antmaze": "antmaze-medium-play-v2", "kitchen": "kitchen-mixed-v0"}
SUITE_IDS = [f"{f}-{s}" for f, s in SUITE_CLI]


def _suite_config(family, suite, *overrides):
    return load_config(SUITE_CLI[(family, suite)].CONFIG_DIR, suite,
                       ["platform=cpu", *SMALL[family], *overrides])


@pytest.mark.parametrize("family, suite", list(SUITE_CLI), ids=SUITE_IDS)
def test_suite_rl_cli_trains_saves_and_evaluates_its_checkpoint(family, suite, tmp_path,
                                                               monkeypatch):
    pytest.importorskip("gymnasium_robotics")
    monkeypatch.chdir(tmp_path)
    cli = SUITE_CLI[(family, suite)]
    cli.pipeline(_suite_config(family, suite, "mode=train"))
    run = Path(f"results/torch/{family}_d4rl_{suite}/{ENV[suite]}")
    assert {p.name for p in run.glob("ckpt_*")} == {"ckpt_4.pt", "ckpt_latest.pt"}
    logs = [json.loads(s) for s in (run / "train.jsonl").read_text().splitlines()]
    assert [lg["gradient_steps"] for lg in logs] == [2, 4]
    assert all(LOG_KEYS[family] <= set(lg) and all(np.isfinite(lg[k]) for k in LOG_KEYS[family])
               for lg in logs)
    state = torch.load(run / "ckpt_latest.pt", weights_only=True)
    assert state["actor"]["step"] == 4 and state["critic"]["step"] == 4

    monkeypatch.setattr(rl, "d4rl_eval_loop", functools.partial(rl.d4rl_eval_loop, max_steps=3))
    cli.pipeline(_suite_config(family, suite, "mode=inference", "num_envs=2", "num_episodes=1",
                               "num_candidates=4"))
    scores = [json.loads(s) for s in (run / "inference.jsonl").read_text().splitlines()]
    assert len(scores) == 1 and np.isfinite(scores[0]["normalized_score_mean"])


def _bound(cls, kw):
    """The arguments a pipeline class receives, its defaults applied; the
    port's `device` dropped."""
    kw = {k: v for k, v in kw.items() if k != "device"}
    bound = inspect.signature(cls).bind(**kw)
    bound.apply_defaults()
    args = dict(bound.arguments)
    extra = args.pop("kwargs", {})  # EDP's **kwargs, passed on to DQL's
    if extra:
        args.update(extra)
        args = {**{k: v.default for k, v in inspect.signature(cls.__mro__[1]).parameters.items()
                   if k not in ("self", "device")}, **args}
    args.pop("device", None)
    return args


@pytest.mark.parametrize("family, suite", list(SUITE_CLI), ids=SUITE_IDS)
def test_suite_rl_cli_builds_what_the_jax_cli_builds(family, suite, tmp_path, monkeypatch):
    """The suite's transitions and normaliser, and the pipelines' arguments
    with each package's defaults applied (DQL's and EDP's `max_q_backup`,
    EDP's `predict_noise` from its class's default)."""
    import cleandiffuser_tpu.pipelines as jpipes
    import cleandiffuser_tpu_torch.pipelines as tpipes

    monkeypatch.chdir(tmp_path)
    path = ROOT / f"pipelines/{family}_d4rl_{suite}.py"
    spec = importlib.util.spec_from_file_location(f"jax_cli_{family}_{suite}", path)
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    cli = SUITE_CLI[(family, suite)]
    name = {"dql": "DQLPipeline", "idql": "IDQLPipeline", "edp": "EDPPipeline"}[family]
    data = "D4RLAntmazeTDDataset" if suite == "antmaze" else "D4RLKitchenTDDataset"
    built = {}

    def record(key, cls=None):
        def make(*a, **kw):
            built[key] = kw if cls is None else cls(*a, **kw)
            return built[key]
        return make

    monkeypatch.setattr(jcli, name, record("jax_pipe"))
    monkeypatch.setattr(jcli, data, record("jax_data", getattr(jcli, data)))
    monkeypatch.setattr(jcli, "rl_window_fn", lambda *a, **kw: None)
    monkeypatch.setattr(jcli, "train_loop", lambda *a, **kw: None)
    jcli.pipeline(jax_load_config(cli.CONFIG_DIR, suite, ["mode=train", *SMALL[family]]))
    # the module that constructs the port's pipeline
    maker = {"dql": dql_d4rl_mujoco, "idql": idql_d4rl_mujoco, "edp": cli}[family]
    monkeypatch.setattr(maker, name, record("port_pipe"))
    dataset, _ = cli.build(_suite_config(family, suite), "cpu")

    jds = built["jax_data"]
    assert type(dataset).__name__ == data
    for key in ("obs", "next_obs", "act", "rew", "tml"):
        np.testing.assert_array_equal(getattr(dataset, key), getattr(jds, key), err_msg=key)
    for stat in ("mean", "std"):
        np.testing.assert_array_equal(getattr(dataset.get_normalizer(), stat),
                                      getattr(jds.get_normalizer(), stat))
    port_kw = dict(built["port_pipe"])
    assert port_kw["device"] == "cpu"
    got, want = (_bound(getattr(tpipes, name), port_kw),
                 _bound(getattr(jpipes, name), built["jax_pipe"]))
    assert got == want
    if family != "idql":
        assert got["max_q_backup"] == (10 if suite == "antmaze" else 0)

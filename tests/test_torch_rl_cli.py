"""The port's DQL, IDQL and EDP D4RL-MuJoCo CLIs (cleandiffuser_tpu_torch/cli/)
on the CPU (`platform=cpu`), at a small width on the synthetic data, each
config with its own keys.

- `mode=train` trains window by window, logs every window, saves `ckpt_4`
  and `ckpt_latest` under results/torch/<pipeline>/<env>/; DQL's
  `resume=true` resumes from `ckpt_latest`. `mode=inference` loads its own
  `ckpt_latest` and evaluates on gymnasium's MuJoCo env (2 envs, 1 episode;
  the episode length is lowered by a monkeypatch).
- Given the same config, the port's CLI and the JAX package's CLI
  (pipelines/*_d4rl_mujoco.py, its `pipeline(args)` run with the pipeline
  and the trainer stubbed) build datasets with identical arrays and pass
  their pipelines the same arguments.
- Without a CUDA device and without `platform=cpu`, the CLIs raise.
"""

import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cleandiffuser_tpu.utils.config import load_config as jax_load_config
from cleandiffuser_tpu_torch.cli import dql_d4rl_mujoco, edp_d4rl_mujoco, idql_d4rl_mujoco, rl
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
    for cli in (dql_d4rl_mujoco, idql_d4rl_mujoco):  # EDP builds through DQL's `build`
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

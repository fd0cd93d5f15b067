"""The port's Diffusion Veteran and DiffuserLite CLIs
(cleandiffuser_tpu_torch/cli/veteran_d4rl_*.py, diffuserlite_d4rl_*.py) on
the CPU (`platform=cpu`), at a small width on the synthetic data.

- Veteran, all four suites: `mode=train` trains window by window, logs and
  saves `veteran_<step>.pkl` and `veteran_latest.pkl`;
  `mode=train_expected_value` (its step count, a module constant, patched
  down) trains the EV net from `veteran_latest.pkl` and saves it back;
  `mode=inference` serves it through `d4rl_eval_loop` (maze2d also with
  `goal_inpaint=true`, which hands the act function the goal).
- DiffuserLite, all three suites: `iql_training` (antmaze and kitchen),
  `training`, `prepare_dataset` (the JAX CLI's `reflow_pairs.pkl` layout),
  `reflow`, then `inference` with R1 and with R2.
- Episodes are cut to 3 steps by a monkeypatch of the evaluation, not by a
  config key; the MuJoCo suites' evaluation needs gymnasium's MuJoCo envs,
  the others gymnasium_robotics (skipped without).
- Given the same config, the port's CLI and the JAX package's CLI
  (pipelines/*.py, its `pipeline(args)` run with its trainers stubbed)
  build datasets with identical arrays and pipelines whose checkpoints
  carry over: the JAX pipeline's `save` loads into the port's pipeline
  with `load_jax_checkpoint`, every parameter of matching shape.
"""

import functools
import importlib.util
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from cleandiffuser_tpu.utils.config import load_config as jax_load_config
from cleandiffuser_tpu_torch.cli import (
    diffuserlite_d4rl_antmaze,
    diffuserlite_d4rl_kitchen,
    diffuserlite_d4rl_mujoco,
    veteran_d4rl_antmaze,
    veteran_d4rl_kitchen,
    veteran_d4rl_maze2d,
    veteran_d4rl_mujoco,
)
from cleandiffuser_tpu_torch.pipelines import data_loading
from cleandiffuser_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = {"mujoco": "halfcheetah-medium-v2", "maze2d": "maze2d-umaze-v1",
       "antmaze": "antmaze-medium-play-v2", "kitchen": "kitchen-mixed-v0"}
VETERAN = {"mujoco": veteran_d4rl_mujoco, "maze2d": veteran_d4rl_maze2d,
           "antmaze": veteran_d4rl_antmaze, "kitchen": veteran_d4rl_kitchen}
LITE = {"mujoco": diffuserlite_d4rl_mujoco, "antmaze": diffuserlite_d4rl_antmaze,
        "kitchen": diffuserlite_d4rl_kitchen}
SMALL = {
    "veteran": ["planner_d_model=32", "planner_emb_dim=16", "planner_depth=1", "unet_dim=8",
                "policy_hidden_dim=16", "policy_diffusion_steps=2", "policy_sampling_steps=2",
                "planner_sampling_steps=2", "batch_size=8", "planner_num_candidates=4",
                "planner_diffusion_gradient_steps=4", "log_interval=2", "save_interval=4"],
    "diffuserlite": ["emb_dim=16", "d_model=32", "n_heads=2", "depth=1", "batch_size=8",
                     "diffusion_gradient_steps=4", "invdyn_gradient_steps=2",
                     "cond_dataset_size=20", "dataset_prepare_batch_size=10",
                     "dataset_prepare_sampling_steps=2", "reflow_gradient_steps=4",
                     "log_interval=2", "save_interval=4"],
}
# the IQL-valued suites' own keys
IQL_SMALL = ["iql_gradient_steps=4", "num_candidates=4"]
EVAL = ["num_envs=2", "num_episodes=1"]


@functools.lru_cache(maxsize=None)
def _cached(kind, env_name):
    fn = (data_loading.load_d4rl_dataset if kind == "seq"
          else data_loading.load_d4rl_qlearning_dataset)
    return fn(env_name)


@pytest.fixture(autouse=True)
def _synthetic_data_once(monkeypatch):
    """The CLIs' data loaders (the synthetic fallback, seconds to generate)
    made once per env name for this file."""
    for cli in (*VETERAN.values(), *LITE.values()):
        for name, kind in (("load_d4rl_dataset", "seq"), ("load_d4rl_qlearning_dataset", "td")):
            if hasattr(cli, name):
                monkeypatch.setattr(cli, name, lambda env, kind=kind: {
                    k: v.copy() for k, v in _cached(kind, env).items()})


def _short_episodes(monkeypatch, cli):
    """`d4rl_eval_loop` with 3-step episodes, where the CLI calls it."""
    orig = cli.d4rl_eval_loop
    monkeypatch.setattr(cli, "d4rl_eval_loop",
                        lambda *a, **kw: orig(*a, **{**kw, "max_steps": 3}))


def _needs_eval_env(suite):
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco" if suite == "mujoco" else "gymnasium_robotics")


def _logs(path):
    return [json.loads(s) for s in path.read_text().splitlines()]


def _small(family, suite):
    return SMALL[family] + (IQL_SMALL if family == "diffuserlite" and suite != "mujoco" else [])


def _config(family, suite, *overrides):
    cli = (VETERAN if family == "veteran" else LITE)[suite]
    return load_config(cli.CONFIG_DIR, suite, ["platform=cpu", *_small(family, suite),
                                               *overrides])


@pytest.mark.parametrize("suite", list(VETERAN))
def test_veteran_cli_trains_the_ev_net_and_serves(suite, tmp_path, monkeypatch):
    _needs_eval_env(suite)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(veteran_d4rl_mujoco, "EV_GRADIENT_STEPS", 4)
    cli = VETERAN[suite]
    cli.pipeline(_config("veteran", suite, "mode=train"))
    run = Path("results/torch") / (f"veteran_d4rl_{suite}" + ("_MCSS" if suite == "mujoco"
                                                               else "")) / ENV[suite]
    assert {p.name for p in run.glob("veteran_*")} == {"veteran_4.pkl", "veteran_latest.pkl"}
    logs = _logs(run / "train.jsonl")
    assert [lg["gradient_steps"] for lg in logs] == [2, 4]
    for key in ("planner_loss", "val_loss", "val_pred", "policy_bc_loss"):
        assert all(np.isfinite(lg[key]) for lg in logs), key

    before = torch.load(run / "veteran_latest.pkl", weights_only=True)
    cli.pipeline(_config("veteran", suite, "mode=train_expected_value"))
    after = torch.load(run / "veteran_latest.pkl", weights_only=True)
    assert after["planner"]["step"] == before["planner"]["step"] == 4
    moved = [not torch.equal(after["ev"]["params"][k], before["ev"]["params"][k])
             for k in before["ev"]["params"]]
    assert all(moved)
    ev_logs = [lg for lg in _logs(run / "train.jsonl") if "loss_v" in lg]
    assert [lg["gradient_steps"] for lg in ev_logs] == [2, 4]

    _short_episodes(monkeypatch, veteran_d4rl_mujoco)
    extra = ["goal_inpaint=true", "gi_pin_idx=5"] if suite == "maze2d" else []
    cli.pipeline(_config("veteran", suite, "mode=inference", *EVAL, *extra))
    scores = _logs(run / "inference.jsonl")
    assert len(scores) == 1 and np.isfinite(scores[0]["normalized_score_mean"])


@pytest.mark.parametrize("suite", list(LITE))
def test_diffuserlite_cli_runs_every_mode(suite, tmp_path, monkeypatch):
    _needs_eval_env(suite)
    monkeypatch.chdir(tmp_path)
    cli = LITE[suite]
    run = Path(f"results/torch/diffuserlite_d4rl_{suite}/{ENV[suite]}")
    if suite != "mujoco":
        cli.pipeline(_config("diffuserlite", suite, "mode=iql_training"))
        assert (run / "iql_ckpt_latest.pkl").exists()
    cli.pipeline(_config("diffuserlite", suite, "mode=training"))
    logs = _logs(run / "train.jsonl")
    assert [lg["gradient_steps"] for lg in logs] == [2, 4]
    assert logs[0]["invdyn_loss"] > 0 and logs[1]["invdyn_loss"] == 0  # budget of 2
    assert all(np.isfinite(lg[f"loss{i}"]) for lg in logs for i in range(3))
    assert (run / "ckpt_4.diffusion2").exists() and (run / "ckpt_latest.invdyn").exists()

    cli.pipeline(_config("diffuserlite", suite, "mode=prepare_dataset"))
    with open(run / "reflow_pairs.pkl", "rb") as f:
        pairs = pickle.load(f)
    assert len(pairs) == 3 and all(p["x0"].shape[0] == 20 for p in pairs)
    assert all(isinstance(v, np.ndarray) for p in pairs for v in p.values())
    cond = [set(p) for p in pairs]
    if suite == "mujoco":
        assert cond == [{"x0", "x1", "condition"}] * 3
    else:  # only level 0 is conditioned
        assert cond == [{"x0", "x1", "condition"}, {"x0", "x1"}, {"x0", "x1"}]
    cli.pipeline(_config("diffuserlite", suite, "mode=reflow"))
    assert (run / "reflow_ckpt_latest.diffusion0").exists()
    assert [lg["gradient_steps"] for lg in _logs(run / "reflow.jsonl")] == [2, 4]

    mod = diffuserlite_d4rl_mujoco if suite == "mujoco" else diffuserlite_d4rl_antmaze
    _short_episodes(monkeypatch, mod)
    for test_model in ("R1", "R2"):
        cli.pipeline(_config("diffuserlite", suite, "mode=inference",
                             f"test_model={test_model}", *EVAL))
    scores = _logs(run / "inference.jsonl")
    assert len(scores) == 2 and all(np.isfinite(s["normalized_score_mean"]) for s in scores)


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}",
                                                  ROOT / f"pipelines/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(built, name, cls):
    return lambda *a, **kw: built.setdefault(name, cls(*a, **kw))


def _same_dataset(tds, jds, names):
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(tds, name)),
                                      np.asarray(getattr(jds, name)), err_msg=name)


VETERAN_DATA = {"mujoco": "DV_D4RLMuJoCoSeqDataset", "maze2d": "DV_D4RLMaze2DSeqDataset",
                "antmaze": "DV_D4RLAntmazeSeqDataset", "kitchen": "DV_D4RLKitchenSeqDataset"}


@pytest.mark.parametrize("suite", list(VETERAN))
def test_veteran_cli_builds_what_the_jax_cli_builds(suite, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcli = _jax_cli(f"veteran_d4rl_{suite}")
    built = {}
    data_name = VETERAN_DATA[suite]
    monkeypatch.setattr(jcli, "VeteranPipeline", _record(built, "pipe", jcli.VeteranPipeline))
    monkeypatch.setattr(jcli, data_name, _record(built, "dataset", getattr(jcli, data_name)))
    monkeypatch.setattr(jcli, "load_d4rl_dataset", lambda env: _cached("seq", env))
    monkeypatch.setattr(jcli, "planner_window_fn", lambda *a, **kw: None)
    monkeypatch.setattr(jcli, "train_loop", lambda *a, **kw: None)
    cli = VETERAN[suite]
    jcli.pipeline(jax_load_config(cli.CONFIG_DIR, suite, ["mode=train", *_small("veteran", suite)]))
    dataset, pipe = cli.build(_config("veteran", suite), "cpu")
    jds, jpipe = built["dataset"], built["pipe"]
    assert type(dataset).__name__ == data_name
    _same_dataset(dataset, jds, ("seq_obs", "seq_act", "seq_rew", "seq_val", "indices"))
    for attr in ("guidance_type", "pipeline_type", "mcss_selector", "rebase_policy",
                 "planner_dim", "planner_solver", "planner_sampling_steps", "policy_solver",
                 "policy_sampling_steps", "w_cfg", "target_return", "temperature", "discount",
                 "goal_inpaint", "gi_pin_idx"):
        assert getattr(pipe, attr) == getattr(jpipe, attr), attr
    jpipe.save(str(tmp_path / "jax.pkl"))
    pipe.load_jax_checkpoint(str(tmp_path / "jax.pkl"))  # every shape must fit


@pytest.mark.parametrize("suite", list(LITE))
def test_diffuserlite_cli_builds_what_the_jax_cli_builds(suite, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcli = _jax_cli(f"diffuserlite_d4rl_{suite}")
    built = {}
    data_name = {"mujoco": "MultiHorizonD4RLMuJoCoDataset",
                 "antmaze": "MultiHorizonD4RLAntmazeDataset",
                 "kitchen": "MultiHorizonD4RLKitchenDataset"}[suite]
    monkeypatch.setattr(jcli, "DiffuserLitePipeline",
                        _record(built, "pipe", jcli.DiffuserLitePipeline))
    monkeypatch.setattr(jcli, data_name, _record(built, "dataset", getattr(jcli, data_name)))
    monkeypatch.setattr(jcli, "load_d4rl_dataset", lambda env: _cached("seq", env))
    if suite != "mujoco":
        monkeypatch.setattr(jcli, "load_d4rl_qlearning_dataset", lambda env: _cached("td", env))
    cli = LITE[suite]
    # the JAX CLI builds its dataset and pipeline, then refuses the mode
    with pytest.raises(ValueError, match="Invalid mode"):
        jcli.pipeline(jax_load_config(cli.CONFIG_DIR, suite,
                                      ["mode=build_only", *_small("diffuserlite", suite)]))
    dataset, pipe = cli.build(_config("diffuserlite", suite), "cpu")
    jds, jpipe = built["dataset"], built["pipe"]
    assert type(dataset).__name__ == data_name
    _same_dataset(dataset, jds, ("seq_obs", "seq_act", "seq_val")
                  + (("seq_rew",) if suite != "mujoco" else ()))
    for a, b in zip(dataset.indices, jds.indices):
        np.testing.assert_array_equal(a, b)
    for attr in ("planning_horizons", "temporal_horizons", "return_scale", "w_cfg",
                 "target_return", "temperature"):
        assert getattr(pipe, attr) == getattr(jpipe, attr), attr
    jpipe.save(str(tmp_path / "jax"))
    pipe.load_jax_checkpoint(str(tmp_path / "jax"))  # every shape must fit


@pytest.mark.parametrize("cli", [veteran_d4rl_mujoco, diffuserlite_d4rl_mujoco])
def test_cli_raises_without_a_cuda_device(cli, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    small = _small("veteran" if cli is veteran_d4rl_mujoco else "diffuserlite", "mujoco")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.pipeline(load_config(cli.CONFIG_DIR, "mujoco", small))

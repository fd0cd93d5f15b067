"""The port's DD, Diffuser and AdaptDiffuser D4RL CLIs
(cleandiffuser_tpu_torch/cli/) on the CPU (`platform=cpu`), at a small width
on the synthetic data: DD and Diffuser on MuJoCo, antmaze and kitchen,
AdaptDiffuser on all three.

- `mode=train` trains window by window, logs every window, saves
  `ckpt_<step>` and `ckpt_latest` under results/torch/<pipeline>/<env>/;
  `mode=inference` loads its own `ckpt_latest` and evaluates on gymnasium's
  MuJoCo env (2 envs, 1 episode; the episode length is lowered by a
  monkeypatch of the evaluation, not by a config key).
- Given the same config, the port's CLI and the JAX package's CLI
  (pipelines/*_d4rl_mujoco.py, its `pipeline(args)` run with its trainer
  stubbed) build datasets with identical arrays and pipelines whose
  parameter trees have identical shapes: the JAX params load into the port's
  pipeline through `utils/jax_params.py` and read back equal.
- The antmaze and kitchen CLIs and AdaptDiffuser's train 2 windows, save,
  and serve `ckpt_latest` through `d4rl_eval_loop` on gymnasium_robotics'
  eval envs (episodes cut short by a monkeypatch; skipped without
  gymnasium_robotics); AdaptDiffuser's `mode=finetune` keeps trajectories
  (all of them, at a metric_value below any log p), fine-tunes on them,
  writes `ckpt_finetuned_latest` and serves it, or raises when nothing is
  kept. They build what the JAX CLIs build (the suite's dataset arrays;
  DD's return scale and value shift; the parameter shapes).
- Without a CUDA device and without `platform=cpu`, the CLIs raise.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.utils.config import load_config as jax_load_config
from cleandiffuser_tpu_torch.cli import (
    adaptdiffuser_d4rl_antmaze,
    adaptdiffuser_d4rl_kitchen,
    adaptdiffuser_d4rl_mujoco,
    dd_d4rl_antmaze,
    dd_d4rl_kitchen,
    dd_d4rl_mujoco,
    diffuser_d4rl_antmaze,
    diffuser_d4rl_kitchen,
    diffuser_d4rl_mujoco,
)
from cleandiffuser_tpu_torch.pipelines.data_loading import load_d4rl_dataset
from cleandiffuser_tpu_torch.utils.config import load_config
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, jax_params_of
from jax_shaped_init import shaped_inits

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = {
    "dd": ["d_model=32", "n_heads=2", "depth=1", "emb_dim=16", "sampling_steps=2",
           "batch_size=8", "diffusion_gradient_steps=4", "invdyn_gradient_steps=2"],
    "diffuser": ["model_dim=16", "task.dim_mult=[1,2]", "sampling_steps=2", "batch_size=8",
                 "diffusion_gradient_steps=4", "classifier_gradient_steps=2",
                 "num_candidates=4"],
}
SMALL["adaptdiffuser"] = SMALL["diffuser"]
CLI = {"dd": dd_d4rl_mujoco, "diffuser": diffuser_d4rl_mujoco}
SECOND = {"dd": "invdyn_loss", "diffuser": "classifier_loss", "adaptdiffuser": "classifier_loss"}
# (family, suite) -> the CLI module, for the suites beyond MuJoCo and
# AdaptDiffuser's three
SUITE_CLI = {("dd", "antmaze"): dd_d4rl_antmaze, ("dd", "kitchen"): dd_d4rl_kitchen,
             ("diffuser", "antmaze"): diffuser_d4rl_antmaze,
             ("diffuser", "kitchen"): diffuser_d4rl_kitchen,
             ("adaptdiffuser", "mujoco"): adaptdiffuser_d4rl_mujoco,
             ("adaptdiffuser", "antmaze"): adaptdiffuser_d4rl_antmaze,
             ("adaptdiffuser", "kitchen"): adaptdiffuser_d4rl_kitchen}
ENV = {"mujoco": "halfcheetah-medium-v2", "antmaze": "antmaze-medium-play-v2",
       "kitchen": "kitchen-mixed-v0"}


@pytest.fixture(autouse=True)
def _synthetic_data_once(monkeypatch):
    """The CLIs' `load_d4rl_dataset` (the synthetic 100k-step fallback, ~3 s
    to generate) made once per env name for this file (AdaptDiffuser's CLIs
    load through Diffuser's)."""
    for cli in (*CLI.values(), dd_d4rl_antmaze, dd_d4rl_kitchen, diffuser_d4rl_antmaze,
                diffuser_d4rl_kitchen):
        monkeypatch.setattr(cli, "load_d4rl_dataset", _load_once)


@functools.lru_cache(maxsize=None)
def _cached(env_name):
    return load_d4rl_dataset(env_name)


def _load_once(env_name):
    return {k: v.copy() for k, v in _cached(env_name).items()}


def _config(family, *overrides):
    cli = CLI[family]
    return load_config(cli.CONFIG_DIR, "mujoco", ["platform=cpu", *SMALL[family], *overrides])


def _run_dir(family):
    return Path(f"results/torch/{family}_d4rl_mujoco/halfcheetah-medium-v2")


@pytest.mark.parametrize("family", ["dd", "diffuser"])
def test_cli_trains_saves_and_evaluates_its_checkpoint(family, tmp_path, monkeypatch):
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    monkeypatch.chdir(tmp_path)
    CLI[family].pipeline(_config(family, "mode=train", "log_interval=2", "save_interval=4"))
    run = _run_dir(family)
    assert {p.name for p in run.glob("ckpt_*")} == {
        f"ckpt_{tag}.{part}" for tag in ("4", "latest")
        for part in ("diffusion", "invdyn" if family == "dd" else "classifier")}
    logs = [json.loads(s) for s in (run / "train.jsonl").read_text().splitlines()]
    assert [lg["gradient_steps"] for lg in logs] == [2, 4]
    assert all(np.isfinite(lg["loss"]) and np.isfinite(lg["grad_norm"]) for lg in logs)
    assert logs[0][SECOND[family]] > 0 and logs[1][SECOND[family]] == 0  # budget of 2

    if family == "dd":
        monkeypatch.setattr(dd_d4rl_mujoco, "d4rl_eval_loop",
                            functools.partial(dd_d4rl_mujoco.d4rl_eval_loop, max_steps=3))
    else:
        monkeypatch.setattr(diffuser_d4rl_mujoco, "MAX_STEPS", 3)
    CLI[family].pipeline(_config(family, "mode=inference", "num_envs=2", "num_episodes=1"))
    scores = [json.loads(s) for s in (run / "inference.jsonl").read_text().splitlines()]
    assert len(scores) == 1 and np.isfinite(scores[0]["normalized_score_mean"])


def test_cli_off_the_window_grid_trains_per_step(tmp_path, monkeypatch, capsys):
    """Intervals off the window grid: the DD CLI says why and trains per step."""
    monkeypatch.chdir(tmp_path)
    dd_d4rl_mujoco.pipeline(_config("dd", "mode=train", "log_interval=2", "save_interval=3"))
    out = capsys.readouterr().out
    assert "save_interval=3 is not a multiple of log_interval=2" in out
    assert (_run_dir("dd") / "ckpt_3.diffusion").exists()


def _jax_cli(family):
    path = ROOT / f"pipelines/{family}_d4rl_mujoco.py"
    spec = importlib.util.spec_from_file_location(f"jax_cli_{family}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family", ["dd", "diffuser"])
def test_cli_builds_what_the_jax_cli_builds(family, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcli = _jax_cli(family)
    built = {}
    pipe_cls = jcli.DDPipeline if family == "dd" else jcli.DiffuserPipeline
    data_cls = jcli.D4RLMuJoCoDataset

    def record(name, cls):
        return lambda *a, **kw: built.setdefault(name, cls(*a, **kw))

    monkeypatch.setattr(jcli, pipe_cls.__name__, record("pipe", pipe_cls))
    monkeypatch.setattr(jcli, "D4RLMuJoCoDataset", record("dataset", data_cls))
    monkeypatch.setattr(jcli, "planner_window_fn", lambda *a, **kw: None)
    monkeypatch.setattr(jcli, "train_loop", lambda *a, **kw: None)
    # the JAX nets' init values are not compared: the build takes their
    # param shapes without compiling the inits (tests/jax_shaped_init.py),
    # and seeded weights stand in for them below
    with shaped_inits():
        jcli.pipeline(jax_load_config(CLI[family].CONFIG_DIR, "mujoco",
                                      ["mode=train", *SMALL[family]]))

    dataset, pipe = CLI[family].build(_config(family), "cpu")
    jds, jpipe = built["dataset"], built["pipe"]
    for name in ("seq_obs", "seq_act", "seq_rew", "seq_val", "indices", "path_lengths"):
        np.testing.assert_array_equal(getattr(dataset, name), getattr(jds, name), err_msg=name)
    for stat in ("mean", "std"):
        np.testing.assert_array_equal(getattr(dataset.get_normalizer(), stat),
                                      getattr(jds.get_normalizer(), stat))

    rng = np.random.default_rng(0)
    tree = lambda t: jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), t)
    if family == "dd":
        weights = (tree(jpipe.agent.state.params), tree(jpipe.agent.state.ema_params),
                   tree(jpipe.invdyn.params))
        pipe.load_jax_params(*weights)
        ported = (agent_params_of(pipe.agent.params), agent_params_of(pipe.agent.ema_params),
                  {"params": jax_params_of(pipe.invdyn.net)})
    else:
        weights = (tree(jpipe.agent.state.params), tree(jpipe.agent.state.ema_params),
                   tree(jpipe.classifier.state.params), tree(jpipe.classifier.state.ema_params))
        pipe.load_jax_params(*weights)
        ported = (agent_params_of(pipe.agent.params), agent_params_of(pipe.agent.ema_params),
                  {"params": jax_params_of(pipe.classifier.params)},
                  {"params": jax_params_of(pipe.classifier.ema_params)})
    for got, want in zip(ported, weights):
        got_l = jax.tree_util.tree_leaves_with_path(got)
        want_l = jax.tree_util.tree_leaves_with_path(want)
        assert [(p, a.shape) for p, a in got_l] == [(p, b.shape) for p, b in want_l]
        for (path, a), (_, b) in zip(got_l, want_l):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("family", ["dd", "diffuser"])
def test_cli_raises_without_a_cuda_device(family, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    args = load_config(CLI[family].CONFIG_DIR, "mujoco", ["mode=train"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI[family].pipeline(args)


def test_cli_setup_keys():
    """`platform` picks the CLIs' device; a mesh is a DeviceMesh
    (tests/test_torch_parallel*.py run it)."""
    from cleandiffuser_tpu_torch.parallel import device_of, place_pipeline, setup_mesh
    from cleandiffuser_tpu_torch.utils.tensors import set_seed

    assert device_of(_config("dd")) == torch.device("cpu")
    with pytest.raises(ValueError, match="platform"):
        setup_mesh(_config("dd", "platform=tpu"))
    assert setup_mesh(_config("dd")) is None
    place_pipeline(object(), None)  # one device: nothing to place
    with pytest.raises(TypeError):
        place_pipeline(object(), mesh=object())
    g = set_seed(5)
    draws = (np.random.rand(), torch.rand(2), torch.rand(2, generator=g))
    g = set_seed(5)
    assert draws[0] == np.random.rand() and torch.equal(draws[1], torch.rand(2))
    assert torch.equal(draws[2], torch.rand(2, generator=g))


# ---------------------------------------------------------------------------
# the antmaze and kitchen suites, and AdaptDiffuser
def _suite_config(family, suite, *overrides):
    cli = SUITE_CLI[(family, suite)]
    return load_config(cli.CONFIG_DIR, suite, ["platform=cpu", *SMALL[family], *overrides])


def _suite_run_dir(family, suite):
    return Path(f"results/torch/{family}_d4rl_{suite}/{ENV[suite]}")


def _short_episodes(monkeypatch, family):
    """`d4rl_eval_loop` with 3-step episodes, where the CLI calls it."""
    mod = dd_d4rl_mujoco if family == "dd" else diffuser_d4rl_mujoco
    monkeypatch.setattr(mod, "d4rl_eval_loop", functools.partial(mod.d4rl_eval_loop, max_steps=3))


@pytest.mark.parametrize("family, suite", list(SUITE_CLI),
                         ids=[f"{f}-{s}" for f, s in SUITE_CLI])
def test_suite_cli_trains_saves_and_evaluates_its_checkpoint(family, suite, tmp_path,
                                                            monkeypatch):
    pytest.importorskip("gymnasium")
    pytest.importorskip("gymnasium_robotics" if suite != "mujoco" else "mujoco")
    monkeypatch.chdir(tmp_path)
    cli = SUITE_CLI[(family, suite)]
    cli.pipeline(_suite_config(family, suite, "mode=train", "log_interval=2", "save_interval=4"))
    run = _suite_run_dir(family, suite)
    assert {p.name for p in run.glob("ckpt_*")} == {
        f"ckpt_{tag}.{part}" for tag in ("4", "latest")
        for part in ("diffusion", "invdyn" if family == "dd" else "classifier")}
    logs = [json.loads(s) for s in (run / "train.jsonl").read_text().splitlines()]
    assert [lg["gradient_steps"] for lg in logs] == [2, 4]
    assert all(np.isfinite(lg["loss"]) and np.isfinite(lg["grad_norm"]) for lg in logs)
    assert logs[0][SECOND[family]] > 0 and logs[1][SECOND[family]] == 0  # budget of 2

    _short_episodes(monkeypatch, family)
    cli.pipeline(_suite_config(family, suite, "mode=inference", "num_envs=2", "num_episodes=1"))
    scores = [json.loads(s) for s in (run / "inference.jsonl").read_text().splitlines()]
    assert len(scores) == 1 and np.isfinite(scores[0]["normalized_score_mean"])


FINETUNE = ("mode=finetune", "ft_target=50", "ft_gradient_steps=4", "ft_max_rounds=2",
            "log_interval=2", "save_interval=4")


@pytest.mark.parametrize("suite", ["mujoco", "antmaze"])
def test_adaptdiffuser_cli_finetunes_on_what_it_keeps(suite, tmp_path, monkeypatch):
    """One round of 2000 generated trajectories, all kept at a metric_value
    below every log p (50 used), 4 fine-tuning steps logged twice,
    `ckpt_finetuned_latest` written at step 4 and served by
    `mode=inference ckpt=finetuned_latest`."""
    pytest.importorskip("gymnasium")
    pytest.importorskip("gymnasium_robotics" if suite != "mujoco" else "mujoco")
    monkeypatch.chdir(tmp_path)
    cli = SUITE_CLI[("adaptdiffuser", suite)]
    cli.pipeline(_suite_config("adaptdiffuser", suite, "mode=train", "log_interval=2",
                               "save_interval=4"))
    cli.pipeline(_suite_config("adaptdiffuser", suite, *FINETUNE,
                               "task.metric_value=-1000000000.0"))
    run = _suite_run_dir("adaptdiffuser", suite)
    logs = [json.loads(s) for s in (run / "finetune.jsonl").read_text().splitlines()]
    rounds = [lg for lg in logs if "round" in lg]
    steps = [lg for lg in logs if "gradient_steps" in lg]
    assert [(lg["round"], lg["generated"], lg["kept"]) for lg in rounds] == [(1, 2000, 2000)]
    assert [lg["gradient_steps"] for lg in steps] == [2, 4]
    assert all(np.isfinite(lg["loss"]) for lg in steps)
    assert {p.name for p in run.glob("ckpt_finetuned_latest.*")} == {
        "ckpt_finetuned_latest.diffusion", "ckpt_finetuned_latest.classifier"}
    tuned = adaptdiffuser_d4rl_mujoco.AdaptDiffuserPipeline
    _, pipe = cli.build(_suite_config("adaptdiffuser", suite), "cpu")
    assert isinstance(pipe, tuned)
    pipe.load(str(run / "ckpt_finetuned_latest"))
    assert pipe.agent.step == 4 + 4  # the trained checkpoint's 4, then 4 fine-tuning steps

    _short_episodes(monkeypatch, "adaptdiffuser")
    cli.pipeline(_suite_config("adaptdiffuser", suite, "mode=inference", "num_envs=2",
                               "num_episodes=1", "ckpt=finetuned_latest"))
    scores = [json.loads(s) for s in (run / "inference.jsonl").read_text().splitlines()]
    assert len(scores) == 1 and np.isfinite(scores[0]["normalized_score_mean"])


def test_adaptdiffuser_cli_raises_when_nothing_is_kept(tmp_path, monkeypatch):
    """A metric_value above every log p keeps nothing in ft_max_rounds
    rounds: the CLI raises and writes no fine-tuned checkpoint."""
    monkeypatch.chdir(tmp_path)
    cli = adaptdiffuser_d4rl_kitchen
    cli.pipeline(_suite_config("adaptdiffuser", "kitchen", "mode=train", "log_interval=2",
                               "save_interval=4"))
    with pytest.raises(RuntimeError, match="zero trajectories in 2 rounds"):
        cli.pipeline(_suite_config("adaptdiffuser", "kitchen", *FINETUNE,
                                   "task.metric_value=1000000000.0"))
    run = _suite_run_dir("adaptdiffuser", "kitchen")
    rounds = [json.loads(s) for s in (run / "finetune.jsonl").read_text().splitlines()]
    assert [(lg["round"], lg["kept"]) for lg in rounds] == [(1, 0), (2, 0)]
    assert not list(run.glob("ckpt_finetuned_latest*"))


def _jax_suite_cli(family, suite):
    path = ROOT / f"pipelines/{family}_d4rl_{suite}.py"
    spec = importlib.util.spec_from_file_location(f"jax_cli_{family}_{suite}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family, suite", [k for k in SUITE_CLI if k[1] != "mujoco"],
                         ids=[f"{f}-{s}" for f, s in SUITE_CLI if s != "mujoco"])
def test_suite_cli_builds_what_the_jax_cli_builds(family, suite, tmp_path, monkeypatch):
    """The suite's dataset arrays, DD's return scale and value shift, and
    the pipelines' parameter shapes, from the same config."""
    monkeypatch.chdir(tmp_path)
    jcli = _jax_suite_cli(family, suite)
    built = {}
    pipe_name = {"dd": "DDPipeline", "diffuser": "DiffuserPipeline",
                 "adaptdiffuser": "AdaptDiffuserPipeline"}[family]
    data_name = "D4RLAntmazeDataset" if suite == "antmaze" else "D4RLKitchenDataset"

    def record(name, cls):
        return lambda *a, **kw: built.setdefault(name, cls(*a, **kw))

    monkeypatch.setattr(jcli, pipe_name, record("pipe", getattr(jcli, pipe_name)))
    monkeypatch.setattr(jcli, data_name, record("dataset", getattr(jcli, data_name)))
    monkeypatch.setattr(jcli, "planner_window_fn", lambda *a, **kw: None)
    monkeypatch.setattr(jcli, "train_loop", lambda *a, **kw: None)
    cli = SUITE_CLI[(family, suite)]
    with shaped_inits():  # only the param shapes are compared (tests/jax_shaped_init.py)
        jcli.pipeline(jax_load_config(cli.CONFIG_DIR, suite, ["mode=train", *SMALL[family]]))

    dataset, pipe = cli.build(_suite_config(family, suite), "cpu")
    assert type(pipe).__name__ == pipe_name and type(dataset).__name__ == data_name
    jds, jpipe = built["dataset"], built["pipe"]
    for name in ("seq_obs", "seq_act", "seq_rew", "seq_val", "indices", "path_lengths"):
        np.testing.assert_array_equal(getattr(dataset, name), getattr(jds, name), err_msg=name)
    if family == "dd":
        assert (pipe.return_scale, pipe.val_shift) == (jpipe.return_scale, jpipe.val_shift)
        assert pipe.val_shift == (1.0 if suite == "antmaze" else 0.0)
        jparams = jpipe.agent.state.params
    else:
        jparams = {"agent": jpipe.agent.state.params, "cls": jpipe.classifier.state.params}
    ported = (agent_params_of(pipe.agent.params) if family == "dd" else
              {"agent": agent_params_of(pipe.agent.params),
               "cls": {"params": jax_params_of(pipe.classifier.params)}})
    shapes = lambda t: [(jax.tree_util.keystr(p), np.shape(a))
                        for p, a in jax.tree_util.tree_leaves_with_path(t)]
    assert shapes(ported) == shapes(jparams)

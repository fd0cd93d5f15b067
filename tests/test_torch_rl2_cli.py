"""The port's SfBC, QGPO and SynthER D4RL CLIs and its consistency-policy
entry point (cleandiffuser_tpu_torch/cli/), on the CPU (`platform=cpu`),
on small synthetic data (the CLIs' loaders return 400 sequence steps or
2,000 transitions in episodes of 100, the same arrays to both packages).

Each CLI runs every mode in order, as a user does, and each mode leaves
its files: SfBC `ckpt_4` / `ckpt_latest` (`.actor`, `.critic`), then
`ckpt_critic` after two in-sample-planning iterations; QGPO
`diffusion_ckpt_latest`, `supported_act.npy` (every next state, K each),
`q_state.pt`, `clf_ckpt_latest`; SynthER `diff_ckpt_4` / `diff_ckpt_latest`,
`extra_transitions.npy`, `td3bc.pt` (two actor updates in 4 steps). Their
window logs are finite, and `mode=inference` evaluates the files on
gymnasium's envs (episodes cut to 3 steps by a monkeypatch). Given the same
config, each CLI builds the dataset the JAX CLI (pipelines/*.py, its
pipeline and trainers stubbed) builds, array for array, and passes its
pipelines (and TD3+BC) the same arguments. The consistency policy's entry
point runs the JAX tutorial's stages and sizes, and prints what it prints.
Without a CUDA device and without `platform=cpu`, the CLIs raise.
"""

import contextlib
import functools
import importlib.util
import io
import json
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from cleandiffuser_tpu.utils.config import load_config as jax_load_config
from cleandiffuser_tpu_torch.cli import (
    qgpo_d4rl_mujoco,
    sfbc_d4rl_mujoco,
    sp_consistency_policy,
    synther_d4rl_antmaze,
    synther_d4rl_kitchen,
    synther_d4rl_mujoco,
)
from cleandiffuser_tpu_torch.dataset import fake_d4rl_dataset, fake_d4rl_qlearning_dataset
from cleandiffuser_tpu_torch.pipelines import runner
from cleandiffuser_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = {"mujoco": "halfcheetah-medium-v2", "antmaze": "antmaze-medium-play-v2",
       "kitchen": "kitchen-mixed-v0"}
SYNTHER = {"mujoco": synther_d4rl_mujoco, "antmaze": synther_d4rl_antmaze,
           "kitchen": synther_d4rl_kitchen}


@functools.lru_cache(maxsize=None)
def _data(kind, env_name):
    # the TD data: two 1000-step stretches, so `modify_reward` (QGPO's and
    # SynthER's normalize_reward) finds two returns to scale by
    if kind == "seq":
        return fake_d4rl_dataset(env_name, n_steps=400, ep_len=100)
    return fake_d4rl_qlearning_dataset(env_name, n_steps=2000, ep_len=100)


def _loader(kind):
    return lambda env_name: {k: v.copy() for k, v in _data(kind, env_name).items()}


@pytest.fixture(autouse=True)
def _small_data(monkeypatch):
    monkeypatch.setattr(sfbc_d4rl_mujoco, "load_d4rl_dataset", _loader("seq"))
    for cli in (qgpo_d4rl_mujoco, synther_d4rl_mujoco):
        monkeypatch.setattr(cli, "load_d4rl_qlearning_dataset", _loader("td"))
    # episodes of 3 steps in every evaluation
    for cli in (sfbc_d4rl_mujoco, qgpo_d4rl_mujoco, synther_d4rl_mujoco):
        monkeypatch.setattr(cli, "d4rl_eval_loop",
                            functools.partial(runner.d4rl_eval_loop, max_steps=3))


def _jsonl(path):
    return [json.loads(s) for s in path.read_text().splitlines()] if path.exists() else []


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", ROOT / f"pipelines/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorder(built):
    def record(key, cls=None):
        def make(*a, **kw):
            built[key] = (a, kw) if cls is None else cls(*a, **kw)
            return built[key] if cls is not None else _Stub()
        return make
    return record


class _Stub:
    """A stand-in pipeline: every attribute is a callable doing nothing."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return _Stub()

    def __call__(self, *a, **kw):
        return _Stub()


def _same_arrays(port_ds, jax_ds, keys):
    for key in keys:
        np.testing.assert_array_equal(np.asarray(getattr(port_ds, key)),
                                      np.asarray(getattr(jax_ds, key)), err_msg=key)
    for stat in ("mean", "std"):
        np.testing.assert_array_equal(getattr(port_ds.get_normalizer(), stat),
                                      getattr(jax_ds.get_normalizer(), stat))


def _kwargs(port, jax_):
    (pa, pkw), (ja, jkw) = port, jax_
    pkw = dict(pkw)
    assert pkw.pop("device") == "cpu"
    assert pa == ja and pkw == jkw


# ---------------------------------------------------------------------------
SFBC = ["platform=cpu", "hidden_dim=32", "batch_size=4", "bc_gradient_steps=4",
        "log_interval=2", "save_interval=4", "critic_gradient_steps=4",
        "monte_carlo_samples=2", "eval_actor_sampling_steps=2", "sampling_steps=2"]


def test_sfbc_cli_runs_every_mode(tmp_path, monkeypatch):
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    monkeypatch.chdir(tmp_path)
    cfg = lambda mode, *more: load_config(sfbc_d4rl_mujoco.CONFIG_DIR, "mujoco",
                                          [*SFBC, f"mode={mode}", *more])
    run = Path("results/torch/sfbc_d4rl_mujoco/halfcheetah-medium-v2")
    sfbc_d4rl_mujoco.pipeline(cfg("bc_training"))
    assert {p.name for p in run.glob("ckpt_*")} == {
        f"ckpt_{t}.{p}" for t in ("4", "latest") for p in ("actor", "critic")}
    logs = _jsonl(run / "train.jsonl")
    assert [lg["gradient_steps"] for lg in logs] == [2, 4]
    assert all(np.isfinite(lg["loss"]) for lg in logs)
    sfbc_d4rl_mujoco.pipeline(cfg("critic_training"))
    crit = _jsonl(run / "critic_training.jsonl")
    assert [(lg["iter"], lg["gradient_steps"]) for lg in crit] == [(0, 2), (0, 4), (1, 2),
                                                                  (1, 4)]
    assert (run / "ckpt_critic.critic").exists() and (run / "ckpt_critic.actor").exists()
    sfbc_d4rl_mujoco.pipeline(cfg("inference", "num_envs=2", "num_episodes=1",
                                  "num_candidates=4", "top_k_average=2"))
    scores = _jsonl(run / "inference.jsonl")
    assert len(scores) == 1 and np.isfinite(scores[0]["normalized_score_mean"])


def test_sfbc_cli_builds_what_the_jax_cli_builds(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcli = _jax_cli("sfbc_d4rl_mujoco")
    built = {}
    record = _recorder(built)
    monkeypatch.setattr(jcli, "load_d4rl_dataset", _loader("seq"))
    monkeypatch.setattr(jcli, "SfBCPipeline", record("jax_pipe"))
    monkeypatch.setattr(jcli, "D4RLMuJoCoDataset", record("jax_data", jcli.D4RLMuJoCoDataset))
    monkeypatch.setattr(jcli, "train_loop", lambda *a, **kw: None)
    jcli.pipeline(jax_load_config(sfbc_d4rl_mujoco.CONFIG_DIR, "mujoco",
                                  ["mode=bc_training", *SFBC[1:]]))
    monkeypatch.setattr(sfbc_d4rl_mujoco, "SfBCPipeline", record("port_pipe"))
    dataset, _ = sfbc_d4rl_mujoco.build(
        load_config(sfbc_d4rl_mujoco.CONFIG_DIR, "mujoco", SFBC), "cpu")
    _same_arrays(dataset, built["jax_data"], ("seq_obs", "seq_act", "seq_rew", "seq_val",
                                              "tml_and_not_timeout", "indices"))
    _kwargs(built["port_pipe"], built["jax_pipe"])


# ---------------------------------------------------------------------------
QGPO = ["platform=cpu", "K=4", "bc_gradient_steps=4", "q_gradient_steps=4",
        "cep_gradient_steps=4", "log_interval=2", "save_interval=4", "sampling_steps=2"]


def test_qgpo_cli_runs_every_mode(tmp_path, monkeypatch):
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    monkeypatch.chdir(tmp_path)
    cfg = lambda mode, *more: load_config(qgpo_d4rl_mujoco.CONFIG_DIR, "mujoco",
                                          [*QGPO, f"mode={mode}", *more])
    run = Path("results/torch/qgpo_d4rl_mujoco/halfcheetah-medium-v2")
    qgpo_d4rl_mujoco.pipeline(cfg("bc_training"))
    assert (run / "diffusion_ckpt_latest").exists()
    assert [lg["gradient_steps"] for lg in _jsonl(run / "train.jsonl")] == [2, 4]
    qgpo_d4rl_mujoco.pipeline(cfg("supported_action_collecting"))
    sup = np.load(run / "supported_act.npy")
    n = _data("td", ENV["mujoco"])["observations"].shape[0]
    assert sup.shape == (n, 4, 6) and np.abs(sup).max() <= 1.0
    for stage, keys in (("q_training", {"q_loss"}),
                        ("cep_training", {"loss", "f_max", "f_mean", "f_min"})):
        qgpo_d4rl_mujoco.pipeline(cfg(stage))
        logs = _jsonl(run / f"{stage}.jsonl")
        assert [lg["gradient_steps"] for lg in logs] == [2, 4]
        assert all(keys <= set(lg) and all(np.isfinite(lg[k]) for k in keys) for lg in logs)
    assert (run / "q_state.pt").exists() and (run / "clf_ckpt_latest").exists()
    # off the window grid: step by step
    qgpo_d4rl_mujoco.pipeline(cfg("q_training", "q_gradient_steps=3"))
    assert [lg["gradient_steps"] for lg in _jsonl(run / "q_training.jsonl")] == [2, 4, 2]
    qgpo_d4rl_mujoco.pipeline(cfg("inference", "num_envs=2", "num_episodes=1"))
    scores = _jsonl(run / "inference.jsonl")
    assert len(scores) == 1 and np.isfinite(scores[0]["normalized_score_mean"])


def test_qgpo_cli_builds_what_the_jax_cli_builds(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcli = _jax_cli("qgpo_d4rl_mujoco")
    built = {}
    record = _recorder(built)
    monkeypatch.setattr(jcli, "load_d4rl_qlearning_dataset", _loader("td"))
    monkeypatch.setattr(jcli, "QGPOPipeline", record("jax_pipe"))
    monkeypatch.setattr(jcli, "D4RLMuJoCoTDDataset", record("jax_data",
                                                            jcli.D4RLMuJoCoTDDataset))
    import cleandiffuser_tpu.pipelines.runner as jrunner
    monkeypatch.setattr(jrunner, "train_loop", lambda *a, **kw: None)
    jcli.pipeline(jax_load_config(qgpo_d4rl_mujoco.CONFIG_DIR, "mujoco",
                                  ["mode=bc_training", *QGPO[1:]]))
    monkeypatch.setattr(qgpo_d4rl_mujoco, "QGPOPipeline", record("port_pipe"))
    dataset, _ = qgpo_d4rl_mujoco.build(
        load_config(qgpo_d4rl_mujoco.CONFIG_DIR, "mujoco", QGPO), "cpu")
    _same_arrays(dataset, built["jax_data"], ("obs", "next_obs", "act", "rew", "tml"))
    _kwargs(built["port_pipe"], built["jax_pipe"])


# ---------------------------------------------------------------------------
SYN_KEYS = ["platform=cpu", "diffusion_steps=4", "diffusion_gradient_steps=4",
            "td3bc_gradient_steps=4", "num_transitions=16", "batch_size=8", "log_interval=2",
            "save_interval=4"]
# the shipped configs name no width; these add one (1024 x 6 by default)
SYN = [*SYN_KEYS, "+hidden_dim=64", "+n_blocks=2"]


@pytest.mark.parametrize("suite", list(SYNTHER))
def test_synther_cli_runs_every_mode(suite, tmp_path, monkeypatch):
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco" if suite == "mujoco" else "gymnasium_robotics")
    monkeypatch.chdir(tmp_path)
    cli = SYNTHER[suite]
    cfg = lambda mode, *more: load_config(cli.CONFIG_DIR, suite, [*SYN, f"mode={mode}", *more])
    run = Path(f"results/torch/synther_d4rl_{suite}/{ENV[suite]}")
    cli.pipeline(cfg("train_diffusion"))
    assert {p.name for p in run.glob("diff_ckpt_*")} == {"diff_ckpt_4", "diff_ckpt_latest"}
    assert [lg["gradient_steps"] for lg in _jsonl(run / "train.jsonl")] == [2, 4]
    cli.pipeline(cfg("transition_generation"))
    extra = np.load(run / "extra_transitions.npy")
    o, a = _data("td", ENV[suite])["observations"].shape[1], _data(
        "td", ENV[suite])["actions"].shape[1]
    assert extra.shape == (16, 2 * o + a + 2) and np.isfinite(extra).all()
    cli.pipeline(cfg("train_td3bc"))
    logs = _jsonl(run / "train.jsonl")[2:]
    assert [lg["gradient_steps"] for lg in logs] == [2, 4]
    assert all(np.isfinite(lg[k]) for lg in logs for k in ("critic_loss", "policy_loss"))
    state = torch.load(run / "td3bc.pt", weights_only=True)
    assert (state["step"], state["actor_updates"]) == (4, 2)
    cli.pipeline(cfg("inference", "num_envs=2", "num_episodes=1"))
    scores = _jsonl(run / "inference.jsonl")
    assert len(scores) == 1 and np.isfinite(scores[0]["normalized_score_mean"])


@pytest.mark.parametrize("suite", list(SYNTHER))
def test_synther_cli_builds_what_the_jax_cli_builds(suite, tmp_path, monkeypatch):
    """The TD dataset, SynthER's arguments, and in `train_td3bc` the real and
    synthetic mix (clipped actions, thresholded terminals) and TD3+BC's
    arguments."""
    monkeypatch.chdir(tmp_path)
    jcli = _jax_cli(f"synther_d4rl_{suite}")
    data = {"mujoco": "D4RLMuJoCoTDDataset", "antmaze": "D4RLAntmazeTDDataset",
            "kitchen": "D4RLKitchenTDDataset"}[suite]
    built = {}
    record = _recorder(built)
    jax_cfg = lambda mode: jax_load_config(SYNTHER[suite].CONFIG_DIR, suite,
                                           [f"mode={mode}", *SYN_KEYS[1:]])
    monkeypatch.setattr(jcli, "load_d4rl_qlearning_dataset", _loader("td"))
    monkeypatch.setattr(jcli, "SynthERPipeline", record("jax_pipe"))
    monkeypatch.setattr(jcli, "TD3BC", record("jax_agent"))
    monkeypatch.setattr(jcli, "train_loop", lambda *a, **kw: None)
    monkeypatch.setattr(jcli, "planner_window_fn", lambda *a, **kw: None)
    jcli.pipeline(jax_cfg("train_diffusion"))

    port_args = load_config(SYNTHER[suite].CONFIG_DIR, suite, SYN_KEYS)
    monkeypatch.setattr(synther_d4rl_mujoco, "SynthERPipeline", record("port_pipe"))
    monkeypatch.setattr(synther_d4rl_mujoco, "TD3BC", record("port_agent"))
    raw, dataset, _ = SYNTHER[suite].build(port_args, "cpu")
    # the JAX CLI's flow: the TD dataset of the raw data, then the mix of
    # the same raw data (normalize_reward scales the raw rewards in place)
    jraw = _loader("td")(ENV[suite])
    kw = {"normalize_reward": True} if suite == "mujoco" else {}
    jds = getattr(jcli, data)(jraw, *kw.values())
    _same_arrays(dataset, jds, ("obs", "next_obs", "act", "rew", "tml"))
    _kwargs(built["port_pipe"], built["jax_pipe"])

    o, a = dataset.o_dim, dataset.a_dim
    extra = np.random.default_rng(0).uniform(-1.5, 1.5, (16, 2 * o + a + 2)).astype(np.float32)
    got = synther_d4rl_mujoco.mix_transitions(SYNTHER[suite].td_dataset(port_args, raw, "cpu"),
                                              extra, "cpu")
    if suite == "mujoco":
        want = jcli._MixedTD(jraw, extra, True)
    else:
        want = getattr(jcli, data)(jraw)
        want.obs = np.concatenate([want.obs, extra[:, :o]], 0)
        want.act = np.concatenate([want.act, extra[:, o:o + a].clip(-1, 1)], 0)
        want.rew = np.concatenate([want.rew, extra[:, o + a:o + a + 1]], 0)
        want.next_obs = np.concatenate([want.next_obs, extra[:, o + a + 1:2 * o + a + 1]], 0)
        want.tml = np.concatenate([want.tml, (extra[:, -1:] > 0.5).astype(np.float32)], 0)
    assert got.size == dataset.size + 16
    _same_arrays(got, want, ("obs", "next_obs", "act", "rew", "tml"))
    assert np.abs(got.act).max() <= 1.0 and set(np.unique(got.tml[-16:])) <= {0.0, 1.0}
    batch = got.sample_batch(torch.Generator().manual_seed(0), 4)
    assert batch["act"].shape == (4, a)

    run = Path(f"results/synther_d4rl_{suite}/{ENV[suite]}")
    run.mkdir(parents=True, exist_ok=True)
    np.save(run / "extra_transitions.npy", extra)
    monkeypatch.setattr(jcli.pickle if hasattr(jcli, "pickle") else __import__("pickle"),
                        "dump", lambda *a, **kw: None)
    jcli.pipeline(jax_cfg("train_td3bc"))
    synther_d4rl_mujoco.build_agent(port_args, got, "cpu", port_args.td3bc_gradient_steps)
    _kwargs(built["port_agent"], built["jax_agent"])


def test_cli_raises_without_a_cuda_device(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    for cli, name, mode in ((sfbc_d4rl_mujoco, "mujoco", "bc_training"),
                            (qgpo_d4rl_mujoco, "mujoco", "bc_training"),
                            (synther_d4rl_kitchen, "kitchen", "train_diffusion")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.pipeline(load_config(cli.CONFIG_DIR, name, [f"mode={mode}"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp_consistency_policy.main([])


# ---------------------------------------------------------------------------
def test_sp_consistency_policy_runs_the_tutorials_stages():
    """The entry point at the tutorial's sizes (IQL, EDM and distillation,
    20 steps each at batch 64; 16 candidates for 4 observations at 2 NFE)
    prints the tutorial's stages; each stage's logs are finite and the
    actions in [-1, 1]. The JAX tutorial prints the same stages and logs."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = sp_consistency_policy.main(["platform=cpu"])
    text = out.getvalue()
    assert res["args"].hidden_dim == 256 and res["pipe"].cm.cur_logger.s1 == 24
    assert res["pipe"].edm.step == 20 and res["pipe"].cm.step == 20
    assert res["pipe"].cm.distillation_N == 12
    assert res["actions"].shape == (4, res["dataset"].a_dim)
    assert res["actions"].abs().max() <= 1.0
    for name, keys in (("iql", {"loss_v", "loss_q"}), ("edm", {"loss", "grad_norm"}),
                       ("cd", {"loss"})):
        assert set(res["logs"][name]) == keys
        assert all(np.isfinite(v) for v in res["logs"][name].values())
    jax_out = io.StringIO()
    with contextlib.redirect_stdout(jax_out):
        runpy.run_path(str(ROOT / "tutorials/sp_consistency_policy.py"))
    jtext = jax_out.getvalue()
    for header in ("IQL", "EDM", "consistency distillation", "2-NFE actions"):
        assert header.split()[0] in jtext
    assert "actions:" in text and "actions:" in jtext
    for key in ("loss_v", "loss_q", "'loss'", "grad_norm"):
        assert key in text and key in jtext

"""The port's four imitation CLIs on the CPU (`platform=cpu`): each through
`mode=train` (a window run and a per-step run) then `mode=inference` from
`ckpt_latest`, at tiny widths (the pipelines' backbones narrowed by a
stand-in: Chi U-Net model_dim 16 with dim_mult (1, 2), ChiTransformer
d_model 32 with 1 layer, DiT d_model 32 with 2 heads and depth 1,
PearceMlp hidden 32) and short runs. PushT trains off a demo
cache the JAX package wrote (its `ReplayBuffer.save_npz`), and a missing
cache is made by the scripted pusher and written where the JAX package
reads it; Kitchen on the CLIs' synthetic demos, its evaluation on
gymnasium_robotics' FrankaKitchen where installed. Every shipped backbone
directory of configs/{dp,dbc}/{pusht,kitchen} loads and builds. Without
`platform=cpu` and without a CUDA device the CLIs raise."""

import json

import numpy as np
import pytest
import torch

import cleandiffuser_tpu.dataset as jds
import cleandiffuser_tpu_torch.pipelines.dbc as tdbc
import cleandiffuser_tpu_torch.pipelines.dp as tdp
from cleandiffuser_tpu_torch.cli import dbc_kitchen, dbc_pusht, dp_kitchen, dp_pusht
from cleandiffuser_tpu_torch.dataset import generate_pusht_demos
from cleandiffuser_tpu_torch.nn_diffusion import ChiTransformer, ChiUNet1d, DiT1d, PearceMlp
from cleandiffuser_tpu_torch.utils.config import resolve_config_cli

torch.set_num_threads(2)

CLIS = {"dp_pusht": dp_pusht, "dbc_pusht": dbc_pusht, "dp_kitchen": dp_kitchen,
        "dbc_kitchen": dbc_kitchen}


def _narrow(cls, **fixed):
    return lambda **kw: cls(**{**kw, **fixed})


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setattr(tdp, "ChiUNet1d", _narrow(ChiUNet1d, model_dim=16, emb_dim=16,
                                                  dim_mult=(1, 2)))
    monkeypatch.setattr(tdp, "ChiTransformer", _narrow(ChiTransformer, d_model=32,
                                                       num_layers=1))
    monkeypatch.setattr(tdp, "DiT1d", _narrow(DiT1d, d_model=32, n_heads=2, depth=1))
    monkeypatch.setattr(tdbc, "DiT1d", _narrow(DiT1d, d_model=32, n_heads=2, depth=1))
    monkeypatch.setattr(tdbc, "PearceMlp", _narrow(PearceMlp, hidden_dim=32))


def _args(name, argv):
    return resolve_config_cli(CLIS[name].CONFIG_DIR, name.split("_")[1], argv, nn_key="nn")


def _run(name, argv):
    args = _args(name, ["platform=cpu", *argv])
    CLIS[name].pipeline(args)
    return args


def _jsonl(path):
    return [json.loads(s) for s in path.read_text().splitlines()]


@pytest.fixture
def jax_demos(tmp_path, monkeypatch):
    """A demo cache written by the JAX package at the configs' path."""
    monkeypatch.chdir(tmp_path)
    rb = generate_pusht_demos(n_episodes=3, max_steps=30, seed=0)
    (tmp_path / "dev/pusht").mkdir(parents=True)
    for name in ("pusht_demos.npz", "pusht_demos_keypoint.npz"):
        jds.ReplayBuffer.create_from_data(dict(rb.data), rb.episode_ends).save_npz(
            str(tmp_path / "dev/pusht" / name))
    return tmp_path


PUSHT_CASES = [("dp_pusht", "chi_unet", "pusht"), ("dp_pusht", "chi_unet", "pusht_keypoint"),
               ("dp_pusht", "chi_transformer", "pusht"), ("dp_pusht", "dit", "pusht"),
               ("dbc_pusht", "pearce_mlp", "pusht"), ("dbc_pusht", "dit", "pusht"),
               ("dbc_pusht", "pearce_mlp", "pusht_keypoint")]


@pytest.mark.parametrize("name,nn,config", PUSHT_CASES)
def test_pusht_cli_trains_then_serves(jax_demos, name, nn, config):
    common = [f"nn={nn}", f"--config-name={config}", "batch_size=8", "sample_steps=2",
              "num_envs=2", "max_episode_steps=8"]
    args = _run(name, common + ["mode=train", "gradient_steps=4", "log_freq=2", "save_freq=4",
                                "eval_freq=4"])
    run = jax_demos / "results/torch" / args.pipeline_name / args.env_name
    logs = _jsonl(run / "train.jsonl")
    assert [lg["step"] for lg in logs] == [2, 4]
    loss_key = "avg_diffusion_loss" if name == "dp_pusht" else "avg_loss"
    assert all(np.isfinite(lg[loss_key]) for lg in logs)
    assert (run / "ckpt_latest").exists()
    assert (run / "ckpt_4").exists() == (name == "dp_pusht")
    evals = _jsonl(run / "inference.jsonl")
    assert evals[-1]["step"] == 4 and 0.0 <= evals[-1]["mean_success"] <= 1.0
    _run(name, common + ["mode=inference"])
    evals = _jsonl(run / "inference.jsonl")
    assert len(evals) == 2 and np.isfinite(evals[-1]["mean_reward"])


def test_pusht_cli_per_step_path_and_missing_demos(tmp_path, monkeypatch):
    """save_freq off the log grid: the per-step path; no demo file: the
    scripted demos, cached where the JAX package reads them."""
    monkeypatch.chdir(tmp_path)
    args = _run("dbc_pusht", ["mode=train", "demo_expert=false", "demo_episodes=2",
                              "demo_max_steps=20", "batch_size=8", "gradient_steps=3",
                              "log_freq=2", "save_freq=3", "sample_steps=2"])
    logs = _jsonl(tmp_path / "results/torch" / args.pipeline_name / args.env_name / "train.jsonl")
    assert [lg["step"] for lg in logs] == [2, 3]
    rb = jds.ReplayBuffer.load_npz(str(tmp_path / args.dataset_path))
    assert rb.n_episodes == 2 and set(rb.keys()) == {"state", "action", "keypoint"}


KITCHEN_CASES = [("dp_kitchen", "chi_unet", "kitchen"), ("dp_kitchen", "dit", "kitchen"),
                 ("dbc_kitchen", "pearce_mlp", "kitchen"), ("dbc_kitchen", "dit", "kitchen")]


@pytest.mark.parametrize("name,nn,config", KITCHEN_CASES)
def test_kitchen_cli_trains_then_serves(tmp_path, monkeypatch, name, nn, config):
    monkeypatch.chdir(tmp_path)
    common = [f"nn={nn}", f"--config-name={config}", "batch_size=8", "sample_steps=2",
              "eval_episodes=1", "max_episode_steps=4"]
    args = _run(name, common + ["mode=train", "gradient_steps=4", "log_freq=2", "save_freq=4",
                                "eval_freq=8"])
    run = tmp_path / "results/torch" / args.pipeline_name / (args.get("env_name") or "kitchen")
    assert [lg["step"] for lg in _jsonl(run / "train.jsonl")] == [2, 4]
    assert (run / "ckpt_latest").exists()
    try:
        import gymnasium_robotics  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            _run(name, common + ["mode=inference"])
        return
    _run(name, common + ["mode=inference"])
    out = _jsonl(run / "inference.jsonl")[-1]
    # the loop counts a chunk's action_steps per act (the JAX CLI's rule)
    assert np.isfinite(out["mean_reward"]) and 0 < out["mean_steps"] <= max(
        4, args.get("action_steps", 1))


CONFIGS = [(name, d.name, f.stem) for name, cli in CLIS.items()
           for d in sorted(cli.CONFIG_DIR.parent.iterdir()) if d.is_dir()
           for f in sorted(d.glob("*.yaml")) if "image" not in f.stem]


@pytest.mark.parametrize("name,nn,config", CONFIGS)
def test_every_shipped_config_loads_and_builds(tmp_path, name, nn, config):
    """The directory's own yaml (its `nn` is the directory's name), and the
    CLI's pipeline built from it (the dataset stands aside)."""
    args = _args(name, ["platform=cpu", f"nn={nn}", f"--config-name={config}"])
    assert args.nn == nn
    _, pipe = CLIS[name].build(args, torch.device("cpu"), dataset=object())
    assert pipe.obs_dim == args.obs_dim and pipe.action_dim == args.action_dim


def test_cli_needs_the_card_without_platform_cpu(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp_kitchen.pipeline(_args("dp_kitchen", ["mode=train"]))

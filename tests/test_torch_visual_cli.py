"""The port's six visual imitation and robomimic CLIs on the CPU
(`platform=cpu`): `cli.{dp,dbc}_pusht_image`, `cli.{dp,dbc}_robomimic` and
`cli.{dp,dbc}_robomimic_image`, each through `mode=train` (4 steps in two
windows, checkpoints on the reference's grid: `ckpt_<step>` and
`ckpt_latest` for dp_pusht_image, `ckpt_latest` for the others) and then
serving `ckpt_latest`: the PushT CLIs by `mode=inference` (the on-device
evaluation), the robomimic ones by a request (their `mode=inference`
needs robomimic and robosuite and raises ImportError without them).

The backbones run narrow (a stand-in for the class in each pipeline
module: Chi U-Net model_dim 16 with dim_mult (1, 2), DiT d_model 32 with 2
heads and depth 1, PearceMlp hidden 32), the images at 40 x 40 cropped to
36 (a `shape_meta` override; the encoder keeps its widths). PushT trains
on the scripted demos with frames, cached as an .npz the JAX package
reads; robomimic on the CLIs' synthetic demos (the `_abs` config: 10-dim
actions). DP's chi_unet image path runs in the robomimic image CLI (its
default); `nn=chi_unet` on PushT images builds below. Every shipped config of the six CLIs loads, and the PushT image
backbones build (the DP image pipeline takes chi_unet and dit, and raises
for chi_transformer as the JAX one does).
"""

import json

import numpy as np
import pytest
import torch

import cleandiffuser_tpu.dataset as jds
import cleandiffuser_tpu.pipelines.dp_image as jdp_image
import cleandiffuser_tpu_torch.pipelines.dbc as tdbc
import cleandiffuser_tpu_torch.pipelines.dbc_image as tdbci
import cleandiffuser_tpu_torch.pipelines.dp as tdp
import cleandiffuser_tpu_torch.pipelines.dp_image as tdpi
from cleandiffuser_tpu_torch.cli import (
    dbc_pusht_image,
    dbc_robomimic,
    dbc_robomimic_image,
    dp_pusht_image,
    dp_robomimic,
    dp_robomimic_image,
)
from cleandiffuser_tpu_torch.nn_diffusion import ChiUNet1d, DiT1d, PearceMlp

torch.set_num_threads(2)

CLIS = {"dp_pusht_image": dp_pusht_image, "dbc_pusht_image": dbc_pusht_image,
        "dp_robomimic": dp_robomimic, "dbc_robomimic": dbc_robomimic,
        "dp_robomimic_image": dp_robomimic_image, "dbc_robomimic_image": dbc_robomimic_image}
SMALL_IMAGES = {"pusht": ["shape_meta.obs.image.shape=[3,40,40]", "crop_shape=[36,36]"],
                "robomimic_image": ["shape_meta.obs.agentview_image.shape=[3,40,40]",
                                    "crop_shape=[36,36]"]}


def _narrow(cls, **fixed):
    return lambda **kw: cls(**{**kw, **fixed})


@pytest.fixture(autouse=True)
def tiny(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for mod in (tdp, tdpi):
        monkeypatch.setattr(mod, "ChiUNet1d", _narrow(ChiUNet1d, model_dim=16, emb_dim=16,
                                                      dim_mult=(1, 2)))
        monkeypatch.setattr(mod, "DiT1d", _narrow(DiT1d, d_model=32, n_heads=2, depth=1))
    for mod in (tdbc, tdbci):
        monkeypatch.setattr(mod, "PearceMlp", _narrow(PearceMlp, hidden_dim=32))


def _jsonl(path):
    return [json.loads(s) for s in path.read_text().splitlines()]


def _small(name):
    if "pusht" in name:
        return [*SMALL_IMAGES["pusht"], "demo_expert=false", "demo_episodes=2",
                "demo_max_steps=20", "dataset_path=dev/pusht/image_demos.npz", "num_envs=2",
                "max_episode_steps=8" if name.startswith("dp") else "max_episode_steps=2"]
    return SMALL_IMAGES["robomimic_image"] if "image" in name else []


CASES = [("dp_pusht_image", []), ("dbc_pusht_image", []),
         ("dp_robomimic", []), ("dp_robomimic", ["nn=chi_unet", "--config-name=lift_abs"]),
         ("dbc_robomimic", []), ("dp_robomimic_image", []), ("dbc_robomimic_image", [])]


@pytest.mark.parametrize("name,extra", CASES, ids=[" ".join([n, *e]) for n, e in CASES])
def test_visual_cli_trains_then_serves(tmp_path, name, extra):
    cli = CLIS[name]
    common = ["platform=cpu", "batch_size=4", "sample_steps=2", *_small(name), *extra]
    train = ["mode=train", "gradient_steps=4", "log_freq=2", "save_freq=4"]
    if "pusht" in name:
        train.append("eval_freq=4")
    args = cli.config(common + train)
    cli.pipeline(args)
    run = tmp_path / "results/torch" / args.pipeline_name / (
        args.get("env_name") or args.get("task", args).get("task_name"))
    logs = _jsonl(run / "train.jsonl")
    assert [lg["step"] for lg in logs] == [2, 4] and all(np.isfinite(lg["avg_loss"])
                                                         for lg in logs)
    assert (run / "ckpt_latest").exists()
    assert (run / "ckpt_4").exists() == (name == "dp_pusht_image")
    if "pusht" in name:
        assert _jsonl(run / "inference.jsonl")[-1]["step"] == 4
        cli.pipeline(cli.config(common + ["mode=inference"]))
        out = _jsonl(run / "inference.jsonl")
        assert len(out) == 2 and 0.0 <= out[-1]["mean_success"] <= 1.0
        # the cache of the demos with frames is the JAX package's layout
        rb = jds.ReplayBuffer.load_npz(str(tmp_path / args.dataset_path))
        assert set(rb.keys()) == {"state", "action", "keypoint", "img"}
        assert rb["img"].shape[1:] == (40, 40, 3) and rb["img"].dtype == np.uint8
        return
    with pytest.raises(ImportError, match="robomimic"):
        cli.pipeline(cli.config(common + ["mode=inference"]))
    dataset, pipe = cli.build(args, torch.device("cpu"))
    pipe.load(str(run / "ckpt_latest"))
    obs = {k: v[:, :args.obs_steps] for k, v in dataset.gather(torch.arange(2))["obs"].items()}
    out = pipe.act_chunk(obs if "image" in name else obs["state"]) if name.startswith("dp") \
        else pipe.act(obs if "image" in name else obs["state"])
    act_dim = 10 if "lift_abs" in " ".join(extra) else 7
    assert pipe.action_dim == act_dim and out.shape[-1] == act_dim
    assert torch.isfinite(out).all() and out.abs().max() <= 1.0


TASKS = ("can", "lift", "square", "tool_hang", "transport")


def _configs():
    """(CLI, argv) for every shipped config of the six CLIs: the CLI's own
    file with each task, and each backbone directory's file."""
    out = []
    for name, cli in CLIS.items():
        root = cli.CONFIG_DIR if "robomimic" in name else cli.CONFIG_DIR.parent / "pusht"
        if "pusht" in name:
            out.append((name, ()))
        else:
            out += [(name, (f"task={task}",)) for task in TASKS]
        if name.endswith("robomimic_image"):
            continue
        for d in sorted(p for p in root.iterdir() if p.is_dir() and p.name != "task"):
            for f in sorted(d.glob("pusht_image.yaml" if "pusht" in name else "*.yaml")):
                out.append((name, (f"nn={d.name}", f"--config-name={f.stem}")))
    return out


@pytest.mark.parametrize("name,argv", _configs(), ids=[" ".join([n, *a]) for n, a in _configs()])
def test_every_shipped_config_loads(name, argv):
    args = CLIS[name].config(["platform=cpu", *argv])
    assert args.pipeline_name == name
    for a in argv:
        key, value = a.lstrip("-").split("=")
        if key == "nn":
            assert args.nn == value
        elif key == "task":
            assert args.task.task_name == value
        elif "robomimic" in name:  # a backbone's file: the task's keys at the top
            assert value.startswith(args.task_name)


@pytest.mark.parametrize("nn", ["chi_unet", "dit", "chi_transformer"])
def test_pusht_image_backbones_build(nn):
    args = dp_pusht_image.config(["platform=cpu", f"nn={nn}"])
    assert args.nn == nn and (args.horizon == 16) == (nn == "chi_unet")
    if nn == "chi_transformer":  # neither package's image pipeline takes it
        with pytest.raises(ValueError):
            jdp_image.DPImagePipeline(shape_meta=args.shape_meta.to_dict(), action_dim=2, nn=nn)
        with pytest.raises(ValueError):
            dp_pusht_image.build(args, torch.device("cpu"), dataset=object())
        return
    _, pipe = dp_pusht_image.build(args, torch.device("cpu"), dataset=object())
    assert pipe.nn_kind == nn and pipe.horizon == args.horizon


def test_visual_cli_needs_the_card_without_platform_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dbc_robomimic.pipeline(dbc_robomimic.config(["mode=train"]))

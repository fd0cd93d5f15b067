"""The port's windowed trainer and training loop (pipelines/runner.py,
`make_train_scan` of pipelines/dd.py and pipelines/diffuser.py), on the CPU.

The counterpart of tests/test_fused_rl_window.py:62-100 and :314-334: a DD
and a Diffuser window of 4 steps leave the pipeline as the same 4 steps taken
one by one through `train_step(dataset.sample_batch(generator, 8))` with the
same generator stream do (params, EMA, the second model, within rtol 2e-4 /
atol 2e-5, the JAX test's bounds); the engine's step is 4 and the budget-gated
second model stops at its budget of 2; the window's logs are the steps'
means with the gated loss entering as 0. `train_loop` realigns a resume off
the window grid with per-step updates and then runs windows, and
`planner_window_fn` returns None off the grid.

With tests/test_torch_dd_train.py and test_torch_diffuser_train.py (the
port's `train_step` equals the JAX package's) and the JAX package's own
tests/test_fused_rl_window.py (its window equals its steps), this holds the
port's window to the JAX one.
"""

import json

import numpy as np
import pytest
import torch

from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoDataset
from cleandiffuser_tpu_torch.dataset.fake import fake_d4rl_dataset
from cleandiffuser_tpu_torch.pipelines import DDPipeline, DiffuserPipeline
from cleandiffuser_tpu_torch.pipelines.runner import (
    planner_window_fn,
    step_generator,
    train_loop,
)
from cleandiffuser_tpu_torch.utils.config import Config
from cleandiffuser_tpu_torch.utils.logger import Logger

torch.set_num_threads(1)

N_STEPS, BATCH, BUDGET = 4, 8, 2


@pytest.fixture(scope="module")
def dataset():
    raw = fake_d4rl_dataset("halfcheetah-medium-v2", n_steps=288, ep_len=48)
    return D4RLMuJoCoDataset(raw, horizon=8, device="cpu")


def _dd(ds):
    return DDPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, horizon=8, emb_dim=16, d_model=32,
                      n_heads=2, depth=1, diffusion_gradient_steps=100,
                      invdyn_gradient_steps=BUDGET, sampling_steps=4, use_pallas_block=True,
                      rng=0, device="cpu")


def _diffuser(ds):
    return DiffuserPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, horizon=8, model_dim=16,
                            dim_mult=(1, 2), diffusion_steps=4, sampling_steps=4,
                            diffusion_gradient_steps=100, classifier_gradient_steps=BUDGET,
                            use_pallas_block=True, rng=0, device="cpu")


def _modules(pipe):
    second = pipe.invdyn.net if isinstance(pipe, DDPipeline) else pipe.classifier.params
    return pipe.agent.params, pipe.agent.ema_params, second


@pytest.mark.parametrize("family", ["dd", "diffuser"])
def test_window_matches_the_same_steps_one_by_one(dataset, family):
    mk = _dd if family == "dd" else _diffuser
    second = "invdyn_loss" if family == "dd" else "classifier_loss"

    seq = mk(dataset)
    gen = torch.Generator().manual_seed(3)
    logs = [seq.train_step(dataset.sample_batch(gen, BATCH)) for _ in range(N_STEPS)]

    win = mk(dataset)
    log = win.make_train_scan(dataset, BATCH, N_STEPS)(torch.Generator().manual_seed(3))
    assert set(log) == {"loss", "grad_norm", second}
    assert all(v.ndim == 0 and torch.isfinite(v) for v in log.values())

    for a, b in zip(_modules(seq), _modules(win)):
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=name)
    assert win.agent.step == N_STEPS
    if family == "diffuser":
        assert win.classifier.step == BUDGET  # stopped at its budget
    # the window's means: the gated loss enters as 0 past the budget
    assert [second in lg for lg in logs] == [True] * BUDGET + [False] * (N_STEPS - BUDGET)
    for k, v in log.items():
        want = sum(float(lg[k]) for lg in logs if k in lg) / N_STEPS
        np.testing.assert_allclose(float(v), want, rtol=1e-5, err_msg=k)


def _args(**kw):
    return Config(dict(dict(batch_size=BATCH, log_interval=10, save_interval=50,
                            diffusion_gradient_steps=100), **kw))


def test_planner_window_fn_alignment_gates(dataset, capsys):
    pipe = _dd(dataset)
    assert planner_window_fn(pipe, dataset, _args(save_interval=25), mesh=None) is None
    assert "save_interval=25 is not a multiple of log_interval=10" in capsys.readouterr().out
    assert planner_window_fn(pipe, dataset, _args(diffusion_gradient_steps=105), None) is None
    assert "diffusion_gradient_steps=105" in capsys.readouterr().out
    assert callable(planner_window_fn(pipe, dataset, _args(), mesh=None))
    with pytest.raises(TypeError):  # a mesh is a DeviceMesh
        planner_window_fn(pipe, dataset, _args(), mesh=object())
    assert planner_window_fn(object(), dataset, _args(), mesh=None) is None


def test_train_loop_realigns_misaligned_resume():
    """A resume off the window grid realigns with per-step updates, saves
    "latest", then runs windows; it does not run the whole schedule per
    step."""
    calls, saves = {"step": 0, "window": 0}, []

    def step_fn(g):
        calls["step"] += 1
        return {"loss": torch.zeros(())}

    def window_fn(g):
        calls["window"] += 1
        return {"loss": torch.zeros(())}

    train_loop(step_fn, gradient_steps=40, log_interval=10, save_interval=40,
               save_fn=saves.append, resume_fn=lambda: 7, window_fn=window_fn, device="cpu")
    assert calls == {"step": 3, "window": 3}  # realign 7 -> 10, then 10 -> 40
    assert saves == ["latest", "40", "latest"]


def test_train_loop_per_step_logs_means_and_saves(tmp_path, capsys):
    """Without a window: per-window means of the device logs (a key logged
    on some steps only is summed over those and divided by the window),
    steps/s, numbered and latest saves on the save grid."""
    saves = []
    step = {"n": 0}

    def step_fn(g):
        step["n"] += 1
        log = {"loss": torch.tensor(float(step["n"]))}
        if step["n"] <= 3:
            log["invdyn_loss"] = torch.tensor(1.0)
        return log

    logger = Logger(tmp_path, {"seed": 0})
    train_loop(step_fn, gradient_steps=6, log_interval=2, save_interval=4, save_fn=saves.append,
               logger=logger, device="cpu")
    logger.finish()
    lines = [json.loads(s) for s in (tmp_path / "train.jsonl").read_text().splitlines()]
    assert [ln["gradient_steps"] for ln in lines] == [2, 4, 6]
    assert [ln["loss"] for ln in lines] == [1.5, 3.5, 5.5]
    assert [ln.get("invdyn_loss") for ln in lines] == [1.0, 0.5, None]
    assert all(ln["steps_per_sec"] > 0 for ln in lines)
    assert saves == ["4", "latest"]
    assert json.loads((tmp_path / "config.json").read_text()) == {"seed": 0}


def test_train_loop_windows_save_on_the_grid(capsys):
    saves, gens = [], []

    def window_fn(g):
        gens.append(g)
        return {"loss": torch.ones(())}

    train_loop(lambda g: pytest.fail("per-step path taken"), gradient_steps=8, log_interval=2,
               save_interval=4, save_fn=saves.append, window_fn=window_fn, device="cpu")
    assert saves == ["4", "latest", "8", "latest"]
    assert len(gens) == 4 and all(g is gens[0] for g in gens)  # one stream
    out = capsys.readouterr().out
    assert "'gradient_steps': 8" in out and "steps_per_sec" in out


def test_train_loop_says_why_it_runs_per_step(capsys):
    train_loop(lambda g: {"loss": torch.zeros(())}, gradient_steps=6, log_interval=2,
               save_interval=3, save_fn=lambda tag: None,
               window_fn=lambda g: pytest.fail("window off the grid"), device="cpu")
    assert "not all on the 2-step window grid" in capsys.readouterr().out


def test_resumed_run_draws_a_fresh_stream():
    draw = lambda start: torch.rand(4, generator=step_generator(0, start, "cpu"))
    assert torch.equal(draw(0), draw(0))
    assert not torch.equal(draw(0), draw(10))
    assert not torch.equal(draw(0), torch.rand(4, generator=step_generator(1, 0, "cpu")))

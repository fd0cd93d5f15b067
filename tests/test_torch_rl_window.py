"""The port's RL training window (pipelines/runner.py `make_rl_train_scan`,
`rl_window_fn`) on the CPU.

The counterpart of tests/test_fused_rl_window.py:31-59 and :295-312: for
DQL, EDP and IDQL, a window of 4 steps leaves the pipeline as the same 4
steps taken one by one through `train_step(dataset.sample_batch(generator,
8))` with the same generator stream do (the actor's params and EMA, the
critic and its target, V, within rtol 2e-4 / atol 2e-5, the JAX test's
bounds), with the engine's step at 4; the window's logs are the steps'
means. `rl_window_fn` returns the window on the log grid, None off it (with
the reason printed), and raises TypeError for a mesh that is not a
DeviceMesh (tests/test_torch_parallel_pipelines.py runs the window on one).

With tests/test_torch_dql.py and test_torch_idql.py (the port's
`train_step` equals the JAX package's) and the JAX package's own
tests/test_fused_rl_window.py (its window equals its steps), this holds the
port's window to the JAX one.
"""

import numpy as np
import pytest
import torch

from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoTDDataset
from cleandiffuser_tpu_torch.dataset.fake import fake_d4rl_qlearning_dataset
from cleandiffuser_tpu_torch.pipelines import (
    DQLPipeline,
    EDPPipeline,
    IDQLPipeline,
    make_rl_train_scan,
    rl_window_fn,
)
from cleandiffuser_tpu_torch.utils.config import Config

torch.set_num_threads(1)

N_STEPS, BATCH = 4, 8
PIPES = {"dql": DQLPipeline, "edp": EDPPipeline, "idql": IDQLPipeline}


@pytest.fixture(scope="module")
def dataset():
    return D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset("halfcheetah-medium-v2", n_steps=256),
                               device="cpu")


def _make(family, ds):
    kw = dict(obs_dim=ds.o_dim, act_dim=ds.a_dim, diffusion_steps=2, sampling_steps=2,
              gradient_steps=100, rng=0, device="cpu")
    if family == "idql":
        kw.update(actor_hidden_dim=32, critic_hidden_dim=32)
    else:
        kw.update(hidden_dim=32)
    return PIPES[family](**kw)


def _modules(pipe):
    a = pipe.actor
    if isinstance(pipe, IDQLPipeline):
        st = pipe.iql.state
        return a.params, a.ema_params, st.q_params, st.q_target_params, st.v_params
    return a.params, a.ema_params, pipe.critic, pipe.critic_target


@pytest.mark.parametrize("family", list(PIPES))
def test_rl_window_matches_the_same_steps_one_by_one(dataset, family):
    seq = _make(family, dataset)
    gen = torch.Generator().manual_seed(7)
    logs = [seq.train_step(dataset.sample_batch(gen, BATCH)) for _ in range(N_STEPS)]

    win = _make(family, dataset)
    log = make_rl_train_scan(win, dataset, BATCH, N_STEPS)(torch.Generator().manual_seed(7))
    assert set(log) == set(win.LOG_KEYS) == set(logs[0])
    assert all(v.ndim == 0 and torch.isfinite(v) for v in log.values())
    for a, b in zip(_modules(seq), _modules(win)):
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=name)
    assert win.actor.step == N_STEPS
    for k, v in log.items():
        want = sum(float(lg[k]) for lg in logs) / N_STEPS
        np.testing.assert_allclose(float(v), want, rtol=1e-5, atol=1e-7, err_msg=k)


def _args(**kw):
    return Config(dict(dict(batch_size=BATCH, log_interval=10, save_interval=50,
                            gradient_steps=100), **kw))


def test_rl_window_fn_alignment_gates(dataset, capsys):
    pipe = _make("dql", dataset)
    assert rl_window_fn(pipe, dataset, _args(save_interval=25), mesh=None) is None
    assert "save_interval=25 is not a multiple of log_interval=10" in capsys.readouterr().out
    assert rl_window_fn(pipe, dataset, _args(gradient_steps=105), mesh=None) is None
    assert "gradient_steps=105 is not a multiple" in capsys.readouterr().out
    window = rl_window_fn(pipe, dataset, _args(), mesh=None)
    assert callable(window) and capsys.readouterr().out == ""
    with pytest.raises(TypeError):  # a mesh is a DeviceMesh
        rl_window_fn(pipe, dataset, _args(), mesh=object())

"""Two training rules of the PyTorch port, pinned against the JAX package.

1. The Fourier time embedding's frequencies are a parameter read through a
   stop-gradient, as in JAX (`cleandiffuser_tpu/utils/embeddings.py`
   `FourierEmbedding`): no gradient reaches them, but AdamW's decoupled
   weight decay shrinks them by lr * wd per step and the EMA blends them.
   A few updates with wd > 0 on both engines, same weights and draws.
2. The train-step budget after a resume. DD's inverse dynamics and
   Diffuser's classifier train for the first `invdyn_gradient_steps` /
   `classifier_gradient_steps` steps. The port counts the engine's step,
   which a checkpoint restores (the rule of the JAX fused trainer,
   `make_train_scan`): a run resumed past the budget does not train them
   again. The JAX `train_step` counts a host counter that starts at 0 in
   every process, so a JAX run resumed past the budget trains them anew;
   the tests pin that quirk too, as the behaviour the port does not copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.diffusion.diffusionsde import (
    ContinuousDiffusionSDE as JaxContinuousDiffusionSDE,
)
from cleandiffuser_tpu.nn_condition import MLPCondition as JaxMLPCondition
from cleandiffuser_tpu.nn_diffusion.dit import DiT1d as JaxDiT1d
from cleandiffuser_tpu.pipelines.dd import DDPipeline as JaxDDPipeline
from cleandiffuser_tpu.pipelines.diffuser import DiffuserPipeline as JaxDiffuserPipeline
from cleandiffuser_tpu_torch.diffusion import ContinuousDiffusionSDE
from cleandiffuser_tpu_torch.nn_condition import MLPCondition
from cleandiffuser_tpu_torch.nn_diffusion import DiT1d
from cleandiffuser_tpu_torch.pipelines import DDPipeline, DiffuserPipeline
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, load_agent_params
from jax_shaped_init import shaped_inits

torch.set_num_threads(1)

B, H, X, C = 6, 4, 3, 2
LR, WD, EMA_RATE, STEPS = 1e-2, 0.5, 0.5, 3
# float32 on both sides; the decay is p * (1 - lr * wd) per step in torch's
# AdamW and p - lr * wd * p in optax's: a rounding apart per step
FREQS_RTOL = 1e-6
# losses: float32 with the same weights and draws (test_torch_dd_train.py)
LOSS_RTOL = 1e-5


def _seeded(tree, seed):
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(np.shape(a)) * 0.1).astype(np.float32), tree)
    fourier = out["diffusion"]["params"]["FourierEmbedding_0"]
    fourier["freqs"] = (rng.standard_normal(fourier["freqs"].shape) * 16).astype(np.float32)
    return out


def _draws(agent, x0, cond):
    """The draws the JAX update takes from its state's key: (t, eps, keep)."""
    _, sub = jax.random.split(agent.state.rng)
    k_noise, k_cond, _ = jax.random.split(sub, 3)
    k_t, k_eps = jax.random.split(k_noise)
    t = jax.random.uniform(k_t, (B,), minval=agent.t_diffusion[0], maxval=agent.t_diffusion[1])
    eps = jax.random.normal(k_eps, x0.shape)
    dropped = agent.apply_condition(agent.state.params, cond, train=True, rng=k_cond)
    keep = (np.abs(np.asarray(dropped)).sum(-1) > 0).astype(np.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in (t, eps, keep))


@pytest.fixture(scope="module")
def decay_run():
    kw = dict(in_dim=X, emb_dim=16, d_model=32, n_heads=2, depth=1, timestep_emb_type="fourier",
              use_pallas_block=True)
    optim = {"lr": LR, "weight_decay": WD}
    jeng = JaxContinuousDiffusionSDE(
        JaxDiT1d(**kw), JaxMLPCondition(in_dim=C, out_dim=16, hidden_dims=(16,)),
        ema_rate=EMA_RATE, optim_params=optim, rng=0)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((B, H, X)).astype(np.float32) for _ in range(STEPS)]
    conds = [rng.standard_normal((B, C)).astype(np.float32) for _ in range(STEPS)]
    with shaped_inits():  # every leaf is seeded below
        jeng.init(jnp.asarray(xs[0]), jnp.asarray(conds[0]))
    params, ema = _seeded(jeng.state.params, 1), _seeded(jeng.state.ema_params, 2)
    jeng.state = jeng.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                                    ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
    teng = ContinuousDiffusionSDE(DiT1d(**kw), MLPCondition(C, 16, (16,)), ema_rate=EMA_RATE,
                                  optim_params=optim, device="cpu")
    load_agent_params(teng.params, params)
    load_agent_params(teng.ema_params, ema)
    freqs0 = (params["diffusion"]["params"]["FourierEmbedding_0"]["freqs"],
              ema["diffusion"]["params"]["FourierEmbedding_0"]["freqs"])
    losses = []
    for x, c in zip(xs, conds):
        noise = _draws(jeng, jnp.asarray(x), jnp.asarray(c))
        lj = float(jeng.update(jnp.asarray(x), jnp.asarray(c))["loss"])
        lt = float(teng.update(torch.from_numpy(x), torch.from_numpy(c), noise=noise)["loss"])
        losses.append((lj, lt))
    return dict(jeng=jeng, teng=teng, freqs0=freqs0, losses=losses)


def _freqs(tree):
    return np.asarray(tree["diffusion"]["params"]["FourierEmbedding_0"]["freqs"])


def test_fourier_freqs_are_a_parameter_without_gradient():
    emb = DiT1d(X, 16, 32, 2, 1, timestep_emb_type="fourier").t_emb
    assert isinstance(emb.freqs, torch.nn.Parameter) and "freqs" not in dict(emb.named_buffers())
    emb(torch.rand(5)).sum().backward()
    assert emb.freqs.grad is None and emb.dense1.weight.grad is not None


def test_weight_decay_shrinks_freqs_as_in_jax(decay_run):
    """params: freqs * (1 - lr * wd)^steps in both packages (Adam's step is 0
    on a zero gradient), and equal to JAX's."""
    got = agent_params_of(decay_run["teng"].params)
    want = _freqs(decay_run["jeng"].state.params)
    np.testing.assert_allclose(_freqs(got), want, rtol=FREQS_RTOL)
    np.testing.assert_allclose(want, decay_run["freqs0"][0] * (1 - LR * WD) ** STEPS,
                               rtol=FREQS_RTOL)
    assert np.abs(want - decay_run["freqs0"][0]).max() > 0.1  # the decay is visible


def test_ema_blends_freqs_as_in_jax(decay_run):
    got = _freqs(agent_params_of(decay_run["teng"].ema_params))
    want = _freqs(decay_run["jeng"].state.ema_params)
    np.testing.assert_allclose(got, want, rtol=FREQS_RTOL)
    assert np.abs(want - decay_run["freqs0"][1]).max() > 0.1  # moved from its own start


def test_updates_with_decay_match_jax(decay_run):
    for lj, lt in decay_run["losses"]:
        np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# The train-step budget after a resume

DD_CFG = dict(obs_dim=3, act_dim=2, horizon=4, emb_dim=16, d_model=32, n_heads=2, depth=1,
              invdyn_gradient_steps=2, diffusion_gradient_steps=10)
DIFFUSER_CFG = dict(obs_dim=3, act_dim=2, horizon=8, model_dim=8, dim_mult=(1, 2),
                    diffusion_steps=5, classifier_gradient_steps=2, diffusion_gradient_steps=10)
PIPES = {
    "dd": (DDPipeline, JaxDDPipeline, DD_CFG, "invdyn_loss", ".invdyn"),
    "diffuser": (DiffuserPipeline, JaxDiffuserPipeline, DIFFUSER_CFG, "classifier_loss",
                 ".classifier"),
}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    h = cfg["horizon"]
    return {"obs": {"state": rng.standard_normal((4, h, cfg["obs_dim"])).astype(np.float32)},
            "act": rng.uniform(-1, 1, (4, h, cfg["act_dim"])).astype(np.float32),
            "val": rng.uniform(0, 1, (4, 1)).astype(np.float32)}


@pytest.mark.parametrize("name", list(PIPES))
def test_budget_counts_the_restored_step(name, tmp_path):
    """The port's own checkpoint: within the budget the second model trains,
    past it it does not, and a pipeline loaded at step 3 (past a budget of
    2) does not train it again; one loaded at step 1 does."""
    cls, _, cfg, key, _ = PIPES[name]
    pipe = cls(**cfg, device="cpu")
    logs = []
    for i in range(3):
        logs.append(pipe.train_step(_batch(cfg, i)))
        if i == 0:
            pipe.save(str(tmp_path / "at1"))
    pipe.save(str(tmp_path / "at3"))
    assert [key in lg for lg in logs] == [True, True, False]
    for ckpt, trains in (("at3", False), ("at1", True)):
        resumed = cls(**cfg, device="cpu")
        resumed.load(str(tmp_path / ckpt))
        assert (key in resumed.train_step(_batch(cfg, 9))) is trains, ckpt


@pytest.mark.parametrize("name", list(PIPES))
def test_budget_after_a_jax_checkpoint(name, tmp_path):
    """A JAX run saved at step 3, past a budget of 2: resumed in the port,
    the next step trains no second model; resumed in the JAX package, its
    `train_step` trains it again (its host counter restarts at 0)."""
    cls, jax_cls, cfg, key, suffix = PIPES[name]
    # the nets' initial values are not read here: the JAX builds take their
    # param shapes without compiling the inits (tests/jax_shaped_init.py)
    with shaped_inits():
        jpipe = jax_cls(**cfg)
    for i in range(3):
        jpipe.train_step(jax.tree_util.tree_map(jnp.asarray, _batch(cfg, i)))
    path = str(tmp_path / "jax")
    jpipe.save(path)
    port = cls(**cfg, device="cpu")
    port.load_jax_checkpoint(path + ".diffusion", path + suffix)
    assert port.agent.step == 3
    assert key not in port.train_step(_batch(cfg, 9))
    with shaped_inits():
        jres = jax_cls(**cfg)
    jres.load(path)
    assert key in jres.train_step(jax.tree_util.tree_map(jnp.asarray, _batch(cfg, 9)))

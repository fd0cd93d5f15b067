"""The port's image Diffusion Policy and DiffusionBC pipelines against the
JAX package's over 3 training steps, on the same seeded weights, batches,
draws and crops (the set-up of test_torch_dp_dbc_image.py: 40 x 40 images
cropped to 36, one rgb key and the agent's position, the Chi U-Net and the
PearceTransformer narrowed).

The JAX update's draws are replayed as the port's `noise`, and the random
crops are injected on both sides (the JAX module's `random_crop` replaced
by a stand-in that reads the offsets at run time; the port's
`train_step(crops=)`). Each step starts from the JAX pipeline's state,
loaded into the port as `load_jax_checkpoint` loads it (params, EMA, Adam
moments and counts): Adam moves every element by ~lr whatever its gradient's size,
so an element whose gradient is within float32 rounding of 0 moves by lr
either way in each package, and in the GN-ResNet18 ~2e-4 of the 11.5 M
elements flip at a step (gradients up to ~1e-5 of the largest), enough to
part the two runs' losses by ~5e-4 a step later. At every step:

- the loss and the grad norm within 1e-5 / 1e-4;
- params and EMA after the step by the Adam rule of test_torch_dp_dbc.py
  (every element within 2 lr; all but a 1e-4 share within 1e-5 / 1e-4),
  leaving out the elements whose float64 gradient (the port's, on a
  float64 copy) is within the step's float32 rounding of 0: the port's
  float32 gradient's largest distance from it (the elements left beyond
  1e-5 / 1e-4 were 0-4 of 11.3-11.5 M per step on the CPU, against
  1,100 allowed); the encoder's convolutions get a gradient (they learn).

The float64 gradients of the encoder in both packages agree within 1e-9
in test_torch_image_conditions.py, and those of the backbones in
test_torch_dp_dbc.py.

Then `load_jax_checkpoint` of the file the JAX pipeline's `save` wrote
after the 3 steps, and the port's own checkpoint round trip.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleandiffuser_tpu_torch.pipelines.dbc_image as tdbc
import cleandiffuser_tpu_torch.pipelines.dp_image as tdp
from cleandiffuser_tpu_torch.nn_condition.images import CROP_KEY
from cleandiffuser_tpu_torch.utils import schedules as port_schedules
from cleandiffuser_tpu_torch.utils.jax_params import _flatten_blocks, agent_params_of
from test_torch_dp_dbc import ATOL, LR, RTOL, _close_adam_rule, _cosine_tables
from test_torch_dp_dbc_image import (  # noqa: F401  (small_backbones: the module's stand-ins)
    ACT,
    B,
    CROP,
    IMG,
    JAX_CROPS,
    TO,
    _batch,
    _cfg,
    _pair,
    small_backbones,
)
from test_torch_dql import _t
from test_torch_edm_cm import _close_tree

torch.set_num_threads(2)


def _target(tp, batch):
    a = torch.from_numpy(batch["action"])
    return a if isinstance(tp, tdp.DPImagePipeline) else a[:, TO - 1]


def _crops(tp, rng):
    """Offsets for every encoded frame: (B * To,) for the sequence
    encoders, (B,) for DP's DiT (first frame only)."""
    n = B if getattr(tp, "nn_kind", "") == "dit" else B * TO
    return {"image": (rng.integers(0, IMG - CROP + 1, n), rng.integers(0, IMG - CROP + 1, n))}


def _train_draws(jp, tp, batch, dtype=np.float32):
    """The JAX pipeline's next update's draws, as the port's `noise`."""
    agent, st = jp.agent, jp.agent.state
    _, sub = jax.random.split(st.rng)
    k_noise, _, _ = jax.random.split(sub, 3)
    k_t, k_eps = jax.random.split(k_noise)
    x = _target(tp, batch).numpy()
    if tp.diffusion_kind == "edm":
        z = np.asarray(jax.random.normal(k_t, (B,)), dtype)
        t = np.exp(z * dtype(agent.P_std) + dtype(agent.P_mean))
    else:
        t = jax.random.randint(k_t, (B,), 0, agent.diffusion_steps)
    eps = np.asarray(jax.random.normal(k_eps, x.shape), np.float32).astype(dtype)
    return _t(t), _t(eps), None


def _port_grads(tp, batch, noise, crops, f64: bool):
    """The port's gradient of the same loss (float64: on a float64 copy of
    its params), as a flax tree."""
    agent = copy.deepcopy(tp.agent)
    d = lambda v: v.double() if f64 and v is not None and v.is_floating_point() else v
    with pytest.MonkeyPatch.context() as mp:
        if f64:
            agent.params.double()
            mp.setattr(torch, "float32", torch.float64)
            mp.setattr(port_schedules, "_F32", torch.float64)
            if hasattr(agent, "alpha"):
                agent.alpha, agent.sigma = _cosine_tables(port_schedules, agent)
                agent._alpha_dev, agent._sigma_dev = agent.alpha, agent.sigma
        cond = {**tp.condition_of(batch["obs"]), CROP_KEY: crops}
        agent.loss_fn(agent.params, d(_target(tp, batch)), cond,
                      noise=tuple(d(v) for v in noise),
                      generator=torch.Generator().manual_seed(0)).backward()
    grads = copy.deepcopy(agent.params)
    with torch.no_grad():
        for g, p in zip(grads.parameters(), agent.params.parameters()):
            g.copy_(torch.zeros_like(p) if p.grad is None else p.grad)
    return agent_params_of(grads)


def _jax_state(st) -> dict:
    """The fields `load_jax_state` takes, from a live JAX TrainState (the
    same as `load_jax_checkpoint` reads from its file)."""
    named = lambda s: type(s).__name__ in ("ScaleByAdamState", "ScaleByScheduleState")
    states = {type(s).__name__: s for s in jax.tree_util.tree_leaves(st.opt_state, is_leaf=named)
              if named(s)}
    adam, sched = states["ScaleByAdamState"], states.get("ScaleByScheduleState")
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return {"params": np_(st.params), "ema_params": np_(st.ema_params), "mu": np_(adam.mu),
            "nu": np_(adam.nu), "count": int(adam.count),
            "schedule_count": None if sched is None else int(sched.count),
            "step": int(st.step)}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _check_step(jp, tp, logs, grads) -> None:
    """One step's checks (module note)."""
    port64, port32 = grads
    top = max(np.abs(a).max() for a in jax.tree_util.tree_leaves(port64))
    enc = port64["condition"]["params"]["ResNet18_0"]["Conv_0"]["kernel"]
    assert np.abs(enc).max() > 1e-6 * top  # the encoder learns
    rounding = max(np.abs(np.asarray(g) - b).max()
                   for g, b in zip(jax.tree_util.tree_leaves(port32),
                                   jax.tree_util.tree_leaves(port64)))
    lj, lt = logs
    assert set(lt) == set(lj) == {"loss", "grad_norm"}
    for k in lj:
        np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    exempt = jax.tree_util.tree_map(lambda a: np.abs(a) <= rounding, port64)
    st = jp.agent.state
    _close_adam_rule(agent_params_of(tp.agent.params), st.params, exempt, steps=1)
    _close_adam_rule(agent_params_of(tp.agent.ema_params), st.ema_params, exempt, steps=1)


TRAIN_CASES = [("dp", "chi_unet", "ddpm"), ("dbc", "pearce_mlp", "edm")]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Per case: the 3 steps, each checked right after it (the check's
    error, if any, kept for the test), and the JAX pipeline's checkpoint."""
    runs = {}
    for case in TRAIN_CASES:
        jp, tp = _pair(*case)
        rng = np.random.default_rng(6)
        run_dir = tmp_path_factory.mktemp("image_" + "_".join(case))
        error = None
        for i in range(3):
            tp.agent.load_jax_state(_jax_state(jp.agent.state))
            batch, crops = _batch(rng), _crops(tp, rng)
            noise = _train_draws(jp, tp, batch)
            noise64 = _train_draws(jp, tp, batch, np.float64)
            grads = (_port_grads(tp, batch, noise64, crops, True),
                     _port_grads(tp, batch, noise, crops, False))
            JAX_CROPS.queue.append(crops["image"])
            lj = jp.train_step(jax.tree_util.tree_map(jnp.asarray, batch))
            lt = tp.train_step(batch, noise=noise, crops=crops)
            assert not JAX_CROPS.queue  # the JAX encoder took its crops
            logs = tuple({k: float(v) for k, v in lg.items()} for lg in (lj, lt))
            try:
                _check_step(jp, tp, logs, grads)
            except AssertionError as e:
                error = f"step {i + 1}: {e}"
                break
        jp.save(str(run_dir / "ckpt"))
        runs[case] = (jp, tp, error, str(run_dir / "ckpt"))
    return runs


@pytest.mark.parametrize("case", TRAIN_CASES, ids=["_".join(c) for c in TRAIN_CASES])
def test_three_image_training_steps_match_jax(trained, case):
    jp, tp, error, _ = trained[case]
    assert error is None, error
    assert tp.agent.step == int(jp.agent.state.step) == 3


@pytest.mark.parametrize("case", TRAIN_CASES, ids=["dp_chi_unet", "dbc_mlp"])
def test_image_jax_checkpoint_loads_and_port_checkpoint_round_trips(trained, case, tmp_path):
    jp, _, _, ckpt = trained[case]
    P = tdp.DPImagePipeline if case[0] == "dp" else tdbc.DBCImagePipeline
    fresh = P(**_cfg(*case), rng=5, device="cpu")
    fresh.load_jax_checkpoint(ckpt)
    st = jp.agent.state
    _close_tree(agent_params_of(fresh.agent.params), _flatten_blocks(st.params), tol=1e-7)
    _close_tree(agent_params_of(fresh.agent.ema_params), _flatten_blocks(st.ema_params),
                tol=1e-7)
    assert fresh.agent.step == 3 and fresh.agent.optimizer.count == 3
    fresh.save(str(tmp_path / "ckpt"))
    again = P(**_cfg(*case), rng=6, device="cpu")
    again.load(str(tmp_path / "ckpt"))
    for a, b in zip(again.agent.params.parameters(), fresh.agent.params.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert again.agent.step == 3

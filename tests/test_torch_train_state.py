"""The port's training core (utils/train_state.py) against the JAX package's.

- `cosine_decay_schedule` against optax's at steps 0, 1, mid, end and past
  the end.
- `make_optimizer` against the JAX package's optimizer chains on the same
  random parameter tree and gradients over 6 steps (past a 4-step cosine):
  AdamW (`utils/train_state.make_optimizer`: decoupled decay) and the
  classifier's chain (`classifier/base.py`: coupled L2, then Adam), with
  global-norm clipping off, idle and triggered.
- `ema_update` against the JAX `ema_update`.
- `load_jax_checkpoint` of a JAX `save_state` whose DiT blocks are nested
  (flax `DiTBlock`): params, EMA and Adam moments land in the port's flat
  blocks, and the schedule resumes at the saved count.
- The unpickler refuses classes outside numpy and the JAX state's own.
"""

import io
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cleandiffuser_tpu.classifier.base import BaseClassifier as JaxBaseClassifier
from cleandiffuser_tpu.nn_diffusion.dit import convert_checkpoint_blocks
from cleandiffuser_tpu.pipelines.dd import DDPipeline as JaxDDPipeline
from cleandiffuser_tpu.utils import train_state as jts
from cleandiffuser_tpu_torch.pipelines import DDPipeline
from cleandiffuser_tpu_torch.utils import train_state as ts
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, load_agent_params

torch.set_num_threads(1)

SHAPES = {"w": (6, 4), "b": (4,), "s": (3,)}
LR, STEPS, DECAY_STEPS = 1e-2, 6, 4


def test_cosine_schedule_matches_optax():
    """optax evaluates in float32; so does the port: equal to one ulp."""
    for lr, steps in ((2e-4, 10), (1e-3, 1_000_000), (0.5, 3)):
        want = optax.cosine_decay_schedule(lr, steps)
        got = ts.cosine_decay_schedule(lr, steps)
        for n in (0, 1, steps // 2, steps, steps + 7):
            np.testing.assert_array_max_ulp(np.float32(got(n)), np.asarray(want(n)), maxulp=1)
    assert ts.cosine_decay_schedule(1.0, 4)(4) == 0.0


@pytest.mark.parametrize("decoupled,weight_decay,clip,schedule", [
    (True, 1e-2, None, False),
    (True, 0.0, 0.5, True),      # clipping triggers at every step
    (True, 1e-5, 100.0, True),   # clipping idle
    (False, 1e-2, 0.5, True),    # the classifier's chain
    (False, 0.0, None, False),   # the inverse dynamics' plain Adam
], ids=["adamw", "adamw-clip", "adamw-clip-idle", "coupled-clip", "adam"])
def test_optimizer_matches_jax_chain(decoupled, weight_decay, clip, schedule):
    """Params after each step and the gradient's global norm before
    clipping, from the same tree and gradients. Both sides compute Adam in
    float32 and round each step's update into O(1) params differently
    (torch's lerp for the first moment, its order of the bias corrections),
    so they drift apart by a few float32 ulps of 1 (1.2e-7 each): 1e-6."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    lr = optax.cosine_decay_schedule(LR, DECAY_STEPS) if schedule else LR
    if decoupled:
        tx = jts.make_optimizer(lr=lr, weight_decay=weight_decay, grad_clip_norm=clip)
    else:
        tx = JaxBaseClassifier(None, grad_clip_norm=clip,
                               optim_params={"lr": lr, "weight_decay": weight_decay}).tx
    port_params = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in SHAPES]
    opt = ts.make_optimizer(port_params,
                            lr=ts.cosine_decay_schedule(LR, DECAY_STEPS) if schedule else LR,
                            weight_decay=weight_decay, grad_clip_norm=clip, decoupled=decoupled)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for _ in range(STEPS):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        jg = jax.tree_util.tree_map(jnp.asarray, grads)
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(port_params, SHAPES):
            p.grad = torch.from_numpy(grads[k].copy())
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(jg)), rtol=1e-6)
        for p, k in zip(port_params, SHAPES):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
            assert p.grad is None
    assert opt.count == (STEPS if schedule else 0)
    # the params moved by more than the tolerance
    assert np.abs(np.asarray(jp["w"]) - params["w"]).max() > 1e-2


def test_ema_update_matches_jax():
    rng = np.random.default_rng(1)
    tree = [rng.standard_normal(s).astype(np.float32) for s in SHAPES.values()]
    ema = [rng.standard_normal(s).astype(np.float32) for s in SHAPES.values()]
    as_module = lambda arrs: torch.nn.ParameterList(
        torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrs)
    port_params, port_ema = as_module(tree), as_module(ema)
    want = [jnp.asarray(e) for e in ema]
    for rate in (0.995, 0.9999, 0.5):
        want = jts.ema_update([jnp.asarray(a) for a in tree], want, rate)
        ts.ema_update(port_ema, port_params, rate)
        for got, w in zip(port_ema, want):
            np.testing.assert_array_max_ulp(got.detach().numpy(), np.asarray(w), maxulp=1)


def test_jax_checkpoint_with_nested_blocks_loads(tmp_path):
    """A JAX DD state with nested flax `DiTBlock`s (`use_pallas_block=False`)
    and seeded moments, written by the JAX `save_state`: the port (flat
    blocks) loads params, EMA, moments, counts; the expected flat trees come
    from the JAX package's own block converter."""
    cfg = dict(obs_dim=4, act_dim=2, horizon=8, emb_dim=32, d_model=64, n_heads=2, depth=2,
               diffusion_gradient_steps=20)
    jn = JaxDDPipeline(**cfg, use_pallas_block=False)
    rng = np.random.default_rng(2)
    seeded = lambda: jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)),
        jn.agent.state.params)
    params, ema, mu, nu = seeded(), seeded(), seeded(), seeded()
    nu = jax.tree_util.tree_map(jnp.abs, nu)
    adam, decay, sched = jn.agent.state.opt_state[0]
    opt_state = ((adam._replace(count=jnp.int32(7), mu=mu, nu=nu), decay,
                  sched._replace(count=jnp.int32(7))),)
    state = jn.agent.state.replace(params=params, ema_params=ema, opt_state=opt_state,
                                   step=jnp.int32(7))
    jts.save_state(state, str(tmp_path / "nested"))

    port = DDPipeline(**cfg, use_pallas_block=True, device="cpu")
    port.agent.load_jax_checkpoint(str(tmp_path / "nested"))
    flat = agent_params_of(port.agent.params)
    to_flat = lambda tree: convert_checkpoint_blocks(
        jax.tree_util.tree_map(np.asarray, tree), flat)
    for got, want in ((flat, params), (agent_params_of(port.agent.ema_params), ema)):
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                     jax.tree_util.tree_leaves_with_path(to_flat(want))):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    opt = port.agent.optimizer
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        view = torch.nn.ModuleDict(dict(port.agent.params.items()))
        load_agent_params(view, to_flat(tree))
        for (name, p), (_, want) in zip(port.agent.params.named_parameters(),
                                        view.named_parameters()):
            assert float(opt.optimizer.state[p]["step"]) == 7
            torch.testing.assert_close(opt.optimizer.state[p][key], want.detach(), atol=0, rtol=0)
    assert port.agent.step == 7 and opt.count == 7
    assert opt.optimizer.param_groups[0]["lr"] == ts.cosine_decay_schedule(2e-4, 20)(7)


def test_jax_unpickler_refuses_other_classes():
    """Only numpy's and the JAX state's own classes are taken."""
    class Evil:
        def __reduce__(self):
            return (print, ("never",))

    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        ts._JaxUnpickler(io.BytesIO(pickle.dumps(Evil()))).load()

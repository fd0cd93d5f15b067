"""The PyTorch port's Diffuser training against the JAX package's.

Same weights (seeded numpy normals in the JAX layout, carried in by the
converter: the U-Net, its EMA, the classifier and its EMA), same batches
and the same random draws go through
`cleandiffuser_tpu.pipelines.diffuser.DiffuserPipeline.train_step` and the
port's `DiffuserPipeline.train_step` (built with the fused block on, whose
CPU path is the plain version) for 3 steps. The draws are the JAX
package's own: the diffusion update's `rng, sub = split(state.rng)`,
`k_noise = split(sub, 3)[0]`, `k_t, k_eps = split(k_noise)`; the
classifier's noised input from `agent.next_sample_rng()`, split likewise.

Checked per step: the diffusion loss, its gradient norm and the classifier
loss; after 3 steps: U-Net params, EMA, Adam moments and schedule, and the
classifier's params, EMA, Adam moments and schedule (coupled L2, no decay
by default, EMA rate 0.995). A JAX checkpoint taken after 2 steps resumes
in the port (also read in a subprocess with JAX imports blocked) and its
next step matches the JAX run's; the port's own checkpoint resumes
exactly.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cleandiffuser_tpu.pipelines.diffuser import DiffuserPipeline as JaxDiffuserPipeline
from cleandiffuser_tpu_torch.pipelines import DiffuserPipeline
from cleandiffuser_tpu_torch.utils.jax_params import (
    agent_params_of,
    jax_params_of,
    load_agent_params,
)
from jax_shaped_init import shaped_inits

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the shipped config's x0 prediction; a short cosine and a fast EMA, so 3
# steps move both visibly
CFG = dict(obs_dim=5, act_dim=3, horizon=8, model_dim=16, dim_mult=(1, 2), diffusion_steps=20,
           predict_noise=False, ema_rate=0.9, diffusion_gradient_steps=5,
           classifier_gradient_steps=5, lr=1e-3)
B, STEPS = 8, 3
# float32 on both sides with the same weights and draws; sums run in another
# order (convs, GroupNorm statistics), ~1e-6 relative in losses, gradients
# and moments. Adam moves every param by ~lr per step whatever a gradient's
# size, so params agree to ~1e-7 absolute where the gradients' signs agree
# (no U-Net or classifier param has a gradient that is 0 in exact
# arithmetic, as the DiT's key bias does).
TOL = 1e-5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _seeded(tree, seed, std=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * std).astype(np.float32), _numpy_tree(tree))


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batch(rng):
    H = CFG["horizon"]
    return {"obs": {"state": rng.standard_normal((B, H, CFG["obs_dim"])).astype(np.float32)},
            "act": rng.uniform(-1, 1, (B, H, CFG["act_dim"])).astype(np.float32),
            "val": rng.standard_normal((B, 1)).astype(np.float32)}


def _levels(key, shape):
    """add_noise's draws from one key: integer levels and normal noise."""
    k_t, k_eps = jax.random.split(key)
    t = jax.random.randint(k_t, (shape[0],), 0, CFG["diffusion_steps"])
    eps = jax.random.normal(k_eps, shape)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


def _jax_draws(jpipe, batch):
    """(diffusion noise (t, eps, None), classifier noise (t, eps))."""
    shape = batch["obs"]["state"].shape[:2] + (CFG["obs_dim"] + CFG["act_dim"],)
    _, sub = jax.random.split(jpipe.agent.state.rng)
    t, eps = _levels(jax.random.split(sub, 3)[0], shape)
    _, k_cls = jax.random.split(jpipe.agent._sample_rng)
    return (t, eps, None), _levels(k_cls, shape)


def _adam(opt_state):
    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(s))


def _schedule_count(opt_state):
    is_sched = lambda s: isinstance(s, optax.ScaleByScheduleState)
    return next(int(s.count) for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_sched)
                if is_sched(s))


def _assert_tree_close(got, want, tol=TOL):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(_numpy_tree(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=jax.tree_util.keystr(path))


def _assert_moments_close(optimizer, module, load, adam):
    """optimizer: the port's TrainOptimizer over `module`; `load(copy,
    tree)` carries a tree shaped as the JAX params into a copy of it."""
    views = []
    for tree in (adam.mu, adam.nu):
        m = copy.deepcopy(module)
        load(m, _numpy_tree(tree))
        views.append(dict(m.named_parameters()))
    for name, p in module.named_parameters():
        st = optimizer.optimizer.state[p]
        assert float(st["step"]) == int(adam.count)
        np.testing.assert_allclose(st["exp_avg"].numpy(), views[0][name].detach().numpy(),
                                   atol=TOL, rtol=TOL, err_msg=name)
        # v ~ g^2: relative error twice the gradients'
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), views[1][name].detach().numpy(),
                                   atol=TOL * 1e-2, rtol=2 * TOL, err_msg=name)


def _assert_state_matches(tpipe, jpipe):
    a_st, c_st = jpipe.agent.state, jpipe.classifier.state
    _assert_tree_close(agent_params_of(tpipe.agent.params), a_st.params)
    _assert_tree_close(agent_params_of(tpipe.agent.ema_params), a_st.ema_params)
    _assert_moments_close(tpipe.agent.optimizer, tpipe.agent.params, load_agent_params,
                          _adam(a_st.opt_state))
    assert tpipe.agent.optimizer.count == _schedule_count(a_st.opt_state)
    assert tpipe.agent.step == int(a_st.step)

    cls = tpipe.classifier
    _assert_tree_close({"params": jax_params_of(cls.params)}, c_st.params)
    _assert_tree_close({"params": jax_params_of(cls.ema_params)}, c_st.ema_params)
    _assert_moments_close(cls.optimizer, cls.params,
                          lambda m, tree: load_agent_params(
                              torch.nn.ModuleDict({"net": m}), {"net": tree}),
                          _adam(c_st.opt_state))
    assert cls.optimizer.count == _schedule_count(c_st.opt_state)
    assert cls.step == int(c_st.step)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    # every leaf is seeded below: no compile of the nets' inits
    # (tests/jax_shaped_init.py)
    with shaped_inits():
        jpipe = JaxDiffuserPipeline(**CFG)
    w = [_seeded(t, s) for s, t in enumerate(
        (jpipe.agent.state.params, jpipe.agent.state.ema_params, jpipe.classifier.state.params,
         jpipe.classifier.state.ema_params), start=1)]
    jpipe.agent.state = jpipe.agent.state.replace(params=_jt(w[0]), ema_params=_jt(w[1]))
    jpipe.classifier.state = jpipe.classifier.state.replace(params=_jt(w[2]),
                                                            ema_params=_jt(w[3]))
    tpipe = DiffuserPipeline(**CFG, use_pallas_block=True, device="cpu")
    tpipe.load_jax_params(*w)

    rng = np.random.default_rng(5)
    batches = [_batch(rng) for _ in range(STEPS)]
    logs, draws = {"jax": [], "port": []}, []
    ckpt = str(tmp_path_factory.mktemp("diffuser") / "jax")
    for i, batch in enumerate(batches):
        noise, cls_noise = _jax_draws(jpipe, batch)
        draws.append((noise, cls_noise))
        logs["jax"].append({k: float(v) for k, v in
                            jpipe.train_step(jax.tree_util.tree_map(jnp.asarray, batch)).items()})
        logs["port"].append({k: float(v) for k, v in tpipe.train_step(
            batch, noise=noise, classifier_noise=cls_noise).items()})
        if i == 1:
            jpipe.save(ckpt)
    return dict(jpipe=jpipe, tpipe=tpipe, batches=batches, draws=draws, logs=logs, ckpt=ckpt)


def test_losses_and_grad_norms_match_jax(run):
    for lj, lt in zip(run["logs"]["jax"], run["logs"]["port"]):
        assert set(lj) == set(lt) == {"loss", "grad_norm", "classifier_loss"}
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=TOL, err_msg=k)


def test_state_after_three_steps_matches_jax(run):
    """U-Net and classifier: params, EMA, Adam moments, schedule, step."""
    _assert_state_matches(run["tpipe"], run["jpipe"])


def test_jax_checkpoint_resumes_in_the_port(run):
    """A JAX `save` after 2 steps, loaded into a fresh port pipeline; its
    step 3 with the JAX run's step-3 draws matches the JAX run's step 3.
    (The file holds the whole state of both the engine and the classifier,
    key included, so the JAX package's own resume continues the run.)"""
    tres = DiffuserPipeline(**CFG, use_pallas_block=True, device="cpu")
    tres.load_jax_checkpoint(run["ckpt"] + ".diffusion", run["ckpt"] + ".classifier")
    noise, cls_noise = run["draws"][2]
    lt = tres.train_step(run["batches"][2], noise=noise, classifier_noise=cls_noise)
    for k, v in run["logs"]["jax"][2].items():
        np.testing.assert_allclose(float(lt[k]), v, rtol=TOL, err_msg=k)
    _assert_state_matches(tres, run["jpipe"])


def test_jax_checkpoint_reads_without_jax(run):
    """The pipeline's loader in a process where importing jax, flax, optax
    or the JAX package fails."""
    paths = (run["ckpt"] + ".diffusion", run["ckpt"] + ".classifier")
    code = f"""
import sys
for m in ("jax", "jaxlib", "flax", "optax", "cleandiffuser_tpu"):
    sys.modules[m] = None
from cleandiffuser_tpu_torch.pipelines import DiffuserPipeline
p = DiffuserPipeline(**{CFG!r}, device="cpu")
p.load_jax_checkpoint(*{paths!r})
print(p.agent.step, p.classifier.step, p.classifier.optimizer.count,
      repr(float(sum(v.detach().double().sum() for v in p.classifier.ema_params.parameters()))))
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    p = DiffuserPipeline(**CFG, device="cpu")
    p.load_jax_checkpoint(*paths)
    total = float(sum(v.detach().double().sum() for v in p.classifier.ema_params.parameters()))
    assert out.stdout.split() == ["2", "2", "2", repr(total)]


def test_port_checkpoint_resumes_exactly(tmp_path):
    """The port's own save after 2 steps, loaded into a fresh pipeline: the
    next step, with draws from the restored generator, is bit-equal."""
    rng = np.random.default_rng(8)
    tpipe = DiffuserPipeline(**CFG, use_pallas_block=True, device="cpu", rng=3)
    for _ in range(2):
        tpipe.train_step(_batch(rng))
    tpipe.save(str(tmp_path / "diffuser"))
    other = DiffuserPipeline(**CFG, use_pallas_block=True, device="cpu")
    other.load(str(tmp_path / "diffuser"))
    batch = _batch(rng)
    la, lb = tpipe.train_step(batch), other.train_step(batch)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for x, y in ((tpipe.agent.params, other.agent.params),
                 (tpipe.agent.ema_params, other.agent.ema_params),
                 (tpipe.classifier.params, other.classifier.params),
                 (tpipe.classifier.ema_params, other.classifier.ema_params)):
        for a, b in zip(x.parameters(), y.parameters()):
            assert torch.equal(a, b)

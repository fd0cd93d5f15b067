"""The PyTorch port's Decision Diffuser training against the JAX package's.

Same weights (seeded numpy normals in the JAX layout, carried in by the
converter: params, a different EMA, the inverse dynamics), same batches
and the same random draws go through
`cleandiffuser_tpu.pipelines.dd.DDPipeline.train_step` and the port's
`DDPipeline.train_step` for 3 steps. The draws are the JAX update's own:
`rng, sub = split(state.rng)`, `k_noise, k_cond, _ = split(sub, 3)`,
`k_t, k_eps = split(k_noise)`; the condition's keep-mask comes from flax's
`make_rng("dropout")`, which folds in the module path, so it is read back:
the rows the JAX condition zeroes with `train=True`.

Checked: the first step's gradients before the optimizer, then per step the
loss, the gradient norm and the inverse-dynamics loss, and after 3 steps
the params, EMA, Adam moments, schedule and inverse-dynamics params. A JAX
checkpoint taken after 2 steps resumes in the port (a subprocess reads it
with JAX imports blocked) and its next step matches the JAX package's own
resume; the port's own checkpoint resumes exactly.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines.dd import DDPipeline as JaxDDPipeline
from cleandiffuser_tpu_torch.pipelines import DDPipeline
from cleandiffuser_tpu_torch.utils.jax_params import (
    agent_params_of,
    jax_params_of,
    load_agent_params,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# a short cosine (5 steps) and a fast EMA, so 3 steps move both visibly
CFG = dict(obs_dim=5, act_dim=3, horizon=8, emb_dim=32, d_model=64, n_heads=2, depth=2,
           ema_rate=0.9, diffusion_gradient_steps=5, lr=1e-3)
B, STEPS = 8, 3
# Gradients and losses: float32 on both sides with the same weights and
# draws; sums run in another order (matrix products, LayerNorm statistics),
# ~1e-6 relative. After 3 Adam steps the params move by ~lr per step
# whatever a gradient's size (m / sqrt(v) is +-1 at step 1), so they agree
# to ~1e-7 absolute where the gradients' signs agree; the moments carry the
# gradients' relative error.
TOL = 1e-5
# The key bias adds the same q.b_k to every score of a query's row, which
# softmax ignores: its gradient is 0 in exact arithmetic and float32 rounding
# noise (~1e-9) in both packages. Adam turns that noise into steps of +-lr
# with the noise's sign, so there the two packages' params differ by up to
# lr per step (checked: the gradient there is below 1e-6).
KEY_BIAS_TOL = CFG["lr"] * STEPS


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _seeded(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), _numpy_tree(tree))


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batch(rng):
    return {"obs": {"state": rng.standard_normal((B, CFG["horizon"], CFG["obs_dim"]))
                    .astype(np.float32)},
            "act": rng.uniform(-1, 1, (B, CFG["horizon"], CFG["act_dim"])).astype(np.float32),
            "val": rng.uniform(0, 1000, (B, 1)).astype(np.float32)}


def _jax_draws(jpipe, batch):
    """The draws the JAX update takes from its state's key: (t, eps, keep),
    and the key its loss uses."""
    agent, st = jpipe.agent, jpipe.agent.state
    _, sub = jax.random.split(st.rng)
    k_noise, k_cond, _ = jax.random.split(sub, 3)
    k_t, k_eps = jax.random.split(k_noise)
    t = jax.random.uniform(k_t, (B,), minval=agent.t_diffusion[0], maxval=agent.t_diffusion[1])
    eps = jax.random.normal(k_eps, batch["obs"]["state"].shape)
    cond = jnp.asarray(batch["val"]) / jpipe.return_scale + jpipe.val_shift
    train = np.asarray(agent.apply_condition(st.params, cond, train=True, rng=k_cond))
    assert (np.abs(np.asarray(agent.apply_condition(st.params, cond))).sum(-1) > 0).all()
    keep = (np.abs(train).sum(-1) > 0).astype(np.float32)
    noise = tuple(torch.from_numpy(np.array(a)) for a in (t, eps, keep))
    return noise, sub, cond


def _port_view(params, tree):
    """A JAX tree shaped as an engine's params (moments, gradients) as
    {name: tensor} of the port's parameters."""
    m = copy.deepcopy(params)
    load_agent_params(m, _numpy_tree(tree))
    return dict(m.named_parameters())


def _key_bias(a):
    """The key third of a flat block's `bqkv`."""
    D = CFG["d_model"]
    return a[..., D:2 * D]


def _assert_tree_close(got, want, tol=TOL):
    """Leaf by leaf within `tol`; the key bias of each DiT block within
    KEY_BIAS_TOL (see there)."""
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(_numpy_tree(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bqkv']"):
            np.testing.assert_allclose(_key_bias(a), _key_bias(b), atol=KEY_BIAS_TOL,
                                       err_msg=name)
            a, b = a.copy(), b.copy()
            _key_bias(a)[:] = _key_bias(b)[:] = 0
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


def _assert_moments_close(tpipe, mu, nu, count, tol=TOL):
    opt = tpipe.agent.optimizer.optimizer
    want_m, want_v = _port_view(tpipe.agent.params, mu), _port_view(tpipe.agent.params, nu)
    for name, p in tpipe.agent.params.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == count
        np.testing.assert_allclose(st["exp_avg"].numpy(), want_m[name].detach().numpy(),
                                   atol=tol, rtol=tol, err_msg=name)
        # v ~ g^2: relative error twice the gradients'
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), want_v[name].detach().numpy(),
                                   atol=tol * 1e-2, rtol=2 * tol, err_msg=name)


def _assert_state_matches(tpipe, jpipe):
    st = jpipe.agent.state
    _assert_tree_close(agent_params_of(tpipe.agent.params), st.params)
    _assert_tree_close(agent_params_of(tpipe.agent.ema_params), st.ema_params)
    adam = st.opt_state[0][0]
    _assert_moments_close(tpipe, adam.mu, adam.nu, int(adam.count))
    assert tpipe.agent.step == int(st.step)
    assert tpipe.agent.optimizer.count == int(st.opt_state[0][2].count)
    _assert_tree_close(jax_params_of(tpipe.invdyn.net), jpipe.invdyn.params["params"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jpipe = JaxDDPipeline(**CFG, use_pallas_block=True)
    # the Fourier frequencies are a stop-gradient param in both packages:
    # the EMA blends them from its own start
    params, ema = _seeded(jpipe.agent.state.params, 1), _seeded(jpipe.agent.state.ema_params, 2)
    inv = _seeded(jpipe.invdyn.params, 3)
    jpipe.agent.state = jpipe.agent.state.replace(params=_jt(params), ema_params=_jt(ema))
    jpipe.invdyn.params = _jt(inv)
    tpipe = DDPipeline(**CFG, use_pallas_block=True, device="cpu")
    tpipe.load_jax_params(params, ema, inv)

    rng = np.random.default_rng(4)
    batches = [_batch(rng) for _ in range(STEPS)]
    draws = []
    logs = {"jax": [], "port": []}
    ckpt = str(tmp_path_factory.mktemp("dd") / "jax")
    for i, batch in enumerate(batches):
        noise, sub, cond = _jax_draws(jpipe, batch)
        if i == 0:  # the first step's gradients, before any optimizer
            obs = jnp.asarray(batch["obs"]["state"])
            g_jax = jax.grad(lambda p: jpipe.agent.loss_fn(p, sub, obs, cond))(
                jpipe.agent.state.params)
            loss = tpipe.agent.loss_fn(tpipe.agent.params, torch.from_numpy(np.asarray(obs)),
                                       torch.from_numpy(np.asarray(cond)), noise=noise)
            loss.backward()
            # no gradient reaches the Fourier frequencies (JAX's is 0)
            g_port = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                      for n, p in tpipe.agent.params.named_parameters()}
            tpipe.agent.params.zero_grad(set_to_none=True)
        draws.append(noise)
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        logs["jax"].append({k: float(v) for k, v in jpipe.train_step(jb).items()})
        logs["port"].append({k: float(v) for k, v in tpipe.train_step(batch, noise=noise).items()})
        if i == 1:
            jpipe.save(ckpt)
    return dict(jpipe=jpipe, tpipe=tpipe, batches=batches, draws=draws, logs=logs, ckpt=ckpt,
                g_jax=g_jax, g_port=g_port)


def test_first_step_gradients_match_jax(run):
    """The loss's gradients, before the optimizer touches them."""
    want = _port_view(run["tpipe"].agent.params, run["g_jax"])
    for name, g in run["g_port"].items():
        np.testing.assert_allclose(g.numpy(), want[name].detach().numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)
    assert max(g.abs().max().item() for g in run["g_port"].values()) > 1e-2
    for i in range(CFG["depth"]):
        assert _key_bias(run["g_port"][f"diffusion.blocks.{i}.bqkv"]).abs().max() < 1e-6


def test_losses_and_grad_norms_match_jax(run):
    for lj, lt in zip(run["logs"]["jax"], run["logs"]["port"]):
        assert set(lj) == set(lt) == {"loss", "grad_norm", "invdyn_loss"}
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=TOL, err_msg=k)


def test_condition_dropout_was_replayed(run):
    """Some rows had their condition dropped: the keep-mask is live."""
    keep = torch.cat([d[2] for d in run["draws"]])
    assert 0 < keep.sum() < keep.numel()


def test_state_after_three_steps_matches_jax(run):
    """Params, EMA, Adam moments and count, schedule count, step, and the
    inverse dynamics' params."""
    tpipe, jpipe = run["tpipe"], run["jpipe"]
    _assert_state_matches(tpipe, jpipe)
    # the cosine over 5 steps: step 3 ran at lr * 0.5 (1 + cos(pi * 2 / 5))
    lr = tpipe.agent.optimizer.optimizer.param_groups[0]["lr"]
    np.testing.assert_allclose(lr, 1e-3 * 0.5 * (1 + np.cos(np.pi * 3 / 5)), rtol=1e-6)


def test_jax_checkpoint_resumes_in_the_port(run):
    """A JAX `save` after 2 steps, loaded into a fresh JAX pipeline and into
    a fresh port pipeline; step 3 on both (the port with the JAX draws)."""
    jres = JaxDDPipeline(**CFG, use_pallas_block=True)
    jres.load(run["ckpt"])
    tres = DDPipeline(**CFG, use_pallas_block=True, device="cpu")
    tres.load_jax_checkpoint(run["ckpt"] + ".diffusion", run["ckpt"] + ".invdyn")
    batch = run["batches"][2]
    noise, _, _ = _jax_draws(jres, batch)
    for a, b in zip(noise, run["draws"][2]):  # the key resumed too
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    lj = jres.train_step(jax.tree_util.tree_map(jnp.asarray, batch))
    lt = tres.train_step(batch, noise=noise)
    for k in lj:
        np.testing.assert_allclose(float(lt[k]), float(lj[k]), rtol=TOL, err_msg=k)
    _assert_state_matches(tres, jres)


def test_jax_checkpoint_reads_without_jax(run):
    """The reader and the pipeline's loader in a process where importing
    jax, flax, optax or the JAX package fails."""
    code = f"""
import sys
for m in ("jax", "jaxlib", "flax", "optax", "cleandiffuser_tpu"):
    sys.modules[m] = None
import numpy as np
from cleandiffuser_tpu_torch.pipelines import DDPipeline
from cleandiffuser_tpu_torch.utils.train_state import load_jax_checkpoint
ck = load_jax_checkpoint({run["ckpt"] + ".diffusion"!r})
p = DDPipeline(**{CFG!r}, use_pallas_block=True, device="cpu")
p.load_jax_checkpoint({run["ckpt"] + ".diffusion"!r}, {run["ckpt"] + ".invdyn"!r})
print(ck["step"], ck["count"], ck["schedule_count"],
      repr(float(sum(v.detach().double().sum() for v in p.agent.params.parameters()))))
assert not any(m.split(".")[0] in ("jax", "flax", "optax", "cleandiffuser_tpu")
               for m, mod in sys.modules.items() if mod is not None)
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    tres = DDPipeline(**CFG, use_pallas_block=True, device="cpu")
    tres.load_jax_checkpoint(run["ckpt"] + ".diffusion", run["ckpt"] + ".invdyn")
    total = float(sum(v.detach().double().sum() for v in tres.agent.params.parameters()))
    assert out.stdout.split() == ["2", "2", "2", repr(total)]


def test_port_checkpoint_resumes_exactly(tmp_path):
    """The port's own save after 2 steps, loaded into a fresh pipeline: the
    next step, with draws from the restored generator, is bit-equal."""
    rng = np.random.default_rng(8)
    tpipe = DDPipeline(**CFG, use_pallas_block=True, device="cpu", rng=3)
    for _ in range(2):
        tpipe.train_step(_batch(rng))
    tpipe.save(str(tmp_path / "dd"))
    other = DDPipeline(**CFG, use_pallas_block=True, device="cpu")
    other.load(str(tmp_path / "dd"))
    batch = _batch(np.random.default_rng(9))
    la, lb = tpipe.train_step(batch), other.train_step(batch)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for a, b in zip(tpipe.agent.params.parameters(), other.agent.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(tpipe.agent.ema_params.parameters(), other.agent.ema_params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(tpipe.invdyn.net.parameters(), other.invdyn.net.parameters()):
        assert torch.equal(a, b)

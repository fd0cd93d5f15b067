"""The port's SynthER and TD3+BC against the JAX package's.

TD3+BC: the same seeded weights (actor, critic and two different targets)
and batches, 4 updates (two `policy_freq` periods: the actor and both
targets move on steps 0 and 2 only), the JAX update's target-policy noise
replayed (`rng, k_noise = split(state.rng)`, `normal(k_noise)`): per step
the five logs; after 4 steps the four nets, both Adams' moments and counts.
The JAX CLI's `td3bc.pkl` (a pickled `TD3BCState`) is read by
`load_jax_checkpoint` and a fifth step matches.

SynthER: 3 diffusion steps on the same seeded weights with the loss's draws
replayed (`k_noise, _, _ = split(sub, 3)`, `k_t, k_eps = split(k_noise)`)
and the backbone's dropout masks injected on both sides (one mask per
residual block, taken in block order by a stand-in for flax's Bernoulli
draw and for the port's block); a JAX `diff_ckpt` read without JAX; and
`generate_transitions` with JAX's draws, its chunk clamp and its cache
keys; and at the shipped width (1024 x 6, 128 steps) the port's weights
after two steps converted into JAX, 16 rows generated in both, held
relative to the sample scale the unclipped chain reaches in both.

Tolerance 1e-5 absolute / 1e-4 relative for logs, critics, targets and
moments; the trained actor and the diffusion net's params after their steps
as in tests/test_torch_sfbc.py (`_close_adam`). Then
tests/test_rl_pipelines.py's SynthER smoke test and
tests/test_fused_rl_window.py's window test, on the port.
"""

import copy
import pickle

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.pipelines.synther import TD3BC as JaxTD3BC
from cleandiffuser_tpu.pipelines.synther import SynthERPipeline as JaxSynthER
from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoTDDataset, fake_d4rl_qlearning_dataset
from cleandiffuser_tpu_torch.nn_diffusion import mlps
from cleandiffuser_tpu_torch.pipelines import TD3BC, SynthERPipeline
from cleandiffuser_tpu_torch.utils.jax_params import (
    agent_params_of,
    jax_params_of,
    load_agent_params,
    load_jax_params,
)
from test_torch_dql import _sampler_noise, _seeded, _t
from test_torch_edm_cm import _close_tree, _jt
from test_torch_sfbc import _close_adam

torch.set_num_threads(1)

OBS, ACT, B = 5, 3, 8
ATOL, RTOL = 1e-5, 1e-4
NETS = ("actor", "actor_target", "critic", "critic_target")


def _batch(rng):
    return {"obs": {"state": rng.standard_normal((B, OBS)).astype(np.float32)},
            "next_obs": {"state": rng.standard_normal((B, OBS)).astype(np.float32)},
            "act": rng.uniform(-1, 1, (B, ACT)).astype(np.float32),
            "rew": rng.standard_normal((B, 1)).astype(np.float32),
            "tml": (rng.uniform(size=(B, 1)) < 0.25).astype(np.float32)}


def _moments(opt, net):
    """The port optimizer's Adam moments of `net` as flax trees."""
    out = []
    for key in ("exp_avg", "exp_avg_sq"):
        twin = copy.deepcopy(net)
        with torch.no_grad():
            for p, q in zip(twin.parameters(), net.parameters()):
                p.copy_(opt.optimizer.state[q][key])
        out.append({"params": jax_params_of(twin)})
    return out


def _td3_nets(agent):
    return {n: {"params": jax_params_of(getattr(agent, n))} for n in NETS}


@pytest.fixture(scope="module")
def td3(tmp_path_factory):
    jag = JaxTD3BC(OBS, ACT, gradient_steps=10, rng=0)
    tag = TD3BC(OBS, ACT, gradient_steps=10, device="cpu")
    st = jag.state
    w = {"actor": _seeded(st.actor_params, 1), "actor_target": _seeded(st.actor_target_params, 2),
         "critic": _seeded(st.critic_params, 3),
         "critic_target": _seeded(st.critic_target_params, 4)}
    jag.state = st.replace(**{f"{n}_params": _jt(w[n]) for n in NETS})
    for n in NETS:
        load_jax_params(getattr(tag, n), w[n]["params"])
    rng = np.random.default_rng(5)
    logs, nets, draws, batches = [], [], [], [_batch(rng) for _ in range(5)]
    ckpt = tmp_path_factory.mktemp("td3bc") / "td3bc.pkl"
    for i, batch in enumerate(batches[:4]):
        _, k_noise = jax.random.split(jag.state.rng)
        noise = _t(jax.random.normal(k_noise, (B, ACT)))
        nets.append(_td3_nets(tag))
        lj = jag.update(jax.tree_util.tree_map(jnp.asarray, batch))
        lt = tag.update(batch, noise=noise)
        logs.append(({k: float(v) for k, v in lj.items()}, {k: float(v) for k, v in lt.items()}))
        draws.append(noise)
    with open(ckpt, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jag.state), f)
    nets.append(_td3_nets(tag))
    return dict(jag=jag, tag=tag, w=w, logs=logs, nets=nets, batches=batches, ckpt=ckpt)


def test_td3bc_logs_match_jax(td3):
    for lj, lt in td3["logs"]:
        assert set(lt) == set(lj) == set(TD3BC.LOG_KEYS)
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)


def test_td3bc_state_after_two_policy_periods_matches_jax(td3):
    jag, tag = td3["jag"], td3["tag"]
    st = jag.state
    got = _td3_nets(tag)
    _close_adam(got["actor"], st.actor_params, steps=2, lr=3e-4)
    for n in ("actor_target", "critic", "critic_target"):
        _close_tree(got[n], getattr(st, f"{n}_params"))
    for opt, net, jopt in ((tag.actor_optimizer, tag.actor, st.actor_opt_state),
                           (tag.critic_optimizer, tag.critic, st.critic_opt_state)):
        mu, nu = _moments(opt, net)
        _close_tree(mu, jopt[0].mu)
        _close_tree(nu, jopt[0].nu)
    assert tag.step == int(st.step) == 4
    # the actor, its Adam and schedule counts and both targets moved on
    # steps 0 and 2 only
    assert tag.actor_updates == 2 == int(st.actor_opt_state[0].count)
    assert tag.actor_optimizer.count == 2 == int(st.actor_opt_state[1].count)
    assert tag.critic_optimizer.count == 4 == int(st.critic_opt_state[1].count)
    nets = td3["nets"]
    for i, moves in enumerate((True, False, True, False)):
        for n in ("actor", "actor_target", "critic_target"):
            same = all(np.array_equal(a, b) for a, b in zip(
                jax.tree_util.tree_leaves(nets[i][n]), jax.tree_util.tree_leaves(nets[i + 1][n])))
            assert same != moves, (i, n)


def test_td3bc_pkl_reader_resumes(td3):
    fresh = TD3BC(OBS, ACT, gradient_steps=10, rng=3, device="cpu")
    fresh.load_jax_checkpoint(str(td3["ckpt"]))
    st = td3["jag"].state
    for n in NETS:
        _close_tree({"params": jax_params_of(getattr(fresh, n))}, getattr(st, f"{n}_params"), 0.0)
    assert (fresh.step, fresh.actor_updates, fresh.actor_optimizer.count,
            fresh.critic_optimizer.count) == (4, 2, 2, 4)
    mu, _ = _moments(fresh.critic_optimizer, fresh.critic)
    _close_tree(mu, st.critic_opt_state[0].mu, 0.0)
    # a fifth step (an actor step) on both
    batch = td3["batches"][4]
    _, k_noise = jax.random.split(st.rng)
    lj = td3["jag"].update(jax.tree_util.tree_map(jnp.asarray, batch))
    lt = fresh.update(batch, noise=_t(jax.random.normal(k_noise, (B, ACT))))
    for k in lj:
        np.testing.assert_allclose(float(lt[k]), float(lj[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    assert fresh.actor_updates == 3


def test_td3bc_save_load_round_trip(td3, tmp_path):
    td3["tag"].save(str(tmp_path / "td3bc.pt"))
    fresh = TD3BC(OBS, ACT, gradient_steps=10, rng=9, device="cpu")
    fresh.load(str(tmp_path / "td3bc.pt"))
    for n in NETS:
        for a, b in zip(getattr(fresh, n).parameters(), getattr(td3["tag"], n).parameters()):
            assert torch.equal(a, b)
    assert (fresh.step, fresh.actor_updates) == (4, 2)


# ---------------------------------------------------------------------------
SYN = dict(obs_dim=OBS, act_dim=ACT, diffusion_steps=6, emb_dim=16, hidden_dim=32, n_blocks=2,
           lr=1e-3, gradient_steps=10, ema_rate=0.9)
X_DIM = 2 * OBS + ACT + 2
KEEP = 0.9  # 1 - dropout


class _Bernoulli:
    """flax Dropout's `random` with `bernoulli` taking the injected masks."""

    def __init__(self, masks):
        self.masks = masks

    def bernoulli(self, rng, p, shape):
        assert np.isclose(p, KEEP)
        return jnp.asarray(self.masks.pop(0))

    def __getattr__(self, name):
        return getattr(jax.random, name)


def _port_block_forward(masks):
    def forward(self, x, train=False, generator=None):
        h = x
        if train and self.dropout > 0:
            keep = torch.from_numpy(masks.pop(0))
            h = torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))
        return x + self.dense2(mlps.mish(self.dense1(self.norm(h))))

    return forward


@pytest.fixture(scope="module")
def synther(tmp_path_factory):
    jp, tp = JaxSynthER(**SYN, rng=0), SynthERPipeline(**SYN, device="cpu")
    st = jp.diffusion.state
    params, ema = _seeded(st.params, 1), _seeded(st.ema_params, 2)
    jp.diffusion.state = st.replace(params=_jt(params), ema_params=_jt(ema))
    load_agent_params(tp.diffusion.params, params)
    load_agent_params(tp.diffusion.ema_params, ema)
    rng = np.random.default_rng(6)
    mp = pytest.MonkeyPatch()
    logs, masks_used = [], []
    try:
        for _ in range(3):
            batch = _batch(rng)
            masks = [rng.uniform(size=(B, SYN["hidden_dim"])) < KEEP
                     for _ in range(SYN["n_blocks"])]
            masks_used.append(masks)
            _, sub = jax.random.split(jp.diffusion.state.rng)
            k_noise, _, _ = jax.random.split(sub, 3)
            k_t, k_eps = jax.random.split(k_noise)
            noise = (_t(jax.random.randint(k_t, (B,), 0, SYN["diffusion_steps"])),
                     _t(jax.random.normal(k_eps, (B, X_DIM))), None)
            jmasks, tmasks = list(masks), list(masks)
            mp.setattr(flax_stochastic, "random", _Bernoulli(jmasks))
            mp.setattr(mlps._LNResBlock, "forward", _port_block_forward(tmasks))
            jp.diffusion._fn_cache.clear()  # retrace: the masks enter at trace time
            lj = jp.train_step(jax.tree_util.tree_map(jnp.asarray, batch))
            lt = tp.train_step(batch, noise=noise)
            assert not jmasks and not tmasks  # each block took its mask
            logs.append(({k: float(v) for k, v in lj.items()},
                         {k: float(v) for k, v in lt.items()}))
    finally:
        mp.undo()
    ckpt = str(tmp_path_factory.mktemp("synther") / "diff_ckpt_latest")
    jp.diffusion.save(ckpt)
    return dict(jp=jp, tp=tp, logs=logs, ckpt=ckpt, masks=masks_used)


def test_synther_steps_match_jax_with_injected_dropout(synther):
    for lj, lt in synther["logs"]:
        assert set(lt) == set(lj) == {"loss", "grad_norm"}
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], atol=ATOL, rtol=RTOL, err_msg=k)
    st = synther["jp"].diffusion.state
    tp = synther["tp"]
    _close_adam(agent_params_of(tp.diffusion.params), st.params, lr=SYN["lr"])
    _close_adam(agent_params_of(tp.diffusion.ema_params), st.ema_params, lr=SYN["lr"])
    assert tp.diffusion.step == int(st.step) == 3 and tp.diffusion.optimizer.count == 3
    masks = np.stack([m for step in synther["masks"] for m in step])
    assert 0 < masks.mean() < 1  # the masks drop entries


def test_synther_jax_diff_ckpt_reads_without_jax(synther):
    fresh = SynthERPipeline(**SYN, rng=4, device="cpu")
    fresh.diffusion.load_jax_checkpoint(synther["ckpt"])
    st = synther["jp"].diffusion.state
    _close_tree(agent_params_of(fresh.diffusion.params), st.params, 0.0)
    _close_tree(agent_params_of(fresh.diffusion.ema_params), st.ema_params, 0.0)
    assert fresh.diffusion.step == 3 and fresh.diffusion.optimizer.count == 3


def test_generate_transitions_matches_jax(synther):
    jp, tp = synther["jp"], synther["tp"]
    steps, n, bs = 3, 10, 4
    rng, noise = jp._rng, []
    for _ in range(3):  # 4 + 4 + 2 of a batch of 4
        rng, k = jax.random.split(rng)
        noise.append(_sampler_noise(k, (bs, X_DIM), steps))
    want = jp.generate_transitions(n, batch_size=bs, sampling_steps=steps)
    got = tp.generate_transitions(n, batch_size=bs, sampling_steps=steps, noise=noise)
    assert got.shape == (n, X_DIM)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# relative to the sample scale: a 128-step chain at |x| ~ 1e4 rounds by
# ~1e-2 in float32 in either package (measured 1.3e-6 / 1.6e-6 of the scale)
FULL_WIDTH_RTOL_OF_SCALE = 1e-5


def test_full_width_generation_reaches_the_jax_scale():
    """The shipped SynthER (IDQLMlp 1024 x 6, emb 128, 128 ddpm steps, no
    clipping) at halfcheetah's widths: the port's weights after two
    training steps at batch 256, converted into the JAX pipeline, generate
    16 rows in both with JAX's draws. The EMA model is still near its
    initial weights (as after the card's smoke run's 500 steps at EMA
    0.999), and its unclipped chain leaves the data's range in both
    packages alike (|x| > 1e3): the same rows within
    FULL_WIDTH_RTOL_OF_SCALE of that scale."""
    ds = D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset(n_steps=2000), device="cpu")
    tp = SynthERPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, gradient_steps=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        assert np.isfinite(float(tp.train_step(ds.sample_batch(g, 256))["loss"]))
    jp = JaxSynthER(obs_dim=ds.o_dim, act_dim=ds.a_dim, rng=0)
    jp.diffusion.state = jp.diffusion.state.replace(
        ema_params=_jt(agent_params_of(tp.diffusion.ema_params)))
    rows = 16
    _, k = jax.random.split(jp._rng)
    noise = _sampler_noise(k, (rows, tp.x_dim), 128)
    want = jp.generate_transitions(rows, sampling_steps=128)
    got = tp.generate_transitions(rows, sampling_steps=128, noise=[noise])
    scale = float(np.abs(want).max())
    assert got.shape == want.shape == (rows, 2 * ds.o_dim + ds.a_dim + 2)
    assert scale > 1e3 and np.abs(got).max() > 1e3
    np.testing.assert_allclose(got, want, rtol=0, atol=FULL_WIDTH_RTOL_OF_SCALE * scale)


# ---------------------------------------------------------------------------
# tests/test_rl_pipelines.py:100 and tests/test_fused_rl_window.py:175 on the port
def _td_ds(n=800):
    return D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset(n_steps=n, ep_len=150), device="cpu")


def test_synther_and_td3bc_smoke_port():
    ds = _td_ds()
    pipe = SynthERPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, diffusion_steps=8, hidden_dim=64,
                           n_blocks=2, gradient_steps=100, device="cpu")
    g = torch.Generator().manual_seed(0)
    assert np.isfinite(float(pipe.train_step(ds.sample_batch(g, 16))["loss"]))
    trans = pipe.generate_transitions(40, batch_size=32, sampling_steps=4)
    assert trans.shape == (40, ds.o_dim * 2 + ds.a_dim + 2) and np.isfinite(trans).all()
    # the chunk clamps to the request; one sampler per (batch, steps)
    small = pipe.generate_transitions(8, batch_size=10_000, sampling_steps=2)
    assert small.shape == (8, ds.o_dim * 2 + ds.a_dim + 2)
    assert set(pipe._gen_fns) == {(32, 4), (8, 2)}
    agent = TD3BC(obs_dim=ds.o_dim, act_dim=ds.a_dim, gradient_steps=100, device="cpu")
    for _ in range(3):
        log = agent.update(ds.sample_batch(g, 16))
        assert all(np.isfinite(float(v)) for v in log.values())
    assert agent.act(np.random.randn(3, ds.o_dim).astype(np.float32)).shape == (3, ds.a_dim)


def test_synther_windows_equal_their_steps_port():
    ds = D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset(n_steps=256), device="cpu")
    n_steps, batch = 3, 8

    def mk():
        return SynthERPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, diffusion_steps=4,
                               hidden_dim=32, n_blocks=1, gradient_steps=100, device="cpu")

    seq, win = mk(), mk()
    g = torch.Generator().manual_seed(11)
    for _ in range(n_steps):
        seq.train_step(ds.sample_batch(g, batch))
    log = win.make_train_scan(ds, batch, n_steps)(torch.Generator().manual_seed(11))
    assert np.isfinite(float(log["loss"]))
    for a, b in zip(seq.diffusion.params.parameters(), win.diffusion.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    seq_a = TD3BC(obs_dim=ds.o_dim, act_dim=ds.a_dim, gradient_steps=100, device="cpu")
    win_a = TD3BC(obs_dim=ds.o_dim, act_dim=ds.a_dim, gradient_steps=100, device="cpu")
    g = torch.Generator().manual_seed(11)
    for _ in range(n_steps):
        seq_a.update(ds.sample_batch(g, batch))
    log = win_a.make_train_scan(ds, batch, n_steps)(torch.Generator().manual_seed(11))
    assert all(np.isfinite(float(v)) for v in log.values())
    for n in NETS:
        for a, b in zip(getattr(seq_a, n).parameters(), getattr(win_a, n).parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert win_a.step == n_steps and win_a.actor_updates == 2

"""The port's D4RL antmaze and kitchen datasets against the JAX package's,
on the same synthetic D4RL-format data.

Ports tests/test_datasets.py:116-140 (shapes, the antmaze TD reward tune,
the kitchen windows) to both packages. Beyond them, for each of the eight
classes (sequence, TD, multi-horizon and DV, per suite):

- both packages build the same host arrays (windows, values, indices,
  path lengths, normaliser statistics) bit for bit;
- the port's device gather at the JAX draw's indices
  (`randint(key, (B,), 0, N)`) gives the JAX batch bit for bit;
- antmaze's four reward tunes, the no-reaching penalty on full-length
  episodes and the padding of short ones (the next state repeated, zero
  actions and rewards; kitchen repeats the last reward instead).

Everything is numpy and index gathers, so every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch

from cleandiffuser_tpu import dataset as jds
from cleandiffuser_tpu.dataset import d4rl_antmaze as jant
from cleandiffuser_tpu_torch import dataset as tds
from cleandiffuser_tpu_torch.dataset import d4rl_antmaze as tant

ANT, KIT = "antmaze-medium-play-v2", "kitchen-mixed-v0"
SEQ_ARRAYS = ("seq_obs", "seq_act", "seq_rew", "seq_val", "indices", "path_lengths")


@pytest.fixture(scope="module")
def raw():
    return {ANT: jds.fake_d4rl_dataset(ANT, n_steps=3000, ep_len=300),
            KIT: jds.fake_d4rl_dataset(KIT, n_steps=2000, ep_len=200)}


@pytest.fixture(scope="module")
def raw_td():
    return {ANT: jds.fake_d4rl_qlearning_dataset(ANT, n_steps=2000, ep_len=300),
            KIT: jds.fake_d4rl_qlearning_dataset(KIT, n_steps=2000, ep_len=200)}


def _jax_indices(key, batch, n):
    """The JAX sampler's index draw (dataset/base.py `gather_fn`)."""
    return torch.from_numpy(np.asarray(jax.random.randint(key, (batch,), 0, n)).astype(np.int64))


def _same_batch(jbatch, tbatch):
    jl = jax.tree_util.tree_leaves_with_path(jbatch)
    tl = jax.tree_util.tree_leaves_with_path(tbatch)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=jax.tree_util.keystr(path))


def _same_arrays(td, jd, names):
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(td, name)),
                                      np.asarray(getattr(jd, name)), err_msg=name)
    for stat in ("mean", "std"):
        np.testing.assert_array_equal(getattr(td.get_normalizer(), stat),
                                      getattr(jd.get_normalizer(), stat))


# the sequence and DV classes of both suites, with their arguments
SEQ_CASES = {
    "antmaze": (ANT, "D4RLAntmazeDataset", dict(horizon=8, max_path_length=301)),
    "antmaze-dv": (ANT, "DV_D4RLAntmazeSeqDataset",
                   dict(horizon=4, max_path_length=301, stride=2, reward_tune="cql",
                        continous_reward_at_done=True)),
    "kitchen": (KIT, "D4RLKitchenDataset", dict(horizon=8, max_path_length=280)),
    "kitchen-dv": (KIT, "DV_D4RLKitchenSeqDataset",
                   dict(horizon=4, max_path_length=280, stride=3, center_mapping=False)),
}


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_datasets_same_arrays_and_batches(raw, case):
    env, cls, kw = SEQ_CASES[case]
    jd = getattr(jds, cls)(raw[env], **kw)
    td = getattr(tds, cls)(raw[env], **kw, device="cpu")
    names = SEQ_ARRAYS + (("tml_and_not_timeout",) if "DV" not in cls else ())
    _same_arrays(td, jd, names)
    for seed in (1, 2):
        key = jax.random.PRNGKey(seed)
        k = _jax_indices(key, 16, len(jd))
        _same_batch(jd.sample_batch(key, 16),
                    tds.D4RLMuJoCoDataset.batch(td._sampler.gather(k)))
    # the host item is the gathered window
    gathered = tds.D4RLMuJoCoDataset.batch(td._sampler.gather(torch.tensor([3])))
    for name in ("act", "rew", "val"):
        np.testing.assert_array_equal(gathered[name][0].numpy(), td[3][name])
    np.testing.assert_array_equal(gathered["obs"]["state"][0].numpy(), td[3]["obs"]["state"])
    batch = td.sample_batch(torch.Generator().manual_seed(0), 8)
    assert batch["obs"]["state"].shape == (8, kw["horizon"], td.o_dim)


@pytest.mark.parametrize("env", [ANT, KIT])
def test_td_datasets_same_arrays_and_batches(raw_td, env):
    cls = "D4RLAntmazeTDDataset" if env == ANT else "D4RLKitchenTDDataset"
    jd = getattr(jds, cls)(dict(raw_td[env]))
    td = getattr(tds, cls)(dict(raw_td[env]), device="cpu")
    _same_arrays(td, jd, ("obs", "next_obs", "act", "rew", "tml"))
    key = jax.random.PRNGKey(7)
    _same_batch(jd.sample_batch(key, 32),
                tds.D4RLMuJoCoTDDataset.batch(td._sampler.gather(_jax_indices(key, 32, len(jd)))))
    item = td[0]
    assert item["obs"]["state"].shape == (td.o_dim,) and item["rew"].shape == (1,)


@pytest.mark.parametrize("env", [ANT, KIT])
def test_multi_horizon_same_arrays_and_batches(raw, env):
    suite = "Antmaze" if env == ANT else "Kitchen"
    kw = dict(horizons=(8, 16), max_path_length=301 if env == ANT else 280)
    jd = getattr(jds, f"MultiHorizonD4RL{suite}Dataset")(raw[env], **kw)
    td = getattr(tds, f"MultiHorizonD4RL{suite}Dataset")(raw[env], **kw, device="cpu")
    _same_arrays(td, jd, ("seq_obs", "seq_act", "seq_val", "path_lengths", "len_each_horizon"))
    items = td[0]
    assert [it["horizon"] for it in items] == [8, 16]
    assert items[1]["data"]["obs"]["state"].shape == (16, td.o_dim)
    key = jax.random.PRNGKey(2)
    for h in (0, 1):
        np.testing.assert_array_equal(td.indices[h], jd.indices[h])
        out = td._samplers[h].gather(_jax_indices(key, 16, jd.len_each_horizon[h]))
        _same_batch(jd.sample_batch(key, 16, horizon_idx=h),
                    {"obs": {"state": out["obs"]}, "act": out["act"], "val": out["val"]})
        b = td.sample_batch(torch.Generator().manual_seed(0), 4, horizon_idx=h)
        assert b["obs"]["state"].shape == (4, (8, 16)[h], td.o_dim)


@pytest.mark.parametrize("tune", ["iql", "cql", "antmaze", "none"])
def test_tune_reward_modes(raw_td, tune):
    """The four tunes, as formulas and as the JAX package's; the TD
    dataset's rewards are the tuned ones."""
    r = np.array([0.0, 1.0, 0.25, -2.0], np.float32)
    want = {"iql": r - 1.0, "cql": (r - 0.5) * 4.0, "antmaze": (r - 0.25) * 2.0,
            "none": r}[tune]
    np.testing.assert_array_equal(tant.tune_reward(r, tune), want)
    np.testing.assert_array_equal(tant.tune_reward(r, tune), jant.tune_reward(r, tune))
    td = tds.D4RLAntmazeTDDataset(dict(raw_td[ANT]), reward_tune=tune, device="cpu")
    jd = jds.D4RLAntmazeTDDataset(dict(raw_td[ANT]), reward_tune=tune)
    np.testing.assert_array_equal(td.rew, jd.rew)
    np.testing.assert_array_equal(
        td.rew[:, 0], tant.tune_reward(raw_td[ANT]["rewards"].astype(np.float32), tune))


def test_tune_reward_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="not supported"):
        tant.tune_reward(np.zeros(2, np.float32), "sparse")


def test_antmaze_td_reward_tune(raw_td):
    """tests/test_datasets.py:125-129 on the port."""
    ds_iql = tds.D4RLAntmazeTDDataset(dict(raw_td[ANT]), reward_tune="iql", device="cpu")
    ds_none = tds.D4RLAntmazeTDDataset(dict(raw_td[ANT]), reward_tune="none", device="cpu")
    np.testing.assert_allclose(ds_iql.rew, ds_none.rew - 1.0, atol=1e-6)


def test_antmaze_noreaching_penalty_and_padding():
    """Episodes of 150 steps (the timeouts) at max_path_length 150 are full
    length: the last reward of each is the penalty. Shorter ones (cut by a
    terminal) are padded with the state that follows them, zero actions
    and zero rewards. Boundaries come from done[i-1]."""
    raw = jds.fake_d4rl_dataset(ANT, n_steps=3000, ep_len=150, seed=3)
    kw = dict(horizon=4, max_path_length=150, noreaching_penalty=-37.0)
    jd, td = jds.D4RLAntmazeDataset(raw, **kw), tds.D4RLAntmazeDataset(raw, **kw, device="cpu")
    _same_arrays(td, jd, SEQ_ARRAYS + ("tml_and_not_timeout",))
    lengths = np.asarray(td.path_lengths)
    full, short = np.flatnonzero(lengths == 150), np.flatnonzero(lengths < 150)
    assert len(full) and len(short)
    np.testing.assert_array_equal(td.seq_rew[full, -1, 0], -37.0)
    # rewards are the data's - 1 before the end
    assert np.all(td.seq_rew[full, :-1, 0] <= 0.0)
    dones = np.logical_or(raw["timeouts"], raw["terminals"])
    starts = [0] + [i for i in range(1, len(dones))
                    if (dones[i - 1] and not dones[i]) or raw["timeouts"][i - 1]]
    normed = td.get_normalizer().normalize(raw["observations"].astype(np.float32))
    for p in short:
        plen, nxt = lengths[p], starts[p + 1]
        assert starts[p] + plen == nxt
        np.testing.assert_array_equal(td.seq_obs[p, plen:], np.broadcast_to(
            normed[nxt], td.seq_obs[p, plen:].shape))
        assert not td.seq_act[p, plen:].any() and not td.seq_rew[p, plen:].any()


def test_kitchen_padding_repeats_the_last_reward():
    raw = jds.fake_d4rl_dataset(KIT, n_steps=2000, ep_len=200, seed=4)
    jd = jds.D4RLKitchenDataset(raw, horizon=4)
    td = tds.D4RLKitchenDataset(raw, horizon=4, device="cpu")
    _same_arrays(td, jd, SEQ_ARRAYS + ("tml_and_not_timeout",))
    assert td.seq_obs.shape[1] == 280
    for p, plen in enumerate(td.path_lengths):
        np.testing.assert_array_equal(td.seq_rew[p, plen:, 0], td.seq_rew[p, plen - 1, 0])
        np.testing.assert_array_equal(td.seq_obs[p, plen:],
                                      np.broadcast_to(td.seq_obs[p, plen - 1],
                                                      td.seq_obs[p, plen:].shape))
        assert not td.seq_act[p, plen:].any()


@pytest.mark.parametrize("env", [ANT, KIT])
def test_suite_shapes(raw, env):
    """tests/test_datasets.py:116-122 and :132-138 on the port."""
    if env == ANT:
        ds = tds.D4RLAntmazeDataset(raw[env], horizon=8, max_path_length=301, device="cpu")
    else:
        ds = tds.D4RLKitchenDataset(raw[env], horizon=8, max_path_length=280, device="cpu")
    o_dim = 29 if env == ANT else 60
    assert len(ds) > 0
    assert ds[0]["obs"]["state"].shape == (8, o_dim)
    batch = ds.sample_batch(torch.Generator().manual_seed(0), 8)
    assert batch["obs"]["state"].shape == (8, 8, o_dim)


def test_suite_stores_default_to_the_gpu(raw, raw_td):
    """Without a `device`, the stores take the CUDA device and raise without
    one; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: tds.D4RLAntmazeDataset(raw[ANT], horizon=4),
                 lambda: tds.D4RLKitchenTDDataset(dict(raw_td[KIT]))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()

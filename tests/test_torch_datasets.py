"""The PyTorch port's datasets, normalizers and data loading against the JAX
package's, on the same synthetic D4RL-format data.

The tests of tests/test_datasets.py:30-102 and :141, each run on both
packages: shapes, the MC value recursion, the terminal penalty, the TD and
multi-horizon variants and the DV stride. Beyond them:

- both packages build the same host arrays (windows, values, indices,
  normalizer statistics) bit for bit: the port's copy is the same numpy code;
- the same indices give identical batches: the index draw is the JAX
  sampler's own (`randint(key, (B,), 0, N)`), handed to the port's device
  gather (`gather(k)`), since a torch generator draws other indices from a
  seed;
- `sample_batch` draws from an explicit torch generator, seeded;
- the windowing utilities, the normalizers, the hermetic Goal2D data and the
  npz snapshot / synthetic fallback of `pipelines/data_loading.py`.

Everything is exact (numpy and index gathers, no arithmetic that could
round differently), so every comparison is bit for bit, except the
normalizers applied to torch tensors (float32 arithmetic, 1e-6).
"""

import jax
import numpy as np
import pytest
import torch

from cleandiffuser_tpu import dataset as jds
from cleandiffuser_tpu.dataset import dataset_utils as jutils
from cleandiffuser_tpu.utils import normalizers as jnorm
from cleandiffuser_tpu_torch import dataset as tds
from cleandiffuser_tpu_torch.dataset import dataset_utils as tutils
from cleandiffuser_tpu_torch.utils import normalizers as tnorm

NORM_TOL = 1e-6


@pytest.fixture(scope="module")
def raw():
    return jds.fake_d4rl_dataset("halfcheetah-medium-v2", n_steps=3000, ep_len=200)


@pytest.fixture(scope="module")
def raw_td():
    return jds.fake_d4rl_qlearning_dataset("halfcheetah-medium-v2", n_steps=3000, ep_len=200)


def _same_batch(jbatch, tbatch):
    """Two nested batch dicts, leaf for leaf, bit for bit."""
    jl = jax.tree_util.tree_leaves_with_path(jbatch)
    tl = jax.tree_util.tree_leaves_with_path(tbatch)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=jax.tree_util.keystr(path))


def _jax_indices(key, batch, n):
    """The JAX sampler's index draw (dataset/base.py `gather_fn`)."""
    return torch.from_numpy(np.asarray(jax.random.randint(key, (batch,), 0, n)).astype(np.int64))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_seq_dataset_shapes(raw, pkg):
    if pkg == "jax":
        ds = jds.D4RLMuJoCoDataset(raw, horizon=16, max_path_length=200)
        batch = ds.sample_batch(jax.random.PRNGKey(0), 32)
    else:
        ds = tds.D4RLMuJoCoDataset(raw, horizon=16, max_path_length=200, device="cpu")
        batch = ds.sample_batch(torch.Generator().manual_seed(0), 32)
    assert len(ds) > 0
    item = ds[0]
    assert item["obs"]["state"].shape == (16, 17)
    assert item["act"].shape == (16, 6)
    assert item["rew"].shape == (16, 1)
    assert item["val"].shape == (1,)
    assert batch["obs"]["state"].shape == (32, 16, 17)
    assert batch["act"].shape == (32, 16, 6)
    assert batch["val"].shape == (32, 1)


def test_seq_dataset_same_arrays_and_batches(raw):
    """Host arrays bit for bit; the device gather at the JAX draw's indices
    gives the JAX batch; the host `__getitem__` agrees with the gather."""
    jd = jds.D4RLMuJoCoDataset(raw, horizon=8, max_path_length=200)
    td = tds.D4RLMuJoCoDataset(raw, horizon=8, max_path_length=200, device="cpu")
    for name in ("seq_obs", "seq_act", "seq_rew", "seq_val", "indices", "path_lengths",
                 "tml_and_not_timeout"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name), err_msg=name)
    np.testing.assert_array_equal(td.get_normalizer().mean, jd.get_normalizer().mean)
    np.testing.assert_array_equal(td.get_normalizer().std, jd.get_normalizer().std)
    for seed in (1, 2):
        key = jax.random.PRNGKey(seed)
        k = _jax_indices(key, 16, len(jd))
        _same_batch(jd.sample_batch(key, 16), td.batch(td._sampler.gather(k)))
    host = td[5]
    path_idx, start = td.indices[5]
    np.testing.assert_array_equal(host["obs"]["state"], td.seq_obs[path_idx, start:start + 8])
    gathered = td.batch(td._sampler.gather(torch.tensor([5])))
    for key in ("act", "rew", "val"):
        np.testing.assert_array_equal(gathered[key][0].numpy(), host[key])


def test_sample_batch_is_seeded(raw):
    td = tds.D4RLMuJoCoDataset(raw, horizon=8, max_path_length=200, device="cpu")
    a = td.sample_batch(torch.Generator().manual_seed(3), 8)
    b = td.sample_batch(torch.Generator().manual_seed(3), 8)
    c = td.sample_batch(torch.Generator().manual_seed(4), 8)
    assert torch.equal(a["obs"]["state"], b["obs"]["state"])
    assert not torch.equal(a["obs"]["state"], c["obs"]["state"])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_mc_value_recursion(raw, pkg):
    kw = dict(horizon=4, max_path_length=200, discount=0.99)
    ds = (jds.D4RLMuJoCoDataset(raw, **kw) if pkg == "jax"
          else tds.D4RLMuJoCoDataset(raw, **kw, device="cpu"))
    v, r = ds.seq_val[0], ds.seq_rew[0]
    np.testing.assert_allclose(v[:-1], r[:-1] + 0.99 * v[1:], rtol=1e-4, atol=1e-4)


def test_terminal_penalty():
    raw = jds.fake_d4rl_dataset("halfcheetah-medium-v2", n_steps=3000, ep_len=150, seed=3)
    kw = dict(horizon=4, max_path_length=150, terminal_penalty=-100)
    jd, td = jds.D4RLMuJoCoDataset(raw, **kw), tds.D4RLMuJoCoDataset(raw, **kw, device="cpu")
    np.testing.assert_array_equal(td.tml_and_not_timeout, jd.tml_and_not_timeout)
    np.testing.assert_array_equal(td.seq_rew, jd.seq_rew)
    for p, t in td.tml_and_not_timeout[:1]:
        assert td.seq_rew[p, t, 0] == -100.0


def test_td_dataset(raw_td):
    jd, td = jds.D4RLMuJoCoTDDataset(raw_td), tds.D4RLMuJoCoTDDataset(raw_td, device="cpu")
    item = td[0]
    assert item["obs"]["state"].shape == (17,)
    assert item["next_obs"]["state"].shape == (17,)
    batch = td.sample_batch(torch.Generator().manual_seed(0), 64)
    assert batch["obs"]["state"].shape == (64, 17)
    assert batch["act"].shape == (64, 6)
    assert batch["rew"].shape == (64, 1)
    assert batch["tml"].shape == (64, 1)
    assert abs(float(td.obs.mean())) < 0.1  # normalized obs ~zero-mean unit-var
    for name in ("obs", "next_obs", "act", "rew", "tml"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name), err_msg=name)
    key = jax.random.PRNGKey(7)
    _same_batch(jd.sample_batch(key, 32), td.batch(td._sampler.gather(_jax_indices(key, 32,
                                                                                   len(jd)))))


def test_td_dataset_reward_scaling(raw_td):
    """`normalize_reward`: the antmaze-style return-range scaling."""
    jd = jds.D4RLMuJoCoTDDataset(dict(raw_td), normalize_reward=True)
    td = tds.D4RLMuJoCoTDDataset(dict(raw_td), normalize_reward=True, device="cpu")
    np.testing.assert_array_equal(td.rew, jd.rew)


def test_multi_horizon(raw):
    jd = jds.MultiHorizonD4RLMuJoCoDataset(raw, horizons=(8, 16), max_path_length=200)
    td = tds.MultiHorizonD4RLMuJoCoDataset(raw, horizons=(8, 16), max_path_length=200,
                                           device="cpu")
    items = td[0]
    assert items[0]["horizon"] == 8
    assert items[0]["data"]["obs"]["state"].shape == (8, 17)
    assert items[1]["data"]["obs"]["state"].shape == (16, 17)
    b0 = td.sample_batch(torch.Generator().manual_seed(0), 16, horizon_idx=0)
    b1 = td.sample_batch(torch.Generator().manual_seed(0), 16, horizon_idx=1)
    assert b0["obs"]["state"].shape == (16, 8, 17)
    assert b1["obs"]["state"].shape == (16, 16, 17)
    key = jax.random.PRNGKey(2)
    for h in (0, 1):
        np.testing.assert_array_equal(td.indices[h], jd.indices[h])
        out = td._samplers[h].gather(_jax_indices(key, 16, jd.len_each_horizon[h]))
        _same_batch(jd.sample_batch(key, 16, horizon_idx=h),
                    {"obs": {"state": out["obs"]}, "act": out["act"], "val": out["val"]})


def test_dv_dataset_stride(raw):
    kw = dict(horizon=4, max_path_length=200, stride=2)
    jd, td = jds.DV_D4RLMuJoCoSeqDataset(raw, **kw), tds.DV_D4RLMuJoCoSeqDataset(raw, **kw,
                                                                                 device="cpu")
    item = td[0]
    assert item["obs"]["state"].shape == (4, 17)
    assert td.seq_val.min() >= -1 - 1e-6 and td.seq_val.max() <= 1 + 1e-6
    batch = td.sample_batch(torch.Generator().manual_seed(0), 8)
    assert batch["obs"]["state"].shape == (8, 4, 17)
    path_idx, start = td.indices[0]
    np.testing.assert_array_equal(td[0]["obs"]["state"], td.seq_obs[path_idx, start:start + 7:2])
    np.testing.assert_array_equal(td.seq_val, jd.seq_val)
    key = jax.random.PRNGKey(3)
    out = td._sampler.gather(_jax_indices(key, 8, len(jd)))
    _same_batch(jd.sample_batch(key, 8), tds.D4RLMuJoCoDataset.batch(out))


@pytest.mark.parametrize("fake", ["fake_d4rl_dataset", "fake_d4rl_qlearning_dataset"])
def test_fake_data_matches_and_dims_match_eval_envs(fake):
    """The same seed gives the JAX package's arrays, and the hermetic
    fallback carries the eval env's obs/act dims for every task tier,
    including tiers absent from FAKE_ENV_SPECS (prefix fallback)."""
    for env_name, (o_dim, a_dim) in (
        ("antmaze-umaze-v2", (29, 8)),
        ("antmaze-umaze-diverse-v2", (29, 8)),
        ("antmaze-ultra-play-v2", (29, 8)),
        ("hopper-expert-v2", (11, 3)),
        ("kitchen-complete-v0", (60, 9)),
        ("maze2d-umaze-v1", (4, 2)),
    ):
        d = getattr(tds, fake)(env_name, n_steps=64, ep_len=16)
        want = getattr(jds, fake)(env_name, n_steps=64, ep_len=16)
        assert d["observations"].shape[1] == o_dim, env_name
        assert d["actions"].shape[1] == a_dim, env_name
        assert sorted(d) == sorted(want)
        for k in d:
            np.testing.assert_array_equal(d[k], want[k], err_msg=f"{env_name} {k}")


@pytest.mark.parametrize("kind", ["qlearning", "sequence"])
def test_goal2d_hermetic_data_matches(kind):
    from cleandiffuser_tpu.dataset import hermetic as jherm
    from cleandiffuser_tpu_torch.dataset import hermetic as therm

    jf = getattr(jherm, f"goal2d_{kind}_dataset")
    tf = getattr(therm, f"goal2d_{kind}_dataset")
    want, got = jf(n_episodes=50, seed=3), tf(n_episodes=50, seed=3)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("pads", [(0, 0), (2, 3), (7, 9)])
def test_create_indices_and_sequence_sampler(pads):
    """Windows with replication (and zero) padding over an episodic buffer."""

    class Buffer(dict):
        episode_ends = np.array([5, 12, 13, 20])

    rng = np.random.default_rng(0)
    buf = Buffer(obs=rng.standard_normal((20, 3)).astype(np.float32),
                 act=rng.standard_normal((20, 2)).astype(np.float32))
    want = jutils.create_indices(buf.episode_ends, 8, *pads)
    np.testing.assert_array_equal(tutils.create_indices(buf.episode_ends, 8, *pads), want)
    for zero in (False, True):
        kw = dict(pad_before=pads[0], pad_after=pads[1], zero_padding=zero,
                  key_first_k={"act": 2})
        js, ts = jutils.SequenceSampler(buf, 8, **kw), tutils.SequenceSampler(buf, 8, **kw)
        assert len(ts) == len(js) == len(want)
        for i in range(len(js)):
            a, b = js.sample_sequence(i), ts.sample_sequence(i)
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("name", ["GaussianNormalizer", "MinMaxNormalizer",
                                  "DatasetGaussianNormalizer", "DatasetMinMaxNormalizer",
                                  "CDFNormalizer", "ImageNormalizer", "EmptyNormalizer"])
def test_normalizers_match(name):
    """Statistics bit for bit; numpy in, numpy out as in JAX's; a torch
    tensor in gives a tensor on its device, within NORM_TOL."""
    X = np.random.default_rng(1).standard_normal((50, 4, 3)).astype(np.float32)
    X[..., 1] = 2.0  # a constant dimension
    x = np.random.default_rng(2).standard_normal((6, 4, 3)).astype(np.float32)
    args = () if name in ("ImageNormalizer", "EmptyNormalizer") else (X,)
    jn, tn = getattr(jnorm, name)(*args), getattr(tnorm, name)(*args)
    for fn in ("normalize", "unnormalize"):
        want = np.asarray(getattr(jn, fn)(x))
        np.testing.assert_allclose(getattr(tn, fn)(x), want, atol=NORM_TOL, rtol=NORM_TOL)
        if name != "CDFNormalizer":  # host data only, as in the reference
            got = getattr(tn, fn)(torch.from_numpy(x))
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, atol=NORM_TOL, rtol=NORM_TOL)


def test_data_loading_snapshot_else_synthetic(tmp_path, monkeypatch):
    """A snapshot under $CLEANDIFFUSER_DATA is read as it is; without one the
    synthetic fallback (the JAX package's arrays) is used."""
    from cleandiffuser_tpu_torch.pipelines import data_loading

    monkeypatch.setenv("CLEANDIFFUSER_DATA", str(tmp_path))
    snap = {"observations": np.ones((4, 2), np.float32), "actions": np.zeros((4, 1), np.float32)}
    np.savez(tmp_path / "hopper-medium-v2.npz", **snap)
    got = data_loading.load_d4rl_dataset("hopper-medium-v2")
    assert sorted(got) == sorted(snap)
    for k in snap:
        np.testing.assert_array_equal(got[k], snap[k])
    fake = data_loading.load_d4rl_qlearning_dataset("hopper-medium-v2")
    want = jds.fake_d4rl_qlearning_dataset("hopper-medium-v2", n_steps=100_000, ep_len=1000)
    for k in want:
        np.testing.assert_array_equal(fake[k], want[k], err_msg=k)


def test_device_stores_default_to_the_gpu(raw, raw_td):
    """Without a `device`, a dataset's device store takes the CUDA device and
    raises without one, saying how to ask for the CPU; it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tds.D4RLMuJoCoDataset(raw, horizon=4, max_path_length=200)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tds.D4RLMuJoCoTDDataset(raw_td)

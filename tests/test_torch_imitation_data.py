"""The port's imitation data path against the JAX package's: the replay
buffer (an .npz written by either package read by the other), the zarr-v2
directory store (tests/test_ingestion_fixtures.py's fixture writer), the
PushT state and keypoint datasets (every window, the normalisers and the
device gather at the JAX sampler's indices, bit for bit), the Kitchen
datasets over a relay-policy .npy archive and over raw .mjl logs, and
`MultiStepWrapper` over a stub env (observations, rewards, dones and
spaces equal to the JAX wrapper's step by step). Also the mirrors of
tests/test_imitation_data.py's buffer and PushT tests and of
tests/test_imitation_pipelines.py's combined keypoint normaliser."""

import jax
import numpy as np
import pytest
import torch

import cleandiffuser_tpu.dataset as jds
from cleandiffuser_tpu.dataset.kitchen import KitchenDataset as JaxKitchen
from cleandiffuser_tpu.dataset.kitchen import KitchenDatasetV2 as JaxKitchenV2
from cleandiffuser_tpu.dataset.kitchen import KitchenMjlDataset as JaxKitchenMjl
from cleandiffuser_tpu.dataset.mjl import parse_mjl_log as jax_parse_mjl
from cleandiffuser_tpu.env.wrapper import MultiStepWrapper as JaxMultiStep
from cleandiffuser_tpu_torch.dataset import (
    KitchenDataset,
    KitchenDatasetV2,
    KitchenMjlDataset,
    PushTKeypointDataset,
    PushTStateDataset,
    ReplayBuffer,
    generate_pusht_demos,
)
from cleandiffuser_tpu_torch.dataset.mjl import parse_mjl_log
from cleandiffuser_tpu_torch.env.wrapper import MultiStepWrapper, stack_last_n_obs
from test_ingestion_fixtures import _make_cchi_zarr

H, PB, PA = 8, 1, 7


@pytest.fixture(scope="module")
def demos():
    return generate_pusht_demos(n_episodes=3, max_steps=30, seed=0)


def _jax_buffer(rb):
    return jds.ReplayBuffer.create_from_data(dict(rb.data), rb.episode_ends)


# ---------------------------------------------------------------- buffer
def test_replay_buffer():
    rb = ReplayBuffer.create_empty_numpy()
    rb.add_episode({"state": np.ones((10, 5)), "action": np.zeros((10, 2))})
    rb.add_episode({"state": np.ones((7, 5)) * 2, "action": np.ones((7, 2))})
    assert rb.n_episodes == 2 and rb.n_steps == 17
    assert rb.get_episode(1)["state"].shape == (7, 5)
    np.testing.assert_array_equal(rb.episode_ends, [10, 17])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_written_by_either_package_reads_in_the_other(demos, tmp_path, writer):
    path = str(tmp_path / "demos.npz")
    if writer == "jax":
        _jax_buffer(demos).save_npz(path)
        back = ReplayBuffer.load_npz(path)
    else:
        demos.save_npz(path)
        back = jds.ReplayBuffer.load_npz(path)
    assert sorted(back.keys()) == sorted(demos.keys())
    for k in demos.keys():
        np.testing.assert_array_equal(back[k], demos[k])
        assert back[k].dtype == np.float32
    np.testing.assert_array_equal(back.episode_ends, demos.episode_ends)


def test_zarr_directory_store_reads_as_the_jax_package_reads_it(tmp_path):
    ref = _make_cchi_zarr(tmp_path / "mini.zarr")
    rb = ReplayBuffer.copy_from_path(str(tmp_path / "mini.zarr"))
    jrb = jds.ReplayBuffer.copy_from_path(str(tmp_path / "mini.zarr"))
    assert sorted(rb.keys()) == sorted(jrb.keys()) == ["action", "keypoint", "state"]
    for k in rb.keys():
        np.testing.assert_array_equal(rb[k], jrb[k])
        np.testing.assert_array_equal(rb[k], ref[k])
    np.testing.assert_array_equal(rb.episode_ends, ref["episode_ends"])
    ds = PushTStateDataset(str(tmp_path / "mini.zarr"), horizon=H, pad_before=PB, pad_after=PA,
                           device="cpu")
    assert ds[0]["obs"]["state"].shape == (H, 5) and len(ds) > 0


def test_zarr_blosc_store_raises_actionable_error(tmp_path):
    import json

    root = tmp_path / "blosc.zarr"
    _make_cchi_zarr(root, seed=3)
    meta_p = root / "data" / "state" / ".zarray"
    meta = json.loads(meta_p.read_text())
    meta["compressor"] = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}
    meta_p.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="blosc.*zarr"):
        ReplayBuffer.copy_from_path(str(root), keys=["state"])


# ---------------------------------------------------------------- PushT
def _same_normalizer(a, b):
    np.testing.assert_array_equal(a.min, b.min)
    np.testing.assert_array_equal(a.range, b.range)


@pytest.mark.parametrize("variant", ["state", "keypoint"])
def test_pusht_windows_and_normalizers_match_jax(demos, variant):
    P, J = ((PushTStateDataset, jds.PushTStateDataset) if variant == "state" else
            (PushTKeypointDataset, jds.PushTKeypointDataset))
    ds = P(demos, horizon=H, pad_before=PB, pad_after=PA, device="cpu")
    jd = J(_jax_buffer(demos), horizon=H, pad_before=PB, pad_after=PA)
    assert len(ds) == len(jd)
    for key in ds.normalizer["obs"]:
        _same_normalizer(ds.normalizer["obs"][key], jd.normalizer["obs"][key])
    _same_normalizer(ds.normalizer["action"], jd.normalizer["action"])
    for i in range(len(ds)):
        a, b = ds[i], jd[i]
        np.testing.assert_array_equal(a["obs"]["state"], b["obs"]["state"])
        np.testing.assert_array_equal(a["action"], b["action"])
    rng = jax.random.PRNGKey(3)
    want = jd.sample_batch(rng, 16)
    k = np.asarray(jax.random.randint(rng, (16,), 0, len(jd)))  # the JAX sampler's indices
    got = ds.gather(torch.from_numpy(k))
    np.testing.assert_array_equal(got["obs"]["state"].numpy(), np.asarray(want["obs"]["state"]))
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(want["action"]))
    batch = ds.sample_batch(torch.Generator().manual_seed(0), 16)
    obs_dim = 5 if variant == "state" else 20
    assert batch["obs"]["state"].shape == (16, H, obs_dim) and batch["action"].shape == (16, H, 2)
    assert batch["action"].abs().max() <= 1.0 + 1e-6


def test_pusht_keypoint_combined_normalizer(demos):
    ds = PushTKeypointDataset(demos, horizon=4, pad_before=1, pad_after=1, device="cpu")
    kp = demos["keypoint"].reshape(len(demos["keypoint"]), -1)
    agent = demos["state"][:, :2]
    combined = ds.normalizer["obs"]["state"].normalize(np.concatenate([kp, agent], -1))
    piecewise = np.concatenate([ds.normalizer["obs"]["keypoint"].normalize(kp),
                                ds.normalizer["obs"]["agent_pos"].normalize(agent)], -1)
    np.testing.assert_allclose(combined, piecewise, atol=1e-6)


def test_expert_demos_keep_only_solved_episodes():
    rb = generate_pusht_demos(n_episodes=2, max_steps=30, seed=1, expert=True,
                              mpc_kwargs=dict(n_samples=32, n_iters=2), device="cpu")
    assert set(rb.keys()) <= {"state", "action", "keypoint"}
    assert rb.n_episodes <= 2  # episodes that never reach the threshold are dropped


# ---------------------------------------------------------------- Kitchen
@pytest.fixture(scope="module")
def kitchen_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitchen")
    rng = np.random.default_rng(0)
    masks = np.zeros((3, 40), np.float32)
    for i, n in enumerate((40, 25, 33)):
        masks[i, :n] = 1
    np.save(d / "observations_seq.npy", rng.standard_normal((3, 40, 60)).astype(np.float32))
    np.save(d / "actions_seq.npy", rng.uniform(-1, 1, (3, 40, 9)).astype(np.float32))
    np.save(d / "existence_mask.npy", masks)
    return d


@pytest.mark.parametrize("v2", [False, True])
def test_kitchen_datasets_match_jax(kitchen_dir, v2):
    P, J = (KitchenDatasetV2, JaxKitchenV2) if v2 else (KitchenDataset, JaxKitchen)
    ds = P(kitchen_dir, horizon=H, pad_before=1, pad_after=7, device="cpu")
    jd = J(kitchen_dir, horizon=H, pad_before=1, pad_after=7)
    assert ds.replay_buffer.n_episodes == 3 and len(ds) == len(jd)
    np.testing.assert_array_equal(ds.replay_buffer.episode_ends, [40, 65, 98])
    _same_normalizer(ds.normalizer["obs"]["state"], jd.normalizer["obs"]["state"])
    _same_normalizer(ds.normalizer["action"], jd.normalizer["action"])
    for i in range(0, len(ds), 7):
        np.testing.assert_array_equal(ds[i]["obs"]["state"], jd[i]["obs"]["state"])
        np.testing.assert_array_equal(ds[i]["action"], jd[i]["action"])
    rng = jax.random.PRNGKey(1)
    want = jd.sample_batch(rng, 8)
    got = ds.gather(torch.from_numpy(np.asarray(jax.random.randint(rng, (8,), 0, len(jd)))))
    np.testing.assert_array_equal(got["obs"]["state"].numpy(), np.asarray(want["obs"]["state"]))
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(want["action"]))


def _write_mjl(path, T, seed, nq=30, nv=29, nu=9, nmocap=1, nsensor=3, nuser=0):
    """A MuJoCo .mjl log in the wire format dataset/mjl.py documents."""
    rng = np.random.default_rng(seed)
    name = b"kitchen\x00\x00"
    width = 1 + nq + nv + nu + 7 * nmocap + nsensor + nuser
    header = np.array([nq, nv, nu, nmocap, nsensor, nuser, len(name)], np.int32)
    rec = rng.standard_normal((T, width)).astype(np.float32)
    rec[:, 0] = np.arange(T) * 0.002
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(header.tobytes() + name + rec.tobytes())
    return rec


def test_mjl_parsing_and_mjl_dataset_match_jax(tmp_path):
    recs = [_write_mjl(tmp_path / "demos" / f"task{i}" / f"log{i}.mjl", 400 + 40 * i, i)
            for i in range(2)]
    (tmp_path / "demos" / "task9").mkdir()
    (tmp_path / "demos" / "task9" / "broken.mjl").write_bytes(b"\x00" * 10)  # skipped
    log, jlog = (f(str(tmp_path / "demos" / "task0" / "log0.mjl"), skip=40)
                 for f in (parse_mjl_log, jax_parse_mjl))
    for k in ("time", "qpos", "qvel", "ctrl", "mocap_pos", "mocap_quat", "sensordata"):
        np.testing.assert_array_equal(log[k], jlog[k])
    np.testing.assert_array_equal(log["qpos"], recs[0][::40, 1:31])
    assert log["name"] == jlog["name"] == "kitchen"
    ds = KitchenMjlDataset(tmp_path / "demos", horizon=4, pad_before=1, pad_after=3,
                           device="cpu")
    jd = JaxKitchenMjl(tmp_path / "demos", horizon=4, pad_before=1, pad_after=3)
    assert ds.replay_buffer.n_episodes == jd.replay_buffer.n_episodes == 2
    np.testing.assert_array_equal(ds.replay_buffer["state"], jd.replay_buffer["state"])
    np.testing.assert_array_equal(ds.replay_buffer["action"], jd.replay_buffer["action"])
    assert ds.replay_buffer["state"].shape[1] == 60
    with pytest.raises(FileNotFoundError):
        KitchenMjlDataset(tmp_path / "nothing", device="cpu")


# ---------------------------------------------------------------- MultiStepWrapper
class _StubEnv:
    """A deterministic env: obs = [t, a.sum()], reward t / 10, terminated at
    `end` (a gymnasium.Env, which the JAX wrapper requires)."""

    def __init__(self, end=7):
        import gymnasium as gym

        self.end = end
        self.observation_space = gym.spaces.Box(-np.inf, np.inf, (2,), np.float32)
        self.action_space = gym.spaces.Box(-1, 1, (3,), np.float32)
        self.t = 0

    def reset(self, seed=None, options=None):
        self.t = 0
        return np.array([0.0, 0.0], np.float32), {}

    def step(self, a):
        self.t += 1
        return (np.array([self.t, np.sum(a)], np.float32), self.t / 10.0, self.t >= self.end,
                False, {"t": self.t})

    def close(self):
        pass


def _stub(end):
    import gymnasium as gym

    cls = type("StubGymEnv", (_StubEnv, gym.Env), {})
    return cls(end)


@pytest.mark.parametrize("agg,max_steps", [("max", None), ("sum", 5), ("mean", None)])
def test_multistep_wrapper_matches_jax(agg, max_steps):
    kw = dict(n_obs_steps=3, n_action_steps=2, max_episode_steps=max_steps,
              reward_agg_method=agg)
    w, jw = MultiStepWrapper(_stub(7), **kw), JaxMultiStep(_stub(7), **kw)
    assert w.action_space == jw.action_space and w.observation_space == jw.observation_space
    o, _ = w.reset(seed=0)
    jo, _ = jw.reset(seed=0)
    np.testing.assert_array_equal(o, jo)
    assert o.shape == (3, 2)
    rng = np.random.default_rng(0)
    for _ in range(5):
        chunk = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
        out, jout = w.step(chunk), jw.step(chunk)
        np.testing.assert_array_equal(out[0], jout[0])
        assert out[1:4] == jout[1:4]
        assert {k: list(v) for k, v in out[4].items()} == {k: list(v) for k, v in jout[4].items()}


def test_stack_last_n_obs_front_pads():
    out = stack_last_n_obs([np.array([1.0]), np.array([2.0])], 4)
    np.testing.assert_array_equal(out[:, 0], [1.0, 1.0, 1.0, 2.0])

"""The port's robomimic data path (dataset/robomimic.py, env/robomimic.py,
the rotation conversions of dataset/dataset_utils.py, `fake_robomimic_buffer`)
against the JAX package's.

- `RotationTransformer` over every pair of representations (axis_angle,
  euler_angles, quaternion, rotation_6d, matrix), forward and inverse,
  within 1e-12 of the JAX package's numpy module.
- `abs_action_transform` / `undo_transform_action` for one and two arms,
  within 1e-12.
- An hdf5 file in robomimic's layout (data/demo_<i>/obs/<key>, actions,
  camera frames uint8) read by both packages, with and without
  `abs_action`: the buffers, normalisers, every window of the device store
  and `__getitem__` bit for bit (`RobomimicDataset`,
  `RobomimicImageDataset`, `RobomimicTDDataset`).
- `fake_robomimic_buffer`, with frames, equal to JAX's.
- The wrappers against a stub of robomimic's `EnvRobosuite`
  (tests/test_robomimic_wrappers.py): the same observations, rewards and
  flags as the JAX wrappers'; `create_robomimic_env` raises an ImportError
  that names robomimic where it is not installed.
"""

import json

import numpy as np
import pytest
import torch

import cleandiffuser_tpu.dataset.dataset_utils as jdu
import cleandiffuser_tpu.dataset.fake as jfake
import cleandiffuser_tpu.dataset.robomimic as jrobo
import cleandiffuser_tpu.env.robomimic as jenv
import cleandiffuser_tpu_torch.dataset.dataset_utils as tdu
import cleandiffuser_tpu_torch.dataset.fake as tfake
import cleandiffuser_tpu_torch.dataset.robomimic as trobo
import cleandiffuser_tpu_torch.env.robomimic as tenv
from test_robomimic_wrappers import StubEnvRobosuite

TOL = 1e-12
REPS = ["axis_angle", "euler_angles", "quaternion", "rotation_6d", "matrix"]


def _samples(rep, n=64, seed=0):
    """n inputs in `rep`, drawn around the whole rotation group (small and
    near-pi angles included)."""
    rng = np.random.default_rng(seed)
    aa = rng.standard_normal((n, 3))
    aa *= rng.uniform(0, np.pi, (n, 1)) / np.linalg.norm(aa, axis=-1, keepdims=True)
    aa[:2] *= 1e-9  # near the identity
    if rep == "axis_angle":
        return aa
    R = jdu.axis_angle_to_matrix(aa)
    if rep == "matrix":
        return R
    if rep == "euler_angles":
        return rng.uniform(-np.pi / 2 + 0.1, np.pi / 2 - 0.1, (n, 3))
    if rep == "quaternion":
        return jdu.matrix_to_quaternion(R)
    return jdu.matrix_to_rotation_6d(R) + rng.normal(0, 0.05, (n, 6))  # not orthonormal yet


@pytest.mark.parametrize("src,dst", [(a, b) for a in REPS for b in REPS if a != b])
def test_rotation_transformer_matches_jax(src, dst):
    x = _samples(src)
    jt, tt = jdu.RotationTransformer(src, dst), tdu.RotationTransformer(src, dst)
    fwd = tt.forward(x)
    np.testing.assert_allclose(fwd, jt.forward(x), atol=TOL, rtol=0)
    np.testing.assert_allclose(tt.inverse(fwd), jt.inverse(fwd), atol=TOL, rtol=0)


@pytest.mark.parametrize("arms", [1, 2])
def test_abs_action_transform_matches_jax(arms):
    rng = np.random.default_rng(1)
    raw = rng.uniform(-1, 1, (12, 7 * arms))
    jt, tt = jdu.RotationTransformer(), tdu.RotationTransformer()
    got = trobo.abs_action_transform(raw, tt)
    np.testing.assert_array_equal(got, jrobo.abs_action_transform(raw, jt))
    assert got.shape == (12, 10 * arms)
    back = trobo.undo_transform_action(got.astype(np.float64), tt)
    np.testing.assert_allclose(back, jrobo.undo_transform_action(got.astype(np.float64), jt),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(back, raw, atol=1e-6)


def _write_hdf5(path, lens=(9, 14, 6), image=8, seed=0):
    """A robomimic-layout hdf5: per demo the four low-dim keys, a camera's
    uint8 frames and axis-angle actions."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        data.attrs["env_args"] = json.dumps({"env_name": "Lift", "type": 1, "env_kwargs": {}})
        for i, T in enumerate(lens):
            d = data.create_group(f"demo_{i}")
            obs = d.create_group("obs")
            for key, dim in (("object", 10), ("robot0_eef_pos", 3), ("robot0_eef_quat", 4),
                             ("robot0_gripper_qpos", 2)):
                obs.create_dataset(key, data=rng.normal(size=(T, dim)))
            obs.create_dataset("agentview_image",
                               data=rng.integers(0, 256, (T, image, image, 3), dtype=np.uint8))
            act = np.concatenate([rng.uniform(-1, 1, (T, 3)), rng.uniform(-1, 1, (T, 3)),
                                  rng.uniform(-1, 1, (T, 1))], -1)
            d.create_dataset("actions", data=act)
    return str(path)


def _assert_same_dataset(tds, jds, obs_keys):
    for key in tds.replay_buffer.keys():
        np.testing.assert_array_equal(tds.replay_buffer[key], jds.replay_buffer[key])
    np.testing.assert_array_equal(tds.replay_buffer.episode_ends, jds.replay_buffer.episode_ends)
    for name in ("min", "max"):
        np.testing.assert_array_equal(getattr(tds.normalizer["obs"]["state"], name),
                                      getattr(jds.normalizer["obs"]["state"], name))
        np.testing.assert_array_equal(getattr(tds.normalizer["action"], name),
                                      getattr(jds.normalizer["action"], name))
    arrays, widx = jds._placed_store()
    rows = np.asarray(widx)
    got = tds.gather(torch.arange(len(tds)))
    assert len(tds) == len(jds) == len(rows)
    for key in obs_keys:
        np.testing.assert_array_equal(got["obs"][key].numpy(),
                                      np.asarray(arrays["obs"][key])[rows])
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(arrays["action"])[rows])
    for idx in (0, len(tds) // 2, len(tds) - 1):
        a, b = tds[idx], jds[idx]
        for key in obs_keys:
            np.testing.assert_array_equal(a["obs"][key], b["obs"][key])
        np.testing.assert_array_equal(a["action"], b["action"])


@pytest.mark.parametrize("abs_action", [False, True])
def test_hdf5_reads_equal_jax(tmp_path, abs_action):
    path = _write_hdf5(tmp_path / "demo.hdf5")
    kw = dict(horizon=6, pad_before=1, pad_after=5, abs_action=abs_action)
    tds = trobo.RobomimicDataset(path, device="cpu", **kw)
    _assert_same_dataset(tds, jrobo.RobomimicDataset(path, **kw), ["state"])
    assert tds.replay_buffer["action"].shape[-1] == (10 if abs_action else 7)
    if abs_action:  # the served actions back to the env's axis-angle
        chunk = tds.gather(torch.arange(2))["action"][:, 0].numpy()
        unnorm = tds.normalizer["action"].unnormalize(chunk)
        np.testing.assert_array_equal(
            tds.undo_transform_action(unnorm),
            jrobo.RobomimicDataset(path, **kw).undo_transform_action(unnorm))
    ikw = dict(kw, pad_after=0)
    tds = trobo.RobomimicImageDataset(path, device="cpu", **ikw)
    jds = jrobo.RobomimicImageDataset(path, **ikw)
    _assert_same_dataset(tds, jds, ["state", "agentview_image"])
    assert tds.gather(torch.arange(1))["obs"]["agentview_image"].dtype == torch.uint8
    td, jd = trobo.RobomimicTDDataset(path, device="cpu"), jrobo.RobomimicTDDataset(path)
    for idx in (0, 3):
        a, b = td[idx], jd[idx]
        for key in ("act", "rew", "tml"):
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a["next_obs"]["state"], b["next_obs"]["state"])


def test_fake_buffer_equals_jax():
    kw = dict(obs_dim=9, act_dim=7, n_episodes=3, ep_len=5, image_keys=("a", "b"),
              image_size=6, seed=3)
    got, want = tfake.fake_robomimic_buffer(**kw), jfake.fake_robomimic_buffer(**kw)
    assert set(got.keys()) == set(want.keys()) == {"obs", "action", "a", "b"}
    for key in got.keys():
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)


@pytest.mark.parametrize("image", [False, True])
def test_wrappers_match_jax_on_a_stub_env(image):
    make = lambda mod: (mod.RobomimicImageWrapper if image else mod.RobomimicLowdimWrapper)(
        StubEnvRobosuite(with_images=image))
    tw, jw = make(tenv), make(jenv)
    pairs = [(tw.reset(), jw.reset())]
    for _ in range(3):
        a = np.zeros(7, np.float32)
        pairs.append((tw.step(a), jw.step(a)))
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, dict):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
            elif isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w and type(g) is type(w)
    assert pairs[-1][0][2] is True  # done at the stub's third step


def test_create_env_names_robomimic_when_missing():
    try:
        import robomimic  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="robomimic"):
            tenv.create_robomimic_env({"env_name": "Lift"})
        return
    pytest.skip("robomimic is installed here")

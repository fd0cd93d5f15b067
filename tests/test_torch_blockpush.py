"""BlockPush (env/block_pushing.py, dataset/block_push.py) against the JAX
package's, and the host wrappers no pipeline uses.

- The step function from shared states: 64 envs (JAX reset states, the
  effector moved next to the blocks so that contacts happen) x 60 steps of
  seeded actions through both packages' `step`: states, obs and rewards
  within 1e-5 (float32 on both sides; the contact thresholds can flip on a
  rounding, and none does here), done flags equal.
- The JAX package's own cases (tests/test_blockpush_env.py: the obs
  contract, the single-block variant, a push that moves a block, the
  oracles' demos into the dataset, the multimodal oracle's 4 modes, the
  reach and discontinuous oracles) on the port; the dataset case of
  tests/test_env_wrappers_more_data.py. Resets draw from Philox here and
  from threefry there, so the episodes differ while the checks hold.
- `VideoWrapper`, `VideoRecordingWrapper` (a video file written through
  imageio), `make_sync_vector_env`, `make_async_vector_env` and the
  import-gated codec registration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleandiffuser_tpu.env import BlockPushMultimodalEnvJax
from cleandiffuser_tpu_torch.dataset import BlockPushDataset, ReplayBuffer
from cleandiffuser_tpu_torch.env import (
    BlockPushEnv,
    BlockPushMultimodalEnv,
    BlockPushState,
    generate_blockpush_demos,
    generate_blockpush_discontinuous_demos,
    generate_blockpush_reach_demos,
)
from cleandiffuser_tpu_torch.env.block_pushing import TARGET_R

torch.set_num_threads(2)
TOL = 1e-5


def test_step_matches_jax_from_shared_states():
    jenv, tenv = BlockPushMultimodalEnvJax(), BlockPushMultimodalEnv(device="cpu")
    n, steps = 64, 60
    jstate, _ = jenv.reset(jax.random.PRNGKey(0), n)
    rng = np.random.default_rng(1)
    # start the effector beside a block (either side), so that pushes happen
    blocks = np.asarray(jstate.blocks)
    side = rng.integers(2, size=n)
    eff = blocks[np.arange(n), side] + rng.uniform(-0.05, 0.05, (n, 2)).astype(np.float32)
    jstate = jstate._replace(effector=jnp.asarray(eff, jnp.float32))
    tstate = BlockPushState(*(torch.from_numpy(np.array(x)) for x in jstate))
    moved = 0.0
    for _ in range(steps):
        act = rng.uniform(-0.03, 0.03, (n, 2)).astype(np.float32)
        jstate, jobs, jrew, jdone = jenv.step(jstate, jnp.asarray(act))
        tstate, tobs, trew, tdone = tenv.step(tstate, torch.from_numpy(act))
        for name, a, b in zip(BlockPushState._fields, tstate, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL,
                                       err_msg=name)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    moved = np.abs(tstate.blocks.numpy() - blocks).max()
    assert moved > 0.01  # the contact ran


# ---------------------------------------------------------------------------
# tests/test_blockpush_env.py, on the port
def test_multimodal_obs_contract():
    env = BlockPushMultimodalEnv(device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(0), 3)
    assert obs.shape == (3, 16)
    state, obs, rew, done = env.step(state, torch.zeros(3, 2))
    assert obs.shape == (3, 16) and rew.shape == (3,) and done.shape == (3,)
    assert torch.all(rew == 0.0)


def test_single_block_variant_parks_second():
    env = BlockPushEnv(device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(0), 2)
    assert torch.all(state.blocks[:, 1] == 10.0) and torch.all(state.targets[:, 1] == -10.0)
    assert obs.shape == (2, 16)


def test_push_moves_block():
    env = BlockPushMultimodalEnv(device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(0), 1)
    b0 = state.blocks[:, 0]
    state = state._replace(effector=b0 - torch.tensor([[0.04, 0.0]]))
    before = b0.clone()
    for _ in range(8):
        state, _, _, _ = env.step(state, torch.tensor([[0.025, 0.0]]))
    assert state.blocks[0, 0, 0] > before[0, 0] + 0.005  # pushed along +x


def test_oracle_demos_feed_dataset():
    rb = generate_blockpush_demos(n_episodes=2, max_steps=80, seed=0)
    assert rb["obs"].shape[-1] == 16 and rb["action"].shape[-1] == 2
    ds = BlockPushDataset(rb, horizon=4, pad_before=1, pad_after=3, device="cpu")
    batch = ds.sample_batch(torch.Generator().manual_seed(0), 4)
    assert batch["obs"]["state"].shape == (4, 4, 16)
    assert torch.all(batch["action"].abs() <= 1.0 + 1e-6)
    # the device gather serves what __getitem__ serves
    k = torch.tensor([0, len(ds) - 1])
    got = ds.gather(k)
    for j, i in enumerate(k.tolist()):
        np.testing.assert_allclose(got["obs"]["state"][j].numpy(), ds[i]["obs"]["state"])
        np.testing.assert_allclose(got["action"][j].numpy(), ds[i]["action"])


def test_multimodal_oracle_covers_four_modes():
    rb = generate_blockpush_demos(n_episodes=12, max_steps=200, seed=3)
    first_pushed, assigns = set(), set()
    for ep in range(rb.n_episodes):
        obs = rb.get_episode(ep)["obs"]
        b0, b1 = obs[:, 0:2], obs[:, 3:5]
        t0, t1 = obs[0, 10:12], obs[0, 13:15]
        m0 = np.linalg.norm(b0 - b0[0], axis=-1) > 0.01
        m1 = np.linalg.norm(b1 - b1[0], axis=-1) > 0.01
        if m0.any() and m1.any():
            first_pushed.add(0 if m0.argmax() < m1.argmax() else 1)
        d00, d01 = np.linalg.norm(b0[-1] - t0), np.linalg.norm(b0[-1] - t1)
        if min(d00, d01) < TARGET_R:
            assigns.add(0 if d00 < d01 else 1)
    assert first_pushed == {0, 1}, f"push orders seen: {first_pushed}"
    assert assigns == {0, 1}, f"assignments seen: {assigns}"


def test_reach_oracle_reaches_without_touching():
    rb = generate_blockpush_reach_demos(n_episodes=4, max_steps=120, seed=0)
    for ep in range(rb.n_episodes):
        obs = rb.get_episode(ep)["obs"]
        eff = obs[:, 8:10]
        t0, t1 = obs[0, 10:12], obs[0, 13:15]
        d = min(np.linalg.norm(eff[-1] - t0), np.linalg.norm(eff[-1] - t1))
        assert d < TARGET_R, f"episode {ep} never reached a target ({d:.3f})"
        for sl in (slice(0, 2), slice(3, 5)):
            assert np.linalg.norm(obs[-1, sl] - obs[0, sl]) < 1e-5


def test_discontinuous_oracle_switches_midway_and_succeeds():
    rb = generate_blockpush_discontinuous_demos(n_episodes=6, max_steps=260, seed=1)
    n_success = n_switch = 0
    for ep in range(rb.n_episodes):
        obs = rb.get_episode(ep)["obs"]
        b = [obs[:, 0:2], obs[:, 3:5]]
        t = [obs[0, 10:12], obs[0, 13:15]]
        d = np.array([[np.linalg.norm(b[i][-1] - t[j]) for j in (0, 1)] for i in (0, 1)])
        hit = d < TARGET_R
        if (hit[0, 0] and hit[1, 1]) or (hit[0, 1] and hit[1, 0]):
            n_success += 1
        for bi in (0, 1):
            sp = np.linalg.norm(np.diff(b[bi], axis=0), axis=-1) > 1e-4
            if sp.any():
                first, last = sp.argmax(), len(sp) - 1 - sp[::-1].argmax()
                if (~sp[first:last]).sum() > 15:
                    n_switch += 1
                    break
    assert n_success >= 4, f"only {n_success}/6 succeeded"
    assert n_switch >= 4, f"only {n_switch}/6 showed the mid-task switch"


def test_block_push_dataset():
    rb = ReplayBuffer.create_empty_numpy()
    rng = np.random.default_rng(0)
    rb.add_episode({"obs": rng.standard_normal((40, 16)).astype(np.float32),
                    "action": rng.standard_normal((40, 2)).astype(np.float32)})
    ds = BlockPushDataset(rb, horizon=5, pad_before=1, pad_after=3, device="cpu")
    assert ds[0]["obs"]["state"].shape == (5, 16)


# ---------------------------------------------------------------------------
# env/wrapper.py, env/async_vector.py, dataset/imagecodecs_compat.py
class _FrameEnv:
    """A host env whose frame is its step count."""

    def __init__(self):
        self.t, self.closed = 0, False

    def reset(self, seed=None):
        self.t = 0
        return np.zeros(2, np.float32), {}

    def step(self, action):
        self.t += 1
        return np.full(2, self.t, np.float32), 1.0, False, False, {}

    def render(self):
        return np.full((16, 16, 3), 10 * self.t, np.uint8)

    def close(self):
        self.closed = True


def test_video_wrappers(tmp_path):
    from cleandiffuser_tpu_torch.env import VideoRecorder, VideoRecordingWrapper, VideoWrapper

    env = VideoWrapper(_FrameEnv(), steps_per_render=2)
    env.reset()
    for _ in range(4):
        env.step(0)
    video = env.get_video()
    # the reset's frame, then every second step (step counts 2 and 4 of 1..5)
    assert video.shape == (3, 16, 16, 3) and list(video[:, 0, 0, 0]) == [0, 10, 30]
    assert env.t == 4  # attributes pass through

    path = tmp_path / "ep.gif"  # imageio's pillow backend: this host has no ffmpeg
    rec = VideoRecordingWrapper(_FrameEnv(), VideoRecorder(fps=5), file_path=str(path))
    rec.reset()
    for _ in range(3):
        rec.step(0)
    assert len(rec.video_recorder.frames) == 4
    rec.stop()
    assert path.stat().st_size > 0 and rec.video_recorder.frames == []
    rec.close()
    assert rec.env.closed


def test_vector_envs_and_codec_gate():
    import gymnasium as gym

    from cleandiffuser_tpu_torch.dataset import imagecodecs_compat
    from cleandiffuser_tpu_torch.env import make_async_vector_env, make_sync_vector_env

    sync = make_sync_vector_env([lambda: gym.make("CartPole-v1")] * 2)
    obs, _ = sync.reset(seed=0)
    assert obs.shape == (2, 4)
    sync.close()
    env = make_async_vector_env([lambda: gym.make("CartPole-v1")] * 2)
    try:
        obs, _ = env.reset(seed=0)
        obs, rew, term, trunc, _ = env.step(np.zeros(2, np.int64))
        assert obs.shape == (2, 4) and rew.shape == (2,)
    finally:
        env.close()
    try:
        import imagecodecs  # noqa: F401
    except ImportError:
        assert imagecodecs_compat.Jpeg2k is None
        with pytest.raises(ImportError, match="imagecodecs is not installed"):
            imagecodecs_compat.register_codecs()

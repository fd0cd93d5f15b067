"""The port's PushT renderer, image env and image dataset (env/pusht.py,
dataset/pusht.py) against the JAX package's.

- `render_state` of a batch of seeded states (agents near and on blocks)
  equals JAX's per-state render pixel for pixel, except pixels whose
  signed distance to the goal T, the block T or the agent circle lies
  within 1e-4 of 0, where float rounding decides (their count printed).
- `PushTImageEnv.get_obs` (the frame as (3, H, W) in [0, 1], the agent's
  position) against `PushTImageEnvJax.get_obs`, at a reset and a step
  later, by the same rule.
- `PushTImageDataset` from one buffer: the normalisers, every window of
  the device store (uint8 frames, normalised positions and actions) and
  `__getitem__` equal JAX's bit for bit.
- The demos with frames, both paths: the scripted pusher's frames are its
  states' renders (JAX's, by the same rule) and leave its states and
  actions as they are without frames; the expert's path renders the
  episodes after the rollout in chunks (the expert stood in for by fixed
  episodes on both sides) and equals JAX's expert buffer by the same rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleandiffuser_tpu.env.pusht_expert as jexpert
import cleandiffuser_tpu_torch.dataset.pusht as tpusht
import cleandiffuser_tpu_torch.env.pusht_expert as texpert
from cleandiffuser_tpu.dataset import PushTImageDataset as JaxPushTImage
from cleandiffuser_tpu.dataset import ReplayBuffer as JaxReplayBuffer
from cleandiffuser_tpu.dataset.pusht import generate_pusht_demos as jax_demos
from cleandiffuser_tpu.env.pusht_jax import PushTEnvJax, PushTImageEnvJax
from cleandiffuser_tpu.env.pusht_jax import PushTState as JaxState
from cleandiffuser_tpu_torch.dataset import PushTImageDataset, generate_pusht_demos
from cleandiffuser_tpu_torch.env.pusht import PushTImageEnv, PushTState, render_sdfs, render_state

torch.set_num_threads(2)

BAND, SIZE = 1e-4, 96


def _states(n=48, seed=0):
    """Seeded states, the agent within 40 px of the block for half of them."""
    rng = np.random.default_rng(seed)
    block = rng.uniform(100, 400, (n, 2))
    agent = np.where(np.arange(n)[:, None] % 2 == 0, block + rng.uniform(-40, 40, (n, 2)),
                     rng.uniform(50, 450, (n, 2)))
    return np.concatenate([agent, block, rng.uniform(-np.pi, np.pi, (n, 1))], -1).astype(
        np.float32)


def _port_state(s):
    s = torch.from_numpy(np.asarray(s, np.float32))
    return PushTState(s[:, :2], torch.zeros_like(s[:, :2]), s[:, 2:4], s[:, 4])


def _jax_render(states, size=SIZE):
    s = jnp.asarray(states)
    js = JaxState(s[:, :2], jnp.zeros_like(s[:, :2]), s[:, 2:4], s[:, 4])
    env = PushTEnvJax()
    return np.asarray(jax.jit(jax.vmap(lambda x: env.render_state(x, size)))(js))


def _band(states, size=SIZE):
    sd_goal, sd_block, sd_agent = render_sdfs(_port_state(states), size)
    return ((sd_goal.abs() < BAND) | (sd_block.abs() < BAND) | (sd_agent.abs() < BAND)).numpy()


def _assert_frames_equal(got, want, states, size=SIZE):
    """Pixel for pixel outside the SDF band; returns the band's pixels
    that differ and the band's size."""
    diff = (got != want).reshape(got.shape[:3] + (-1,)).any(-1)
    band = _band(states, size)
    assert not (diff & ~band).any(), f"{int((diff & ~band).sum())} pixels differ outside the band"
    print(f"{int((diff & band).sum())} of {int(band.sum())} band pixels differ "
          f"({diff.size} pixels)")
    return int((diff & band).sum()), int(band.sum())


def test_render_state_matches_jax():
    states = _states()
    got = render_state(_port_state(states), SIZE).numpy()
    assert got.shape == (len(states), SIZE, SIZE, 3) and got.dtype == np.uint8
    _, band = _assert_frames_equal(got, _jax_render(states), states)
    assert band > 0  # the boundaries the rule leaves out exist
    # the four colours appear: background, goal, block, agent
    colours = {tuple(c) for c in got.reshape(-1, 3)}
    assert {(255, 255, 255), (144, 238, 144), (119, 136, 153), (65, 105, 225)} <= colours


def test_image_env_obs_matches_jax():
    states = _states(8, seed=1)
    jenv, tenv = PushTImageEnvJax(render_size=SIZE), PushTImageEnv(render_size=SIZE,
                                                                    device="cpu")
    s = jnp.asarray(states)
    jstate = JaxState(s[:, :2], jnp.zeros_like(s[:, :2]), s[:, 2:4], s[:, 4])
    tstate, tobs = tenv.reset(batch=8, reset_to_state=torch.from_numpy(states))
    actions = states[:, :2] + np.random.default_rng(2).uniform(-30, 30, (8, 2)).astype(np.float32)
    get_obs = jax.jit(jenv.get_obs)
    for step in range(2):
        jobs = get_obs(jstate)
        assert tobs["image"].shape == (8, 3, SIZE, SIZE) and tobs["image"].dtype == torch.float32
        np.testing.assert_array_equal(tobs["agent_pos"].numpy(), np.asarray(jobs["agent_pos"]))
        now = np.concatenate([tobs["agent_pos"].numpy(), tstate.block_pos.numpy(),
                              tstate.block_angle.numpy()[:, None]], -1)
        to_u8 = lambda img: np.round(np.moveaxis(np.asarray(img), 1, -1) * 255).astype(np.uint8)
        _assert_frames_equal(to_u8(tobs["image"].numpy()), to_u8(jobs["image"]), now)
        if step == 0:
            jstate, _, _, _ = jenv.step(jstate, jnp.asarray(actions))
            tstate, tobs, _, _ = tenv.step(tstate, torch.from_numpy(actions))


@pytest.fixture(scope="module")
def buffer():
    return generate_pusht_demos(n_episodes=2, max_steps=25, seed=0, with_images=True,
                                image_size=32)


def test_image_dataset_matches_jax(buffer):
    kw = dict(horizon=10, pad_before=1, pad_after=7)
    jrb = JaxReplayBuffer.create_from_data(dict(buffer.data), buffer.episode_ends)
    jds, tds = JaxPushTImage(jrb, **kw), PushTImageDataset(buffer, device="cpu", **kw)
    assert len(jds) == len(tds)
    for key in ("agent_pos",):
        for attr in ("min", "max"):
            np.testing.assert_array_equal(getattr(tds.normalizer["obs"][key], attr),
                                          getattr(jds.normalizer["obs"][key], attr))
    arrays, widx = jds._placed_store()
    got = tds.gather(torch.arange(len(tds)))
    rows = np.asarray(widx)
    for key in ("image", "agent_pos"):
        want = np.asarray(arrays["obs"][key])[rows]
        assert got["obs"][key].numpy().dtype == want.dtype
        np.testing.assert_array_equal(got["obs"][key].numpy(), want)
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(arrays["action"])[rows])
    for idx in (0, 5, len(tds) - 1):
        a, b = tds[idx], jds[idx]
        for key in ("image", "agent_pos"):
            np.testing.assert_array_equal(a["obs"][key], b["obs"][key])
        np.testing.assert_array_equal(a["action"], b["action"])


def test_scripted_demos_with_frames(buffer):
    plain = generate_pusht_demos(n_episodes=2, max_steps=25, seed=0)
    for key in ("state", "action", "keypoint"):
        np.testing.assert_array_equal(buffer[key], plain[key])
    assert buffer["img"].shape == (buffer.n_steps, 32, 32, 3) and buffer["img"].dtype == np.uint8
    _assert_frames_equal(buffer["img"], _jax_render(buffer["state"], 32), buffer["state"], 32)
    # the JAX package's scripted path renders the same way (its own episodes)
    jrb = jax_demos(n_episodes=1, max_steps=6, seed=0, with_images=True, image_size=32)
    _assert_frames_equal(render_state(_port_state(jrb["state"]), 32).numpy(), jrb["img"],
                         jrb["state"], 32)


def test_expert_demos_rendered_after_the_rollout(buffer, monkeypatch):
    """The expert's path, the expert stood in for by the scripted episodes:
    the frames rendered in chunks (RENDER_CHUNK cut to 16 to cross them)
    equal JAX's expert buffer's."""
    ends = np.concatenate([[0], buffer.episode_ends])
    episodes = [{k: buffer[k][a:b] for k in ("state", "action", "keypoint")}
                for a, b in zip(ends[:-1], ends[1:])]
    stand_in = lambda **kw: ([dict(ep) for ep in episodes], [1.0] * len(episodes))
    monkeypatch.setattr(texpert, "generate_pusht_expert_trajectories", stand_in)
    monkeypatch.setattr(jexpert, "generate_pusht_expert_trajectories", stand_in)
    monkeypatch.setattr(tpusht, "RENDER_CHUNK", 16)
    got = generate_pusht_demos(n_episodes=2, max_steps=25, expert=True, with_images=True,
                               image_size=32, device="cpu")
    want = jax_demos(n_episodes=2, max_steps=25, expert=True, with_images=True, image_size=32)
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    for key in ("state", "action", "keypoint"):
        np.testing.assert_array_equal(got[key], want[key])
    _assert_frames_equal(got["img"], want["img"], got["state"], 32)

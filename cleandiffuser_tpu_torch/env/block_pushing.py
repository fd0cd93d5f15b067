"""BlockPush, batched on the device (counterpart of
cleandiffuser_tpu/env/block_pushing_jax.py).

    env = BlockPushMultimodalEnv(device="cpu")    # the CUDA device by default
    state, obs = env.reset(generator, batch)
    state, obs, reward, done = env.step(state, action)

The reference's pybullet xArm simulation was rewritten by the JAX package
as a pure function over a batch of states; the port keeps that model op
for op, in torch on the device (no pipeline uses it; its callers are the
demo generators and `BlockPushDataset`):

- a planar effector (radius 0.015) moved by 2-dim displacement actions,
  clipped to 0.025 per control step and applied in `N_SUB` = 4 substeps,
  the effector clipped to the workspace [0.15, 0.75] x [-0.35, 0.35];
- two 4 cm blocks pushed by a quasi-static circle-vs-square contact: the
  block slides out along the box's outward normal (central differences of
  its signed distance at 1e-4) by the penetration, and turns by 40 x the
  contact's lever times the penetration;
- the 16-dim observation of the released multimodal demos: [block0 xy,
  block0 angle, block1 xy, block1 angle, effector xy, effector target xy
  (the effector again), target0 xy, target0 angle, target1 xy, target1
  angle];
- reward 0.49 for block 0 and 0.51 for block 1 in any target zone
  (radius 0.05); done when the two blocks rest in distinct targets.

`BlockPushEnv` is the single-block variant: the second block parked at
(10, 10) and its target at (-10, -10), the 16-dim layout kept.

Resets draw from an explicit `torch.Generator` (Philox), the reference
from threefry keys: the states differ, the step function does not (the
tests hold it to the reference's from shared states).

The scripted oracles (`generate_blockpush_demos`: block-to-target
assignment x push order, 4 modes; `generate_blockpush_reach_demos`;
`generate_blockpush_discontinuous_demos`) read the state back at every
step, so they roll one episode at a time on the CPU, as the reference's
do; each episode's mode is drawn from `np.random.default_rng(seed)`, as
the reference draws it, so both packages pick the same modes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.tensors import default_device

__all__ = ["BlockPushState", "BlockPushMultimodalEnv", "BlockPushEnv",
           "generate_blockpush_demos", "generate_blockpush_reach_demos",
           "generate_blockpush_discontinuous_demos"]

WS_LO = np.array([0.15, -0.35], np.float32)
WS_HI = np.array([0.75, 0.35], np.float32)
BLOCK_HALF = 0.02
EFFECTOR_R = 0.015
TARGET_R = 0.05
STEP_LIMIT = 0.025
N_SUB = 4
_EPS = 1e-4  # the central difference of the contact normal


class BlockPushState(NamedTuple):
    effector: torch.Tensor  # (..., 2)
    blocks: torch.Tensor  # (..., 2, 2) xy per block
    block_angles: torch.Tensor  # (..., 2)
    targets: torch.Tensor  # (..., 2, 2) xy per target
    target_angles: torch.Tensor  # (..., 2)


def _sd_box(px, py, half: float):
    """Signed distance of local-frame points (px, py) to the square of
    half-side `half`, negative inside."""
    qx, qy = px.abs() - half, py.abs() - half
    outside = torch.sqrt(qx.clamp(min=0.0) ** 2 + qy.clamp(min=0.0) ** 2)
    return outside + torch.maximum(qx, qy).clamp(max=0.0)


def _push_block(eff, block, angle):
    """Quasi-static circle-vs-square contact for one block: (new block xy,
    new angle)."""
    c, s = torch.cos(angle), torch.sin(angle)
    dx, dy = eff[..., 0] - block[..., 0], eff[..., 1] - block[..., 1]
    # the row vector (eff - block) times R(angle)
    px, py = dx * c + dy * s, dx * (-s) + dy * c
    pen = (EFFECTOR_R - _sd_box(px, py, BLOCK_HALF)).clamp(min=0.0)
    gx = _sd_box(px + _EPS, py, BLOCK_HALF) - _sd_box(px - _EPS, py, BLOCK_HALF)
    gy = _sd_box(px, py + _EPS, BLOCK_HALF) - _sd_box(px, py - _EPS, BLOCK_HALF)
    norm = torch.sqrt(gx * gx + gy * gy) + 1e-8
    nx, ny = gx / norm, gy / norm
    n_world = torch.stack([c * nx + (-s) * ny, s * nx + c * ny], -1)
    new_block = block - n_world * pen[..., None]
    lever = px * ny - py * nx
    return new_block, angle - lever * pen * 40.0


class BlockPushMultimodalEnv:
    """Two blocks, two targets, batched on `device` (the CUDA device unless
    the caller names another); states are `BlockPushState`s of tensors
    there. obs: the 16-dim layout of the module note."""

    obs_dim = 16
    act_dim = 2
    n_blocks = 2

    def __init__(self, device=None):
        self.device = default_device(device)
        self.ws_lo = torch.as_tensor(WS_LO, device=self.device)
        self.ws_hi = torch.as_tensor(WS_HI, device=self.device)

    def reset(self, generator: Optional[torch.Generator] = None, batch: int = 1):
        """`batch` states drawn from `generator` (on the env's device): the
        effector at x 0.3, y in [-0.05, 0.05]; the blocks at x in [0.35,
        0.45], y -0.12 and 0.12 each +- 0.03, angles in [-0.3, 0.3]; the
        targets at (0.65, -0.2) and (0.65, 0.2)."""
        dev = self.device
        uniform = lambda shape, lo, hi: torch.rand(shape, generator=generator,
                                                   device=dev) * (hi - lo) + lo
        eff = torch.stack([torch.full((batch,), 0.3, device=dev),
                           uniform((batch,), -0.05, 0.05)], -1)
        bx = uniform((batch, 2), 0.35, 0.45)
        by = torch.tensor([-0.12, 0.12], device=dev)[None] + uniform((batch, 2), -0.03, 0.03)
        angles = uniform((batch, 2), -0.3, 0.3)
        tx = torch.full((batch, 2), 0.65, device=dev)
        ty = torch.tensor([-0.2, 0.2], device=dev)[None].expand(batch, 2)
        state = BlockPushState(eff, torch.stack([bx, by], -1), angles,
                               torch.stack([tx, ty], -1), torch.zeros(batch, 2, device=dev))
        return state, self.get_obs(state)

    def get_obs(self, state: BlockPushState):
        b, t = state.blocks, state.targets
        return torch.cat([
            b[..., 0, :], state.block_angles[..., 0:1],
            b[..., 1, :], state.block_angles[..., 1:2],
            state.effector, state.effector,  # the effector's target is its position
            t[..., 0, :], state.target_angles[..., 0:1],
            t[..., 1, :], state.target_angles[..., 1:2],
        ], -1)

    def step(self, state: BlockPushState, action):
        """`N_SUB` contact substeps of the clipped displacement `action`
        (batch, 2); returns (state, obs, reward, done)."""
        delta = action.clamp(-STEP_LIMIT, STEP_LIMIT)
        eff, blocks, angles = state.effector, state.blocks, state.block_angles
        for _ in range(N_SUB):
            eff = torch.minimum(torch.maximum(eff + delta / N_SUB, self.ws_lo), self.ws_hi)
            b0, a0 = _push_block(eff, blocks[..., 0, :], angles[..., 0])
            b1, a1 = _push_block(eff, blocks[..., 1, :], angles[..., 1])
            blocks, angles = torch.stack([b0, b1], -2), torch.stack([a0, a1], -1)
        state = state._replace(effector=eff, blocks=blocks, block_angles=angles)
        d = torch.linalg.vector_norm(blocks[..., :, None, :] - state.targets[..., None, :, :],
                                     dim=-1)  # (..., block, target)
        hit = d < TARGET_R
        reward = 0.49 * hit[..., 0, :].any(-1).float() + 0.51 * hit[..., 1, :].any(-1).float()
        distinct = (hit[..., 0, 0] & hit[..., 1, 1]) | (hit[..., 0, 1] & hit[..., 1, 0])
        return state, self.get_obs(state), reward, distinct


class BlockPushEnv(BlockPushMultimodalEnv):
    """One block and one target: the second block parked at (10, 10) and
    its target at (-10, -10), so the 16-dim layout holds."""

    def reset(self, generator: Optional[torch.Generator] = None, batch: int = 1):
        state, _ = super().reset(generator, batch)
        blocks, targets = state.blocks.clone(), state.targets.clone()
        blocks[:, 1] = 10.0
        targets[:, 1] = -10.0
        state = state._replace(blocks=blocks, targets=targets)
        return state, self.get_obs(state)


# ---------------------------------------------------------------------------
# Scripted oracles, one episode at a time on the CPU (module note)
def _push_action(s0, block, target, standoff: float = 0.01):
    """Oriented push: move behind the block on the block->target ray, then
    push through it."""
    push_dir = target - block
    push_dir = push_dir / (np.linalg.norm(push_dir) + 1e-8)
    behind = block - push_dir * (BLOCK_HALF + EFFECTOR_R + standoff)
    to_behind = behind - s0.effector
    action = to_behind if np.linalg.norm(to_behind) > 0.02 else push_dir * STEP_LIMIT
    return np.clip(action, -STEP_LIMIT, STEP_LIMIT).astype(np.float32)


def _rollout_oracle(env, policy_fn, n_episodes: int, max_steps: int, seed: int, mode_fn=None):
    """Roll `policy_fn(s0, t, mode) -> action | None` episodes (None ends
    one) into a ReplayBuffer of "obs" and "action"; `mode_fn(np_rng)` draws
    each episode's mode. A done step appends the last obs with a zero
    action."""
    from ..dataset.replay_buffer import ReplayBuffer

    generator = torch.Generator().manual_seed(seed)
    np_rng = np.random.default_rng(seed)
    rb = ReplayBuffer.create_empty_numpy()
    for _ in range(n_episodes):
        state, obs = env.reset(generator, 1)
        mode = mode_fn(np_rng) if mode_fn is not None else None
        obs_l, act_l = [], []
        for t in range(max_steps):
            s0 = BlockPushState(*(x[0].numpy() for x in state))
            action = policy_fn(s0, t, mode)
            if action is None:
                break
            obs_l.append(obs[0].numpy())
            act_l.append(action)
            state, obs, _, done = env.step(state, torch.from_numpy(action)[None])
            if bool(done[0]):
                obs_l.append(obs[0].numpy())
                act_l.append(np.zeros(2, np.float32))
                break
        rb.add_episode({"obs": np.asarray(obs_l, np.float32),
                        "action": np.asarray(act_l, np.float32)})
    return rb


def generate_blockpush_demos(n_episodes: int = 16, max_steps: int = 200, seed: int = 0):
    """The multimodal oracle: 4 modes per episode, a random block->target
    assignment x a random push order. Returns a ReplayBuffer with the
    16-dim obs and 2-dim actions."""
    env = BlockPushMultimodalEnv(device="cpu")

    def mode_fn(np_rng):
        assign = (0, 1) if np_rng.random() < 0.5 else (1, 0)
        order = (0, 1) if np_rng.random() < 0.5 else (1, 0)
        return assign, order

    def policy(s0, t, mode):
        assign, order = mode
        for bi in order:  # the first block not yet in its target, in this order
            if np.linalg.norm(s0.blocks[bi] - s0.targets[assign[bi]]) > TARGET_R * 0.8:
                return _push_action(s0, s0.blocks[bi], s0.targets[assign[bi]])
        return None

    return _rollout_oracle(env, policy, n_episodes, max_steps, seed, mode_fn)


def generate_blockpush_reach_demos(n_episodes: int = 16, max_steps: int = 120, seed: int = 0):
    """The reach oracle: drive the effector to a random target zone without
    touching the blocks, through a waypoint lane at |y| = 0.28 outside the
    blocks' rows."""
    env = BlockPushMultimodalEnv(device="cpu")

    def mode_fn(np_rng):
        return int(np_rng.integers(2))

    def policy(s0, t, mode):
        target = s0.targets[mode]
        lane_y = np.sign(target[1]) * 0.28
        if abs(s0.effector[1] - lane_y) > 0.02 and s0.effector[0] < target[0] - 0.02:
            goal = np.array([s0.effector[0], lane_y], np.float32)
        elif s0.effector[0] < target[0] - 0.02:
            goal = np.array([target[0], lane_y], np.float32)
        else:
            goal = target
        if np.linalg.norm(target - s0.effector) < 0.01:
            return None
        return np.clip(goal - s0.effector, -STEP_LIMIT, STEP_LIMIT).astype(np.float32)

    return _rollout_oracle(env, policy, n_episodes, max_steps, seed, mode_fn)


def generate_blockpush_discontinuous_demos(n_episodes: int = 16, max_steps: int = 260,
                                           seed: int = 0):
    """The discontinuous oracle: push the first block halfway to its
    target, finish the second block, then return to finish the first."""
    env = BlockPushMultimodalEnv(device="cpu")

    def mode_fn(np_rng):
        assign = (0, 1) if np_rng.random() < 0.5 else (1, 0)
        first = int(np_rng.integers(2))
        return assign, first, {"half_done": False, "start": None}

    def policy(s0, t, mode):
        assign, first, st = mode
        second = 1 - first
        tgt_f, tgt_s = s0.targets[assign[first]], s0.targets[assign[second]]
        if st["start"] is None:
            st["start"] = s0.blocks[first].copy()
        half_point = 0.5 * (st["start"] + tgt_f)
        if not st["half_done"]:
            # aim at the half point itself: aiming at the target while
            # stopping near the half point lets a lateral miss sail past
            if np.linalg.norm(s0.blocks[first] - half_point) > TARGET_R * 0.6:
                return _push_action(s0, s0.blocks[first], half_point)
            st["half_done"] = True
        if np.linalg.norm(s0.blocks[second] - tgt_s) > TARGET_R * 0.8:
            return _push_action(s0, s0.blocks[second], tgt_s)
        if np.linalg.norm(s0.blocks[first] - tgt_f) > TARGET_R * 0.8:
            return _push_action(s0, s0.blocks[first], tgt_f)
        return None

    return _rollout_oracle(env, policy, n_episodes, max_steps, seed, mode_fn)

"""PushT, batched on the device (counterpart of
cleandiffuser_tpu/env/pusht_jax.py `PushTEnvJax` and `PushTKeypointEnvJax`).

    env = PushTEnv(device="cpu")                  # the CUDA device by default
    state, obs = env.reset(generator, batch)      # or reset_to_state=(batch, 5)
    state, obs, reward, done = env.step(state, action)

The reference's pymunk PushT steps one env per process; the JAX package
rewrote it as a pure function over a batch of states, and the port keeps
that model op for op, in torch on the device:

- world 512 x 512 with walls at [5, 506]; agent circle r = 15; T-block of
  scale 30 (120 x 30 bar, 30 x 90 stem); goal pose (256, 256, pi/4); PD
  agent control (k_p 100, k_v 20) at 100 Hz sim / 10 Hz control (10
  substeps per `step`); success at 0.95 coverage; obs [agent_x, agent_y,
  block_x, block_y, block_angle mod 2 pi]; resets with the agent in
  [50, 450)^2, the block in [100, 400)^2 (integers) and the angle
  N(0, 1) 2 pi - pi;
- a quasi-static contact: circle-vs-T penetration resolved by a mass-split
  positional correction and a torque from the contact offset (the block
  moves only while pushed);
- coverage as the share of a 32 x 32 grid per T rectangle (2048 points) of
  the goal T that lies inside the block's T (`sd <= 0`).

Every threshold is hard (`pen > 0`, `sd <= 0`, `coverage > 0.95`), so
float32 op order can flip a branch near one; the port keeps the JAX op
order. `PushTKeypointEnv` observes the block's 9 keypoints and the agent
(20 dims).

`render_state(state, size)` rasterises a batch of states in one pass of
tensor ops on the states' device, as the reference's SDF rasteriser does
one state: a `linspace(0, 512, size)` grid in world coordinates, white,
then the goal T light green, the block T grey and the agent royal blue,
each where its signed distance is <= 0: (B, size, size, 3) uint8.
`PushTImageEnv` observes {"image": (B, 3, size, size) float in [0, 1],
"agent_pos": (B, 2)}, rendered at every step.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.tensors import default_device

__all__ = ["PushTState", "PushTEnv", "PushTKeypointEnv", "PushTImageEnv", "render_state",
           "GOAL_POSE", "KEYPOINTS_LOCAL", "AGENT_R", "SIM_HZ", "CONTROL_HZ"]

WS = 512.0
SCALE = 30.0
LENGTH = 4.0
AGENT_R = 15.0
K_P, K_V = 100.0, 20.0
SIM_HZ, CONTROL_HZ = 100, 10
SUCCESS_THRESHOLD = 0.95
GOAL_POSE = np.array([256.0, 256.0, np.pi / 4], np.float32)

# T-block local geometry: bar x in [-60, 60], y in [0, 30]; stem x in
# [-15, 15], y in [30, 120]
BAR = np.array([-LENGTH * SCALE / 2, 0.0, LENGTH * SCALE / 2, SCALE], np.float32)
STEM = np.array([-SCALE / 2, SCALE, SCALE / 2, LENGTH * SCALE], np.float32)
# center of gravity: the mean of the two rectangles' centroids
_COG = np.array([((BAR[0] + BAR[2]) / 2 + (STEM[0] + STEM[2]) / 2) / 2,
                 ((BAR[1] + BAR[3]) / 2 + (STEM[1] + STEM[3]) / 2) / 2], np.float32)
_BLOCK_MASS = 1.0
_AGENT_MASS = 1.0


def _moment_for_box(mass, w, h, centroid, cog):
    d = np.asarray(centroid) - np.asarray(cog)
    return mass / 12.0 * (w**2 + h**2) + mass * (d**2).sum()


_BLOCK_INERTIA = float(
    _moment_for_box(0.5, BAR[2] - BAR[0], BAR[3] - BAR[1],
                    [(BAR[0] + BAR[2]) / 2, (BAR[1] + BAR[3]) / 2], _COG)
    + _moment_for_box(0.5, STEM[2] - STEM[0], STEM[3] - STEM[1],
                      [(STEM[0] + STEM[2]) / 2, (STEM[1] + STEM[3]) / 2], _COG))


def _coverage_grid(n: int = 32) -> np.ndarray:
    """Points filling the two T rectangles in the local frame, n x n each."""
    pts = []
    for rect in (BAR, STEM):
        xs = np.linspace(rect[0], rect[2], n, endpoint=False) + (rect[2] - rect[0]) / n / 2
        ys = np.linspace(rect[1], rect[3], n, endpoint=False) + (rect[3] - rect[1]) / n / 2
        pts.append(np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2))
    return np.concatenate(pts, 0).astype(np.float32)


# the 9 keypoints of the keypoint variant: the T's corners and junctions
KEYPOINTS_LOCAL = np.array(
    [[BAR[0], BAR[1]], [BAR[2], BAR[1]], [BAR[0], BAR[3]], [BAR[2], BAR[3]],
     [STEM[0], STEM[3]], [STEM[2], STEM[3]], [STEM[0], STEM[1]], [STEM[2], STEM[1]],
     [0.0, 0.0]], np.float32)


class PushTState(NamedTuple):
    agent_pos: torch.Tensor  # (..., 2)
    agent_vel: torch.Tensor  # (..., 2)
    block_pos: torch.Tensor  # (..., 2), the body origin
    block_angle: torch.Tensor  # (...,)


def _rotate(p, theta):
    """R(theta) @ p for (..., 2) points and (...) angles."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([c * p[..., 0] + (-s) * p[..., 1], s * p[..., 0] + c * p[..., 1]], -1)


def world_to_block(p, block_pos, block_angle):
    return _rotate(p - block_pos, -block_angle)


def block_to_world(p, block_pos, block_angle):
    return _rotate(p, block_angle) + block_pos


def _sd_box(p, rect):
    """Signed distance of local-frame points p to an axis-aligned rect,
    negative inside (the rect's centre and half sizes enter as scalars)."""
    cx, cy = float((rect[0] + rect[2]) / 2), float((rect[1] + rect[3]) / 2)
    hx, hy = float((rect[2] - rect[0]) / 2), float((rect[3] - rect[1]) / 2)
    qx, qy = (p[..., 0] - cx).abs() - hx, (p[..., 1] - cy).abs() - hy
    outside = torch.sqrt(qx.clamp(min=0.0) ** 2 + qy.clamp(min=0.0) ** 2)
    inside = torch.maximum(qx, qy).clamp(max=0.0)
    return outside + inside


def sd_tee_local(p):
    """Signed distance of local-frame points to the T."""
    return torch.minimum(_sd_box(p, BAR), _sd_box(p, STEM))


GOAL_RGB, BLOCK_RGB, AGENT_RGB = (144.0, 238.0, 144.0), (119.0, 136.0, 153.0), (65.0, 105.0, 225.0)


def render_grid(size: int, device) -> torch.Tensor:
    """(size, size, 2) world coordinates (x, y) of the pixels: row i at y =
    linspace(0, 512, size)[i], column j at x = linspace(...)[j]."""
    lin = torch.linspace(0.0, WS, size, device=device)
    ys, xs = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([xs, ys], -1)


@functools.lru_cache(maxsize=16)
def _render_consts(size: int, device: torch.device):
    """The pixel grid, the goal T's signed distances on it and the three
    colours, made once per size and device (a render per env step then
    copies nothing from the host)."""
    pts = render_grid(size, device)
    goal = torch.as_tensor(GOAL_POSE, device=device)
    sd_goal = sd_tee_local(world_to_block(pts, goal[:2], goal[2]))
    colors = [torch.tensor(rgb, device=device) for rgb in (GOAL_RGB, BLOCK_RGB, AGENT_RGB)]
    return pts, sd_goal, colors


def render_sdfs(state: PushTState, size: int):
    """The signed distances the renderer thresholds at 0, per pixel: the
    goal T's (size, size), the block T's and the agent circle's (...,
    size, size)."""
    pts, sd_goal, _ = _render_consts(size, state.agent_pos.device)
    lead = lambda v: v[..., None, None, :]
    sd_block = sd_tee_local(world_to_block(pts, lead(state.block_pos),
                                           state.block_angle[..., None, None]))
    sd_agent = torch.linalg.vector_norm(pts - lead(state.agent_pos), dim=-1) - AGENT_R
    return sd_goal, sd_block, sd_agent


def render_state(state: PushTState, size: int = 96) -> torch.Tensor:
    """A batch of states (any leading shape) as (..., size, size, 3) uint8
    images on their device (module note)."""
    dev = state.agent_pos.device
    colors = _render_consts(size, dev)[2]
    img = torch.full((*state.block_angle.shape, size, size, 3), 255.0, device=dev)
    for sd, rgb in zip(render_sdfs(state, size), colors):
        # a - b <= 0 exactly when a <= b in floating point: the agent's test
        # is the reference's |p - agent| <= r
        img = torch.where((sd <= 0.0)[..., None], rgb, img)
    return img.to(torch.uint8)


class PushTEnv:
    """Batched PushT on `device` (the CUDA device unless the caller names
    another); states are `PushTState`s of tensors there."""

    obs_dim = 5
    act_dim = 2

    def __init__(self, coverage_grid_n: int = 32, device=None):
        self.device = default_device(device)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        self.grid = f32(_coverage_grid(coverage_grid_n))
        self.goal_pose = f32(GOAL_POSE)
        self.goal_pts = block_to_world(self.grid, self.goal_pose[:2], self.goal_pose[2])
        self.cog = f32(_COG)
        self.keypoints_local = f32(KEYPOINTS_LOCAL)
        self.eps_x, self.eps_y = f32([0.5, 0.0]), f32([0.0, 0.5])

    # ------------------------------------------------------------------
    def reset(self, generator: Optional[torch.Generator] = None, batch: int = 1,
              reset_to_state=None):
        """`batch` states drawn from `generator` (on the env's device), or
        `reset_to_state` ((5,) or (batch, 5): agent xy, block xy, angle)."""
        if reset_to_state is None:
            draw = lambda lo, hi: torch.randint(lo, hi, (batch,), generator=generator,
                                                device=self.device).to(torch.float32)
            ax, ay, bx, by = draw(50, 450), draw(50, 450), draw(100, 400), draw(100, 400)
            th = (torch.randn(batch, generator=generator, device=self.device) * 2 * math.pi
                  - math.pi)
        else:
            s = torch.as_tensor(reset_to_state, dtype=torch.float32,
                                device=self.device).expand(batch, 5)
            ax, ay, bx, by, th = s.unbind(-1)
        state = PushTState(torch.stack([ax, ay], -1), torch.zeros(batch, 2, device=self.device),
                           torch.stack([bx, by], -1), th.clone())
        return state, self.get_obs(state)

    def get_obs(self, state: PushTState):
        angle = torch.remainder(state.block_angle, 2 * math.pi)
        return torch.cat([state.agent_pos, state.block_pos, angle[..., None]], -1)

    # ------------------------------------------------------------------
    def substep(self, state: PushTState, action, dt: float) -> PushTState:
        """One 100 Hz substep: PD control, then the contact."""
        acc = K_P * (action - state.agent_pos) + K_V * (-state.agent_vel)
        vel = state.agent_vel + acc * dt
        pos = state.agent_pos + vel * dt

        p_local = world_to_block(pos, state.block_pos, state.block_angle)
        pen = AGENT_R - sd_tee_local(p_local)  # > 0: contact
        # central differences at eps 0.5: the division by 2 eps is by 1
        grad = torch.stack([
            sd_tee_local(p_local + self.eps_x) - sd_tee_local(p_local - self.eps_x),
            sd_tee_local(p_local + self.eps_y) - sd_tee_local(p_local - self.eps_y)], -1)
        n_local = grad / (torch.linalg.vector_norm(grad, dim=-1, keepdim=True) + 1e-8)
        n_world = _rotate(n_local, state.block_angle)  # outward normal, toward the agent

        contact = pen > 0.0
        pen_pos = pen.clamp(min=0.0)[..., None]
        w_a = _BLOCK_MASS / (_AGENT_MASS + _BLOCK_MASS)
        w_b = _AGENT_MASS / (_AGENT_MASS + _BLOCK_MASS)
        zero = torch.zeros_like(pos)
        pos = pos + torch.where(contact[..., None], pen_pos * n_world * w_a, zero)
        block_pos = state.block_pos - torch.where(contact[..., None], pen_pos * n_world * w_b,
                                                  zero)
        # torque about the centre of gravity from the contact point
        contact_pt = pos - n_world * AGENT_R
        r_vec = contact_pt - block_to_world(self.cog, block_pos, state.block_angle)
        force = -n_world * pen_pos * _BLOCK_MASS
        torque = r_vec[..., 0] * force[..., 1] - r_vec[..., 1] * force[..., 0]
        block_angle = state.block_angle + torch.where(contact, torque / _BLOCK_INERTIA,
                                                      torch.zeros_like(torque))
        # inelastic: the agent's velocity into the block is removed
        vn = (vel * n_world).sum(-1, keepdim=True)
        vel = torch.where(contact[..., None] & (vn < 0), vel - vn * n_world, vel)
        pos = pos.clamp(5.0 + AGENT_R, WS - 6.0 - AGENT_R)
        return PushTState(pos, vel, block_pos, block_angle)

    def step(self, state: PushTState, action):
        """10 substeps toward the target `action` (batch, 2); returns (state,
        obs, reward = clip(coverage / 0.95, 0, 1), done = coverage > 0.95)."""
        dt = 1.0 / SIM_HZ
        for _ in range(SIM_HZ // CONTROL_HZ):
            state = self.substep(state, action, dt)
        cov = self.coverage(state)
        return (state, self.get_obs(state), (cov / SUCCESS_THRESHOLD).clamp(0.0, 1.0),
                cov > SUCCESS_THRESHOLD)

    # ------------------------------------------------------------------
    def coverage_count(self, state: PushTState):
        """The number of the goal T's grid points inside the block's T."""
        local = world_to_block(self.goal_pts, state.block_pos[..., None, :],
                               state.block_angle[..., None])
        return (sd_tee_local(local) <= 0.0).sum(-1)

    def coverage(self, state: PushTState):
        """The share of the goal T's grid points inside the block's T (the
        count over the grid's size, a power of 2: exact, as the JAX mean)."""
        return self.coverage_count(state).to(torch.float32) / self.goal_pts.shape[0]

    def keypoints(self, state: PushTState):
        """(..., 9, 2) world-frame keypoints of the block."""
        return block_to_world(self.keypoints_local, state.block_pos[..., None, :],
                              state.block_angle[..., None])


class PushTKeypointEnv(PushTEnv):
    """obs = [9 block keypoints (18), agent position (2)] = 20 dims."""

    obs_dim = 20

    def get_obs(self, state: PushTState):
        kp = self.keypoints(state).reshape(*state.block_angle.shape, -1)
        return torch.cat([kp, state.agent_pos], -1)


class PushTImageEnv(PushTEnv):
    """obs = {"image": (B, 3, size, size) float in [0, 1], "agent_pos": (B,
    2)}, the state rendered at `render_size` on the env's device."""

    def __init__(self, render_size: int = 96, coverage_grid_n: int = 32, device=None):
        super().__init__(coverage_grid_n, device)
        self.render_size = render_size

    def get_obs(self, state: PushTState):
        img = render_state(state, self.render_size).movedim(-1, -3).to(torch.float32) / 255.0
        return {"image": img, "agent_pos": state.agent_pos}

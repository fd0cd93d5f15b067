"""PushT expert demonstrations by model-predictive control on the device
(counterpart of cleandiffuser_tpu/env/pusht_expert.py).

The reference trains Diffusion Policy on human teleop demos that cannot
ship here; the JAX package's expert is a CEM planner over the env's own
dynamics, and the port's is the same planner in torch:

- `plan(state, mean, generator, noise=None)`: per control step `n_iters`
  CEM iterations of K candidate waypoint sequences of horizon H (a random
  walk around the mean, the incumbent best plan, and 9 heuristic plans
  that approach each block keypoint from behind and push it toward its
  goal), rolled through the exact env substeps and scored by the keypoint
  distance to the goal pose, a coverage bonus and a contact-gap penalty;
  the elites' mean is the next mean, the best plan so far is executed.
  `noise` ((n_iters, K, B, H, 2) standard normal) gives the CEM draws
  explicitly, as the JAX planner's `normal(k, (K, B, H, 2))` per iteration.
- `rollout(generator, batch, max_steps)`: `batch` episodes at once, the
  first action of each plan executed (with DART execution noise when
  `exec_noise_prob` > 0: a perturbed waypoint runs while the clean one is
  recorded). On a CUDA device one control step (the whole CEM plan and the
  env step, ~13,000 small kernels at the shipped budget) is captured once
  as a CUDA graph and replayed; on the CPU, and with `graph=False`, the
  same step runs op by op.
- `generate_pusht_expert_trajectories`: episodes that reach the 0.95
  coverage threshold, truncated there; failures are dropped.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .pusht import (
    AGENT_R,
    CONTROL_HZ,
    GOAL_POSE,
    KEYPOINTS_LOCAL,
    SIM_HZ,
    PushTEnv,
    PushTState,
    block_to_world,
    sd_tee_local,
    world_to_block,
)

__all__ = ["PushTExpertMPC", "generate_pusht_expert_trajectories"]

LO, HI = 5.0 + AGENT_R, 506.0 - AGENT_R  # the waypoints' box inside the walls


class PushTExpertMPC:
    """CEM model-predictive controller on the PushT dynamics (the shipped
    budget: K = 160 candidates, 16 elites, 4 iterations, horizon 8)."""

    def __init__(self, env: Optional[PushTEnv] = None, horizon: int = 8, n_samples: int = 160,
                 n_elites: int = 16, n_iters: int = 4, sigma: float = 32.0,
                 exec_noise_prob: float = 0.0, exec_noise_sigma: float = 25.0, device=None,
                 graph: Optional[bool] = None):
        self.env = env or PushTEnv(device=device)
        self.device = self.env.device
        self.H, self.K, self.E, self.iters, self.sigma = (horizon, n_samples, n_elites, n_iters,
                                                          sigma)
        self.exec_noise_prob, self.exec_noise_sigma = exec_noise_prob, exec_noise_sigma
        goal = torch.as_tensor(GOAL_POSE, device=self.device)
        self.goal_kp = block_to_world(torch.as_tensor(KEYPOINTS_LOCAL, device=self.device),
                                      goal[:2], goal[2])
        # the last iteration refines at sigma 5: the last few percent of
        # coverage need px-level nudges
        self.sigmas = [float(np.float32(sigma))] * (n_iters - 1) + [5.0]
        self.graph = self.device.type == "cuda" if graph is None else graph
        self._graphs = {}

    # ------------------------------------------------------------------
    def score(self, state: PushTState):
        """Planning score of a batch of states, higher is better."""
        kd = torch.linalg.vector_norm(self.env.keypoints(state) - self.goal_kp, dim=-1).mean(-1)
        p_local = world_to_block(state.agent_pos, state.block_pos, state.block_angle)
        gap = (sd_tee_local(p_local) - AGENT_R).clamp(min=0.0)
        return -kd + 120.0 * self.env.coverage(state) - 0.25 * gap

    def dynamics_rollout(self, state: PushTState, actions) -> PushTState:
        """The final state after (H, N, 2) actions from N states: the env's
        substeps, without the coverage reward."""
        dt = 1.0 / SIM_HZ
        for a in actions:
            for _ in range(SIM_HZ // CONTROL_HZ):
                state = self.env.substep(state, a, dt)
        return state

    def plan(self, state: PushTState, mean, generator: Optional[torch.Generator] = None,
             noise=None):
        """One CEM plan for B states from the warm-start mean (B, H, 2).
        Returns (action (B, 2), next mean (B, H, 2))."""
        B, H, K, E = mean.shape[0], self.H, self.K, self.E
        if noise is None:
            noise = torch.randn((self.iters, K, B, H, 2), generator=generator,
                                device=self.device)
        # candidate k of state b is row k * B + b
        tiled = PushTState(*(x.repeat((K,) + (1,) * (x.ndim - 1)) for x in state))

        kp = self.env.keypoints(state)  # (B, 9, 2)
        err = self.goal_kp - kp
        err_n = torch.linalg.vector_norm(err, dim=-1, keepdim=True)
        d = err / (err_n + 1e-6)
        approach = kp - d * (AGENT_R + 14.0)
        push_to = kp + d * torch.minimum(err_n, torch.full_like(err_n, 30.0))
        h1 = H // 2
        frac1 = (torch.arange(1, h1 + 1, device=self.device) / h1)[None, None, :, None]
        frac2 = (torch.arange(1, H - h1 + 1, device=self.device) / (H - h1))[None, None, :, None]
        agent = state.agent_pos[:, None, None, :]
        leg1 = agent + (approach[:, :, None] - agent) * frac1
        leg2 = approach[:, :, None] + (push_to - approach)[:, :, None] * frac2
        heur = torch.cat([leg1, leg2], dim=2).transpose(0, 1)  # (9, B, H, 2)

        best_plan = mean
        best_score = torch.full((B,), -float("inf"), device=self.device)
        rows = torch.arange(B, device=self.device)
        for it in range(self.iters):
            eps = torch.cumsum(noise[it] * self.sigmas[it], dim=2)  # a smooth waypoint walk
            cand = mean[None] + eps
            cand = torch.cat([best_plan[None], heur, cand[1 + heur.shape[0]:]], 0)
            cand = cand.clamp(LO, HI)
            final = self.dynamics_rollout(tiled, cand.reshape(K * B, H, 2).transpose(0, 1))
            scores = self.score(final).reshape(K, B).T  # (B, K)
            top_score, elite_idx = torch.topk(scores, E, dim=1)
            cand_bk = cand.transpose(0, 1)  # (B, K, H, 2)
            elites = cand_bk[rows[:, None], elite_idx]
            # the incumbent is the best plan, not the elites' mean: averaging
            # dilutes the one precise nudge that works
            improved = top_score[:, 0] > best_score
            best_plan = torch.where(improved[:, None, None], elites[:, 0], best_plan)
            best_score = torch.where(improved, top_score[:, 0], best_score)
            mean = elites.mean(dim=1)
        return best_plan[:, 0], torch.cat([best_plan[:, 1:], best_plan[:, -1:]], dim=1)

    # ------------------------------------------------------------------
    def _control_step(self, state: PushTState, mean, noise, coin, exec_noise):
        """Plan, execute (perturbed where `coin`), step the env. Returns
        (state, mean, the step's record)."""
        obs, kp = self.env.get_obs(state), self.env.keypoints(state)
        action, mean = self.plan(state, mean, noise=noise)
        exec_action = action
        if self.exec_noise_prob > 0.0:
            exec_action = (action + torch.where(coin, exec_noise * self.exec_noise_sigma,
                                                torch.zeros_like(action))).clamp(LO, HI)
        state, _, rew, done = self.env.step(state, exec_action)
        return state, mean, (obs, action, kp, rew, done)

    def _graphed_step(self, batch: int):
        """`_control_step` captured for `batch` envs: (static inputs, the
        graph, static outputs)."""
        if batch in self._graphs:
            return self._graphs[batch]
        dev = self.device
        z2 = lambda: torch.zeros(batch, 2, device=dev)
        static = {"state": PushTState(z2() + 256.0, z2(), z2() + 256.0,
                                      torch.zeros(batch, device=dev)),
                  "mean": torch.full((batch, self.H, 2), 256.0, device=dev),
                  "noise": torch.zeros((self.iters, self.K, batch, self.H, 2), device=dev),
                  "coin": torch.zeros(batch, 1, dtype=torch.bool, device=dev),
                  "exec_noise": torch.zeros(batch, 2, device=dev)}
        args = (static["state"], static["mean"], static["noise"], static["coin"],
                static["exec_noise"])
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):  # warm up before the capture
                self._control_step(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._control_step(*args)
        self._graphs[batch] = (static, graph, out)
        return self._graphs[batch]

    def rollout(self, generator: Optional[torch.Generator], batch: int, max_steps: int,
                reset_to_state=None):
        """`batch` episodes of `max_steps` control steps. Returns a dict of
        stacked tensors: obs (T, B, 5), action (T, B, 2), keypoint
        (T, B, 9, 2), reward (T, B), done (T, B); obs, keypoint and action
        at t are the pre-step ones (the (state_t, action_t) pairs of the
        replay-buffer format). No host sync inside the loop."""
        state, _ = self.env.reset(generator, batch, reset_to_state)
        mean = state.agent_pos[:, None, :].repeat(1, self.H, 1)
        records = []
        if self.graph:
            static, graph, out = self._graphed_step(batch)
        for _ in range(max_steps):
            noise_shape = (self.iters, self.K, batch, self.H, 2)
            if self.graph:
                for dst, src in zip(static["state"], state):
                    dst.copy_(src)
                static["mean"].copy_(mean)
                # the same draws, in the same order, as the plain loop's
                static["noise"].copy_(torch.randn(noise_shape, generator=generator,
                                                  device=self.device))
                if self.exec_noise_prob > 0.0:
                    static["coin"].copy_(torch.rand((batch, 1), generator=generator,
                                                    device=self.device) < self.exec_noise_prob)
                    static["exec_noise"].copy_(torch.randn((batch, 2), generator=generator,
                                                           device=self.device))
                graph.replay()
                state = PushTState(*(x.clone() for x in out[0]))
                mean = out[1].clone()
                records.append(tuple(x.clone() for x in out[2]))
                continue
            noise = torch.randn(noise_shape, generator=generator, device=self.device)
            coin = exec_noise = None
            if self.exec_noise_prob > 0.0:
                coin = torch.rand((batch, 1), generator=generator,
                                  device=self.device) < self.exec_noise_prob
                exec_noise = torch.randn((batch, 2), generator=generator, device=self.device)
            state, mean, rec = self._control_step(state, mean, noise, coin, exec_noise)
            records.append(rec)
        keys = ("obs", "action", "keypoint", "reward", "done")
        return {k: torch.stack([r[i] for r in records]) for i, k in enumerate(keys)}


# ---------------------------------------------------------------------------
def generate_pusht_expert_trajectories(n_episodes: int = 32, max_steps: int = 300,
                                       seed: int = 0, batch: Optional[int] = None,
                                       mpc_kwargs: Optional[dict] = None, device=None):
    """Expert episodes from the MPC controller: a list of dicts {state,
    action, keypoint} (numpy) truncated at the first success, and every
    episode's best reward. Episodes that never reach the 0.95 threshold
    are dropped (the expert-demo contract: each episode ends at success).
    `batch` episodes roll out together (all of them by default, in one
    rollout)."""
    mpc = PushTExpertMPC(**(mpc_kwargs or {}), device=device)
    generator = torch.Generator(device=mpc.device).manual_seed(seed)
    batch = n_episodes if batch is None else min(batch, n_episodes)
    episodes, max_covs = [], []
    for _ in range(-(-n_episodes // batch)):
        traj = {k: v.cpu().numpy() for k, v in mpc.rollout(generator, batch, max_steps).items()}
        for b in range(batch):
            done = traj["done"][:, b]
            max_covs.append(float(traj["reward"][:, b].max()))
            if not done.any():
                continue  # the demo quality gate: failures are dropped
            t_end = int(np.argmax(done)) + 1
            episodes.append({"state": traj["obs"][:t_end, b],
                             "action": traj["action"][:t_end, b],
                             "keypoint": traj["keypoint"][:t_end, b]})
    return episodes[:n_episodes], max_covs

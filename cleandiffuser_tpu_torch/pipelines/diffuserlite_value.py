"""DiffuserLite conditioned on reward-derived values, for the antmaze and
kitchen suites (counterpart of cleandiffuser_tpu/pipelines/diffuserlite_value.py).

The sparse-reward suites condition each level on a progress value instead
of the Monte-Carlo return: level 0 on the discounted in-window reward with
an IQL V(s) bootstrap at the window's end (antmaze) or on the discounted
in-window reward (kitchen), finer levels on time-to-success statistics
(antmaze) or the mean reward (kitchen). Planning draws K candidate level-0
plans per environment (tiled env-major, row e*K + k), ranks them by IQL's
V at plan index `select_t` (1 for antmaze, -1 for kitchen) and refines the
best. IQL (utils/iql.py) is trained first (`train_iql`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..dataset.base import DeviceSeqSampler, place_on_mesh
from ..utils.iql import IQL
from ..utils.profiling import annotate
from ..utils.ranks import rows_step
from .diffuserlite import DiffuserLitePipeline
from .runner import step_window

__all__ = [
    "IQLValueMultiHorizonDataset",
    "antmaze_level_values",
    "kitchen_level_values",
    "value_train_step",
    "prepare_value_reflow_pairs",
    "build_candidate_plan_fn",
    "train_iql",
]


class IQLValueMultiHorizonDataset:
    """A multi-horizon dataset whose batches also carry the per-step reward
    ("rew") and IQL's V of each state ("pred_val"), computed once over the
    stored paths in chunks of `chunk` paths."""

    def __init__(self, base, iql: IQL, chunk: int = 64, device=None):
        self.base = base
        self.o_dim, self.a_dim = base.o_dim, base.a_dim
        dev = iql.device
        with torch.no_grad():
            self.pred_values = torch.cat([
                iql.state.v_params(torch.as_tensor(base.seq_obs[i:i + chunk], device=dev)).cpu()
                for i in range(0, base.seq_obs.shape[0], chunk)]).numpy()
        self._samplers = [
            DeviceSeqSampler(
                {"obs": base.seq_obs, "act": base.seq_act, "rew": base.seq_rew,
                 "pred_val": self.pred_values},
                idxs, horizon, scalars={"val": base.seq_val}, device=device)
            for idxs, horizon in zip(base.indices, base.horizons)
        ]

    def get_normalizer(self):
        return self.base.get_normalizer()

    def place_on_mesh(self, mesh, axis: str = "dp"):
        return place_on_mesh(self, mesh, axis)

    def sample_batch(self, generator, batch_size: int, horizon_idx: int = 0):
        out = self._samplers[horizon_idx].sample(generator, batch_size)
        return {"obs": {"state": out["obs"]}, "act": out["act"], "rew": out["rew"],
                "pred_val": out["pred_val"], "val": out["val"]}


def _discounts(n: int, discount: float, device):
    return discount ** torch.arange(n, dtype=torch.float32, device=device)


def antmaze_level_values(batch, level: int, discount: float):
    """Rewards arrive IQL-tuned (-1 a step, 0 at the goal). Level 0: the
    discounted step rewards up to the first success, with IQL's V at the
    window's last step, / 100 + 1. Finer levels: 1 / (steps to success) if
    the goal is reached inside the window, else 0."""
    rew = batch["rew"] + 1.0  # back to sparse {0, 1}
    mask = (torch.cumsum(rew, dim=1) == 0.0).to(torch.float32)
    mask = torch.cat([torch.ones_like(mask[:, :1]), mask[:, :-1]], dim=1)
    if level == 0:
        val = rew - 1.0
        val = torch.cat([val[:, :-1], batch["pred_val"][:, -1:]], dim=1)
        disc = _discounts(rew.shape[1], discount, rew.device)
        return (disc[None, :, None] * val * mask).sum(dim=1) / 100.0 + 1.0
    return rew.max(dim=1).values / mask.sum(dim=1)


def kitchen_level_values(batch, level: int, discount: float):
    """Level 0: the discounted in-window reward / 100; finer levels: the
    mean reward."""
    rew = batch["rew"]
    if level == 0:
        disc = _discounts(rew.shape[1], discount, rew.device)
        return (disc[None, :, None] * rew).sum(dim=1) / 100.0
    return rew.mean(dim=1)


@rows_step
def value_train_step(pipe: DiffuserLitePipeline, batches, val_fn: Callable,
                     invdyn_budget_left: bool = True, noise=None) -> dict:
    """`pipe.train_step` with each level conditioned on
    `val_fn(batch, level)`. On a mesh, `batches` (a placed dataset's) are
    the rank's rows: the step runs data-parallel in their rows, as the
    levels' strided copies carry no tag (utils/ranks.py `rows_step`)."""
    log = {}
    for i in range(pipe.n_levels):
        obs, act = pipe.level_strided(batches[i], i)
        log.update(pipe.update_level(i, obs, act, val_fn(batches[i], i), invdyn_budget_left,
                                     noise))
    return log


def prepare_value_reflow_pairs(pipe: DiffuserLitePipeline, batches, val_fn,
                               sampling_steps: int = 20, generator=None, x1s=None):
    """Reflow pairs with only level 0 conditioned (on its value) and the
    finer levels unconditional, as the reference's CFG weights (1, 0, 0)."""
    out = []
    for i in range(pipe.n_levels):
        obs, _ = pipe.level_strided(batches[i], i)
        cond = val_fn(batches[i], i) if i == 0 else None
        out.append(pipe.sample_pair(i, obs, cond, sampling_steps, generator,
                                    None if x1s is None else x1s[i]))
    return out


def build_candidate_plan_fn(pipe: DiffuserLitePipeline, iql: IQL, num_envs: int,
                            num_candidates: int, sample_steps: int, w_cfgs: Sequence[float],
                            select_t: int):
    """`plan(generator, obs_normed, tgt, noise=None) -> (act, info)`: K
    level-0 candidates per environment under CFG weight `w_cfgs[0]` on
    the target `tgt` (E, 1), ranked by IQL's V at plan index `select_t`,
    the best refined by the finer levels. `noise` lists each level's
    initial draw (level 0's of the E*K prior's shape). `info` holds the
    "candidates" (E, K, h0, obs_dim), their "scores" (E, K) and the pick
    "idx"."""
    E, K, O = num_envs, num_candidates, pipe.obs_dim
    sample_fns = pipe.level_sample_fns(sample_steps)

    @torch.no_grad()
    def plan(generator, obs_normed, tgt, noise=None):
        obs, tgt = pipe._f32(obs_normed), pipe._f32(tgt)
        h0 = pipe.planning_horizons[0]
        prior = torch.zeros((E * K, h0, O), device=obs.device)
        prior[:, 0] = obs.repeat_interleave(K, 0)
        traj = pipe.sample_level(sample_fns, 0, generator, prior, tgt.repeat_interleave(K, 0),
                                 w_cfgs[0], noise)
        candidates = traj.reshape(E, K, h0, O)
        with annotate("diffuserlite.score"):
            scores = iql.state.v_params(candidates[:, :, select_t])[..., 0]  # (E, K)
            idx = scores.argmax(-1)
        traj = candidates[torch.arange(E, device=idx.device), idx]
        traj = pipe.refine(sample_fns, traj, generator, tgt, w_cfgs, noise)
        return pipe.invdyn_action(traj), {"candidates": candidates, "scores": scores,
                                          "idx": idx, "traj": traj}

    return plan


def train_iql(iql: IQL, dataset, gradient_steps: int, batch_size: int, log_interval: int,
              save_interval: int, save_fn, seed: int = 0):
    """IQL's pre-training: per step a batch gathered on the device, the V
    update, then the Q update (and its target's). Logs "loss_v" and
    "loss_q" per log window and calls `save_fn()` on the save grid; runs
    window by window (no host sync inside) when the schedule is on the log
    grid, else step by step."""
    g = torch.Generator(device=iql.device).manual_seed(seed)

    def step(gen):
        b = dataset.sample_batch(gen, batch_size)
        obs, act = b["obs"]["state"], b["act"]
        return {"loss_v": iql.update_V(obs, act),
                "loss_q": iql.update_Q(obs, act, b["rew"], b["next_obs"]["state"], b["tml"])}

    windowed = gradient_steps % log_interval == 0 and save_interval % log_interval == 0
    run = step_window(step, log_interval if windowed else 1, ("loss_v", "loss_q"), iql.device)
    acc, step_n = {}, 0
    while step_n < gradient_steps:
        log = run(g)
        step_n += log_interval if windowed else 1
        for k, v in log.items():
            acc[k] = acc.get(k, 0.0) + v
        if step_n % log_interval == 0:
            n = 1 if windowed else log_interval
            print({k: float(v) / n for k, v in acc.items()}, {"gradient_steps": step_n},
                  flush=True)
            acc = {}
        if step_n % save_interval == 0:
            save_fn()

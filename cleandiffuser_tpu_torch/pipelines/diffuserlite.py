"""DiffuserLite pipeline (counterpart of cleandiffuser_tpu/pipelines/diffuserlite.py).

A coarse-to-fine planner of `len(planning_horizons)` levels, each a
continuous rectified flow (diffusion/rectifiedflow.py) on a DiT1d over
states with an MLP return condition. Level 0 plans `planning_horizons[0]`
states `temporal_horizons[1] - 1` env steps apart from the current state;
each finer level refines the span between the previous level's first two
states (first state and last state pinned), and the last level's first two
states give the action through a `FancyMlpInvDynamic`. Every level samples
with CFG in "mix" mode on the `quad` schedule: 3 Euler steps ("R1") or, after
reflow, 1 ("R2").

Training (`train_step`): one update per level on its strided window of a
multi-horizon batch, conditioned on the return / `return_scale`, and, within
the inverse dynamics' budget, one inverse-dynamics update on the last
level's consecutive states. `make_train_scan` is the CLI's window.
Reflow: `prepare_reflow_pairs` samples (x0, x1, condition) per level from
the trained planner with its source noise kept; `reflow_step` retrains each
level on such pairs. The pairs are dicts of numpy arrays, the layout the
JAX CLI pickles (`reflow_pairs.pkl`), so either package reads the other's.

A plan's levels and its action run in the profiler ranges
"diffuserlite.level<i>" and "diffuserlite.invdyn".

Random draws come from the pipeline's generator or as explicit noise
(`act(..., noise=)`, `train_step(..., noise=)`), which is how the tests
replay the reference's draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..diffusion import ContinuousRectifiedFlow
from ..invdynamic import FancyMlpInvDynamic
from ..nn_condition import MLPCondition
from ..nn_diffusion import DiT1d
from ..utils.profiling import annotate
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from ..utils.ranks import batch_draw
from ..utils.train_state import cosine_decay_schedule
from .runner import step_window

__all__ = ["DiffuserLitePipeline", "compute_temporal_horizons"]


def compute_temporal_horizons(planning_horizons: Sequence[int]) -> List[int]:
    """Each level's span in env steps: the last level's is its planning
    horizon, and each coarser level's is (its horizon - 1) times the finer
    level's span less one, plus one."""
    n = len(planning_horizons)
    temporal = [planning_horizons[-1]] * n
    for i in range(n - 1):
        temporal[-2 - i] = (planning_horizons[-2 - i] - 1) * (temporal[-1 - i] - 1) + 1
    return temporal


class DiffuserLitePipeline:
    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        planning_horizons: Sequence[int] = (5, 5, 9),
        emb_dim: int = 128,
        d_model: int = 256,
        n_heads: int = 8,
        depth: int = 2,
        next_obs_loss_weight: float = 10.0,
        return_scale: float = 1000.0,
        ema_rate: float = 0.9995,
        diffusion_gradient_steps: int = 1_000_000,
        lr: float = 2e-4,
        w_cfg: float = 1.2,
        target_return: float = 0.9,
        temperature: float = 1.0,
        rng: int = 0,
        device=None,
    ):
        self.device = default_device(device)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.planning_horizons = list(planning_horizons)
        self.temporal_horizons = compute_temporal_horizons(planning_horizons)
        self.n_levels = len(planning_horizons)
        self.return_scale = return_scale
        self.w_cfg, self.target_return, self.temperature = w_cfg, target_return, temperature

        self.diffusions: List[ContinuousRectifiedFlow] = []
        for i, h in enumerate(self.planning_horizons):
            fix_mask = np.zeros((h, obs_dim), np.float32)
            fix_mask[[0] if i == 0 else [0, -1]] = 1.0  # finer levels pin both ends
            loss_weight = np.ones((h, obs_dim), np.float32)
            loss_weight[1] = next_obs_loss_weight
            init = torch.Generator().manual_seed(rng + i)
            self.diffusions.append(ContinuousRectifiedFlow(
                DiT1d(obs_dim, emb_dim, d_model, n_heads, depth, timestep_emb_type="fourier",
                      generator=init),
                MLPCondition(1, emb_dim, (emb_dim,), generator=init),
                fix_mask=fix_mask, loss_weight=loss_weight, ema_rate=ema_rate,
                optim_params={"lr": cosine_decay_schedule(lr, diffusion_gradient_steps),
                              "weight_decay": 0.0},
                rng=rng + i, device=self.device))
        self.invdyn = FancyMlpInvDynamic(
            obs_dim, act_dim, 256, torch.tanh, add_dropout=True,
            generator=torch.Generator().manual_seed(rng + 100), device=self.device,
            rng=rng + 100)
        self._plan_fns = {}
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 200)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _f32(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def level_strided(self, batch_level, i: int):
        """The level's window subsampled to its planning horizon: (obs, act)."""
        stride = self.temporal_horizons[i + 1] - 1 if i < self.n_levels - 1 else 1
        return (self._f32(batch_level["obs"]["state"])[:, ::stride],
                self._f32(batch_level["act"])[:, ::stride])

    def update_level(self, i: int, obs, act, val, invdyn_budget_left: bool, noise=None) -> dict:
        """One update of level `i` on (obs, condition `val`), and, at the last
        level within the budget, one inverse-dynamics update on its
        consecutive states. `noise` holds the level's (t, x1, keep_mask)
        and the inverse dynamics' dropout keep-mask ("invdyn")."""
        noise = noise or {}
        log = {f"loss{i}": self.diffusions[i].update(obs, val, noise=noise.get(i))["loss"]}
        if i == self.n_levels - 1 and invdyn_budget_left:
            O, A = self.obs_dim, self.act_dim
            log["invdyn_loss"] = self.invdyn.update(
                obs[:, :-1].reshape(-1, O), act[:, :-1].reshape(-1, A),
                obs[:, 1:].reshape(-1, O), keep=noise.get("invdyn"))["loss"]
        return log

    def train_step(self, batches, invdyn_budget_left: bool = True,
                   noise: Optional[dict] = None) -> dict:
        """One step on `batches`, one multi-horizon batch per level. Returns
        device scalars "loss<i>" and (within the budget) "invdyn_loss".
        `noise` maps a level to its explicit (t, x1, keep_mask) and
        "invdyn" to the dropout keep-mask."""
        log = {}
        for i in range(self.n_levels):
            obs, act = self.level_strided(batches[i], i)
            val = self._f32(batches[i]["val"]) / self.return_scale
            log.update(self.update_level(i, obs, act, val, invdyn_budget_left, noise))
        return log

    def log_keys(self):
        return tuple(f"loss{i}" for i in range(self.n_levels)) + ("invdyn_loss",)

    def step_fn(self, dataset, batch_size: int, invdyn_budget: int, train_step=None):
        """The CLI's step: a batch per level drawn one after the other from
        the generator, then `train_step(batches, budget_left)` (the
        pipeline's own unless given), the inverse dynamics within the first
        `invdyn_budget` steps."""
        train_step = train_step or self.train_step

        def step(g):
            batches = [dataset.sample_batch(g, batch_size, horizon_idx=i)
                       for i in range(self.n_levels)]
            return train_step(batches, self.diffusions[0].step < invdyn_budget)

        return step

    def make_train_scan(self, dataset, batch_size: int, n_steps: int, invdyn_budget: int,
                        train_step=None):
        """The window: `run(generator) -> log` takes the `n_steps` steps
        `step_fn` takes one by one and returns the window means of
        `log_keys()` (the inverse dynamics' loss counts 0 past its budget)
        as device scalars, with no host sync inside the window."""
        return step_window(self.step_fn(dataset, batch_size, invdyn_budget, train_step),
                           n_steps, self.log_keys(), self.device)

    # ------------------------------------------------------------------
    # Reflow
    # ------------------------------------------------------------------
    @torch.no_grad()
    def sample_pair(self, i: int, obs, condition, sampling_steps: int,
                    generator: Optional[torch.Generator] = None, x1=None) -> dict:
        """One reflow pair of level `i`: x1 (drawn unless given), and x0 the
        EMA net's `sampling_steps`-step Euler sample from x1 on the quad
        schedule, with the level's ends pinned to `obs`'s and the
        `condition` at weight 1 (None: unconditional). Numpy arrays."""
        b, h = obs.shape[0], self.planning_horizons[i]
        prior = torch.zeros((b, h, self.obs_dim), device=self.device)
        prior[:, 0] = obs[:, 0]
        if i > 0:
            prior[:, -1] = obs[:, -1]
        if x1 is None:
            x1 = batch_draw(lambda s: torch.randn(s, generator=generator or self._generator,
                                                  device=self.device), prior.shape)
        x1 = self._f32(x1)
        traj, _ = self.diffusions[i].sample(
            prior, x1=x1, sample_steps=sampling_steps, use_ema=True,
            condition_cfg=condition, w_cfg=0.0 if condition is None else 1.0,
            sample_step_schedule="quad_continuous")
        pair = {"x0": traj.cpu().numpy(), "x1": x1.cpu().numpy()}
        if condition is not None:
            pair["condition"] = condition.cpu().numpy()
        return pair

    def prepare_reflow_pairs(self, batches, sampling_steps: int = 20, conditioned: bool = True,
                             generator: Optional[torch.Generator] = None, x1s=None):
        """A reflow pair per level (`sample_pair`), each conditioned on its
        batch's return / `return_scale` unless not `conditioned`; `x1s`
        gives the levels' source noise explicitly."""
        out = []
        for i in range(self.n_levels):
            obs, _ = self.level_strided(batches[i], i)
            cond = self._f32(batches[i]["val"]) / self.return_scale if conditioned else None
            out.append(self.sample_pair(i, obs, cond, sampling_steps, generator,
                                        None if x1s is None else x1s[i]))
        return out

    def reflow_step(self, pairs_per_level, conditioned: bool = True,
                    noise: Optional[dict] = None) -> dict:
        """One update per level on its pairs: x1 given, t drawn (or
        `noise[i]` = (t, None, keep_mask))."""
        noise = noise or {}
        log = {}
        for i, p in enumerate(pairs_per_level):
            cond = self._f32(p["condition"]) if conditioned and "condition" in p else None
            log[f"loss{i}"] = self.diffusions[i].update(
                self._f32(p["x0"]), cond, noise=noise.get(i), x1=self._f32(p["x1"]))["loss"]
        return log

    # ------------------------------------------------------------------
    # Planning
    # ------------------------------------------------------------------
    def level_sample_fns(self, sample_steps: int):
        return [d.build_sample_fn(sample_steps=sample_steps,
                                  sample_step_schedule="quad_continuous", cfg_mode="mix")
                for d in self.diffusions]

    def refine(self, sample_fns, traj, generator, condition, w_cfgs, noise=None, first=1):
        """Levels `first`.. from the coarser plan `traj`: each pins the
        previous plan's first state at its start and its second state at
        its end. Returns the last level's plan."""
        E, O = traj.shape[0], self.obs_dim
        for j in range(first, self.n_levels):
            prior = torch.zeros((E, self.planning_horizons[j], O), device=traj.device)
            prior[:, 0] = traj[:, 0]
            prior[:, -1] = traj[:, 1]
            traj = self.sample_level(sample_fns, j, generator, prior, condition, w_cfgs[j], noise)
        return traj

    def sample_level(self, sample_fns, j, generator, prior, condition, w_cfg, noise=None):
        with annotate(f"diffuserlite.level{j}"):
            return sample_fns[j](self.diffusions[j].ema_params, generator, prior,
                                 condition_cfg=condition, w_cfg=w_cfg,
                                 temperature=self.temperature,
                                 noise=None if noise is None else noise[j])[0]

    def invdyn_action(self, traj):
        with annotate("diffuserlite.invdyn"):
            return self.invdyn.predict(traj[:, 0], traj[:, 1])

    def _make_plan_fn(self, E: int, sample_steps: int):
        sample_fns = self.level_sample_fns(sample_steps)
        w_cfgs = [self.w_cfg] * self.n_levels

        def plan(generator, obs, condition, noise=None):
            prior = torch.zeros((E, self.planning_horizons[0], self.obs_dim), device=obs.device)
            prior[:, 0] = obs
            traj = self.sample_level(sample_fns, 0, generator, prior, condition, self.w_cfg, noise)
            traj = self.refine(sample_fns, traj, generator, condition, w_cfgs, noise)
            return self.invdyn_action(traj), {"traj": traj}

        return plan

    @torch.no_grad()
    def act(self, obs_normed, sample_steps: int = 3, target_return: Optional[float] = None,
            generator: Optional[torch.Generator] = None, noise=None):
        """Plan from normalised observations (E, obs_dim): `sample_steps` 1
        for R2 (after reflow), 3 for R1. Returns the actions (E, act_dim)
        and {"traj": the last level's plan}. `noise` lists each level's
        initial draw (E, h_level, obs_dim)."""
        obs = self._f32(obs_normed)
        E = obs.shape[0]
        if (E, sample_steps) not in self._plan_fns:
            self._plan_fns[(E, sample_steps)] = self._make_plan_fn(E, sample_steps)
        tr = self.target_return if target_return is None else target_return
        condition = torch.ones((E, 1), device=self.device) * tr
        return self._plan_fns[(E, sample_steps)](generator or self._generator, obs, condition,
                                                 noise)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    @writer_only
    def save(self, path: str):
        for i, d in enumerate(self.diffusions):
            d.save(path + f".diffusion{i}")
        self.invdyn.save(path + ".invdyn")

    def load(self, path: str):
        for i, d in enumerate(self.diffusions):
            d.load(path + f".diffusion{i}")
        self.invdyn.load(path + ".invdyn")

    def load_jax_checkpoint(self, path: str):
        """Resume from the files the JAX pipeline's `save(path)` wrote
        (`path.diffusion<i>`, `path.invdyn`), without JAX installed."""
        for i, d in enumerate(self.diffusions):
            d.load_jax_checkpoint(path + f".diffusion{i}")
        self.invdyn.load_jax_checkpoint(path + ".invdyn")

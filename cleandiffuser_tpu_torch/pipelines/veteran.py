"""Diffusion Veteran (DV) pipeline (counterpart of
cleandiffuser_tpu/pipelines/veteran.py).

A continuous VP-SDE planner (linear schedule, x0 prediction, a DiT1d or a
Janner U-Net on the plain blocks, as the reference builds them) over state
trajectories ("separate") or state-action trajectories ("joint"), with the
first state pinned and the next state's loss weighted. Three guidance
types:

- "MCSS": K candidate plans per environment, ranked by the expected-value
  net (`IDQLVNet`, trained by TD in its own stage) summed over the plan's
  states after the first (`mcss_selector="ev"`), or by the
  `DVHorizonCritic` value head trained beside the planner ("critic",
  maze2d's);
- "cfg": one plan per environment under classifier-free guidance on the
  normalised return;
- "cg": K candidates under a `CumRewClassifier`'s gradient (half U-Net),
  ranked by its log p.

The action: the plan's first action ("joint"), or a policy from (s, s~')
with s~' the plan's next state ("separate"): a `DVInvMlp` diffusion policy
on a discrete VP-SDE (5 steps, clipped to [-1, 1]), or an `MlpInvDynamic`.
`rebase_policy` moves the pair so that s sits at the origin in x-y
(antmaze). `goal_inpaint` pins the plan's x-y at index `gi_pin_idx`
(default H - 1) to the environment's goal while sampling (maze2d; an
extension of the reference's, off by default).

Candidates are tiled env-major (row e*K + k), as the reference tiles them.
Random draws come from an explicit `torch.Generator` or as explicit noise
(`act(..., noise=)`, `train_step(..., noise=)`), which is how the tests
replay the reference's draws.

Training: `train_step(planner_batch, policy_batch)` updates the planner
(optionally with exponential weighted regression), the critic ("MCSS",
Adam) or the classifier on the batch noised by the planner ("cg"), then the
policy or inverse dynamics on (s_0, s_1, a_0) of the second batch.
`make_train_scan` is the CLI's window: per step two batches gathered on the
device, then `train_step`. The expected-value stage
(`train_expected_value_step`, `make_ev_train_scan`) trains the EV net by
TD against a Polyak target. `save` / `load` keep every component in one
`torch.save` file; `load_jax_checkpoint` reads the JAX pipeline's pickle.
A request's planner, scoring and policy run in the profiler ranges
"veteran.plan", "veteran.score" and "veteran.policy".
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..classifier import CumRewClassifier
from ..diffusion import ContinuousDiffusionSDE, DiscreteDiffusionSDE
from ..invdynamic import MlpInvDynamic
from ..nn_classifier import HalfJannerUNet1d
from ..nn_condition import IdentityCondition, MLPCondition
from ..nn_diffusion import DiT1d, DVInvMlp, JannerUNet1d
from ..utils.blocks import DVHorizonCritic, IDQLVNet
from ..utils.jax_params import load_adam_moments, load_jax_params
from ..utils.profiling import annotate
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from ..utils.train_state import (
    cosine_decay_schedule,
    ema_update,
    jax_adam_state,
    jax_train_state,
    load_train_state_dict,
    make_adam,
    read_jax_pickle,
    train_state_dict,
)
from .runner import step_window, train_window

__all__ = ["VeteranPipeline"]


class VeteranPipeline:
    EV_LOG_KEYS = ("loss_v", "v_mean")

    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        planner_horizon: int = 32,
        guidance_type: str = "MCSS",
        pipeline_type: str = "separate",
        planner_net: str = "transformer",
        use_diffusion_invdyn: bool = True,
        use_weighted_regression: bool = False,
        weight_factor: float = 10.0,
        planner_emb_dim: int = 128,
        planner_d_model: int = 320,
        planner_depth: int = 2,
        unet_dim: int = 32,
        next_obs_loss_weight: float = 10.0,
        policy_hidden_dim: int = 256,
        policy_diffusion_steps: int = 5,
        discount: float = 0.997,
        gradient_steps: int = 1_000_000,
        lr: float = 2e-4,
        critic_lr: float = 2e-4,
        planner_solver: str = "ddpm",
        planner_sampling_steps: int = 20,
        policy_solver: str = "ddpm",
        policy_sampling_steps: int = 5,
        w_cfg: float = 1.2,
        target_return: float = 0.9,
        temperature: float = 1.0,
        rebase_policy: bool = False,
        mcss_selector: str = "ev",
        goal_inpaint: bool = False,
        gi_pin_idx: Optional[int] = None,
        rng: int = 0,
        device=None,
    ):
        if guidance_type not in ("MCSS", "cfg", "cg"):
            raise ValueError(f"guidance_type {guidance_type!r}")
        if mcss_selector not in ("ev", "critic"):
            raise ValueError(f"mcss_selector {mcss_selector!r}")
        if pipeline_type not in ("separate", "joint"):
            raise ValueError(f"pipeline_type {pipeline_type!r}")
        if gi_pin_idx is not None and not 0 < gi_pin_idx < planner_horizon:
            raise ValueError(f"gi_pin_idx must be in (0, {planner_horizon})")
        self.device = default_device(device)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.planner_horizon = planner_horizon
        self.guidance_type, self.pipeline_type = guidance_type, pipeline_type
        self.mcss_selector, self.rebase_policy = mcss_selector, rebase_policy
        self.goal_inpaint, self.gi_pin_idx = goal_inpaint, gi_pin_idx
        self.use_diffusion_invdyn = use_diffusion_invdyn
        self.use_weighted_regression, self.weight_factor = use_weighted_regression, weight_factor
        self.discount = discount
        self.planner_solver, self.planner_sampling_steps = planner_solver, planner_sampling_steps
        self.policy_solver, self.policy_sampling_steps = policy_solver, policy_sampling_steps
        self.w_cfg, self.target_return, self.temperature = w_cfg, target_return, temperature
        self.planner_dim = PD = obs_dim if pipeline_type == "separate" else obs_dim + act_dim
        init = lambda k: torch.Generator().manual_seed(rng + k)

        if planner_net == "transformer":
            nn_diffusion = DiT1d(PD, planner_emb_dim, planner_d_model, planner_d_model // 32,
                                 planner_depth, timestep_emb_type="fourier", generator=init(0))
        else:
            nn_diffusion = JannerUNet1d(PD, model_dim=unet_dim, emb_dim=unet_dim,
                                        attention=False, kernel_size=5, generator=init(0))
        nn_condition = classifier = self.critic = None
        if guidance_type == "MCSS":
            self.critic = DVHorizonCritic(PD, planner_emb_dim, planner_d_model,
                                          planner_d_model // 32, depth=2, norm_type="pre",
                                          generator=init(2)).to(self.device)
            self.critic_opt = make_adam(self.critic.parameters(), critic_lr)
        elif guidance_type == "cfg":
            cond_dim = planner_emb_dim if planner_net == "transformer" else unet_dim
            nn_condition = MLPCondition(1, cond_dim, (cond_dim,), act=F.silu, dropout=0.25,
                                        generator=init(1))
        else:
            classifier = CumRewClassifier(
                HalfJannerUNet1d(planner_horizon, PD, out_dim=1, model_dim=unet_dim,
                                 emb_dim=unet_dim, kernel_size=3, generator=init(1)),
                device=self.device)

        fix_mask = np.zeros((planner_horizon, PD), np.float32)
        fix_mask[0, :obs_dim] = 1.0
        loss_weight = np.ones((planner_horizon, PD), np.float32)
        loss_weight[1] = next_obs_loss_weight
        self.planner = ContinuousDiffusionSDE(
            nn_diffusion, nn_condition, fix_mask=fix_mask, loss_weight=loss_weight,
            classifier=classifier, ema_rate=0.9999, predict_noise=False,
            noise_schedule="linear",
            optim_params={"lr": cosine_decay_schedule(lr, gradient_steps), "weight_decay": 0.0},
            rng=rng, device=self.device)

        self.policy = self.invdyn = None
        if pipeline_type == "separate":
            if use_diffusion_invdyn:
                self.policy = DiscreteDiffusionSDE(
                    DVInvMlp(obs_dim, act_dim, emb_dim=64, hidden_dim=policy_hidden_dim,
                             generator=init(3)),
                    IdentityCondition(dropout=0.0), predict_noise=True,
                    x_max=np.ones((act_dim,)), x_min=-np.ones((act_dim,)),
                    diffusion_steps=policy_diffusion_steps, ema_rate=0.995,
                    optim_params={"lr": 3e-4, "weight_decay": 0.0}, rng=rng + 3,
                    device=self.device)
            else:
                self.invdyn = MlpInvDynamic(obs_dim, act_dim, 512, torch.tanh, {"lr": 2e-4},
                                            generator=init(3), device=self.device)

        # the expected-value net of MCSS's "ev" selector, with its TD target
        self.ev_net = IDQLVNet(obs_dim, 256, generator=init(4)).to(self.device)
        self.ev_target = copy.deepcopy(self.ev_net).requires_grad_(False)
        self.ev_opt = make_adam(self.ev_net.parameters(), 3e-4)

        self._plan_fns = {}
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 5)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _f32(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def train_step(self, planner_batch, policy_batch=None, noise: Optional[dict] = None) -> dict:
        """One planner step and its guidance's step on `planner_batch`, then
        one policy (or inverse-dynamics) step on `policy_batch`'s first
        transitions ("separate" only). Returns device scalars
        "planner_loss", and "val_loss" and "val_pred" (MCSS),
        "classifier_loss" (cg), "policy_bc_loss" or "invdyn_loss".
        `noise` holds optional explicit draws: "planner" (t, eps,
        keep_mask), "classifier" (t, eps) of the classifier's noised input,
        "policy" (t, eps, keep_mask)."""
        noise = noise or {}
        obs, act, val = (self._f32(planner_batch["obs"]["state"]),
                         self._f32(planner_batch["act"]), self._f32(planner_batch["val"]))
        data = obs if self.pipeline_type == "separate" else torch.cat([obs, act], -1)
        gt, planner_noise = self.guidance_type, noise.get("planner")
        log = {}
        if gt == "cfg":
            out = self.planner.update(data, val, noise=planner_noise)
        elif self.use_weighted_regression:
            wrt = torch.exp((val - 1.0) * self.weight_factor)
            out = self.planner.update(data, noise=planner_noise, weighted_regression_tensor=wrt)
        else:
            out = self.planner.update(data, noise=planner_noise)
        log["planner_loss"] = out["loss"]

        if gt == "MCSS":
            pred = self.critic(data)
            loss = ((pred - val) ** 2).mean()
            loss.backward()
            self.critic_opt.step()
            log["val_loss"], log["val_pred"] = loss.detach(), pred.detach().mean()
        elif gt == "cg":
            t, eps = noise.get("classifier", (None, None))
            xt, t, _ = self.planner.add_noise(data, t, eps, self.planner.generator)
            log["classifier_loss"] = self.planner.classifier.update(xt, t, val)["loss"]

        if policy_batch is not None and self.pipeline_type == "separate":
            p_obs, p_act = self._f32(policy_batch["obs"]["state"]), self._f32(policy_batch["act"])
            o0, o1, a0 = p_obs[:, 0], p_obs[:, 1], p_act[:, 0]
            if self.policy is not None:
                log["policy_bc_loss"] = self.policy.update(
                    a0, torch.cat([o0, o1], -1), noise=noise.get("policy"))["loss"]
            else:
                log["invdyn_loss"] = self.invdyn.update(o0, a0, o1)["loss"]
        return log

    def log_keys(self):
        keys = ["planner_loss"]
        keys += {"MCSS": ["val_loss", "val_pred"], "cg": ["classifier_loss"], "cfg": []}[
            self.guidance_type]
        if self.pipeline_type == "separate":
            keys.append("policy_bc_loss" if self.policy is not None else "invdyn_loss")
        return tuple(keys)

    def step_fn(self, dataset, batch_size: int):
        """The CLI's step: `train_step` on two batches drawn one after the
        other from the generator (the planner's, then the policy's)."""
        return lambda g: self.train_step(dataset.sample_batch(g, batch_size),
                                         dataset.sample_batch(g, batch_size))

    def make_train_scan(self, dataset, batch_size: int, n_steps: int):
        """The planner stage's window: `run(generator) -> log` takes the
        `n_steps` steps `step_fn` takes one by one and returns the window
        means of `log_keys()` as device scalars, with no host sync inside
        the window."""
        return step_window(self.step_fn(dataset, batch_size), n_steps, self.log_keys(),
                           self.device)

    def train_expected_value_step(self, batch) -> dict:
        """One TD step of the EV net: V(s) against r + (1 - done) * discount
        * V_target(s'), Adam, then the target's Polyak step. Returns device
        scalars "loss_v" and "v_mean"."""
        obs, next_obs = self._f32(batch["obs"]["state"]), self._f32(batch["next_obs"]["state"])
        rew, tml = self._f32(batch["rew"]), self._f32(batch["tml"])
        with torch.no_grad():
            target_v = rew + (1 - tml) * self.discount * self.ev_target(next_obs)
        v = self.ev_net(obs)
        loss = ((v - target_v) ** 2).mean()
        loss.backward()
        self.ev_opt.step()
        # the reference's rule here: target <- 0.995 * target + 0.005 * online
        ema_update(self.ev_target, self.ev_net, 0.995)
        return {"loss_v": loss.detach(), "v_mean": v.detach().mean()}

    def make_ev_train_scan(self, dataset, batch_size: int, n_steps: int):
        """The EV stage's window: `n_steps` x `train_expected_value_step` on
        device gathers, window means as device scalars."""
        return train_window(self.train_expected_value_step, dataset, batch_size, n_steps,
                            self.EV_LOG_KEYS, self.device)

    # ------------------------------------------------------------------
    # Planning
    # ------------------------------------------------------------------
    def _make_plan_fn(self, E: int, K: int, with_goal: bool):
        H, PD, O = self.planner_horizon, self.planner_dim, self.obs_dim
        gt = self.guidance_type
        pin = self.gi_pin_idx if self.gi_pin_idx is not None else H - 1
        eval_fix_mask = None
        if with_goal:
            eval_fix_mask = np.zeros((H, PD), np.float32)
            eval_fix_mask[0, :O] = 1.0
            eval_fix_mask[pin, :2] = 1.0
        planner_sample = self.planner.build_sample_fn(
            solver=self.planner_solver, sample_steps=self.planner_sampling_steps,
            cfg_mode="mix" if gt == "cfg" else "uncond", use_cg=gt == "cg",
            final_logp=gt == "cg", fix_mask=eval_fix_mask)
        policy_sample = None if self.policy is None else self.policy.build_sample_fn(
            solver=self.policy_solver, sample_steps=self.policy_sampling_steps,
            cfg_mode="cond", final_logp=False)

        def plan(generator, obs, goal=None, noise=None):
            noise = noise or {}
            info = {}
            if gt in ("MCSS", "cg"):
                prior = torch.zeros((E * K, H, PD), device=obs.device)
                prior[:, 0, :O] = obs.repeat_interleave(K, 0)  # env-major: row e*K + k
                if goal is not None:
                    prior[:, pin, :2] = goal.repeat_interleave(K, 0)
                with annotate("veteran.plan"):
                    traj, log = planner_sample(
                        self.planner.ema_params, generator, prior,
                        temperature=self.temperature, noise=noise.get("plan"),
                        cls_params=(self.planner.classifier.inference_params if gt == "cg"
                                    else None),
                        w_cg=self.w_cfg if gt == "cg" else 0.0)
                with annotate("veteran.score"):
                    if gt == "cg":
                        value = log["log_p"].reshape(E, K)
                    elif self.mcss_selector == "critic":
                        value = self.critic(traj).reshape(E, K)
                    else:
                        value = self.ev_net(traj[..., :O])[:, 1:].sum(1).reshape(E, K)
                    idx = value.argmax(-1)
                candidates = traj.reshape(E, K, H, PD)
                traj = candidates[torch.arange(E, device=idx.device), idx]
                info.update(candidates=candidates, scores=value, idx=idx)
            else:
                prior = torch.zeros((E, H, PD), device=obs.device)
                prior[:, 0, :O] = obs
                if goal is not None:
                    prior[:, pin, :2] = goal
                condition = torch.ones((E, 1), device=obs.device) * self.target_return
                with annotate("veteran.plan"):
                    traj, _ = planner_sample(
                        self.planner.ema_params, generator, prior, condition_cfg=condition,
                        w_cfg=self.w_cfg, temperature=self.temperature, noise=noise.get("plan"))
            info["traj"] = traj

            if self.pipeline_type == "joint":
                return traj[:, 0, O:], info
            next_obs = traj[:, 1, :O]
            with annotate("veteran.policy"):
                if policy_sample is None:
                    return self.invdyn.predict(obs, next_obs), info
                obs_pol, next_pol = obs, next_obs
                if self.rebase_policy:
                    # translate the pair so that s sits at the origin in x-y
                    next_pol = next_pol.clone()
                    next_pol[:, :2] -= obs_pol[:, :2]
                    obs_pol = obs_pol.clone()
                    obs_pol[:, :2] = 0.0
                act, _ = policy_sample(
                    self.policy.ema_params, generator,
                    torch.zeros((E, self.act_dim), device=obs.device),
                    condition_cfg=torch.cat([obs_pol, next_pol], -1), w_cfg=1.0,
                    noise=noise.get("policy"))
            return act, info

        return plan

    @torch.no_grad()
    def act(self, obs_normed, num_candidates: int = 32,
            generator: Optional[torch.Generator] = None, goal_normed=None,
            noise: Optional[dict] = None):
        """Plan from normalised observations (E, obs_dim); `goal_normed`
        (E, 2) is pinned into the plan with `goal_inpaint`. Returns the
        actions (E, act_dim) and a dict: the chosen plan "traj" (E, H,
        planner_dim) and, for MCSS and cg, all "candidates" (E, K, H,
        planner_dim), their "scores" (E, K) and the pick "idx" (E,).
        `noise` holds optional explicit draws: "plan" and "policy", each
        (initial, per_step) as the SDE sampler takes them
        (diffusion/diffusionsde.py), "plan" of the E*K prior's shape."""
        obs = self._f32(obs_normed)
        goal = (self._f32(goal_normed) if self.goal_inpaint and goal_normed is not None
                else None)
        key = (obs.shape[0], num_candidates, goal is not None)
        if key not in self._plan_fns:
            self._plan_fns[key] = self._make_plan_fn(*key)
        return self._plan_fns[key](generator or self._generator, obs, goal, noise)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        pl = self.planner
        state = {"planner": train_state_dict(pl.params, pl.ema_params, pl.optimizer, pl.step,
                                             pl.generator),
                 "ev": {"params": self.ev_net.state_dict(),
                        "target": self.ev_target.state_dict(),
                        "optimizer": self.ev_opt.state_dict()}}
        if self.critic is not None:
            state["critic"] = {"params": self.critic.state_dict(),
                               "optimizer": self.critic_opt.state_dict()}
        if pl.classifier is not None:
            c = pl.classifier
            state["classifier"] = train_state_dict(c.params, c.ema_params, c.optimizer, c.step)
        if self.policy is not None:
            p = self.policy
            state["policy"] = train_state_dict(p.params, p.ema_params, p.optimizer, p.step,
                                               p.generator)
        if self.invdyn is not None:
            state["invdyn"] = {"params": self.invdyn.net.state_dict(),
                               "optimizer": self.invdyn.optimizer.state_dict()}
        return state

    @writer_only
    def save(self, path: str):
        """Every component in one `torch.save` file (the reference keeps
        them in one pickle)."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(self.state_dict(), path)

    def load(self, path: str):
        state = torch.load(path, map_location="cpu", weights_only=True)
        pl = self.planner
        pl.step = load_train_state_dict(state["planner"], pl.params, pl.ema_params,
                                        pl.optimizer, pl.generator)
        self.ev_net.load_state_dict(state["ev"]["params"])
        self.ev_target.load_state_dict(state["ev"]["target"])
        self.ev_opt.load_state_dict(state["ev"]["optimizer"])
        if self.critic is not None:
            self.critic.load_state_dict(state["critic"]["params"])
            self.critic_opt.load_state_dict(state["critic"]["optimizer"])
        if pl.classifier is not None:
            c = pl.classifier
            c.step = load_train_state_dict(state["classifier"], c.params, c.ema_params,
                                           c.optimizer)
        if self.policy is not None:
            p = self.policy
            p.step = load_train_state_dict(state["policy"], p.params, p.ema_params, p.optimizer,
                                           p.generator)
        if self.invdyn is not None:
            self.invdyn.net.load_state_dict(state["invdyn"]["params"])
            self.invdyn.optimizer.load_state_dict(state["invdyn"]["optimizer"])

    def load_jax_checkpoint(self, path: str):
        """Resume from the pickle the JAX pipeline's `save` wrote (planner,
        EV state, critic or classifier, policy or inverse dynamics), without
        JAX installed. PRNG keys have no counterpart: the generators keep
        their state."""
        state = read_jax_pickle(path)

        def adam_into(opt, net, opt_state):
            adam = jax_adam_state(opt_state)
            load_adam_moments(opt.optimizer, net, adam["mu"]["params"], adam["nu"]["params"],
                              adam["count"])
            if adam["schedule_count"] is not None:
                opt.set_count(adam["schedule_count"])

        self.planner.load_jax_state(jax_train_state(state["planner"]))
        ev = state["ev"]
        load_jax_params(self.ev_net, ev["params"]["params"])
        load_jax_params(self.ev_target, ev["target_params"]["params"])
        adam_into(self.ev_opt, self.ev_net, ev["opt_state"])
        if self.critic is not None and "critic_params" in state:
            load_jax_params(self.critic, state["critic_params"]["params"])
            adam_into(self.critic_opt, self.critic, state["critic_opt"])
        if self.planner.classifier is not None and "classifier" in state:
            self.planner.classifier.load_jax_state(jax_train_state(state["classifier"]))
        if self.policy is not None and "policy" in state:
            self.policy.load_jax_state(jax_train_state(state["policy"]))
        if self.invdyn is not None and "invdyn_params" in state:
            load_jax_params(self.invdyn.net, state["invdyn_params"]["params"])
            adam_into(self.invdyn.optimizer, self.invdyn.net, state["invdyn_opt"])

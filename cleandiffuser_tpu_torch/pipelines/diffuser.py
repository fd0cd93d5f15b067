"""Diffuser pipeline, planning path (counterpart of
cleandiffuser_tpu/pipelines/diffuser.py).

Joint (state, action) trajectory diffusion with a Janner U-Net,
first-state inpainting (fix_mask[0, :obs_dim] = 1), classifier guidance
from a `CumRewClassifier` on a half U-Net, and candidate-argmax plan
selection.

One `act` = one plan for E environments and K candidates each: the prior is
tiled candidate-major (row k*E + e), the K*E trajectories are sampled with
the classifier's gradient added at every step, scored by the classifier's
log p at t = 0, and the best candidate of each environment gives its first
action, clipped to [-1, 1]. With `use_pallas_block=True` every residual
block of the diffusion U-Net runs the fused Hopper kernel on a CUDA device
(ops/film_resblock.py), and every residual block of the classifier, which
is differentiated with respect to its input, the forward and
input-gradient kernels (ops/film_resblock_vjp.py). With `fused_update=True` every ddpm step runs the fused
solver-update kernel (ops/solver_update.py).

One `train_step` = the diffusion update (AdamW, cosine schedule over
`diffusion_gradient_steps`, no decay, EMA) on the joint (state, action)
trajectory, then, for the first `classifier_gradient_steps` steps, the
classifier's update (Adam, cosine schedule) on that trajectory noised to a
random level, against the batch's value. With `use_pallas_block=True` the
U-Net's forward runs K3 in every residual block, its backward autograd
through the plain version; the classifier's update, which needs its
weights' gradients, takes its plain blocks. `terminal_penalty` and `discount` are the value
targets' settings: stored as the JAX pipeline stores them and read by
nothing here (the dataset builds the targets from its own).
`make_train_scan` is the windowed trainer the CLI runs: a log window of
those steps on batches gathered on the device, logs kept on the device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..classifier import CumRewClassifier
from ..diffusion import DiscreteDiffusionSDE
from ..nn_classifier import HalfJannerUNet1d
from ..nn_diffusion import JannerUNet1d
from ..utils.jax_params import load_agent_params, load_jax_params
from ..utils.profiling import annotate
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from ..utils.train_state import cosine_decay_schedule
from .runner import train_window

__all__ = ["DiffuserPipeline"]


class DiffuserPipeline:
    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        horizon: int = 32,
        model_dim: int = 32,
        dim_mult: Sequence[int] = (1, 2, 2, 2),
        diffusion_steps: int = 20,
        sampling_steps: int = 20,
        solver: str = "ddpm",
        predict_noise: bool = True,
        action_loss_weight: float = 10.0,
        terminal_penalty: float = -100.0,
        discount: float = 0.997,
        ema_rate: float = 0.9999,
        diffusion_gradient_steps: int = 1_000_000,
        classifier_gradient_steps: int = 1_000_000,
        lr: float = 2e-4,
        w_cg: float = 0.1,
        temperature: float = 0.5,
        use_pallas_block: bool = False,
        fused_update: bool = False,
        rng: int = 0,
        device=None,
    ):
        self.obs_dim, self.act_dim, self.horizon = obs_dim, act_dim, horizon
        self.sampling_steps, self.solver = sampling_steps, solver
        self.w_cg, self.temperature = w_cg, temperature
        self.classifier_gradient_steps = classifier_gradient_steps
        self.terminal_penalty, self.discount = terminal_penalty, discount
        # read when a plan function is built; plans are cached per value
        self.fused_update = fused_update
        self.device = default_device(device)

        in_dim = obs_dim + act_dim
        nn_diffusion = JannerUNet1d(
            in_dim, model_dim=model_dim, emb_dim=model_dim, dim_mult=dim_mult,
            attention=False, kernel_size=5, use_pallas_block=use_pallas_block,
            generator=torch.Generator().manual_seed(rng),
        )
        nn_classifier = HalfJannerUNet1d(
            horizon, in_dim, out_dim=1, model_dim=model_dim, emb_dim=model_dim,
            dim_mult=dim_mult, kernel_size=3, use_pallas_block=use_pallas_block,
            generator=torch.Generator().manual_seed(rng + 1),
        )
        self.classifier = CumRewClassifier(
            nn_classifier,
            optim_params={"lr": cosine_decay_schedule(lr, classifier_gradient_steps)},
            device=self.device)

        fix_mask = np.zeros((horizon, in_dim), np.float32)
        fix_mask[0, :obs_dim] = 1.0
        loss_weight = np.ones((horizon, in_dim), np.float32)
        loss_weight[0, obs_dim:] = action_loss_weight

        self.agent = DiscreteDiffusionSDE(
            nn_diffusion, None, fix_mask=fix_mask, loss_weight=loss_weight,
            classifier=self.classifier, ema_rate=ema_rate,
            optim_params={"lr": cosine_decay_schedule(lr, diffusion_gradient_steps),
                          "weight_decay": 0.0},
            diffusion_steps=diffusion_steps, predict_noise=predict_noise, rng=rng,
            device=self.device,
        )
        self._plan_fns = {}
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 2)

    def load_jax_params(self, params: dict, ema_params: dict, cls_params: dict,
                        cls_ema_params: dict):
        """Load the JAX pipeline's `agent.state.params`, `agent.state.ema_params`,
        `classifier.state.params` and `classifier.state.ema_params` (nested
        dicts of numpy arrays)."""
        load_agent_params(self.agent.params, params)
        load_agent_params(self.agent.ema_params, ema_params)
        load_jax_params(self.classifier.params, cls_params["params"])
        load_jax_params(self.classifier.ema_params, cls_ema_params["params"])

    # ------------------------------------------------------------------
    def train_step(self, batch, noise=None, classifier_noise=None) -> dict:
        """One diffusion update (+ one classifier update within its budget)
        on batch {"obs": {"state": (B, H, obs)}, "act": (B, H, act), "val":
        (B, 1)}. Returns device scalars "loss", "grad_norm" and
        "classifier_loss" (within the budget). `noise` is the diffusion
        loss's optional explicit draws, `classifier_noise` = (t, eps) those
        of the classifier's noised input (else drawn from the engine's
        generator)."""
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        x = torch.cat([f32(batch["obs"]["state"]), f32(batch["act"])], dim=-1)
        log = self.agent.update(x, noise=noise)
        if self.agent.step <= self.classifier_gradient_steps:
            t, eps = classifier_noise if classifier_noise is not None else (None, None)
            xt, t, _ = self.agent.add_noise(x, t, eps, self.agent.generator)
            log["classifier_loss"] = self.classifier.update(xt, t, f32(batch["val"]))["loss"]
        return log

    def make_train_scan(self, dataset, batch_size: int, n_steps: int):
        """The fused trainer of one log window: `run(generator) -> log`
        takes `n_steps` steps, each a device gather from `generator`
        (`dataset.sample_batch`), the diffusion update and, while the
        engine's step is within `classifier_gradient_steps`, the
        classifier's update on the batch noised by the engine's `add_noise`:
        the steps `train_step(dataset.sample_batch(generator, batch_size))`
        takes one by one. Returns the window means of "loss", "grad_norm"
        and "classifier_loss" (0 on the steps past the budget) as device
        scalars, with no host sync inside the window."""
        return train_window(self.train_step, dataset, batch_size, n_steps,
                            ("loss", "grad_norm", "classifier_loss"), self.device)

    @writer_only
    def save(self, path: str):
        self.agent.save(path + ".diffusion")
        self.classifier.save(path + ".classifier")

    def load(self, path: str):
        self.agent.load(path + ".diffusion")
        self.classifier.load(path + ".classifier")

    def load_jax_checkpoint(self, diffusion_path: str, classifier_path: str):
        """Resume from the files the JAX pipeline's `save(path)` wrote
        (`path.diffusion`, `path.classifier`), without JAX installed."""
        self.agent.load_jax_checkpoint(diffusion_path)
        self.classifier.load_jax_checkpoint(classifier_path)

    # ------------------------------------------------------------------
    def _make_plan_fn(self, num_envs: int, num_candidates: int):
        E, K = num_envs, num_candidates
        H, O, A = self.horizon, self.obs_dim, self.act_dim
        sample_fn = self.agent.build_sample_fn(
            solver=self.solver, sample_steps=self.sampling_steps, cfg_mode="uncond",
            use_cg=True, final_logp=True, fused_update=self.fused_update)

        def plan(params, cls_params, generator, obs_normed, noise=None):
            prior = torch.zeros((E, H, O + A), device=obs_normed.device)
            prior[:, 0, :O] = obs_normed
            prior = prior.repeat(K, 1, 1)  # (K*E, H, O+A), candidate-major
            traj, log = sample_fn(params, generator, prior, w_cg=self.w_cg,
                                  temperature=self.temperature, noise=noise,
                                  cls_params=cls_params)
            logp = log["log_p"].reshape(K, E, -1).sum(-1)  # (K, E)
            idx = logp.argmax(0)
            traj = traj.reshape(K, E, H, O + A)
            envs = torch.arange(E, device=idx.device)
            best = traj[idx, envs]  # (E, H, O+A)
            act = torch.clamp(best[:, 0, O:], -1.0, 1.0)
            return act, {"traj": best, "logp": logp[idx, envs], "idx": idx,
                         "candidates": traj, "candidate_logp": logp}

        return plan

    @torch.no_grad()
    def act(self, obs_normed, num_candidates: int = 64,
            generator: Optional[torch.Generator] = None, use_ema: bool = True, noise=None):
        """Plan from normalised observations (E, obs_dim). Returns the
        actions (E, act_dim) and a dict: the chosen plan "traj" (E, horizon,
        obs_dim + act_dim), its "logp" (E,), the chosen candidate "idx" (E,),
        and all "candidates" (K, E, horizon, obs_dim + act_dim) with their
        "candidate_logp" (K, E). `noise` is the sampler's optional explicit
        noise (diffusion/diffusionsde.py), of the K*E prior's shape."""
        obs = torch.as_tensor(obs_normed, dtype=torch.float32, device=self.device)
        key = (obs.shape[0], num_candidates, self.fused_update)
        if key not in self._plan_fns:
            self._plan_fns[key] = self._make_plan_fn(obs.shape[0], num_candidates)
        params = self.agent.ema_params if use_ema else self.agent.params
        with annotate("diffuser.plan"):
            return self._plan_fns[key](params, self.classifier.inference_params,
                                       generator or self._generator, obs, noise)

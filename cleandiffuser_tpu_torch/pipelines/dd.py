"""Decision Diffuser pipeline, planning path (counterpart of
cleandiffuser_tpu/pipelines/dd.py).

State-only DiT planner with classifier-free guidance on the normalised
return (MLPCondition(1 -> emb)), first-state inpainting, and an
MlpInvDynamic that turns the plan's next state into the action.

One `act` = one plan: CFG trajectory sampling (doubled-batch forward at
every step) -> invdyn(s0, s1) -> action. With `use_pallas_block=True`, every
DiT block of every step runs the fused Hopper kernel on a CUDA device
(ops/dit_block.py).

One `train_step` = the diffusion update (AdamW, cosine schedule over
`diffusion_gradient_steps`, no decay, EMA) on the return normalised as
`val / return_scale + val_shift`, then, for the first
`invdyn_gradient_steps` steps, the inverse-dynamics update on the batch's
consecutive states. With `use_pallas_block=True` the forward of every DiT
block runs the kernel, its backward autograd through the plain version.
The budget counts the engine's host step counter (the reference's
`train_step` keeps its own, which a loaded checkpoint does not restore; its
fused trainer counts the restored device step, as this one does).
`make_train_scan` is the windowed trainer the CLI runs: a log window of
those steps on batches gathered on the device, logs kept on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion import ContinuousDiffusionSDE
from ..invdynamic import MlpInvDynamic
from ..nn_condition import MLPCondition
from ..nn_diffusion import DiT1d
from ..utils.jax_params import load_agent_params, load_jax_params
from ..utils.profiling import annotate
from ..utils.ranks import writer_only
from ..utils.tensors import default_device
from ..utils.train_state import cosine_decay_schedule
from .runner import train_window

__all__ = ["DDPipeline"]


class DDPipeline:
    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        horizon: int = 32,
        emb_dim: int = 128,
        d_model: int = 320,
        n_heads: int = 10,
        depth: int = 2,
        label_dropout: float = 0.25,
        predict_noise: bool = False,
        next_obs_loss_weight: float = 10.0,
        return_scale: float = 1000.0,
        ema_rate: float = 0.9999,
        diffusion_gradient_steps: int = 1_000_000,
        invdyn_gradient_steps: int = 1_000_000,
        lr: float = 2e-4,
        solver: str = "ddpm",
        sampling_steps: int = 20,
        w_cfg: float = 1.2,
        target_return: float = 0.9,
        temperature: float = 0.5,
        val_shift: float = 0.0,
        use_pallas_block: bool = False,
        rng: int = 0,
        device=None,
    ):
        self.obs_dim, self.act_dim, self.horizon = obs_dim, act_dim, horizon
        # antmaze conditions on val / scale + 1 (returns in [0, 1])
        self.return_scale, self.val_shift = return_scale, val_shift
        self.invdyn_gradient_steps = invdyn_gradient_steps
        self.solver, self.sampling_steps = solver, sampling_steps
        self.w_cfg, self.target_return, self.temperature = w_cfg, target_return, temperature
        self.device = default_device(device)

        init = torch.Generator().manual_seed(rng)
        nn_diffusion = DiT1d(
            in_dim=obs_dim, emb_dim=emb_dim, d_model=d_model, n_heads=n_heads,
            depth=depth, timestep_emb_type="fourier",
            use_pallas_block=use_pallas_block, generator=init,
        )
        nn_condition = MLPCondition(
            in_dim=1, out_dim=emb_dim, hidden_dims=(emb_dim,), act=F.silu,
            dropout=label_dropout, generator=init,
        )

        fix_mask = np.zeros((horizon, obs_dim), np.float32)
        fix_mask[0] = 1.0
        loss_weight = np.ones((horizon, obs_dim), np.float32)
        loss_weight[1] = next_obs_loss_weight

        self.agent = ContinuousDiffusionSDE(
            nn_diffusion, nn_condition, fix_mask=fix_mask, loss_weight=loss_weight,
            ema_rate=ema_rate, predict_noise=predict_noise, noise_schedule="linear",
            optim_params={"lr": cosine_decay_schedule(lr, diffusion_gradient_steps),
                          "weight_decay": 0.0},
            rng=rng, device=self.device,
        )
        self.invdyn = MlpInvDynamic(obs_dim, act_dim, 512, torch.tanh, {"lr": 2e-4},
                                    generator=torch.Generator().manual_seed(rng + 1),
                                    device=self.device)
        self._plan_fn = None
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 2)

    def load_jax_params(self, params: dict, ema_params: dict, invdyn_params: dict):
        """Load the JAX pipeline's `agent.state.params`, `agent.state.ema_params`
        and `invdyn.params` (nested dicts of numpy arrays)."""
        load_agent_params(self.agent.params, params)
        load_agent_params(self.agent.ema_params, ema_params)
        load_jax_params(self.invdyn.net, invdyn_params["params"])

    # ------------------------------------------------------------------
    def train_step(self, batch, noise=None) -> dict:
        """One diffusion update (+ one inverse-dynamics update within its
        budget) on batch {"obs": {"state": (B, H, obs)}, "act": (B, H, act),
        "val": (B, 1)}. Returns device scalars "loss", "grad_norm" and
        "invdyn_loss" (within the budget). `noise` is the diffusion loss's
        optional explicit draws (diffusion/diffusionsde.py `loss_fn`)."""
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        obs, act = f32(batch["obs"]["state"]), f32(batch["act"])
        val = f32(batch["val"]) / self.return_scale + self.val_shift
        log = self.agent.update(obs, val, noise=noise)
        if self.agent.step <= self.invdyn_gradient_steps:
            o = obs[:, :-1].reshape(-1, self.obs_dim)
            a = act[:, :-1].reshape(-1, self.act_dim)
            o2 = obs[:, 1:].reshape(-1, self.obs_dim)
            log["invdyn_loss"] = self.invdyn.update(o, a, o2)["loss"]
        return log

    def make_train_scan(self, dataset, batch_size: int, n_steps: int):
        """The fused trainer of one log window: `run(generator) -> log`
        takes `n_steps` steps, each a device gather from `generator`
        (`dataset.sample_batch`), the diffusion update and, while the
        engine's step is within `invdyn_gradient_steps`, the
        inverse-dynamics update: the steps `train_step(dataset.sample_batch(
        generator, batch_size))` takes one by one. Returns the window means
        of "loss", "grad_norm" and "invdyn_loss" (0 on the steps past the
        budget) as device scalars, with no host sync inside the window."""
        return train_window(self.train_step, dataset, batch_size, n_steps,
                            ("loss", "grad_norm", "invdyn_loss"), self.device)

    @writer_only
    def save(self, path: str):
        self.agent.save(path + ".diffusion")
        self.invdyn.save(path + ".invdyn")

    def load(self, path: str):
        self.agent.load(path + ".diffusion")
        self.invdyn.load(path + ".invdyn")

    def load_jax_checkpoint(self, diffusion_path: str, invdyn_path: str):
        """Resume from the files the JAX pipeline's `save(path)` wrote
        (`path.diffusion`, `path.invdyn`), without JAX installed."""
        self.agent.load_jax_checkpoint(diffusion_path)
        self.invdyn.load_jax_checkpoint(invdyn_path)

    # ------------------------------------------------------------------
    def _make_plan_fn(self):
        sample_fn = self.agent.build_sample_fn(
            solver=self.solver, sample_steps=self.sampling_steps, cfg_mode="mix")

        def plan(params, generator, obs_normed, condition, noise=None):
            E = obs_normed.shape[0]
            prior = torch.zeros((E, self.horizon, self.obs_dim), device=obs_normed.device)
            prior[:, 0] = obs_normed
            traj, _ = sample_fn(params, generator, prior, condition_cfg=condition,
                                w_cfg=self.w_cfg, temperature=self.temperature, noise=noise)
            act = self.invdyn.predict(obs_normed, traj[:, 1, :])
            return act, traj

        return plan

    @torch.no_grad()
    def act(self, obs_normed, target_return: Optional[float] = None,
            generator: Optional[torch.Generator] = None, use_ema: bool = True,
            noise=None):
        """Plan from normalised observations (E, obs_dim). Returns the
        actions (E, act_dim) and {"traj": (E, horizon, obs_dim)}. `noise`
        is the sampler's optional explicit noise (diffusion/diffusionsde.py)."""
        if self._plan_fn is None:
            self._plan_fn = self._make_plan_fn()
        obs = torch.as_tensor(obs_normed, dtype=torch.float32, device=self.device)
        tr = self.target_return if target_return is None else target_return
        condition = torch.ones((obs.shape[0], 1), device=self.device) * tr
        params = self.agent.ema_params if use_ema else self.agent.params
        with annotate("dd.plan"):
            act, traj = self._plan_fn(params, generator or self._generator, obs, condition,
                                      noise)
        return act, {"traj": traj}

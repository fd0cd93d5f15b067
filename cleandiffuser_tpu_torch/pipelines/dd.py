"""Decision Diffuser pipeline, planning path (counterpart of
cleandiffuser_tpu/pipelines/dd.py).

State-only DiT planner with classifier-free guidance on the normalised
return (MLPCondition(1 -> emb)), first-state inpainting, and an
MlpInvDynamic that turns the plan's next state into the action.

One `act` = one plan: CFG trajectory sampling (doubled-batch forward at
every step) -> invdyn(s0, s1) -> action. With `use_pallas_block=True`, every
DiT block of every step runs the fused Hopper kernel on a CUDA device
(ops/dit_block.py). Training (`train_step`, `make_train_scan`, and with it
the return normalisation `return_scale` / `val_shift`) comes later.
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
from ..utils.tensors import default_device

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
        solver: str = "ddpm",
        sampling_steps: int = 20,
        w_cfg: float = 1.2,
        target_return: float = 0.9,
        temperature: float = 0.5,
        use_pallas_block: bool = False,
        rng: int = 0,
        device=None,
    ):
        self.obs_dim, self.act_dim, self.horizon = obs_dim, act_dim, horizon
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
            predict_noise=predict_noise, noise_schedule="linear", device=self.device,
        )
        self.invdyn = MlpInvDynamic(obs_dim, act_dim, 512, torch.tanh,
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
        act, traj = self._plan_fn(params, generator or self._generator, obs, condition, noise)
        return act, {"traj": traj}

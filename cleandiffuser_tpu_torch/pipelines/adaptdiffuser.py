"""AdaptDiffuser pipeline (counterpart of
cleandiffuser_tpu/pipelines/adaptdiffuser.py).

Diffuser plus a self-evolving stage: generate trajectories from dataset
start states with classifier guidance, keep those whose classifier log p
clears a threshold, and fine-tune the diffusion model on the kept set.
Generation is a Diffuser plan without candidates: one trajectory per start
state, the first state inpainted, the EMA U-Net (its residual blocks
through the fused kernel when `use_pallas_block` is on) and the classifier's
gradient at every step (its blocks through the forward and input-gradient
kernels when the flag is on), the final log p returned.
"""

from __future__ import annotations

from typing import Optional

import torch

from .diffuser import DiffuserPipeline

__all__ = ["AdaptDiffuserPipeline"]


class AdaptDiffuserPipeline(DiffuserPipeline):
    """Diffuser with `generate_and_filter` and `finetune_step`."""

    def _make_gen_fn(self, n: int, sampling_steps: int):
        H, O, A = self.horizon, self.obs_dim, self.act_dim
        sample_fn = self.agent.build_sample_fn(
            solver=self.solver, sample_steps=sampling_steps, cfg_mode="uncond", use_cg=True,
            final_logp=True, fused_update=self.fused_update)

        def gen(params, cls_params, generator, obs, noise=None):
            prior = torch.zeros((n, H, O + A), device=obs.device)
            prior[:, 0, :O] = obs
            traj, log = sample_fn(params, generator, prior, w_cg=self.w_cg,
                                  temperature=self.temperature, noise=noise,
                                  cls_params=cls_params)
            return traj, log["log_p"]

        return gen

    @torch.no_grad()
    def generate_and_filter(self, start_obs, metric_value: float,
                            sampling_steps: Optional[int] = None,
                            generator: Optional[torch.Generator] = None, noise=None):
        """Sample one trajectory (N, horizon, obs_dim + act_dim) from each
        normalised start state (N, obs_dim), from the EMA weights; return the
        trajectories whose classifier log p (N, 1) exceeds `metric_value`,
        and their log p, on the pipeline's device. `noise` is the sampler's
        optional explicit noise (diffusion/diffusionsde.py), of the (N,
        horizon, obs_dim + act_dim) prior's shape."""
        obs = torch.as_tensor(start_obs, dtype=torch.float32, device=self.device)
        steps = sampling_steps or self.sampling_steps
        key = ("gen", obs.shape[0], steps, self.fused_update)
        if key not in self._plan_fns:
            self._plan_fns[key] = self._make_gen_fn(obs.shape[0], steps)
        traj, logp = self._plan_fns[key](self.agent.ema_params, self.classifier.inference_params,
                                         generator or self._generator, obs, noise)
        keep = logp[:, 0] > metric_value
        return traj[keep], logp[keep]

    def finetune_step(self, traj_batch, noise=None) -> dict:
        """One diffusion update (and EMA step) on a batch of kept
        trajectories (B, horizon, obs_dim + act_dim); the classifier stays.
        `noise` is the loss's optional explicit draws."""
        x = torch.as_tensor(traj_batch, dtype=torch.float32, device=self.device)
        return self.agent.update(x, noise=noise)

"""EDP, Efficient Diffusion Policy (counterpart of
cleandiffuser_tpu/pipelines/edp.py): DQL's networks, critic update, gates
and `act`, with the policy's Q-loss on the one-step action approximation
instead of backprop through the sampler. Each step noises the batch's
actions to an integer level t uniform on [0, T) (`noisy = alpha_t * act +
sigma_t * eps`) and scores the backbone's raw, unclipped prediction from
there. Its defaults: x0 prediction, 15 sampling steps.

`train_step(batch, noise)` takes DQL's draws ("next", "bc", "coin") and
"q", the (t, eps) of the approximation, in place of "new".
"""

from __future__ import annotations

from .dql import DQLPipeline

__all__ = ["EDPPipeline"]


class EDPPipeline(DQLPipeline):
    def __init__(self, *args, predict_noise: bool = False, sampling_steps: int = 15, **kwargs):
        super().__init__(*args, predict_noise=predict_noise, sampling_steps=sampling_steps,
                         **kwargs)

    def _policy_actions(self, obs, act, noise: dict):
        actor, params = self.actor, self.actor.params
        t, eps = noise.get("q") or (None, None)
        noisy_act, t, _ = actor.add_noise(act, t, eps, actor.generator)
        emb = actor.apply_condition(params, obs, train=False)
        return actor.apply_diffusion(params, noisy_act, t, emb)

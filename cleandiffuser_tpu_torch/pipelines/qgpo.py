"""QGPO pipeline (counterpart of cleandiffuser_tpu/pipelines/qgpo.py), in
four stages and an evaluation:

1. behavior cloning: an `SfBCUNet` actor on a `ContinuousDiffusionSDE`
   (AdamW at the engine's defaults, so the untrainable Fourier frequencies
   decay as the reference's do), `bc_train_step` / `make_bc_train_scan`;
2. `collect_supported_actions`: K actions per next state from the EMA actor
   (10 ddpm steps on the `quad_continuous` schedule), in batches of
   `batch_size` states, the last batch padded up to it;
3. Q training over the support (`q_train_step`, `make_q_train_scan`): a
   `TwinQ` trained by TD on rew + discount (1 - tml) sum_k softmax(betaQ
   Q_target(s', a_k)) Q_target(s', a_k), Adam 3e-4, and the target
   `0.995 target + 0.005 online` on every step;
4. contrastive energy prediction (`cep_train_step`,
   `make_cep_train_scan`): the support actions noised as in training, soft
   labels softmax(beta Q(s', a_k)) from the Q network, one
   `QGPOClassifier` step (Adam 1e-3);
5. `act`: classifier-guided sampling (`w_cg`), the final log p of each
   candidate, and a categorical pick over them (pipelines/dql.py
   `gumbel_pick`).

The two trainers of stages 3 and 4 share one device store
(`support_store`): the dataset's device transitions and the support set,
placed once. Draws come from an explicit generator or as `noise=`. No
kernel runs on this path: the nets are MLPs.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..classifier import QGPOClassifier
from ..diffusion import ContinuousDiffusionSDE
from ..nn_classifier import QGPONNClassifier
from ..nn_condition import MLPCondition
from ..nn_diffusion import SfBCUNet
from ..utils.blocks import TwinQ
from ..utils.jax_params import load_jax_params
from ..utils.tensors import default_device
from ..utils.train_state import ema_update, make_adam, read_jax_pickle
from .dql import gumbel_pick
from .runner import step_window, train_window

__all__ = ["QGPOPipeline"]


class QGPOPipeline:
    LOG_KEYS = ("loss", "grad_norm")
    CEP_LOG_KEYS = ("loss", "f_max", "f_mean", "f_min")

    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        K: int = 16,
        betaQ: float = 1.0,
        beta: float = 1.0,
        emb_dim: int = 64,
        ema_rate: float = 0.995,
        discount: float = 0.99,
        rng: int = 0,
        device=None,
    ):
        self.obs_dim, self.act_dim, self.K = obs_dim, act_dim, K
        self.betaQ, self.beta, self.discount = betaQ, beta, discount
        self.device = default_device(device)
        init = torch.Generator().manual_seed(rng)
        self.actor = ContinuousDiffusionSDE(
            SfBCUNet(act_dim, emb_dim, generator=init),
            MLPCondition(obs_dim, emb_dim, (emb_dim,), act=F.silu, generator=init),
            ema_rate=ema_rate, x_max=np.ones((act_dim,)), x_min=-np.ones((act_dim,)),
            rng=rng, device=self.device,
        )
        q_init = torch.Generator().manual_seed(rng + 1)
        self.q_net = TwinQ(obs_dim, act_dim, 256, generator=q_init).to(self.device)
        self.q_target = copy.deepcopy(self.q_net).requires_grad_(False)
        self.q_optimizer = make_adam(self.q_net.parameters(), 3e-4)
        self.classifier = QGPOClassifier(
            QGPONNClassifier(obs_dim, act_dim, emb_dim, hidden_dims=(256, 256, 256),
                             timestep_emb_type="untrainable_fourier",
                             generator=torch.Generator().manual_seed(rng + 2)),
            ema_rate=ema_rate, optim_params={"lr": 1e-3}, device=self.device)
        self.actor.classifier = self.classifier
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 3)
        self._sample_fns = {}
        self._store = None

    def _f32(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # Stage 1: behavior cloning
    def bc_train_step(self, batch, noise=None) -> dict:
        return self.actor.update(self._f32(batch["act"]), self._f32(batch["obs"]["state"]),
                                 noise=noise)

    def make_bc_train_scan(self, dataset, batch_size: int, n_steps: int):
        return train_window(self.bc_train_step, dataset, batch_size, n_steps, self.LOG_KEYS,
                            self.device)

    # ------------------------------------------------------------------
    # Stage 2: the support set
    @torch.no_grad()
    def collect_supported_actions(self, next_obs: np.ndarray, batch_size: int = 5000,
                                  sampling_steps: int = 10,
                                  generator: Optional[torch.Generator] = None, noise=None):
        """K EMA actions per state, (N, K, act_dim) numpy. Every sampler call
        takes `batch_size` states (the last batch padded with zeros);
        `noise`, when given, is one sampler draw (initial, per_step) per
        batch, its rows state-major."""
        key = ("collect", sampling_steps)
        if key not in self._sample_fns:
            self._sample_fns[key] = self.actor.build_sample_fn(
                solver="ddpm", sample_steps=sampling_steps,
                sample_step_schedule="quad_continuous", cfg_mode="cond", final_logp=False)
        fn, K, gen = self._sample_fns[key], self.K, generator or self._generator
        N = next_obs.shape[0]
        out = np.empty((N, K, self.act_dim), np.float32)
        prior = torch.zeros((batch_size * K, self.act_dim), device=self.device)
        for b, i in enumerate(range(0, N, batch_size)):
            sl = slice(i, min(i + batch_size, N))
            n = sl.stop - sl.start
            obs = np.zeros((batch_size, self.obs_dim), np.float32)
            obs[:n] = next_obs[sl]
            obs_rep = self._f32(obs).repeat_interleave(K, dim=0)
            acts, _ = fn(self.actor.ema_params, gen, prior, condition_cfg=obs_rep, w_cfg=1.0,
                         noise=None if noise is None else noise[b])
            out[sl] = acts.reshape(batch_size, K, self.act_dim)[:n].cpu().numpy()
            if b % 10 == 0 or sl.stop == N:
                print(f"supported actions: step {sl.stop}/{N}", flush=True)
        return out

    def support_store(self, dataset, sup) -> dict:
        """The device store of the Q and CEP trainers: the dataset's device
        transitions (obs, next_obs, act, rew, tml) and the support set, placed
        once per support array and shared by both."""
        if self._store is None or self._store[0] is not sup:
            arrays = dict(dataset._sampler.arrays)
            arrays["sup"] = torch.as_tensor(np.ascontiguousarray(sup), dtype=torch.float32,
                                            device=self.device)
            self._store = (sup, arrays)
        return self._store[1]

    @staticmethod
    def store_batch(store: dict, idx) -> dict:
        return {"obs": {"state": store["obs"][idx]}, "next_obs": {"state": store["next_obs"][idx]},
                "act": store["act"][idx], "rew": store["rew"][idx], "tml": store["tml"][idx],
                "supported_act": store["sup"][idx]}

    # ------------------------------------------------------------------
    # Stage 3: Q over the support
    def q_train_step(self, batch) -> dict:
        obs, act = self._f32(batch["obs"]["state"]), self._f32(batch["act"])
        next_obs = self._f32(batch["next_obs"]["state"])
        rew, tml, sup = self._f32(batch["rew"]), self._f32(batch["tml"]), self._f32(
            batch["supported_act"])
        B, K = sup.shape[:2]
        with torch.no_grad():
            next_q = self.q_target(next_obs[:, None, :].expand(B, K, self.obs_dim), sup)
            w = torch.softmax(self.betaQ * next_q, dim=1)
            td_target = rew + self.discount * (1 - tml) * (next_q * w).sum(1)
        q1, q2 = self.q_net.both(obs, act)
        loss = ((q1 - td_target) ** 2 + (q2 - td_target) ** 2).mean()
        loss.backward()
        self.q_optimizer.step()
        ema_update(self.q_target, self.q_net, 0.995)
        return {"q_loss": loss.detach()}

    def make_q_train_scan(self, dataset, sup, batch_size: int, n_steps: int):
        """`run(generator) -> {"q_loss"}`: `n_steps` Q steps on batches drawn
        from the shared store, the window mean on the device."""
        store, size = self.support_store(dataset, sup), dataset.size

        def step(g):
            idx = torch.randint(size, (batch_size,), generator=g, device=g.device)
            return self.q_train_step(self.store_batch(store, idx.to(self.device)))

        return step_window(step, n_steps, ("q_loss",), self.device)

    # ------------------------------------------------------------------
    # Stage 4: contrastive energy prediction
    def cep_train_step(self, batch, noise=None, generator: Optional[torch.Generator] = None):
        """One classifier step. `noise=(t, eps)` gives the noising draws
        (levels (B,), noise of the support's shape); otherwise they come
        from `generator` (the pipeline's by default)."""
        next_obs = self._f32(batch["next_obs"]["state"])
        sup = self._f32(batch["supported_act"])
        B, K = sup.shape[:2]
        t, eps = noise if noise is not None else (None, None)
        with torch.no_grad():
            pred_q = self.q_net(next_obs[:, None, :].expand(B, K, self.obs_dim), sup)
            soft_label = torch.softmax(self.beta * pred_q, dim=1)
            noisy_act, t, _ = self.actor.add_noise(sup, t, eps, generator or self._generator)
        return self.classifier.update(noisy_act, t, {"soft_label": soft_label, "obs": next_obs})

    def make_cep_train_scan(self, dataset, sup, batch_size: int, n_steps: int):
        """`run(generator) -> log`: `n_steps` CEP steps on batches drawn from
        the shared store (indices, then the noising draws, from the
        generator), the window means on the device."""
        store, size = self.support_store(dataset, sup), dataset.size

        def step(g):
            idx = torch.randint(size, (batch_size,), generator=g, device=g.device)
            return self.cep_train_step(self.store_batch(store, idx.to(self.device)), generator=g)

        return step_window(step, n_steps, self.CEP_LOG_KEYS, self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def act(self, obs_normed, w_cg: float = 1.0, num_candidates: int = 1,
            sampling_steps: int = 5, generator: Optional[torch.Generator] = None, noise=None,
            return_info: bool = False):
        """Classifier-guided actions (E, act_dim): `num_candidates` per env
        from the EMA actor, one picked per env from softmax(log p).
        `noise=(sampler_noise, gumbel)` as in `DQLPipeline.act`. With
        `return_info`, (actions, {"candidates", "log_p" (E, K), "scores"
        (the Gumbel-perturbed log p the pick is the argmax of), "idx"})."""
        key = ("act", sampling_steps, w_cg != 0.0)
        if key not in self._sample_fns:
            self._sample_fns[key] = self.actor.build_sample_fn(
                solver="ddpm", sample_steps=sampling_steps,
                sample_step_schedule="quad_continuous", cfg_mode="cond", use_cg=w_cg != 0.0,
                final_logp=True)
        sample_noise, gumbel = noise if noise is not None else (None, None)
        gen = generator or self._generator
        obs = self._f32(obs_normed)
        E, K = obs.shape[0], num_candidates
        obs_rep = obs.repeat_interleave(K, dim=0)
        prior = torch.zeros((E * K, self.act_dim), device=self.device)
        act, log = self._sample_fns[key](
            self.actor.ema_params, gen, prior, condition_cfg=obs_rep, w_cfg=1.0,
            noise=sample_noise, cls_params=self.classifier.inference_params,
            condition_cg=obs_rep, w_cg=w_cg)
        logp = log["log_p"].reshape(E, K)
        cand = act.reshape(E, K, -1)
        out, idx, perturbed = gumbel_pick(cand, logp, gen, gumbel)
        if return_info:
            return out, {"candidates": cand, "log_p": logp, "scores": perturbed, "idx": idx}
        return out

    # ------------------------------------------------------------------
    def save_q(self, path: str):
        """The Q network and its target (the CEP stage reads the network)."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"params": self.q_net.state_dict(),
                    "target_params": self.q_target.state_dict()}, path)

    def load_q(self, path: str):
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.q_net.load_state_dict(state["params"])
        self.q_target.load_state_dict(state["target_params"])

    def load_jax_q_state(self, path: str):
        """Read the JAX CLI's `q_state.pkl` (the Q network's flax params;
        the reference keeps no target or optimizer there), without JAX."""
        load_jax_params(self.q_net, read_jax_pickle(path)["params"])

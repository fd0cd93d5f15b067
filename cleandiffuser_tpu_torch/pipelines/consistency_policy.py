"""The staged consistency policy (counterpart of
cleandiffuser_tpu/pipelines/consistency_policy.py): IQL, then an `IDQLMlp`
behavior policy trained as a `ContinuousEDM`, then a
`ContinuousConsistencyModel` distilled from it (CD) or trained directly
(CT), for 1-2 network evaluations per action; `act` samples candidates from
the chosen actor ("edm", "cd" or "ct") and picks one per env from
softmax(weight_temperature * (min-Q_target - V)) of IQL.

Each stage's step takes its draws explicitly (`noise=`, the engine's
`update` convention: EDM (sigma, eps, keep), CT (idx, eps, keep), CD (idx,
eps)); the backbones' dropout masks come from the engines' generators.
`act(noise=(sampler_noise, gumbel))`: the EDM sampler's initial draw, or
the consistency sampler's (initial, per_step), and the pick's Gumbel noise
(E, K). No kernel runs on this path: the nets are MLPs.

`goal2d_gate` is the hermetic score gate's recipe on the Goal2D behavior
data; the slow tests and the card's smoke run both call it.
"""

from __future__ import annotations

from typing import Optional

import time

import numpy as np
import torch

from ..dataset.d4rl_mujoco import D4RLMuJoCoTDDataset
from ..dataset.hermetic import goal2d_qlearning_dataset
from ..diffusion import ContinuousConsistencyModel, ContinuousEDM
from ..nn_condition import IdentityCondition
from ..nn_diffusion import IDQLMlp
from ..env.goal2d import evaluate_policy, normalized_score_fn
from ..utils.iql import IQL
from ..utils.tensors import default_device
from .dql import gumbel_pick

__all__ = ["ConsistencyPolicyPipeline", "goal2d_gate"]


class ConsistencyPolicyPipeline:
    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        emb_dim: int = 64,
        hidden_dim: int = 256,
        iql_tau: float = 0.7,
        discount: float = 0.99,
        curriculum_cycle: int = 100_000,
        s0: int = 10,
        s1: int = 1280,
        rng: int = 0,
        device=None,
    ):
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.device = default_device(device)
        self.iql = IQL(obs_dim, act_dim, tau=iql_tau, discount=discount, hidden_dim=hidden_dim,
                       rng=rng, device=self.device)

        def backbone(seed):
            return IDQLMlp(obs_dim=obs_dim, act_dim=act_dim, emb_dim=emb_dim,
                           hidden_dim=hidden_dim, generator=torch.Generator().manual_seed(seed))

        bounds = dict(x_max=np.ones((act_dim,)), x_min=-np.ones((act_dim,)))
        self.edm = ContinuousEDM(backbone(rng + 1), IdentityCondition(dropout=0.0), **bounds,
                                 rng=rng + 1, device=self.device)
        self.cm = ContinuousConsistencyModel(
            backbone(rng + 2), IdentityCondition(dropout=0.0), **bounds, s0=s0, s1=s1,
            data_dim=act_dim, curriculum_cycle=curriculum_cycle, rng=rng + 2,
            device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(rng + 3)
        self._sample_fns = {}

    def _f32(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    def iql_train_step(self, batch) -> dict:
        obs, act = self._f32(batch["obs"]["state"]), self._f32(batch["act"])
        next_obs, rew, tml = (self._f32(batch["next_obs"]["state"]), self._f32(batch["rew"]),
                              self._f32(batch["tml"]))
        loss_v = self.iql.update_V(obs, act)
        loss_q = self.iql.update_Q(obs, act, rew, next_obs, tml)
        return {"loss_v": loss_v, "loss_q": loss_q}

    def edm_train_step(self, batch, noise=None) -> dict:
        return self.edm.update(self._f32(batch["act"]), self._f32(batch["obs"]["state"]),
                               noise=noise)

    def prepare_distillation(self, distillation_N: int = 18):
        self.cm.prepare_distillation(self.edm, distillation_N)

    def cd_train_step(self, batch, noise=None) -> dict:
        return self.cm.update(self._f32(batch["act"]), self._f32(batch["obs"]["state"]),
                              loss_type="distillation", noise=noise)

    def ct_train_step(self, batch, noise=None) -> dict:
        return self.cm.update(self._f32(batch["act"]), self._f32(batch["obs"]["state"]),
                              loss_type="training", noise=noise)

    # ------------------------------------------------------------------
    def _sampler(self, model: str, sampling_steps: int):
        key = (model, sampling_steps)
        if key not in self._sample_fns:
            if model == "edm":
                fn = self.edm.build_sample_fn(solver="euler", sample_steps=sampling_steps,
                                              cfg_mode="cond", final_logp=False)
                actor = self.edm
            elif model == "edm_heun":
                fn = self.edm.build_sample_fn(solver="heun", sample_steps=sampling_steps,
                                              cfg_mode="cond", final_logp=False)
                actor = self.edm
            elif model in ("cd", "ct"):
                fn = self.cm.build_sample_fn(sample_steps=sampling_steps, cfg_mode="cond")
                actor = self.cm
            else:
                raise ValueError(f"unknown model {model!r}: edm, edm_heun, cd or ct")
            self._sample_fns[key] = (fn, actor)
        return self._sample_fns[key]

    @torch.no_grad()
    def act(self, obs_normed, model: str = "ct", num_candidates: int = 32,
            sampling_steps: int = 2, weight_temperature: float = 100.0,
            generator: Optional[torch.Generator] = None, noise=None, return_info: bool = False):
        """Actions (E, act_dim) from the chosen actor's EMA ("edm" Euler,
        "edm_heun", "cd" or "ct"), clipped to [-1, 1], one of
        `num_candidates` per env picked by the IQL advantage. With
        `return_info`, (actions, {"candidates", "adv" (E, K), "scores" (the
        Gumbel-perturbed logits the pick is the argmax of), "idx"})."""
        fn, actor = self._sampler(model, sampling_steps)
        sample_noise, gumbel = noise if noise is not None else (None, None)
        gen = generator or self._generator
        obs = self._f32(obs_normed)
        E, K = obs.shape[0], num_candidates
        obs_rep = obs.repeat_interleave(K, dim=0)
        prior = torch.zeros((E * K, self.act_dim), device=self.device)
        a, _ = fn(actor.ema_params, gen, prior, condition_cfg=obs_rep, w_cfg=1.0,
                  noise=sample_noise)
        a = torch.clamp(a, -1.0, 1.0)
        adv = (self.iql.q_target(obs_rep, a) - self.iql.v(obs_rep)).reshape(E, K)
        cand = a.reshape(E, K, -1)
        out, idx, perturbed = gumbel_pick(cand, adv * weight_temperature, gen, gumbel)
        if return_info:
            return out, {"candidates": cand, "adv": adv, "scores": perturbed, "idx": idx}
        return out

    # ------------------------------------------------------------------
    def save(self, path: str):
        self.iql.save(path + ".iql")
        self.edm.save(path + ".edm")
        self.cm.save(path + ".cm")

    def load(self, path: str):
        self.iql.load(path + ".iql")
        self.edm.load(path + ".edm")
        self.cm.load(path + ".cm")


def goal2d_gate(device=None, steps=(2000, 3000, 2000), batch_size: int = 128,
                seed: int = 0) -> dict:
    """The hermetic gate's recipe (JAX tests/test_hermetic_parity.py:160):
    IQL, EDM and distillation (18 levels) for `steps` at `batch_size` on
    the Goal2D behavior data (1000 episodes), then 128 episodes with 32
    candidates per env from the EDM teacher at 5 Euler steps and from the
    distilled student at 2 NFE. Returns {"pipe", "dataset", "teacher",
    "student" (normalized scores), "ms" (per step of each stage, the device
    synchronized), "cd_loss"}."""
    device = default_device(device)
    ds = D4RLMuJoCoTDDataset(goal2d_qlearning_dataset(n_episodes=1000, seed=0), device=device)
    pipe = ConsistencyPolicyPipeline(obs_dim=2, act_dim=2, emb_dim=32, hidden_dim=128,
                                     curriculum_cycle=2000, s0=10, s1=160, rng=0, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    norm = ds.get_normalizer()
    score = normalized_score_fn(device=device)
    ms = {}

    def stage(name, step, n):
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            log = step(ds.sample_batch(gen, batch_size))
        sync()
        ms[name] = (time.perf_counter() - t0) * 1e3 / n
        return log

    def policy_score(model, sampling_steps):
        return score(evaluate_policy(
            lambda g, obs: pipe.act(norm.normalize(obs), model=model, num_candidates=32,
                                    sampling_steps=sampling_steps, generator=g),
            num_envs=128, seed=1, device=device))

    n_iql, n_edm, n_cd = steps
    stage("iql", pipe.iql_train_step, n_iql)
    stage("edm", pipe.edm_train_step, n_edm)
    teacher = policy_score("edm", 5)
    pipe.prepare_distillation(distillation_N=18)
    log = stage("cd", pipe.cd_train_step, n_cd)
    return {"pipe": pipe, "dataset": ds, "teacher": teacher,
            "student": policy_score("cd", 2), "ms": ms, "cd_loss": float(log["loss"])}

"""Diffuser planning through the port's `DiffuserPipeline.act`.

One request is one plan for `envs` environments with `candidates`
trajectories each: the observations and the sampler's explicit draws
(`noise=`, of the K*E prior's shape) come from the run's seed and the
request's index, so the reference replays any request. The EMA U-Net and
the classifier's EMA net take the benchmark's seeded weights; the reference
gets the same tensors.
"""

from __future__ import annotations

import torch

from benchmark import common, work
from benchmark.reference import diffuser as reference


def tiny(config: dict, traffic: dict):
    """(configuration, traffic) cut to a CPU test's size: width, levels,
    steps, horizon, envs and candidates shrunk; every other key kept."""
    return (dict(config, model_dim=8, dim_mult=[1, 2], sampling_steps=4, diffusion_steps=4,
                 horizon=8), dict(traffic, envs=4, candidates=4))


class Cell:
    # the program's span around each plan (`DiffuserPipeline.act`)
    plan_span = "diffuser.plan"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed, self.device = config, seed, device
        self.envs, self.candidates = traffic["envs"], traffic["candidates"]
        self.actions_per_plan = self.envs
        self.pipe = None
        self.gen = torch.Generator(device=device)
        self._weights = None

    @property
    def weights(self) -> dict:
        if self._weights is None:
            self._weights = common.make_weights(reference.spec(self.cfg), self.seed, self.device)
        return self._weights

    def build(self):
        from cleandiffuser_tpu_torch.pipelines import DiffuserPipeline

        c = self.cfg
        self.pipe = DiffuserPipeline(
            obs_dim=c["obs_dim"], act_dim=c["act_dim"], horizon=c["horizon"],
            model_dim=c["model_dim"], dim_mult=tuple(c["dim_mult"]),
            diffusion_steps=c["diffusion_steps"], sampling_steps=c["sampling_steps"],
            solver=c["solver"], predict_noise=c["predict_noise"], w_cg=c["w_cg"],
            temperature=c["temperature"], use_pallas_block=c["use_pallas_block"],
            fused_update=c["fused_update"], device=self.device)
        common.load_weights({"diffusion": self.pipe.agent.ema_params["diffusion"],
                             "classifier": self.pipe.classifier.ema_params}, self.weights)

    def request(self, index: int) -> dict:
        c, E = self.cfg, self.envs
        self.gen.manual_seed(common.request_seed(self.seed, index))
        shape = (self.candidates * E, c["horizon"], c["obs_dim"] + c["act_dim"])
        draw = lambda *s: torch.randn(s, generator=self.gen, device=self.device)
        return {"obs": draw(E, c["obs_dim"]), "noise0": draw(*shape),
                "noise_steps": draw(c["sampling_steps"], *shape)}

    def serve(self, req: dict) -> dict:
        act, info = self.pipe.act(req["obs"], num_candidates=self.candidates,
                                  noise=(req["noise0"], req["noise_steps"]))
        return {"act": act, "candidates": info["candidates"], "logp": info["candidate_logp"],
                "idx": info["idx"]}

    def reference(self, req: dict) -> dict:
        act, cands, logp, idx = reference.plan(self.weights, self.cfg, req["obs"],
                                               self.candidates, req["noise0"],
                                               req["noise_steps"])
        return {"act": act, "candidates": cands, "logp": logp, "idx": idx}

    @staticmethod
    def invalid(act) -> bool:
        """An answer a client cannot use: actions not finite or outside [-1, 1]."""
        return not (bool(torch.isfinite(act).all()) and act.abs().max().item() <= 1.0)

    def judge(self, cases) -> dict:
        """The numbers compared, each the worst over `cases`, a list of
        (request, program's outputs, reference's outputs). A choice is
        compared only where the reference's two best candidates lie
        further apart than `choice_apart` times the logp limit, relative
        to the scale of the log p; the actions are those of the candidate
        the program chose."""
        O = self.cfg["obs_dim"]
        apart = self.cfg["choice_apart"] * self.cfg["limits"]["logp_gap"]
        pin = cand = logp = act = 0.0
        miss = 0
        for req, out, ref in cases:
            cands = out["candidates"]
            pin = max(pin, (cands[:, :, 0, :O] - req["obs"]).abs().max().item())
            cand = max(cand, common.rel_gap(cands, ref["candidates"]))
            logp = max(logp, common.rel_gap(out["logp"], ref["logp"]))
            top2 = ref["logp"].topk(2, dim=0).values
            scale = ref["logp"].abs().max()
            decided = (top2[0] - top2[1]) > apart * scale
            miss += int((decided & (out["idx"] != ref["idx"])).sum())
            envs = torch.arange(cands.shape[1], device=cands.device)
            want = torch.clamp(ref["candidates"][out["idx"], envs, 0, O:], -1.0, 1.0)
            act = max(act, (out["act"] - want).abs().max().item())
        return {"pin_gap": pin, "cand_gap": cand, "logp_gap": logp, "choice_miss": miss,
                "act_gap": act}

    def work(self) -> dict:
        """Operations of one plan (per step the U-Net, and where it guides
        the classifier's forward and its input gradient, which costs its
        forward again; at the end the classifier's log p); K3's launches of
        one U-Net call, and the VJP pair's of one plan (per guided step the
        classifier's blocks forward, keeping their residuals, then their
        input gradients in reverse; at the end the blocks forward alone),
        with their operations and bytes."""
        c = self.cfg
        N, H, md = self.candidates * self.envs, c["horizon"], c["model_dim"]
        F_ = c["obs_dim"] + c["act_dim"]
        time_mlp = work.dense(N, md, 4 * md) + work.dense(N, 4 * md, md)
        blocks = reference.unet_blocks(c)
        k3 = [work.film_resblock(N, h, ci, co, c["kernel_size"]) for h, ci, co in blocks]
        unet = time_mlp + sum(ops for ops, _ in k3) + sum(work.dense(N, md, co)
                                                         for _, _, co in blocks)
        downs, ups = reference.unet_resamples(c)
        unet += sum(work.conv1d(N, length, 3, ch, ch) for length, ch in downs)
        unet += sum(work.conv_transpose1d(N, length, 4, ch, ch) for length, ch in ups)
        unet += work.conv1d(N, H, 5, md, md) + work.conv1d(N, H, 1, md, F_)
        cls = time_mlp
        forward, grad, score = [], [], []
        for h, ci, co, k in reference.classifier_blocks(c):
            cls += work.film_resblock(N, h, ci, co, k)[0] + work.dense(N, md, co)
            g = reference.groups(co)
            forward.append(work.film_vjp_forward(N, h, ci, co, k, g))
            grad.insert(0, work.film_vjp_input_grad(N, h, ci, co, k, g))
            score.append(work.film_vjp_forward(N, h, ci, co, k, g, residuals=False))
        cls += sum(work.conv1d(N, length, 3, ch, ch) for length, ch in reference.classifier_downs(c))
        head = reference.spec(c)["classifier.head1.weight"][0]
        cls += work.dense(N, head[1], head[0]) + work.dense(N, head[0], 1)
        steps = c["sampling_steps"]
        guided = steps if c["w_cg"] != 0 else 0
        pair = guided * (forward + grad) + score
        return {"plan_ops": steps * unet + guided * 2 * cls + cls,
                "kernels": {"k3": {"match": "film_resblock_kernel", "launches": k3,
                                   "per_plan": steps * len(k3)},
                            "vjp": {"match": "film_vjp_", "launches": pair,
                                    "per_plan": len(pair)}}}

    def free(self):
        self.pipe = None

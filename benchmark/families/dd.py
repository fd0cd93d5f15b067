"""Decision Diffuser planning through the port's `DDPipeline.act`.

One request is one plan for `envs` environments: the observations and the
sampler's explicit draws (`noise=`) come from the run's seed and the
request's index, so the reference replays any request. The EMA planner,
its condition and its inverse dynamics take the benchmark's seeded weights;
the reference gets the same tensors.
"""

from __future__ import annotations

import torch

from benchmark import common, work
from benchmark.reference import dd as reference


def tiny(config: dict, traffic: dict):
    """(configuration, traffic) cut to a CPU test's size: width, heads,
    embedding, steps, horizon and envs shrunk; every other key kept."""
    return (dict(config, d_model=64, n_heads=2, emb_dim=32, sampling_steps=4, horizon=8),
            dict(traffic, envs=4))


class Cell:
    # the program's span around each plan (`DDPipeline.act`)
    plan_span = "dd.plan"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed, self.device = config, seed, device
        self.envs = traffic["envs"]
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
        from cleandiffuser_tpu_torch.pipelines import DDPipeline

        c = self.cfg
        self.pipe = DDPipeline(
            obs_dim=c["obs_dim"], act_dim=c["act_dim"], horizon=c["horizon"],
            emb_dim=c["emb_dim"], d_model=c["d_model"], n_heads=c["n_heads"], depth=c["depth"],
            label_dropout=c["label_dropout"], predict_noise=c["predict_noise"],
            solver=c["solver"], sampling_steps=c["sampling_steps"], w_cfg=c["w_cfg"],
            target_return=c["target_return"], temperature=c["temperature"],
            use_pallas_block=c["use_pallas_block"], device=self.device)
        ema = self.pipe.agent.ema_params
        common.load_weights({"diffusion": ema["diffusion"], "condition": ema["condition"],
                             "invdyn": self.pipe.invdyn.net}, self.weights)

    def request(self, index: int) -> dict:
        c, E = self.cfg, self.envs
        self.gen.manual_seed(common.request_seed(self.seed, index))
        shape = (E, c["horizon"], c["obs_dim"])
        draw = lambda *s: torch.randn(s, generator=self.gen, device=self.device)
        return {"obs": draw(E, c["obs_dim"]), "noise0": draw(*shape),
                "noise_steps": draw(c["sampling_steps"], *shape)}

    def serve(self, req: dict) -> dict:
        act, info = self.pipe.act(req["obs"], noise=(req["noise0"], req["noise_steps"]))
        return {"act": act, "traj": info["traj"]}

    def reference(self, req: dict) -> dict:
        act, traj = reference.plan(self.weights, self.cfg, req["obs"], req["noise0"],
                                   req["noise_steps"])
        return {"act": act, "traj": traj}

    @staticmethod
    def invalid(act) -> bool:
        """An answer a client cannot use: actions not finite or outside [-1, 1]."""
        return not (bool(torch.isfinite(act).all()) and act.abs().max().item() <= 1.0)

    def judge(self, cases) -> dict:
        """The numbers compared, each the worst over `cases`, a list of
        (request, program's outputs, reference's outputs)."""
        pin = traj = act = 0.0
        for req, out, ref in cases:
            pin = max(pin, (out["traj"][:, 0] - req["obs"]).abs().max().item())
            traj = max(traj, common.rel_gap(out["traj"], ref["traj"]))
            act = max(act, (out["act"] - ref["act"]).abs().max().item())
        return {"pin_gap": pin, "traj_gap": traj, "act_gap": act}

    def work(self) -> dict:
        """Operations of one plan, and K1's launches of one plan with their
        operations and bytes."""
        c, E = self.cfg, self.envs
        B, H, D, O = 2 * E, c["horizon"], c["d_model"], c["obs_dim"]
        emb, f = c["emb_dim"], 2 * (c["emb_dim"] // 8)
        k1 = work.dit_block(B, H, D, c["n_heads"])
        step = (work.dense(B * H, O, D) + work.dense(B, f, emb) + work.dense(B, emb, emb)
                + work.dense(B, emb, D) + work.dense(B, D, D)
                + c["depth"] * (work.dense(B, D, 6 * D) + k1[0])
                + work.dense(B, D, 2 * D) + work.dense(B * H, D, O))
        hid = c["invdyn_hidden"]
        once = (work.dense(E, 1, emb) + work.dense(E, emb, emb) + work.dense(E, 2 * O, hid)
                + work.dense(E, hid, hid) + work.dense(E, hid, c["act_dim"]))
        return {"plan_ops": c["sampling_steps"] * step + once,
                "kernels": {"k1": {"match": "dit_block_kernel", "launches": [k1],
                                   "per_plan": c["sampling_steps"] * c["depth"]}}}

    def free(self):
        self.pipe = None

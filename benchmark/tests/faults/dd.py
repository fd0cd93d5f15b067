"""Faults planted in the DD family's program (`DDPipeline.act`), each of
which a run has to read as not correct: a sampler step that returns its
state unchanged, half of the envs left out with the mean of the other half
in their place, and an answer altered where it is produced."""

from __future__ import annotations

import torch

from conftest import halve


def plant(monkeypatch, fault: str):
    """Plant `fault` ("step_unchanged", "half_batch" or "answer_altered")
    for the rest of the test."""
    from cleandiffuser_tpu_torch.diffusion import diffusionsde
    from cleandiffuser_tpu_torch.pipelines import DDPipeline

    if fault == "step_unchanged":
        monkeypatch.setattr(diffusionsde, "solver_step", lambda solver, xt, *a, **k: xt)
        return
    if fault not in ("half_batch", "answer_altered"):
        raise ValueError(f"no fault {fault!r}")
    act = DDPipeline.act

    def broken(self, *args, **kwargs):
        a, info = act(self, *args, **kwargs)
        if fault == "half_batch":
            halve(a, 0)
            halve(info["traj"], 0)
        else:
            a[0, 0] -= 0.01 * torch.sign(a[0, 0])
        return a, info

    monkeypatch.setattr(DDPipeline, "act", broken)

"""The spans the port opens on its planning path (utils/profiling.py
`annotate`) on the CPU, at tiny sizes: one plan span per `act`, the
sampler's `sampler.denoise`, `sampler.guide` and `sampler.update` once per
step under it, the same plans with the profiler on and off, no
`record_function` opened while nothing records, and the Veteran and
DiffuserLite spans under their names."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cleandiffuser_tpu_torch
from cleandiffuser_tpu_torch.pipelines import (
    DDPipeline,
    DiffuserLitePipeline,
    DiffuserPipeline,
    VeteranPipeline,
)
from cleandiffuser_tpu_torch.pipelines import diffuserlite_value
from cleandiffuser_tpu_torch.utils.iql import IQL
from cleandiffuser_tpu_torch.utils.profiling import annotate

O, A, H, STEPS, ENVS, K = 5, 2, 8, 4, 3, 4
SAMPLER_SPANS = ("sampler.denoise", "sampler.guide", "sampler.update")
VETERAN_STEPS = 2


def _perturbed(module, seed):
    """Seeded noise on every parameter, so that the zero-initialised
    output layers do not make every plan the same."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))


def _dd():
    pipe = DDPipeline(obs_dim=O, act_dim=A, horizon=H, emb_dim=16, d_model=32, n_heads=2,
                      depth=1, sampling_steps=STEPS, use_pallas_block=False, device="cpu")
    _perturbed(pipe.agent.ema_params, 1)
    shape = (ENVS, H, O)

    def act(obs, noise):
        return pipe.act(obs, noise=noise)

    return act, shape


def _diffuser():
    pipe = DiffuserPipeline(obs_dim=O, act_dim=A, horizon=H, model_dim=8, dim_mult=(1, 2),
                            diffusion_steps=STEPS, sampling_steps=STEPS,
                            use_pallas_block=False, device="cpu")
    _perturbed(pipe.agent.ema_params, 1)
    _perturbed(pipe.classifier.ema_params, 2)
    shape = (K * ENVS, H, O + A)

    def act(obs, noise):
        return pipe.act(obs, num_candidates=K, noise=noise)

    return act, shape


PIPELINES = {"dd": (_dd, "dd.plan", 0), "diffuser": (_diffuser, "diffuser.plan", STEPS)}


def _request(shape):
    g = torch.Generator().manual_seed(3)
    obs = torch.randn((ENVS, O), generator=g)
    return obs, (torch.randn(shape, generator=g), torch.randn((STEPS, *shape), generator=g))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _count(events, name):
    return sum(e.name == name for e in events)


def test_annotate_shares_one_context_while_nothing_records():
    assert annotate("a") is annotate("b")
    with annotate("a"), annotate("a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert annotate("a") is not annotate("b")


@pytest.mark.parametrize("kind", sorted(PIPELINES))
def test_act_records_one_plan_span_and_each_steps_spans(kind):
    make, plan_span, guides = PIPELINES[kind]
    act, shape = make()
    obs, noise = _request(shape)
    act(obs, noise)  # builds the plan function outside the record
    _, events = _profiled(lambda: act(obs, noise))
    assert _count(events, plan_span) == 1
    assert _count(events, "dd.plan" if kind == "diffuser" else "diffuser.plan") == 0
    assert _count(events, "sampler.denoise") == STEPS
    assert _count(events, "sampler.update") == STEPS
    assert _count(events, "sampler.guide") == guides


@pytest.mark.parametrize("kind", sorted(PIPELINES))
def test_sampler_spans_sit_under_the_plan_span(kind):
    make, plan_span, _ = PIPELINES[kind]
    act, shape = make()
    obs, noise = _request(shape)
    _, events = _profiled(lambda: act(obs, noise))

    def ancestors(e):
        p = e.cpu_parent
        while p is not None:
            yield p.name
            p = p.cpu_parent

    spans = [e for e in events if e.name in SAMPLER_SPANS]
    assert spans and all(plan_span in ancestors(e) for e in spans)
    # the guidance and the update are not inside the denoiser's span
    assert not any("sampler.denoise" in ancestors(e) for e in spans)


@pytest.mark.parametrize("kind", sorted(PIPELINES))
def test_plans_are_bitwise_equal_with_the_profiler_on_and_off(kind):
    make, _, _ = PIPELINES[kind]
    act, shape = make()
    obs, noise = _request(shape)
    off_act, off_info = act(obs, noise)
    (on_act, on_info), events = _profiled(lambda: act(obs, noise))
    assert _count(events, "sampler.update") == STEPS
    torch.testing.assert_close(on_act, off_act, rtol=0, atol=0)
    for key in off_info:
        torch.testing.assert_close(on_info[key], off_info[key], rtol=0, atol=0)


@pytest.mark.parametrize("kind", sorted(PIPELINES) + ["veteran"])
def test_no_record_function_opens_while_nothing_records(monkeypatch, kind):
    if kind == "veteran":
        act = _veteran("cg")
    else:
        plan, shape = PIPELINES[kind][0]()
        act = lambda: plan(*_request(shape))  # noqa: E731
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    act()
    assert opened == []


def test_record_function_is_opened_only_by_annotate():
    root = Path(cleandiffuser_tpu_torch.__file__).parent
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["utils/profiling.py"]


def _veteran(guidance):
    pipe = VeteranPipeline(
        obs_dim=O, act_dim=A, planner_horizon=H, guidance_type=guidance,
        planner_net="transformer" if guidance != "cg" else "unet", planner_emb_dim=16,
        planner_d_model=32, unet_dim=8, planner_sampling_steps=VETERAN_STEPS,
        policy_sampling_steps=2,
        device="cpu")
    obs = np.random.default_rng(0).standard_normal((2, O)).astype(np.float32)
    return lambda: pipe.act(obs, num_candidates=K)


@pytest.mark.parametrize("guidance,spans", [
    ("MCSS", ("veteran.plan", "veteran.score", "veteran.policy")),
    ("cg", ("veteran.plan", "veteran.score", "veteran.policy")),
    ("cfg", ("veteran.plan", "veteran.policy")),
])
def test_veteran_spans_record_under_their_names(guidance, spans):
    act = _veteran(guidance)
    act()
    _, events = _profiled(act)
    for name in spans:
        assert _count(events, name) == 1, name
    # the planner's sampler opens its step spans inside `veteran.plan`
    plan = next(e for e in events if e.name == "veteran.plan")
    inside = [e for e in events if e.name == "sampler.denoise"
              and plan.time_range.start <= e.time_range.start < plan.time_range.end]
    assert len(inside) == VETERAN_STEPS
    assert _count(events, "sampler.guide") == (VETERAN_STEPS if guidance == "cg" else 0)


def _lite():
    return DiffuserLitePipeline(obs_dim=O, act_dim=A, planning_horizons=(3, 3, 5), emb_dim=16,
                                d_model=32, n_heads=2, depth=1, device="cpu")


def test_diffuserlite_spans_record_under_their_names():
    pipe = _lite()
    obs = np.random.default_rng(0).standard_normal((2, O)).astype(np.float32)
    _, events = _profiled(lambda: pipe.act(obs, sample_steps=2))
    for name in ("diffuserlite.level0", "diffuserlite.level1", "diffuserlite.level2",
                 "diffuserlite.invdyn"):
        assert _count(events, name) == 1, name


def test_diffuserlite_value_score_span_records():
    pipe = _lite()
    iql = IQL(O, A, hidden_dim=16, device="cpu")
    plan = diffuserlite_value.build_candidate_plan_fn(pipe, iql, 2, K, 2, (1.0, 1.0, 1.0), 1)
    obs = torch.randn((2, O), generator=torch.Generator().manual_seed(0))
    _, events = _profiled(lambda: plan(None, obs, torch.full((2, 1), 0.5)))
    assert _count(events, "diffuserlite.score") == 1
    assert _count(events, "diffuserlite.level0") == 1

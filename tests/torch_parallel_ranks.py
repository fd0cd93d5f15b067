"""The port's multi-device cases, run in one process per rank over gloo.

`spawn(world, names, tmp, inputs)` starts `world` processes of this file,
each of which joins a gloo process group through a file under `tmp` (no TCP
port: the tests run under xdist), runs every case of `names` in turn and
writes {name: result or {"error": traceback}} to `tmp/rank<r>.pt`. A case
is `fn(rank, world, inputs) -> dict` of numbers, numpy arrays and tensors;
rank 0 also runs the one-process reference where a case compares with one.
The ranks import torch and the port only, never JAX: the tests compute
JAX's side in their own process and pass its weights and draws in `inputs`.
Used by tests/test_torch_parallel.py and test_torch_parallel_pipelines.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def spawn(world: int, names, tmp: Path, inputs=None, timeout: float = 300.0):
    """Run the cases `names` on `world` ranks; returns the ranks' results."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(inputs or {}, tmp / "inputs.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, __file__, str(world), str(r), str(tmp), *names],
                              env=env, cwd=tmp, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def result(ranks, name):
    """Each rank's result of case `name`, failing on a rank's error."""
    out = []
    for r, res in enumerate(ranks):
        got = res[name]
        assert "error" not in got, f"rank {r}, case {name}:\n{got['error']}"
        out.append(got)
    return out


# ---------------------------------------------------------------------------
# cases

def _flat(module) -> np.ndarray:
    """A module's params laid end to end (whole tensors of sharded ones)."""
    full = lambda p: p.full_tensor() if type(p).__name__ == "DTensor" else p
    return torch.cat([full(p).detach().reshape(-1) for p in module.parameters()]).numpy()


def _dql_engine(rng=42):
    from cleandiffuser_tpu_torch.diffusion import DiscreteDiffusionSDE
    from cleandiffuser_tpu_torch.nn_condition import IdentityCondition
    from cleandiffuser_tpu_torch.nn_diffusion import DQLMlp

    net = DQLMlp(7, 3, emb_dim=16, generator=torch.Generator().manual_seed(1))
    return DiscreteDiffusionSDE(net, IdentityCondition(dropout=0.0), diffusion_steps=8, rng=rng,
                                device="cpu")


def _xc(seed=0, B=16):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((B, 3)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((B, 7)).astype(np.float32)))


def case_mesh(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import batch_sharded, make_mesh, replicated

    mesh = make_mesh()
    two = make_mesh(world, ("dp", "fsdp"), (1, world))
    return {"dims": mesh.mesh_dim_names, "shape": tuple(mesh.mesh.shape),
            "two_dims": two.mesh_dim_names, "two_shape": tuple(two.mesh.shape),
            "placements": [str(p) for p in (*replicated(two), *batch_sharded(two, "fsdp"))]}


def case_dp_update_and_sample(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import DataParallelEngine, make_mesh

    x0, cond = _xc()
    engine = _dql_engine()
    dp = DataParallelEngine(engine, make_mesh(world)).place()
    losses = [float(dp.update(x0, cond)["loss"]) for _ in range(2)]
    fn = engine.build_sample_fn(solver="ddim", sample_steps=3, cfg_mode="cond")
    with torch.no_grad():
        out, _ = fn(engine.ema_params, torch.Generator().manual_seed(0), torch.zeros(8, 3),
                    condition_cfg=cond[:8], w_cfg=1.0)
    return {"losses": losses, "out": out.numpy(), "params": _flat(engine.params)}


def case_dp_matches_single(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import DataParallelEngine, make_mesh

    x0, cond = _xc()
    out = {}
    if rank == 0:
        e1 = _dql_engine()
        out["single"] = [float(e1.update(x0, cond)["loss"]) for _ in range(2)]
        out["single_params"] = _flat(e1.params)
        out["single_ema"] = _flat(e1.ema_params)
    e2 = _dql_engine()
    dp = DataParallelEngine(e2, make_mesh(world)).place()
    out["mesh"] = [float(dp.update(x0, cond)["loss"]) for _ in range(2)]
    out["mesh_params"], out["mesh_ema"] = _flat(e2.params), _flat(e2.ema_params)
    return out


def case_dp_matches_jax(rank, world, inputs):
    """The JAX engine's weights, batch and draws (its update's t and eps)."""
    from cleandiffuser_tpu_torch.parallel import DataParallelEngine, make_mesh
    from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, load_agent_params

    inp = inputs["dp_jax"]
    e = _dql_engine()
    load_agent_params(e.params, inp["params"])
    load_agent_params(e.ema_params, inp["params"])
    dp = DataParallelEngine(e, make_mesh(world)).place()
    x0, cond = (torch.from_numpy(a) for a in (inp["x0"], inp["cond"]))
    log = dp.update(x0, cond, noise=(torch.from_numpy(inp["t"]), torch.from_numpy(inp["eps"]),
                                     None))
    return {"loss": float(log["loss"]), "grad_norm": float(log["grad_norm"]),
            "params": agent_params_of(e.params)}


def case_sharded_sampling(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import make_mesh, shard_sample_fn

    e = _dql_engine(rng=7)
    _, cond = _xc(1)
    fn = e.build_sample_fn(solver="ddim", sample_steps=4, cfg_mode="cond", final_logp=False)
    kw = dict(condition_cfg=cond, w_cfg=1.0)
    with torch.no_grad():
        single, _ = fn(e.ema_params, torch.Generator().manual_seed(0), torch.zeros(16, 3), **kw)
        sharded, _ = shard_sample_fn(fn, make_mesh(world))(
            e.ema_params, torch.Generator().manual_seed(0), torch.zeros(16, 3), **kw)
        g = torch.Generator().manual_seed(5)  # the same draws on every rank
        noise = (torch.randn(16, 3, generator=g), torch.randn(4, 16, 3, generator=g))
        explicit, _ = fn(e.ema_params, None, torch.zeros(16, 3), noise=noise, **kw)
        explicit_sharded, _ = shard_sample_fn(fn, make_mesh(world))(
            e.ema_params, None, torch.zeros(16, 3), noise=noise, **kw)
    return {"single": single.numpy(), "sharded": sharded.numpy(),
            "explicit": explicit.numpy(), "explicit_sharded": explicit_sharded.numpy()}


def _dit_engine():
    from cleandiffuser_tpu_torch.diffusion import DiscreteDiffusionSDE
    from cleandiffuser_tpu_torch.nn_condition import IdentityCondition
    from cleandiffuser_tpu_torch.nn_diffusion import DiT1d

    return DiscreteDiffusionSDE(DiT1d(6, 32, 64, 4, 2, generator=torch.Generator().manual_seed(2)),
                                IdentityCondition(dropout=0.0), diffusion_steps=8, rng=11,
                                device="cpu")


def _fsdp(rank, world, n_dp):
    """One step on a (n_dp, world / n_dp) ("dp", "fsdp") mesh with params of
    >= 1024 elements sharded; rank 0 also takes it in one process."""
    from cleandiffuser_tpu_torch.parallel import DataParallelEngine, make_mesh

    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 16, 6)).astype(np.float32))
    out = {}
    sample = lambda e: e.build_sample_fn(solver="ddim", sample_steps=3)(
        e.ema_params, torch.Generator().manual_seed(0), torch.zeros(8, 16, 6))[0]
    if rank == 0:
        e1 = _dit_engine()
        out["single"] = float(e1.update(x0)["loss"])
        out["single_params"], out["single_ema"] = _flat(e1.params), _flat(e1.ema_params)
        with torch.no_grad():
            out["single_sample"] = sample(e1).numpy()
    e2 = _dit_engine()
    mesh = make_mesh(world, ("dp", "fsdp"), (n_dp, world // n_dp))
    dp = DataParallelEngine(e2, mesh, fsdp_axis="fsdp", fsdp_min_size=1024).place()
    out["mesh"] = float(dp.update(x0)["loss"])

    def share(tensors):
        local = lambda t: t.to_local() if type(t).__name__ == "DTensor" else t
        return sum(local(t).numel() for t in tensors) / sum(t.numel() for t in tensors)

    opt = e2.optimizer.optimizer
    out["param_share"] = share(list(e2.params.parameters()))
    out["ema_share"] = share(list(e2.ema_params.parameters()))
    out["moment_share"] = share([st[k] for st in opt.state.values()
                                 for k in ("exp_avg", "exp_avg_sq")])
    out["sharded_leaf_shares"] = [p.to_local().numel() / p.numel() for p in e2.params.parameters()
                                  if type(p).__name__ == "DTensor"]
    out["small_share"] = sum(p.numel() for p in e2.params.parameters()
                             if type(p).__name__ != "DTensor") / sum(
        p.numel() for p in e2.params.parameters())
    out["mesh_params"], out["mesh_ema"] = _flat(e2.params), _flat(e2.ema_params)
    with torch.no_grad():
        out["mesh_sample"] = sample(e2).numpy()
    return out


def case_fsdp_2x2(rank, world, inputs):
    return _fsdp(rank, world, 2)


def case_fsdp_1x4(rank, world, inputs):
    return _fsdp(rank, world, 1)


# --- pipelines -------------------------------------------------------------

def case_setup_mesh(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import setup_mesh
    from cleandiffuser_tpu_torch.utils.config import Config

    out = {}
    mesh = setup_mesh(Config({"n_devices": world, "platform": "cpu"}))
    out["dp"] = (mesh.mesh_dim_names, tuple(mesh.mesh.shape))
    two = setup_mesh(Config({"n_devices": world, "mesh_shape": [1, world], "platform": "cpu"}))
    out["two"] = (two.mesh_dim_names, tuple(two.mesh.shape))
    for key, cfg in (("more_than_world", {"n_devices": 2 * world, "platform": "cpu"}),
                     ("bad_shape", {"n_devices": world, "mesh_shape": [world, 2],
                                    "platform": "cpu"}),
                     ("no_gpus", {"n_devices": world})):
        try:
            setup_mesh(Config(cfg))
            out[key] = None
        except (RuntimeError, ValueError) as e:
            out[key] = f"{type(e).__name__}: {e}"
    return out


def _td_dataset():
    from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoTDDataset
    from cleandiffuser_tpu_torch.dataset.fake import fake_d4rl_qlearning_dataset

    raw = fake_d4rl_qlearning_dataset("halfcheetah-medium-v2", n_steps=2000, ep_len=200)
    return D4RLMuJoCoTDDataset(raw, device="cpu")


def case_dataset_rows(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import make_mesh
    from cleandiffuser_tpu_torch.utils.ranks import rows_of

    whole = _td_dataset().sample_batch(torch.Generator().manual_seed(0), 32)
    ds = _td_dataset().place_on_mesh(make_mesh(world))
    batch = ds.sample_batch(torch.Generator().manual_seed(0), 32)
    tag = rows_of(batch)
    try:
        ds.sample_batch(torch.Generator().manual_seed(0), 2 * world + 1)
        odd = None
    except AssertionError as e:
        odd = str(e)
    b = 32 // world
    return {"rows": batch["obs"]["state"].shape[0], "tag": None if tag is None else tag[:2],
            "equal": all(torch.equal(batch[k] if k in ("act", "rew", "tml") else
                                     batch[k]["state"],
                                     (whole[k] if k in ("act", "rew", "tml") else
                                      whole[k]["state"])[rank * b:(rank + 1) * b])
                         for k in ("obs", "next_obs", "act", "rew", "tml")),
            "odd": odd}


def _dql(**kw):
    from cleandiffuser_tpu_torch.pipelines import DQLPipeline

    ds = _td_dataset()
    return ds, DQLPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, diffusion_steps=2,
                           sampling_steps=2, gradient_steps=100, hidden_dim=32,
                           device="cpu", **kw)


def _dql_state(pipe) -> dict:
    return {"actor": _flat(pipe.actor.params), "ema": _flat(pipe.actor.ema_params),
            "critic": _flat(pipe.critic), "target": _flat(pipe.critic_target)}


def _logs(log) -> dict:
    return {k: float(v) for k, v in log.items()}


def case_dql_step(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import make_mesh, place_pipeline, shard_batch

    ds, _ = _dql(rng=3)
    g = torch.Generator().manual_seed(0)
    batches = [ds.sample_batch(g, 32) for _ in range(3)]
    out = {}
    if rank == 0:
        _, p1 = _dql(rng=3)
        out["single"] = [_logs(p1.train_step(b)) for b in batches]
        out["single_state"] = _dql_state(p1)
    mesh = make_mesh(world)
    _, p2 = _dql(rng=3)
    place_pipeline(p2, mesh)
    out["mesh"] = [_logs(p2.train_step(shard_batch(mesh, b))) for b in batches]
    out["mesh_state"] = _dql_state(p2)
    out["is_mesh"] = p2.mesh is mesh
    obs = torch.from_numpy(np.random.default_rng(1).standard_normal((4, ds.o_dim))
                           .astype(np.float32))
    out["act"] = p2.act(obs, num_candidates=16).numpy()
    return out


def _jax_weighted_dql(inp):
    """The port's DQL on the JAX pipeline's seeded weights at its step."""
    from cleandiffuser_tpu_torch.pipelines import DQLPipeline
    from cleandiffuser_tpu_torch.utils.jax_params import load_agent_params, load_jax_params

    p = DQLPipeline(**inp["cfg"], device="cpu")
    load_agent_params(p.actor.params, inp["params"])
    load_agent_params(p.actor.ema_params, inp["ema"])
    load_jax_params(p.critic, inp["critic"]["params"])
    load_jax_params(p.critic_target, inp["target"]["params"])
    p.actor.step = inp["start"]
    return p


def _noise_rows(noise: dict, rank: int, world: int) -> dict:
    """The rank's rows of a DQL step's draws (module tests/test_torch_dql.py
    `_jax_draws`): the samplers' (initial (B', act), per-step (S, B', act)),
    the BC loss's (t (B,), eps (B, act)); the coin is whole."""
    def rows(x, dim=0):
        b = x.shape[dim] // world
        return x.narrow(dim, rank * b, b)

    return {"next": (rows(noise["next"][0]), rows(noise["next"][1], 1)),
            "new": (rows(noise["new"][0]), rows(noise["new"][1], 1)),
            "bc": tuple(rows(z) for z in noise["bc"]), "coin": noise["coin"]}


def _jax_tree_state(p) -> dict:
    from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, jax_params_of

    return {"params": agent_params_of(p.actor.params),
            "ema": agent_params_of(p.actor.ema_params),
            "critic": {"params": jax_params_of(p.critic)},
            "target": {"params": jax_params_of(p.critic_target)}}


def case_dql_jax(rank, world, inputs):
    """The JAX pipeline's steps on the port's mesh: its weights, batches and
    each step's draws (global), this rank's rows of both."""
    from cleandiffuser_tpu_torch.parallel import make_mesh, place_pipeline, shard_batch

    inp = inputs["dql_jax"]
    mesh = make_mesh(world)
    p = _jax_weighted_dql(inp)
    place_pipeline(p, mesh)
    logs = [_logs(p.train_step(shard_batch(mesh, b), noise=_noise_rows(z, rank, world)))
            for b, z in zip(inp["batches"], inp["draws"])]
    return {"logs": logs, "state": _jax_tree_state(p), "step": p.actor.step}


def case_fused_window(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import make_mesh, place_pipeline
    from cleandiffuser_tpu_torch.pipelines.runner import make_rl_train_scan

    out = {}
    if rank == 0:
        ds1, p1 = _dql(rng=5)
        out["single"] = _logs(make_rl_train_scan(p1, ds1, 32, 4)(torch.Generator().manual_seed(9)))
        out["single_state"] = _dql_state(p1)
    mesh = make_mesh(world)
    ds2, p2 = _dql(rng=5)
    place_pipeline(p2, mesh)
    ds2.place_on_mesh(mesh)
    out["mesh"] = _logs(make_rl_train_scan(p2, ds2, 32, 4)(torch.Generator().manual_seed(9)))
    out["mesh_state"] = _dql_state(p2)
    out["step"] = p2.actor.step
    return out


def case_rl_window_jax(rank, world, inputs):
    """The JAX fused window's steps (its batches, its draws) through the
    port's window (`step_window`) on the mesh."""
    from cleandiffuser_tpu_torch.parallel import make_mesh, place_pipeline, shard_batch
    from cleandiffuser_tpu_torch.pipelines.runner import step_window

    inp = inputs["window_jax"]
    mesh = make_mesh(world)
    p = _jax_weighted_dql(inp)
    place_pipeline(p, mesh)
    steps = iter(zip(inp["batches"], inp["draws"]))

    def step(_generator):
        b, z = next(steps)
        return p.train_step(shard_batch(mesh, b), noise=_noise_rows(z, rank, world))

    log = step_window(step, len(inp["batches"]), p.LOG_KEYS, "cpu")(None)
    return {"log": _logs(log), "state": _jax_tree_state(p), "step": p.actor.step}


def _narrow_dp():
    from cleandiffuser_tpu_torch.nn_diffusion import ChiUNet1d
    from cleandiffuser_tpu_torch.pipelines import dp as tdp

    tdp.ChiUNet1d = lambda **kw: ChiUNet1d(**{**kw, "model_dim": 16, "emb_dim": 16,
                                              "dim_mult": (1, 2)})


def _pusht(rng=2):
    from cleandiffuser_tpu_torch.dataset import PushTStateDataset
    from cleandiffuser_tpu_torch.dataset.pusht import generate_pusht_demos
    from cleandiffuser_tpu_torch.pipelines import DPPipeline

    _narrow_dp()
    rb = generate_pusht_demos(n_episodes=4, max_steps=40, seed=0, expert=False, device="cpu")
    ds = PushTStateDataset(rb, horizon=8, pad_before=1, pad_after=3, device="cpu")
    pipe = DPPipeline(obs_dim=5, action_dim=2, horizon=8, obs_steps=2, action_steps=4,
                      nn="chi_unet", diffusion="ddpm", sample_steps=2, gradient_steps=100,
                      rng=rng, device="cpu")
    return ds, pipe


def case_pusht_dp(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import make_mesh, place_pipeline
    from cleandiffuser_tpu_torch.utils.ranks import rows_of

    mesh = make_mesh(world)
    ds, pipe = _pusht()
    place_pipeline(pipe, mesh)
    ds.place_on_mesh(mesh)
    g = torch.Generator().manual_seed(0)
    losses, rows = [], []
    for _ in range(2):
        batch = ds.sample_batch(g, 16)
        rows.append((batch["action"].shape[0], rows_of(batch)[:2]))
        losses.append(float(pipe.train_step(batch)["loss"]))
    obs = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 2, 5)).astype(np.float32))
    chunk = pipe.act_chunk(obs, generator=torch.Generator().manual_seed(1))
    return {"losses": losses, "rows": rows, "chunk": tuple(chunk.shape)}


def case_pusht_window(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import make_mesh, place_pipeline

    out = {}
    if rank == 0:
        ds1, p1 = _pusht()
        out["single"] = _logs(p1.make_train_scan(ds1, 16, 3)(torch.Generator().manual_seed(4)))
        out["single_params"] = _flat(p1.agent.params)
    mesh = make_mesh(world)
    ds2, p2 = _pusht()
    place_pipeline(p2, mesh)
    ds2.place_on_mesh(mesh)
    out["mesh"] = _logs(p2.make_train_scan(ds2, 16, 3)(torch.Generator().manual_seed(4)))
    out["mesh_params"] = _flat(p2.agent.params)
    return out


def case_dd_invdyn(rank, world, inputs):
    """DD's inverse dynamics (a plain module and optimizer, no engine) is
    placed too: rank 1's different weights become rank 0's, and its
    optimizer averages over the ranks."""
    from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoDataset
    from cleandiffuser_tpu_torch.dataset.fake import fake_d4rl_dataset
    from cleandiffuser_tpu_torch.parallel import make_mesh, place_pipeline
    from cleandiffuser_tpu_torch.pipelines import DDPipeline

    ds = D4RLMuJoCoDataset(fake_d4rl_dataset("halfcheetah-medium-v2", n_steps=600, ep_len=100),
                           horizon=4, device="cpu")
    pipe = DDPipeline(obs_dim=17, act_dim=6, horizon=4, emb_dim=16, d_model=32, n_heads=2,
                      depth=1, sampling_steps=2, diffusion_gradient_steps=10, rng=rank,
                      device="cpu")
    mesh = make_mesh(world)
    place_pipeline(pipe, mesh)
    ds.place_on_mesh(mesh)
    before = _flat(pipe.invdyn.net)
    log = pipe.train_step(ds.sample_batch(torch.Generator().manual_seed(0), 16))
    return {"invdyn_before": before, "invdyn_after": _flat(pipe.invdyn.net),
            "agent": _flat(pipe.agent.params), "loss": float(log["loss"]),
            "invdyn_loss": float(log["invdyn_loss"]),
            "grad_group": pipe.invdyn.optimizer.grad_group is not None}


def case_qgpo_placed(rank, world, inputs):
    from cleandiffuser_tpu_torch.parallel import make_mesh, place_pipeline
    from cleandiffuser_tpu_torch.pipelines import QGPOPipeline

    pipe = QGPOPipeline(obs_dim=17, act_dim=6, K=4, rng=rank, device="cpu")
    place_pipeline(pipe, make_mesh(world))
    return {"q": _flat(pipe.q_net), "q_target": _flat(pipe.q_target),
            "grad_group": pipe.q_optimizer.grad_group is not None}


def case_nested_classifier(rank, world, inputs):
    from cleandiffuser_tpu_torch.classifier import CumRewClassifier
    from cleandiffuser_tpu_torch.diffusion import DiscreteDiffusionSDE
    from cleandiffuser_tpu_torch.nn_classifier import HalfJannerUNet1d
    from cleandiffuser_tpu_torch.nn_diffusion import JannerUNet1d
    from cleandiffuser_tpu_torch.parallel import make_mesh, place_pipeline

    g = torch.Generator().manual_seed(rank)
    classifier = CumRewClassifier(HalfJannerUNet1d(horizon=8, in_dim=23, model_dim=16,
                                                   emb_dim=16, generator=g), device="cpu")
    engine = DiscreteDiffusionSDE(JannerUNet1d(in_dim=23, model_dim=16, emb_dim=16, generator=g),
                                  classifier=classifier, diffusion_steps=2, device="cpu")

    class Holder:
        pass

    pipe = Holder()
    pipe.planner = engine
    place_pipeline(pipe, make_mesh(world))
    return {"classifier": _flat(classifier.params), "engine": _flat(engine.params),
            "grad_group": classifier.optimizer.grad_group is not None
            and engine.optimizer.grad_group is not None}


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


def main(world: int, rank: int, tmp: str, names) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    inputs = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
    results = {}
    for name in names:
        try:
            results[name] = CASES[name](rank, world, inputs)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
        dist.barrier()
    torch.save(results, Path(tmp) / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4:])

"""Entry points of the port (counterpart of `__graft_entry__.py`).

- `entry(device=None)`: (fn, example_args) of one forward of the flagship
  backbone, DiT1d at d_model 384, 6 heads, depth 12 (the trajectory
  denoiser of Decision Diffuser, DiffuserLite, Veteran and SynthER). K1
  takes d_model <= 320, so this forward runs the plain blocks.
- `dryrun_multichip(n_devices, platform=None)`: on the port's mesh
  (parallel/), one data-parallel engine step of a small DiT planner (FSDP
  over a (2, n / 2) ("dp", "fsdp") mesh when n >= 4 is even), a mesh-placed
  DQL step on dataset-side row batches, a DQL training window on the mesh
  and batch-split candidate sampling. With n > 1 it runs in each of n
  processes started by torchrun
  (`torchrun --nproc-per-node n -m cleandiffuser_tpu_torch.graft_entry`);
  with one it starts (and ends) a one-rank process group itself.

Both run on the CUDA device unless `platform="cpu"` (`python -m
cleandiffuser_tpu_torch.graft_entry platform=cpu` here).
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, (model, x, t, emb)): one DiT1d forward, fn(model, x, t, emb)."""
    from .nn_diffusion import DiT1d
    from .utils.tensors import default_device

    dev = default_device(device)
    model = DiT1d(in_dim=23, emb_dim=128, d_model=384, n_heads=6, depth=12,
                  generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.zeros((4, 32, 23), device=dev)
    t = torch.zeros((4,), dtype=torch.int32, device=dev)
    emb = torch.zeros((4, 128), device=dev)

    def fn(model, x, t, emb):
        return model(x, t, emb)

    return fn, (model, x, t, emb)


@contextlib.contextmanager
def _process_group(n_devices: int, platform):
    """The process group the dry run takes: torchrun's for n > 1 (its
    WORLD_SIZE must be n), else one rank of a group made here from a file
    in a temporary directory and destroyed at the end."""
    if dist.is_initialized() or n_devices > 1:
        from .parallel import setup_mesh

        setup_mesh(n_devices=n_devices, platform=platform)
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo" if platform == "cpu" else "nccl",
                                init_method=f"file://{tmp}/pg", rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def dryrun_multichip(n_devices: int, platform=None) -> dict:
    """One step of each multi-device path on an n-device mesh, tiny shapes.
    Returns the losses."""
    from .dataset import D4RLMuJoCoTDDataset
    from .dataset.fake import fake_d4rl_qlearning_dataset
    from .diffusion import DiscreteDiffusionSDE
    from .nn_condition import MLPCondition
    from .nn_diffusion import DiT1d
    from .parallel import DataParallelEngine, make_mesh, place_pipeline, shard_sample_fn
    from .pipelines.dql import DQLPipeline
    from .pipelines.runner import make_rl_train_scan
    from .utils.tensors import default_device

    dev = default_device("cpu" if platform == "cpu" else None)
    with _process_group(n_devices, platform):
        if n_devices % 2 == 0 and n_devices >= 4:
            mesh = make_mesh(n_devices, axis_names=("dp", "fsdp"), shape=(2, n_devices // 2))
            fsdp_axis = "fsdp"
        else:
            mesh, fsdp_axis = make_mesh(n_devices), None
        g = torch.Generator().manual_seed(0)
        engine = DiscreteDiffusionSDE(
            DiT1d(in_dim=6, emb_dim=32, d_model=64, n_heads=4, depth=2, generator=g),
            MLPCondition(in_dim=5, out_dim=32, hidden_dims=(32,), generator=g),
            diffusion_steps=8, device=dev)
        rng = np.random.default_rng(0)
        batch = 2 * n_devices
        x0 = torch.from_numpy(rng.standard_normal((batch, 8, 6)).astype(np.float32)).to(dev)
        cond = torch.from_numpy(rng.standard_normal((batch, 5)).astype(np.float32)).to(dev)
        dp = DataParallelEngine(engine, mesh, fsdp_axis=fsdp_axis).place()
        loss = float(dp.update(x0, cond)["loss"])
        assert np.isfinite(loss), f"non-finite loss: {loss}"
        print(f"dryrun engine ok: loss={loss:.4f}, mesh {tuple(mesh.mesh.shape)} "
              f"{mesh.mesh_dim_names}", flush=True)

        # the pipeline path every CLI takes with n_devices > 1: a mesh-placed
        # DQL step on the dataset's row batches, a window, batch-split sampling
        dp_mesh = mesh if fsdp_axis is None else make_mesh(n_devices)
        ds = D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset(n_steps=512, ep_len=64),
                                 device=dev)
        pipe = DQLPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim, diffusion_steps=2,
                           sampling_steps=2, gradient_steps=10, device=dev)
        place_pipeline(pipe, dp_mesh)
        ds.place_on_mesh(dp_mesh)
        gen = torch.Generator(device=dev).manual_seed(0)
        bc = float(pipe.train_step(ds.sample_batch(gen, 2 * n_devices))["bc_loss"])
        assert np.isfinite(bc), f"non-finite pipeline loss: {bc}"
        window = float(make_rl_train_scan(pipe, ds, 2 * n_devices, 2)(gen)["bc_loss"])
        assert np.isfinite(window), f"non-finite window loss: {window}"
        sample_fn = pipe.actor.build_sample_fn(solver="ddpm", sample_steps=2, cfg_mode="cond",
                                               final_logp=False)
        E, K = 2, n_devices
        with torch.no_grad():
            act, _ = shard_sample_fn(sample_fn, dp_mesh)(
                pipe.actor.ema_params, gen, torch.zeros((E * K, ds.a_dim), device=dev),
                condition_cfg=torch.zeros((E * K, ds.o_dim), device=dev), w_cfg=1.0)
        assert bool(torch.isfinite(act).all()), "non-finite sharded samples"
        print(f"dryrun_multichip({n_devices}) ok: engine loss={loss:.4f}, pipeline "
              f"bc_loss={bc:.4f}, window bc_loss={window:.4f}, sharded eval "
              f"{tuple(act.shape)} over dp={n_devices}", flush=True)
    return {"engine_loss": loss, "bc_loss": bc, "window_bc_loss": window}


def main(argv) -> None:
    platform = "cpu" if "platform=cpu" in argv else None
    dev = "cpu" if platform == "cpu" else None
    fn, args = entry(dev)
    with torch.no_grad():
        out = fn(*args)
    print("entry ok:", tuple(out.shape), flush=True)
    dryrun_multichip(int(os.environ.get("WORLD_SIZE", "1")), platform)


if __name__ == "__main__":
    main(sys.argv[1:])

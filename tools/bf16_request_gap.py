"""How far `bf16_sampling` moves a served request from its f32 request, in the
JAX package and in the PyTorch port, on the same weights and draws.

Two requests at their shipped widths on seeded weights, the engines built
as the pipelines build them (5 ddpm steps predicting eps, predictions
clipped to [-1, 1]):

- `dql`: DQL's actor (`DQLMlp`, obs 17, act 6, time embedding 64) on 50
  envs x 50 candidates, temperature 0.5 (configs/dql/mujoco);
- `dp_chi_unet`: Diffusion Policy's Chi U-Net (model_dim 256, dim_mult
  (1, 2, 2), global condition of 2 frames of 5 obs) on 10 envs of 16 x 2
  actions (configs/dp/pusht/chi_unet).

For each it prints, over the sample's scale (max |f32 sample|, at least 1):
the port against JAX in bf16 (max, mean), and each package's bf16 sample
against its f32 sample (max, mean, and the share of entries beyond 0.02).
The JAX side is compiled with XLA's excess precision off, so every bf16
rounding its source asks for is made (tests/test_torch_bf16_backbones.py
`jit_exact`). On the CPU:

    JAX_PLATFORMS=cpu python tools/bf16_request_gap.py [--case dql dp_chi_unet]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cleandiffuser_tpu.diffusion import DiscreteDiffusionSDE as JaxSDE  # noqa: E402
from cleandiffuser_tpu.nn_condition import IdentityCondition as JaxIdentity  # noqa: E402
from cleandiffuser_tpu.nn_diffusion import ChiUNet1d as JaxChiUNet  # noqa: E402
from cleandiffuser_tpu.nn_diffusion import DQLMlp as JaxDQLMlp  # noqa: E402
from cleandiffuser_tpu_torch.diffusion import DiscreteDiffusionSDE  # noqa: E402
from cleandiffuser_tpu_torch.nn_condition import IdentityCondition  # noqa: E402
from cleandiffuser_tpu_torch.nn_diffusion import ChiUNet1d, DQLMlp  # noqa: E402
from cleandiffuser_tpu_torch.utils.jax_params import load_agent_params  # noqa: E402


def seeded(tree, seed: int):
    """Every leaf seeded: kernels N(0, 1 / fan_in), norm scales 1 + 0.1 N,
    other vectors 0.1 N."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        z = rng.standard_normal(a.shape)
        if a.ndim >= 2:
            return (z / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        scale = jax.tree_util.keystr(path).endswith("['scale']")
        return (z * 0.1 + (1.0 if scale else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def chain_draws(key, shape, steps: int):
    """The JAX sampler's draws: k_init, k_scan = split(key); then k, sub =
    split(k) per step."""
    k_init, k = jax.random.split(key)
    per = []
    for _ in range(steps):
        k, sub = jax.random.split(k)
        per.append(np.asarray(jax.random.normal(sub, shape)))
    return np.array(jax.random.normal(k_init, shape)), np.stack(per)


def case(name: str):
    """(JAX backbone, port backbone, prior shape, condition, temperature)."""
    rng = np.random.default_rng(0)
    if name == "dql":
        rows = 50 * 50
        return (JaxDQLMlp(obs_dim=17, act_dim=6, emb_dim=64), DQLMlp(17, 6, emb_dim=64),
                (rows, 6), rng.standard_normal((rows, 17)).astype(np.float32), 0.5)
    kw = dict(act_dim=2, obs_dim=5, To=2, model_dim=256, emb_dim=256, dim_mult=(1, 2, 2),
              obs_as_global_cond=True, timestep_emb_type="positional")
    return (JaxChiUNet(**kw), ChiUNet1d(**kw), (10, 16, 2),
            rng.standard_normal((10, 2, 5)).astype(np.float32), 1.0)


def gap(a, b, scale):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / scale
    return d.max(), d.mean(), (d > 0.02).mean()


def run(name: str):
    jnet, tnet, shape, cond, temperature = case(name)
    steps = 5
    kw = dict(diffusion_steps=steps, predict_noise=True, x_max=np.ones(shape[1:]),
              x_min=-np.ones(shape[1:]))
    jeng = JaxSDE(jnet, JaxIdentity(dropout=0.0), rng=0, **kw)
    teng = DiscreteDiffusionSDE(tnet, IdentityCondition(dropout=0.0), device="cpu", **kw)
    prior = np.zeros(shape, np.float32)
    shapes = jax.eval_shape(lambda: jeng.nn_diffusion.init(
        jax.random.PRNGKey(0), jnp.asarray(prior[:2]), jnp.zeros((2,), jnp.int32),
        jnp.asarray(cond[:2])))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ema = {"diffusion": seeded(zeros, 2), "condition": {}}
    load_agent_params(teng.ema_params, ema)
    jema = jax.tree_util.tree_map(jnp.asarray, ema)
    skw = dict(solver="ddpm", sample_steps=steps, cfg_mode="cond", final_logp=False)
    key = jax.random.PRNGKey(3)
    init, per = (torch.from_numpy(a) for a in chain_draws(key, shape, steps))
    out = {}
    for bf16 in (False, True):
        jeng.bf16_sampling = teng.bf16_sampling = bf16
        jfn = jeng.build_sample_fn(**skw)
        sample = lambda p: jfn(p, None, key, jnp.asarray(prior), condition_cfg=jnp.asarray(cond),
                               w_cfg=1.0, temperature=temperature)[0]
        compiled = jax.jit(sample).lower(jema).compile(
            compiler_options={"xla_allow_excess_precision": False})
        with torch.no_grad():
            got, _ = teng.build_sample_fn(**skw)(
                teng.ema_params, None, torch.from_numpy(prior),
                condition_cfg=torch.from_numpy(cond), w_cfg=1.0, temperature=temperature,
                noise=(init, per))
        out[bf16] = (np.asarray(compiled(jema)), got.numpy())
    scale = max(np.abs(out[False][0]).max(), 1.0)
    print(f"{name}: sample {shape}, scale {scale:.3f}", flush=True)
    print(f"  port against JAX, bf16: max {gap(out[True][1], out[True][0], scale)[0]:.3e}, "
          f"mean {gap(out[True][1], out[True][0], scale)[1]:.3e}", flush=True)
    for side, label in ((0, "JAX"), (1, "port")):
        g_max, g_mean, share = gap(out[True][side], out[False][side], scale)
        print(f"  {label} bf16 against f32: max {g_max:.3e}, mean {g_mean:.3e}, share of "
              f"entries beyond 0.02 {share:.2e}", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--case", nargs="+", default=["dql", "dp_chi_unet"],
                   choices=["dql", "dp_chi_unet"])
    for name in p.parse_args().case:
        run(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())

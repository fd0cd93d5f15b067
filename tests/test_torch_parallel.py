"""The port's multi-device engine path (cleandiffuser_tpu_torch/parallel/)
on gloo process groups on the CPU: the counterparts of the 5 cases of
tests/test_parallel.py.

Each world size is spawned once for the module (tests/torch_parallel_ranks.py:
one process per rank, a file-based init) and runs all its cases; each test
reads its case's results. Against one process of the port: losses within
1e-5 relative, params and EMA within 1e-5, samples within 1e-5 of their
scale. The data-parallel step is also held against the JAX package's
`DataParallelEngine` on a 2-device mesh of the virtual CPU devices
(tests/conftest.py), the port taking the JAX engine's weights and its
update's draws (t, eps): within 1e-5, the tolerance of the single-device
training parity (tests/test_torch_dd_train.py `TOL`).
"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from cleandiffuser_tpu_torch.parallel import place_pipeline, setup_mesh
from cleandiffuser_tpu_torch.utils.ranks import batch_draw, batch_rows

TOL = 1e-5


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _scale_close(got, want, tol=TOL):
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(np.asarray(got) - want).max()) <= tol * scale


def _jax_dp_inputs():
    """The JAX engine's init, its update's draws, and its data-parallel
    update on 2 of the virtual devices."""
    from cleandiffuser_tpu.diffusion import DiscreteDiffusionSDE
    from cleandiffuser_tpu.nn_condition import IdentityCondition
    from cleandiffuser_tpu.nn_diffusion import DQLMlp
    from cleandiffuser_tpu.parallel import DataParallelEngine, make_mesh

    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((16, 3)).astype(np.float32)
    cond = rng.standard_normal((16, 7)).astype(np.float32)
    engine = DiscreteDiffusionSDE(DQLMlp(obs_dim=7, act_dim=3, emb_dim=16),
                                  IdentityCondition(dropout=0.0), diffusion_steps=8, rng=42)
    engine.init(x0, cond)
    np_tree = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)
    params = np_tree(engine.state.params)
    _, sub = jax.random.split(engine.state.rng)
    k_noise, _, _ = jax.random.split(sub, 3)
    k_t, k_eps = jax.random.split(k_noise)
    t = np.array(jax.random.randint(k_t, (16,), 0, 8))
    eps = np.array(jax.random.normal(k_eps, (16, 3)))
    log = DataParallelEngine(engine, make_mesh(2)).place().update(x0, cond)
    want = {"loss": float(log["loss"]), "grad_norm": float(log["grad_norm"]),
            "params": np_tree(engine.state.params)}
    return {"params": params, "x0": x0, "cond": cond, "t": t, "eps": eps}, want


@pytest.fixture(scope="module")
def jax_dp():
    return _jax_dp_inputs()


@pytest.fixture(scope="module")
def two(tmp_path_factory, jax_dp):
    names = ["mesh", "dp_update_and_sample", "dp_matches_single", "dp_matches_jax",
             "sharded_sampling"]
    return ranks.spawn(2, names, tmp_path_factory.mktemp("ranks2"), {"dp_jax": jax_dp[0]})


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return ranks.spawn(4, ["fsdp_2x2"], tmp_path_factory.mktemp("ranks4"))


def test_port_mesh_takes_every_rank(two):
    for got in ranks.result(two, "mesh"):
        assert got["dims"] == ("dp",) and got["shape"] == (2,)
        assert got["two_dims"] == ("dp", "fsdp") and got["two_shape"] == (1, 2)
        assert got["placements"] == ["R", "R", "R", "S(0)"]


def test_port_dp_engine_update_and_sample(two):
    a, b = ranks.result(two, "dp_update_and_sample")
    assert all(np.isfinite(a["losses"])) and a["losses"] == b["losses"]
    assert a["out"].shape == (8, 3) and np.isfinite(a["out"]).all()
    # the ranks' params stay equal, and so do their samples
    np.testing.assert_array_equal(a["params"], b["params"])
    np.testing.assert_array_equal(a["out"], b["out"])


def test_port_dp_step_matches_one_process(two):
    a, b = ranks.result(two, "dp_matches_single")
    for got in (a, b):
        _close(got["mesh"], a["single"])
        _close(got["mesh_params"], a["single_params"])
        _close(got["mesh_ema"], a["single_ema"])
    assert a["mesh"][0] != a["mesh"][1]


def test_port_dp_step_matches_jax_on_a_two_device_mesh(two, jax_dp):
    want = jax_dp[1]
    for got in ranks.result(two, "dp_matches_jax"):
        _close(got["loss"], want["loss"])
        _close(got["grad_norm"], want["grad_norm"])
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got["params"]),
                                     jax.tree_util.tree_leaves_with_path(want["params"])):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=jax.tree_util.keystr(path))


def test_port_fsdp_dit_step_matches_one_process(four):
    """HSDP on a (2, 2) mesh: params of >= 1024 elements sharded over fsdp
    (half of each on a rank), the rest replicated; the step, the EMA and a
    sample from the sharded EMA equal one process's."""
    res = ranks.result(four, "fsdp_2x2")
    single = res[0]
    for got in res:
        _close(got["mesh"], single["single"])
        _close(got["mesh_params"], single["single_params"])
        _close(got["mesh_ema"], single["single_ema"])
        _scale_close(got["mesh_sample"], single["single_sample"])
        assert got["sharded_leaf_shares"] and set(got["sharded_leaf_shares"]) == {0.5}
        np.testing.assert_allclose(got["param_share"], 0.5 + got["small_share"] / 2)


def test_port_sharded_sampling_matches_one_process(two):
    for got in ranks.result(two, "sharded_sampling"):
        _scale_close(got["sharded"], got["single"])
        _scale_close(got["explicit_sharded"], got["explicit"])
        assert got["single"].shape == (16, 3)


# ---------------------------------------------------------------------------
# no process group

def test_setup_mesh_raises_without_a_group_of_that_size():
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        setup_mesh({"n_devices": 2, "platform": "cpu"})
    with pytest.raises(ValueError, match="does not multiply"):
        setup_mesh({"n_devices": 2, "mesh_shape": [2, 2], "platform": "cpu"})
    assert setup_mesh({"n_devices": 1}) is None


def test_place_pipeline_takes_a_device_mesh_only():
    place_pipeline(object(), None)
    with pytest.raises(TypeError, match="DeviceMesh"):
        place_pipeline(object(), mesh=object())


def test_batch_draw_takes_the_rank_rows_of_the_global_draw():
    draw = lambda s: torch.randn(s, generator=torch.Generator().manual_seed(3))
    whole = draw((8, 3))
    for rank in range(4):
        with batch_rows(rank, 4):
            torch.testing.assert_close(batch_draw(draw, (2, 3)), whole[2 * rank:2 * rank + 2],
                                       rtol=0, atol=0)
    torch.testing.assert_close(batch_draw(draw, (8, 3)), whole, rtol=0, atol=0)


def test_fused_update_refuses_a_split_batch():
    """K2 draws each element's noise from its index in the rank's rows:
    the sampler raises rather than give other numbers than one process."""
    e = ranks._dql_engine()
    fn = e.build_sample_fn(solver="ddpm", sample_steps=2, cfg_mode="cond", fused_update=True)
    with torch.no_grad(), batch_rows(0, 2), pytest.raises(ValueError, match="split over ranks"):
        fn(e.ema_params, torch.Generator().manual_seed(0), torch.zeros(4, 3),
           condition_cfg=torch.zeros(4, 7), w_cfg=1.0)



def test_graft_entry_forward_and_one_rank_dry_run():
    """`__graft_entry__.py`'s counterpart: the DiT1d forward at d_model 384
    (the JAX entry's output shape) and the multi-device dry run on a
    one-rank gloo group it makes and ends itself."""
    import torch.distributed as dist

    from cleandiffuser_tpu_torch.graft_entry import dryrun_multichip, entry

    fn, args = entry("cpu")
    with torch.no_grad():
        out = fn(*args)
    assert tuple(out.shape) == (4, 32, 23) and bool(torch.isfinite(out).all())
    losses = dryrun_multichip(1, platform="cpu")
    assert np.isfinite(list(losses.values())).all() and not dist.is_initialized()

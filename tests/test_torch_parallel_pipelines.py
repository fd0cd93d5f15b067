"""The port's pipelines on a mesh (parallel/integrate.py `setup_mesh`,
`place_pipeline`, the datasets' `place_on_mesh`, the runner's windows) on
gloo process groups on the CPU: the counterparts of the 10 cases of
tests/test_parallel_pipelines.py, and a CLI under torchrun.

Each world size is spawned once for the module (tests/torch_parallel_ranks.py)
and runs all its cases. Against one process of the port: losses within 1e-5
relative, params within 1e-5. The PushT cases narrow the Chi U-Net to
model_dim 16 (as tests/test_torch_imitation_cli.py does) to keep the CPU
time small. The DQL step and the DQL window are also held against the JAX
package on a 2-device mesh of the virtual CPU devices (tests/conftest.py):
the port takes the JAX pipeline's seeded weights, its batches (the window's
from its own gather keys) and each step's draws (tests/test_torch_dql.py
`_jax_draws`), each rank its rows of both, with the single-device parity's
tolerances (tests/test_torch_dql.py: logs, critic and target 1e-5 absolute
/ 1e-4 relative, the actor's params and EMA 5e-5). The FSDP case runs on a
(1, 4) mesh, where the JAX test's share bounds apply (each sharded leaf a
quarter on a rank); at fsdp 2 a rank holds half of each sharded leaf and all
of the small ones, which tests/test_torch_parallel.py checks on (2, 2).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from test_torch_dql import ACTOR_TOL, ATOL, CFG, RTOL, START, _assert_tree, _batch, _jax_draws
from test_torch_dql import _np as np_tree
from test_torch_dql import _seeded

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _logs_close(got, want, atol=TOL, rtol=TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol, err_msg=k)


def _jax_dql(cfg):
    """A JAX DQL pipeline on seeded weights at actor step START, and the
    inputs that put the port's pipeline on the same weights."""
    from cleandiffuser_tpu.pipelines.dql import DQLPipeline as JaxDQL

    jpipe = JaxDQL(**cfg)
    st, cs = jpipe.actor.state, jpipe.critic_state
    trees = {"params": _seeded(st.params, 1), "ema": _seeded(st.ema_params, 2),
             "critic": _seeded(cs.params, 3), "target": _seeded(cs.target_params, 4)}
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    jpipe.actor.state = st.replace(params=jt(trees["params"]), ema_params=jt(trees["ema"]),
                                   step=jnp.asarray(START, jnp.int32))
    jpipe.critic_state = cs.replace(params=jt(trees["critic"]), target_params=jt(trees["target"]))
    return jpipe, {**trees, "cfg": cfg, "start": START}


def _jax_state(jpipe) -> dict:
    st, cs = jpipe.actor.state, jpipe.critic_state
    return {"params": np_tree(st.params), "ema": np_tree(st.ema_params),
            "critic": np_tree(cs.params), "target": np_tree(cs.target_params)}


def _jax_dql_step():
    """3 steps of the JAX DQL pipeline placed on 2 devices, with the draws
    each step takes."""
    from cleandiffuser_tpu.parallel import make_mesh, place_pipeline, shard_batch

    jpipe, inp = _jax_dql(CFG)
    mesh = make_mesh(2)
    place_pipeline(jpipe, mesh)
    rng = np.random.default_rng(5)
    batches = [_batch(rng) for _ in range(3)]
    draws, logs = [], []
    for b in batches:
        draws.append(_jax_draws(jpipe, False))
        log = jpipe.train_step(shard_batch(mesh, jax.tree_util.tree_map(jnp.asarray, b)))
        logs.append({k: float(v) for k, v in log.items()})
    inp.update(batches=batches, draws=draws)
    return inp, {"logs": logs, "state": _jax_state(jpipe), "step": int(jpipe.actor.state.step)}


def _jax_window():
    """The JAX fused window (4 steps, batch 8 = tests/test_torch_dql.py's B)
    on 2 devices, and its batches and draws: the batches from its gather
    keys, each step's draws from the actor's key, which a step replaces by
    the first of its 5-way split (cleandiffuser_tpu/pipelines/dql.py:155,216)."""
    from cleandiffuser_tpu.dataset import D4RLMuJoCoTDDataset, fake_d4rl_qlearning_dataset
    from cleandiffuser_tpu.parallel import make_mesh, place_pipeline
    from cleandiffuser_tpu.pipelines.runner import make_rl_train_scan

    raw = fake_d4rl_qlearning_dataset("hopper-medium-v2", n_steps=2000, ep_len=200)
    cfg = {**CFG, "obs_dim": 11}
    n_steps, root = 4, jax.random.PRNGKey(9)
    gather = D4RLMuJoCoTDDataset(raw).gather_fn(8)
    batches = [jax.tree_util.tree_map(np.asarray, gather(k))
               for k in jax.random.split(root, n_steps)]
    jpipe, inp = _jax_dql(cfg)
    start, draws = jpipe.actor.state, []
    for _ in batches:
        draws.append(_jax_draws(jpipe, False))
        st = jpipe.actor.state
        jpipe.actor.state = st.replace(rng=jax.random.split(st.rng, 5)[0])
    jpipe.actor.state = start
    mesh = make_mesh(2)
    ds = D4RLMuJoCoTDDataset(raw).place_on_mesh(mesh)
    place_pipeline(jpipe, mesh)
    log = make_rl_train_scan(jpipe, ds, 8, n_steps)(root)
    inp.update(batches=batches, draws=draws)
    return inp, {"log": {k: float(v) for k, v in log.items()}, "state": _jax_state(jpipe),
                 "step": int(jpipe.actor.state.step)}


@pytest.fixture(scope="module")
def jax_runs():
    return {"dql_jax": _jax_dql_step(), "window_jax": _jax_window()}


@pytest.fixture(scope="module")
def two(tmp_path_factory, jax_runs):
    names = ["setup_mesh", "dataset_rows", "dql_step", "dql_jax", "fused_window",
             "rl_window_jax", "pusht_dp", "pusht_window", "dd_invdyn", "qgpo_placed",
             "nested_classifier"]
    return ranks.spawn(2, names, tmp_path_factory.mktemp("ranks2"),
                       {k: v[0] for k, v in jax_runs.items()})


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return ranks.spawn(4, ["fsdp_1x4"], tmp_path_factory.mktemp("ranks4"))


def test_port_setup_mesh_from_config_keys(two):
    for got in ranks.result(two, "setup_mesh"):
        assert got["dp"] == (("dp",), (2,))
        assert got["two"] == (("dp", "fsdp"), (1, 2))
        assert "n_devices=4 but 2 process(es) run" in got["more_than_world"]
        assert "torchrun --nproc-per-node 4" in got["more_than_world"]
        assert got["bad_shape"].startswith("ValueError: mesh_shape (2, 2)")
        assert "0 GPU(s) present" in got["no_gpus"]


def test_port_dataset_on_mesh_gathers_the_rank_rows(two):
    for rank, got in enumerate(ranks.result(two, "dataset_rows")):
        assert got["rows"] == 16 and got["tag"] == (rank, 2) and got["equal"]
        assert "not divisible by dp size 2" in got["odd"]


def test_port_dql_pipeline_on_mesh_matches_one_process(two):
    res = ranks.result(two, "dql_step")
    single = res[0]
    for got in res:
        assert got["is_mesh"]
        for a, b in zip(got["mesh"], single["single"]):
            _logs_close(a, b)
        for k, v in single["single_state"].items():
            _close(got["mesh_state"][k], v)
        assert got["act"].shape == (4, 6) and np.all(np.abs(got["act"]) <= 1.0)
    np.testing.assert_array_equal(res[0]["act"], res[1]["act"])


def _assert_jax_state(got, want):
    _assert_tree(got["params"], want["params"], ACTOR_TOL["dql"])
    _assert_tree(got["ema"], want["ema"], ACTOR_TOL["dql"])
    _assert_tree(got["critic"], want["critic"])
    _assert_tree(got["target"], want["target"])


def test_port_dql_pipeline_on_mesh_matches_jax_on_two_devices(two, jax_runs):
    want = jax_runs["dql_jax"][1]
    for got in ranks.result(two, "dql_jax"):
        for a, b in zip(got["logs"], want["logs"]):
            _logs_close(a, b, ATOL, RTOL)
        _assert_jax_state(got["state"], want["state"])
        assert got["step"] == want["step"] == START + 3


def test_port_rl_window_on_mesh_matches_one_process(two):
    res = ranks.result(two, "fused_window")
    single = res[0]
    for got in res:
        _logs_close(got["mesh"], single["single"])
        for k, v in single["single_state"].items():
            _close(got["mesh_state"][k], v)
        assert got["step"] == 4


def test_port_rl_window_on_mesh_matches_jax_on_two_devices(two, jax_runs):
    want = jax_runs["window_jax"][1]
    for got in ranks.result(two, "rl_window_jax"):
        _logs_close(got["log"], want["log"], ATOL, RTOL)
        _assert_jax_state(got["state"], want["state"])
        assert got["step"] == want["step"] == START + 4


def test_port_fsdp_step_matches_one_process_and_shards_moments(four):
    res = ranks.result(four, "fsdp_1x4")
    single = res[0]
    for got in res:
        _close(got["mesh"], single["single"])
        _close(got["mesh_params"], single["single_params"])
        _close(got["mesh_ema"], single["single_ema"])
        assert got["param_share"] < 0.5 and got["ema_share"] < 0.5
        assert got["moment_share"] < 0.55
        # a sample from the sharded EMA: the params gathered in each forward
        scale = max(1.0, float(np.abs(single["single_sample"]).max()))
        assert np.abs(got["mesh_sample"] - single["single_sample"]).max() <= TOL * scale


def test_port_dp_pusht_pipeline_trains_on_mesh(two):
    a, b = ranks.result(two, "pusht_dp")
    assert all(np.isfinite(a["losses"])) and a["losses"] == b["losses"]
    assert a["rows"] == [(8, (0, 2))] * 2 and b["rows"] == [(8, (1, 2))] * 2
    assert a["chunk"] == (4, 4, 2)


def test_port_dp_pusht_window_on_mesh_matches_one_process(two):
    res = ranks.result(two, "pusht_window")
    for got in res:
        _logs_close(got["mesh"], res[0]["single"])
        _close(got["mesh_params"], res[0]["single_params"])


def test_port_dd_invdyn_placed_on_mesh(two):
    """Each rank built its pipeline from its own seed: placing it puts rank
    0's weights on both, and the inverse dynamics' optimizer averages."""
    a, b = ranks.result(two, "dd_invdyn")
    np.testing.assert_array_equal(a["invdyn_before"], b["invdyn_before"])
    np.testing.assert_array_equal(a["invdyn_after"], b["invdyn_after"])
    np.testing.assert_array_equal(a["agent"], b["agent"])
    assert a["grad_group"] and np.isfinite([a["loss"], a["invdyn_loss"]]).all()
    assert not np.array_equal(a["invdyn_before"], a["invdyn_after"])


def test_port_qgpo_q_nets_and_optimizer_placed_on_mesh(two):
    a, b = ranks.result(two, "qgpo_placed")
    np.testing.assert_array_equal(a["q"], b["q"])
    np.testing.assert_array_equal(a["q_target"], b["q_target"])
    assert a["grad_group"] and b["grad_group"]


def test_port_engine_and_its_classifier_placed_on_mesh(two):
    a, b = ranks.result(two, "nested_classifier")
    np.testing.assert_array_equal(a["classifier"], b["classifier"])
    np.testing.assert_array_equal(a["engine"], b["engine"])
    assert a["grad_group"] and b["grad_group"]


# ---------------------------------------------------------------------------
CLI_ARGS = ["platform=cpu", "hidden_dim=32", "gradient_steps=4", "log_interval=2",
            "save_interval=4", "diffusion_steps=2", "sampling_steps=2", "batch_size=8"]


def _run_cli(cwd: Path, launcher, *extra):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cwd.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([*launcher, "-m", "cleandiffuser_tpu_torch.cli.dql_d4rl_mujoco",
                          *CLI_ARGS, *extra], cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    run = cwd / "results/torch/dql_d4rl_mujoco/halfcheetah-medium-v2"
    return run, out.stdout.count("{'bc_loss'")  # the window logs printed (both ranks print)


def test_port_dql_cli_under_torchrun_writes_once_and_matches_one_process(tmp_path):
    """`torchrun --nproc-per-node 2 ... platform=cpu n_devices=2`: rank 0
    writes the one train.jsonl and the checkpoints; the logged window means
    equal the one-process run's."""
    import json

    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2"]
    run2, printed = _run_cli(tmp_path / "two", torchrun, "n_devices=2")
    run1, _ = _run_cli(tmp_path / "one", [sys.executable])
    assert sorted(p.name for p in run2.iterdir()) == sorted(p.name for p in run1.iterdir()) == [
        "ckpt_4.pt", "ckpt_latest.pt", "config.json", "train.jsonl"]
    two = [json.loads(line) for line in (run2 / "train.jsonl").read_text().splitlines()]
    one = [json.loads(line) for line in (run1 / "train.jsonl").read_text().splitlines()]
    assert len(two) == len(one) == 2 and printed == 4  # both ranks print, rank 0 writes
    for a, b in zip(two, one):
        assert a["gradient_steps"] == b["gradient_steps"]
        _logs_close({k: a[k] for k in ("bc_loss", "q_loss", "critic_loss", "target_q_mean")},
                    {k: b[k] for k in ("bc_loss", "q_loss", "critic_loss", "target_q_mean")})


VETERAN_EV = """import sys
from cleandiffuser_tpu_torch.cli import veteran_d4rl_mujoco as cli
cli.EV_GRADIENT_STEPS = 4  # the reference's 1,000,000, a module constant
cli.pipeline(cli.load_config(cli.CONFIG_DIR, "mujoco", cli.parse_cli(sys.argv[1:])))
"""
VETERAN_ARGS = ["platform=cpu", "mode=train_expected_value", "planner_d_model=32",
                "planner_emb_dim=16", "planner_depth=1", "unet_dim=8", "policy_hidden_dim=16",
                "policy_diffusion_steps=2", "log_interval=2", "save_interval=4"]


def _run_veteran_ev(cwd: Path, launcher, *extra):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cwd.mkdir(parents=True, exist_ok=True)
    (cwd / "veteran_ev.py").write_text(VETERAN_EV)
    out = subprocess.run([*launcher, "veteran_ev.py", *VETERAN_ARGS, *extra], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "runs whole on every rank" not in out.stdout  # each rank stepped on its rows
    return cwd / "results/torch/veteran_d4rl_mujoco_MCSS/halfcheetah-medium-v2"


def test_port_veteran_ev_stage_under_torchrun_matches_one_process(tmp_path, monkeypatch):
    """Veteran's expected-value stage, a TD stage on its own dataset, under
    `torchrun --nproc-per-node 2 ... n_devices=2`: the TD dataset is placed
    on the mesh (each rank steps on its 128 rows of the 256), rank 0 writes
    the one checkpoint and train.jsonl, and the logs and the EV net equal
    the one-process run's."""
    import json

    import torch

    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2"]
    run2 = _run_veteran_ev(tmp_path / "two", torchrun, "n_devices=2")
    # the one-process run in this process
    from cleandiffuser_tpu_torch.cli import veteran_d4rl_mujoco as cli

    (tmp_path / "one").mkdir()
    monkeypatch.chdir(tmp_path / "one")
    monkeypatch.setattr(cli, "EV_GRADIENT_STEPS", 4)
    cli.pipeline(cli.load_config(cli.CONFIG_DIR, "mujoco", VETERAN_ARGS))
    run1 = run2.relative_to(tmp_path / "two")
    assert sorted(p.name for p in run2.iterdir()) == sorted(p.name for p in run1.iterdir()) == [
        "config.json", "train.jsonl", "veteran_latest.pkl"]
    two = [json.loads(line) for line in (run2 / "train.jsonl").read_text().splitlines()]
    one = [json.loads(line) for line in (run1 / "train.jsonl").read_text().splitlines()]
    assert [lg["gradient_steps"] for lg in two] == [lg["gradient_steps"] for lg in one] == [2, 4]
    for a, b in zip(two, one):
        _logs_close({k: a[k] for k in ("loss_v", "v_mean")},
                    {k: b[k] for k in ("loss_v", "v_mean")})
    ev2 = torch.load(run2 / "veteran_latest.pkl", weights_only=True)["ev"]["params"]
    ev1 = torch.load(run1 / "veteran_latest.pkl", weights_only=True)["ev"]["params"]
    assert set(ev2) == set(ev1)
    for k in ev1:
        _close(ev2[k], ev1[k])

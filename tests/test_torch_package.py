"""Structure of the PyTorch port: what it imports, that it has no CPU path
for the GPU smoke run, and that it reads the shared config tree."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cleandiffuser_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "cleandiffuser_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """Read from the sources: the interpreter may have imported jax before
    any test runs, so sys.modules cannot tell."""
    assert not FORBIDDEN & set(_imported_roots(path))


def _run_chip_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    """No CUDA device here: the smoke run must fail, and print no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """Alone in a directory, without the package, the smoke run fails."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("task", ["halfcheetah-medium-v2", "hopper-medium-v2"])
def test_config_matches_jax_loader(task):
    """The port reads configs/dd/ as the JAX package's loader does."""
    from cleandiffuser_tpu.utils.config import load_config as jax_load
    from cleandiffuser_tpu_torch.utils.config import load_config, parse_cli

    overrides = parse_cli([f"task={task}", "num_envs=7", "--flag", "+extra=1"])
    want = jax_load(ROOT / "configs/dd/mujoco", "mujoco", overrides).to_dict()
    got = load_config(ROOT / "configs/dd/mujoco", "mujoco", overrides).to_dict()
    assert got == want
    assert got["task"]["env_name"] == task and got["num_envs"] == 7 and got["extra"] == 1

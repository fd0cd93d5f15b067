"""Structure of the PyTorch port: what it imports, that it has no CPU path
for the GPU smoke run, and that it reads the shared config tree."""

import ast
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cleandiffuser_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "cleandiffuser_tpu"}
# the port's sources and the scripts that drive it on the card
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "film_bf16_compare.py", ROOT / "tools/dit_block_variants.py",
    ROOT / "tools/profile_dd_plan.py", ROOT / "tools/profile_train_step.py",
    ROOT / "tools/bf16_dd_plan_compare.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """Read from the sources: the interpreter may have imported jax before
    any test runs, so sys.modules cannot tell."""
    assert not FORBIDDEN & set(_imported_roots(path))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_triton_only_inside_functions(path):
    """Triton is imported where a kernel is launched, never at a module's
    top level: the CPU has no triton, and the tests import every module."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                node.module or ""]
            assert not any(n.split(".")[0] == "triton" for n in names)


def test_cpu_plans_import_no_triton():
    """A Diffuser plan on the CPU with every kernel switch on (fused
    blocks, fused solver update) takes the plain versions and never imports
    triton; a fresh interpreter, so that nothing else imported it first."""
    code = (
        "import sys, numpy as np, torch\n"
        "from cleandiffuser_tpu_torch.pipelines import DDPipeline, DiffuserPipeline\n"
        "p = DiffuserPipeline(5, 3, horizon=8, model_dim=16, dim_mult=(1, 2), sampling_steps=2,"
        " use_pallas_block=True, fused_update=True,"
        " device='cpu')\n"
        "a, _ = p.act(np.zeros((2, 5), np.float32), num_candidates=2)\n"
        "assert a.shape == (2, 3)\n"
        "assert 'triton' not in sys.modules, 'triton imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", ["DDPipeline", "DiffuserPipeline"])
def test_entry_points_default_to_the_gpu(name):
    """Without a CUDA device, an entry point built without `device` raises
    and says how to ask for the CPU; with device="cpu" it builds there. It
    never falls back to the CPU by itself."""
    import torch

    from cleandiffuser_tpu_torch import pipelines

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cls = getattr(pipelines, name)
    kw = dict(obs_dim=5, act_dim=3, horizon=8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cls(**kw)
    assert cls(**kw, device="cpu").device == torch.device("cpu")


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


def _load_script(path: str):
    spec = importlib.util.spec_from_file_location(Path(path).stem, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


DIT_BLOCK_VARIANTS = _load_script("tools/dit_block_variants.py")
FILM_BF16_COMPARE = _load_script("film_bf16_compare.py")


@pytest.mark.parametrize("variant", sorted(DIT_BLOCK_VARIANTS.VARIANTS))
def test_dit_block_variant_applies_to_the_kernel_source(variant):
    """The variants tool edits csrc/dit_block.cu by exact text: each edit of
    a variant must find its text once in the kernel as it stands."""
    src = (PORT / "csrc" / "dit_block.cu").read_text()
    for old, _ in DIT_BLOCK_VARIANTS.VARIANTS[variant]:
        assert src.count(old) == 1, old


@pytest.mark.parametrize("variant", sorted(FILM_BF16_COMPARE.VARIANTS))
def test_film_bf16_variant_applies_to_the_kernel_source(variant):
    """film_bf16_compare.py edits csrc/film_resblock_bf16.cu by exact text:
    each edit of a variant must find its text once in the kernel as it
    stands."""
    src = (PORT / FILM_BF16_COMPARE.SOURCE).read_text()
    for old, _ in FILM_BF16_COMPARE.VARIANTS[variant]:
        assert src.count(old) == 1, old


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

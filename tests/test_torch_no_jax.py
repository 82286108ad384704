"""The port imports torch and numpy, never JAX or the JAX package, nor PIL
or PyYAML, which the card's machine does not have: an AST scan of every
module of omnidata_tpu_torch and of the scripts that drive it on the card."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "omnidata_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_annotator.py",
    ROOT / "tools" / "raster_measure.py", ROOT / "tools" / "loader_rate.py",
    ROOT / "tests" / "_torch_dist_worker.py"]
_BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "omnidata_tpu", "PIL", "yaml")


def banned_imports(source: str) -> list[str]:
    """Absolute imports of JAX-family modules or of omnidata_tpu(.*); the
    port's own package name only shares a prefix and is allowed."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in _BANNED]
    return found


def test_scan_catches_banned_and_allows_the_port():
    assert banned_imports("import jax.numpy as jnp") == ["jax.numpy"]
    assert banned_imports("from omnidata_tpu.mesh import raster") == [
        "omnidata_tpu.mesh"]
    assert banned_imports("import omnidata_tpu") == ["omnidata_tpu"]
    assert banned_imports("def f():\n    from jax import lax") == ["jax"]
    assert banned_imports("from PIL import Image\nimport yaml") == ["PIL", "yaml"]
    assert banned_imports(
        "import omnidata_tpu_torch\nfrom omnidata_tpu_torch.mesh import raster\n"
        "from .core import cameras\nimport torch") == []


def test_port_files_exist():
    assert len(PORT_FILES) >= 15
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    assert banned_imports(path.read_text()) == []


EVAL_MULTITASK_MODULES = (
    "omnidata_tpu_torch.eval_depth", "omnidata_tpu_torch.eval_normal",
    "omnidata_tpu_torch.train_multitask", "omnidata_tpu_torch.train.metrics",
    "omnidata_tpu_torch.models.tta", "omnidata_tpu_torch.models.attention_blocks",
    "omnidata_tpu_torch.models.multitask", "omnidata_tpu_torch.models.hrnet",
    "omnidata_tpu_torch.data.external_eval")


MIDAS_REFOCUS_MODULES = (
    "omnidata_tpu_torch.models.midas_full", "omnidata_tpu_torch.models.midas_net",
    "omnidata_tpu_torch.models.midas_transforms", "omnidata_tpu_torch.augment.refocus",
    "omnidata_tpu_torch.demo_refocus")


def _import_with_jax_blocked(modules) -> None:
    """Import modules in a fresh interpreter where importing jax, flax,
    optax, omnidata_tpu, PIL, yaml or h5py fails."""
    import subprocess
    import sys

    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'omnidata_tpu', 'PIL', 'yaml', 'h5py'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_eval_and_multitask_modules_import_with_jax_blocked():
    _import_with_jax_blocked(EVAL_MULTITASK_MODULES)


def test_midas_and_refocus_modules_import_with_jax_blocked():
    _import_with_jax_blocked(MIDAS_REFOCUS_MODULES)


MULTI_DEVICE_MODULES = (
    "omnidata_tpu_torch.train.parallel", "omnidata_tpu_torch.train.multihost",
    "omnidata_tpu_torch.utils.collectives", "omnidata_tpu_torch.graft_entry",
    "omnidata_tpu_torch.train_depth", "omnidata_tpu_torch.train_normal")


def test_multi_device_modules_import_with_jax_blocked():
    """train/parallel, train/multihost, graft_entry and the sharded trainers
    (and the tests' rank worker, by path)."""
    _import_with_jax_blocked(MULTI_DEVICE_MODULES)
    import subprocess
    import sys

    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'omnidata_tpu', 'PIL', 'yaml', 'h5py'):\n"
            "    sys.modules[m] = None\n"
            "sys.path.insert(0, 'tests')\n"
            "import _torch_dist_worker\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]

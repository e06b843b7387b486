"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

`mxnet_tpu_torch` and `chip_smoke.py` run on a machine that has PyTorch
and CUDA but no JAX, so every module of the package must import with
`jax` (and `mxnet_tpu`) blocked, and no source may name either in an
import.  `chip_smoke.py` must refuse, with a non-zero exit and no result
on stdout, where there is no card or no package beside it.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "mxnet_tpu_torch"
SMOKE = REPO / "chip_smoke.py"
BANNED = ("jax", "jaxlib", "mxnet_tpu")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in %r:\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil\n"
        "import mxnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    mxnet_tpu_torch.__path__, 'mxnet_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(' '.join(sorted(names)))\n" % (BANNED,))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=_env())
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for mod in ("serving.engine", "serving.decode", "serving.sampling",
                "serving.paged", "ops.attention",
                "ops.pallas_kernels.layer_norm",
                "ops.pallas_kernels.flash_attention",
                "ops.pallas_kernels._build", "base", "name", "attribute",
                "ops.registry", "ops.nn", "ops.tensor", "ops.elementwise",
                "ops.loss", "symbol", "models", "models.transformer",
                "executor", "random", "initializer", "parallel",
                "parallel.trainer"):
        assert "mxnet_tpu_torch." + mod in names


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [SMOKE]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), mod) for f in files
           for mod in _imported(f)
           if mod.split(".")[0] in BANNED]
    assert bad == []


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(SMOKE)], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=_env(CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    shutil.copy(SMOKE, tmp_path / SMOKE.name)
    out = subprocess.run([sys.executable, SMOKE.name], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=_env(CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""

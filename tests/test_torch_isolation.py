"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

`mxnet_tpu_torch` and `chip_smoke.py` run on a machine that has PyTorch
and CUDA but no JAX, so every module of the package must import with
`jax` (and `mxnet_tpu`) blocked, and no source may name either in an
import.  The port's C++ runtime is its own copy too: every header its
sources include is beside them in `mxnet_tpu_torch/native/`, and the
library the port loads is built from there, never `native/`'s.  `chip_smoke.py` must refuse, with a non-zero exit and no result
on stdout, where there is no card or no package beside it.
"""
import ast
import os
import re
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
                "parallel.trainer", "context", "ndarray", "lr_scheduler",
                "optimizer", "kvstore", "io", "metric", "callback",
                "executor_manager", "checkpoint", "model", "models.mlp",
                "_native", "engine", "recordio", "image"):
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


def test_native_sources_include_only_their_own_headers():
    sources = sorted((PKG / "native").glob("*.cc")) + \
        sorted((PKG / "native").glob("*.h"))
    assert {p.name for p in sources} >= {
        "engine.cc", "recordio.cc", "loader.cc", "optimizer.cc",
        "im2rec.cc", "mxtpu.h", "error.h", "jpeg_err.h"}
    for src in sources:
        for line in src.read_text().splitlines():
            m = re.match(r'\s*#\s*include\s*"([^"]+)"', line)
            if m:
                assert (PKG / "native" / m.group(1)).is_file(), (src, line)
                assert "/" not in m.group(1), (src, line)


def test_the_port_loads_no_library_from_the_jax_packages_native_dir():
    for path in sorted(PKG.rglob("*.py")):
        text = path.read_text()
        assert "libmxtpu.so" not in text, path
        assert not re.search(r"['\"]\.\.['\"]\s*,\s*['\"]native", text), path
    code = (
        "import sys\n"
        "for name in %r:\n"
        "    sys.modules[name] = None\n"
        "from mxnet_tpu_torch import _native, engine\n"
        "e = engine.NativeEngine(num_workers=1)\n"
        "e.push_sync(lambda: None)\n"
        "print(_native.build_info['path'])\n"
        "print(open('/proc/self/maps').read())\n" % (BANNED,))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=_env())
    assert out.returncode == 0, out.stderr
    lib, maps = out.stdout.split("\n", 1)
    assert Path(lib).parent == PKG / "_build"
    assert lib in maps
    assert str(REPO / "native") + "/" not in maps


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

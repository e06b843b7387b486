"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``mxnet_tpu_torch/csrc/<name>.cu`` compiles on its own, with nvcc,
into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>_<hash>.so <name>.cu

No source includes PyTorch's headers, so a build takes seconds, not the
minutes `torch.utils.cpp_extension.load` needs; the tensor-core sources
share ``csrc/*.cuh`` (``wgmma.cuh``, and ``tf32.cuh`` for float32).  The library's file name carries a hash of the
source, the headers and the flags: a changed source or header builds
anew, an unchanged one loads the library already built.  Libraries and
nvcc's logs (ptxas prints each kernel's registers and shared memory
there) go to ``mxnet_tpu_torch/_build/``, which git ignores.

Every C entry takes pointers and the stream as ``void*``, allocates
nothing, launches on the stream it is given and returns
``cudaGetLastError()``; `check` turns a non-zero code into an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ...base import MXNetError

__all__ = ["KERNELS", "build", "build_log", "load", "check",
           "check_current_device"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("layer_norm", "flash_attention_fwd", "flash_attention_fwd_f32",
           "flash_attention_bwd", "flash_attention_bwd_f32", "fused_ce_f32",
           "fused_ce_bf16")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise MXNetError("nvcc not found: the port's CUDA kernels build at "
                         "first use and need the CUDA toolkit")
    return path


def _target(name):
    src = CSRC / ("%s.cu" % name)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / ("lib%s_%s.so" % (name, digest[:16]))


def build(names=KERNELS):
    """Compile every source in ``names`` whose library is missing, one nvcc
    per source, all started together.  Returns ``{name: seconds}`` (0.0
    for a library already built).  Raises `MXNetError` with the end of
    nvcc's log when a build fails; a missing source fails the same way,
    after the other sources have built."""
    BUILD_DIR.mkdir(exist_ok=True)
    todo, took, failed = {}, {}, []
    for name in names:
        if not (CSRC / ("%s.cu" % name)).exists():
            (BUILD_DIR / ("%s.log" % name)).write_text(
                "source %s not found\n" % (CSRC / ("%s.cu" % name)))
            failed.append(name)
            continue
        src, lib = _target(name)
        if lib.exists():
            took[name] = 0.0
            continue
        tmp = lib.with_name("%s.%d.tmp" % (lib.name, os.getpid()))
        log = open(BUILD_DIR / ("%s.log" % name), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        todo[name] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT),
                      log, tmp, lib, time.perf_counter())
    for name, (proc, log, tmp, lib, t0) in todo.items():
        rc = proc.wait()
        log.close()
        took[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
    if failed:
        tails = ["%s:\n%s" % (n, build_log(n)[-3000:]) for n in failed]
        raise MXNetError("nvcc failed for %s\n%s" % (failed,
                                                     "\n".join(tails)))
    return took


def build_log(name):
    """nvcc's output for the last build of ``name`` ('' if none)."""
    path = BUILD_DIR / ("%s.log" % name)
    return path.read_text() if path.exists() else ""


def load(name):
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)[1]))
            _libs[name] = lib
        return lib


def check_current_device(device, what):
    """Raise unless ``device`` is the current CUDA device: a C entry
    launches on the current device, with the stream of ``device``."""
    current = torch.cuda.current_device()
    if device.index != current:
        raise MXNetError("%s: tensors on %s but the current device is "
                         "cuda:%d; launch under torch.cuda.device(%s)"
                         % (what, device, current, device))


def check(err, what):
    """Raise when a C entry returned a CUDA error code."""
    if err:
        raise MXNetError("%s: CUDA error %d (%s)" % (
            what, err, _cuda_error_name(err)))


def _cuda_error_name(err):
    # every source exports the same mxt_error_string
    lib = next(iter(_libs.values()), None)
    if lib is None:
        return "unknown"
    fn = lib.mxt_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()

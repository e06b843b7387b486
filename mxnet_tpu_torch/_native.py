"""ctypes binding of the port's native runtime (`native/` beside this file).

A port of `mxnet_tpu/_native.py`.  The reference exposed its C++ core
through a C ABI consumed by ctypes (`python/mxnet/base.py`); this module
is the same boundary for the host side of the runtime: the dependency
engine (`engine.cc`), recordio (`recordio.cc`), the threaded batch
loader (`loader.cc`), the native SGD (`optimizer.cc`) and the im2rec
packer (`im2rec.cc`).  The library is framework-free C++ and the port
keeps its own copy of the sources.

It builds at first use, never at import: `lib` compiles the five
sources in parallel with

    g++ -O2 -std=c++17 -fPIC -Wall -Wextra -pthread [-DMXTPU_HAVE_JPEG] -c
    g++ -shared -pthread -o libmxtpu_<hash>.so *.o [-ljpeg]

into ``mxnet_tpu_torch/_build/`` (git ignores it), named by a hash of the
sources, the headers, the compiler, the flags and whether libjpeg was
found; a file lock serializes processes that build at once.  JPEG decode
and the im2rec packer are compiled in only where a probe program that
includes ``jpeglib.h`` and links ``-ljpeg`` builds (`has_jpeg`).

Deliberate difference: the JAX loader leaves ``LIB`` None when the build
fails and its callers quietly take the pure-Python path.  Here a failed
build raises `MXNetError` with the compiler's output, and the Python
readers run only where a caller asks for them (``use_native=False``).
``MXNET_TPU_NATIVE_LIB``, when set, names a library built from these
sources to load instead; it raises if that file is missing.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .base import MXNetError

__all__ = ["lib", "build", "available", "has_jpeg", "has_sgd",
           "has_sgd_state", "has_u8_loader", "sgd_export_state",
           "sgd_import_state", "last_error", "check"]

_FN_T = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("engine.cc", "recordio.cc", "loader.cc", "optimizer.cc",
           "im2rec.cc")
CXX = "g++"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")
LDFLAGS = ("-shared", "-pthread")
_JPEG_PROBE = (b"#include <cstdio>\n#include <jpeglib.h>\n"
               b"int main() { jpeg_error_mgr e; jpeg_std_error(&e); }\n")

_lock = threading.Lock()
_LIB = None
build_info = None  # what `build` did: seconds, jpeg, path, built


def _run(cmd, what):
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise MXNetError("native library build failed (%s): %s\n%s"
                         % (what, " ".join(map(str, cmd)),
                            (out.stdout + out.stderr)[-3000:]))


def _probe_jpeg():
    """True where a program including jpeglib.h links with -ljpeg."""
    exe = BUILD_DIR / ("jpeg_probe.%d" % os.getpid())
    try:
        out = subprocess.run([CXX, "-x", "c++", "-", "-o", str(exe),
                              "-ljpeg"], input=_JPEG_PROBE,
                             capture_output=True)
    except OSError as e:
        raise MXNetError("native library build failed: cannot run the "
                         "compiler %r: %s" % (CXX, e))
    exe.unlink(missing_ok=True)
    return out.returncode == 0


def _target(jpeg):
    digest = hashlib.sha256()
    for path in sorted(SRC_DIR.iterdir()):
        if path.suffix in (".cc", ".h"):
            digest.update(path.name.encode() + path.read_bytes())
    digest.update(repr((CXX, CXXFLAGS, LDFLAGS, jpeg)).encode())
    return BUILD_DIR / ("libmxtpu_%s.so" % digest.hexdigest()[:16])


def build():
    """Build the library unless a build of these sources is there.
    Returns (and keeps in `build_info`) ``{"seconds", "jpeg", "path",
    "built"}``; raises `MXNetError` with the compiler's output when a
    step fails."""
    global build_info
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # the first builds, the rest wait
        jpeg = _probe_jpeg()
        target = _target(jpeg)
        built = not target.exists()
        if built:
            tag = "%s.%d" % (target.stem, os.getpid())
            flags = list(CXXFLAGS) + (["-DMXTPU_HAVE_JPEG"] if jpeg else [])
            objs = [BUILD_DIR / ("%s.%s.o" % (tag, Path(s).stem))
                    for s in SOURCES]
            with ThreadPoolExecutor(len(SOURCES)) as pool:
                for job in [pool.submit(_run, [CXX, *flags, "-c",
                                               str(SRC_DIR / s), "-o",
                                               str(o)], s)
                            for s, o in zip(SOURCES, objs)]:
                    job.result()
            tmp = BUILD_DIR / (tag + ".so.tmp")
            _run([CXX, *LDFLAGS, "-o", str(tmp), *map(str, objs)]
                 + (["-ljpeg"] if jpeg else []), "link")
            os.replace(tmp, target)
            for o in objs:
                o.unlink()
    build_info = {"seconds": time.perf_counter() - t0, "jpeg": jpeg,
                  "path": str(target), "built": built}
    return build_info


def lib():
    """The loaded library, built first if needed."""
    global _LIB
    with _lock:
        if _LIB is None:
            path = os.environ.get("MXNET_TPU_NATIVE_LIB")
            if path:
                if not os.path.exists(path):
                    raise MXNetError("MXNET_TPU_NATIVE_LIB names %r, which "
                                     "does not exist" % path)
            else:
                path = build()["path"]
            _LIB = _bind(ctypes.CDLL(path))
        return _LIB


def __getattr__(name):
    # ``_native.LIB``, as the JAX module names it, builds on first use
    if name == "LIB":
        return lib()
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def _bind(lib):
    H = ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    sigs = {
        "mxtpu_last_error": (ctypes.c_char_p, []),
        "mxtpu_has_jpeg": (ctypes.c_int, []),
        "mxtpu_engine_create": (H, [ctypes.c_int]),
        "mxtpu_engine_destroy": (None, [H]),
        "mxtpu_var_create": (H, [H]),
        "mxtpu_var_delete": (None, [H, H]),
        "mxtpu_push": (ctypes.c_int, [H, _FN_T, ctypes.c_void_p,
                                      ctypes.POINTER(H), ctypes.c_int,
                                      ctypes.POINTER(H), ctypes.c_int,
                                      ctypes.c_int]),
        "mxtpu_wait_for_var": (None, [H, H]),
        "mxtpu_wait_all": (None, [H]),
        "mxtpu_engine_num_executed": (ctypes.c_int64, [H]),
        "mxtpu_recio_writer_open": (H, [ctypes.c_char_p]),
        "mxtpu_recio_write": (ctypes.c_int, [H, ctypes.c_void_p,
                                             ctypes.c_uint64]),
        "mxtpu_recio_writer_close": (None, [H]),
        "mxtpu_recio_reader_open": (H, [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int]),
        "mxtpu_recio_read": (ctypes.c_void_p,
                             [H, ctypes.POINTER(ctypes.c_uint64)]),
        "mxtpu_recio_reader_seek0": (None, [H]),
        "mxtpu_recio_reader_close": (None, [H]),
        "mxtpu_loader_open": (H, [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_uint64, ctypes.c_int,
                                  ctypes.c_int]),
        "mxtpu_loader_next": (ctypes.c_int, [H, fp, fp]),
        "mxtpu_loader_open_u8": (H, [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_uint64, ctypes.c_int,
                                     ctypes.c_int]),
        "mxtpu_loader_next_u8": (ctypes.c_int,
                                 [H, ctypes.POINTER(ctypes.c_uint8), fp]),
        "mxtpu_loader_last_failed": (ctypes.c_int, [H]),
        "mxtpu_loader_reset": (None, [H]),
        "mxtpu_loader_close": (None, [H]),
        "mxtpu_im2rec_pack": (ctypes.c_int64, [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64)]),
        "mxtpu_sgd_create": (H, [ctypes.c_float] * 5 + [ctypes.c_int]),
        "mxtpu_sgd_set_lr": (None, [H, ctypes.c_float]),
        "mxtpu_sgd_update": (ctypes.c_int, [H, ctypes.c_int, fp, fp,
                                            ctypes.c_int64]),
        "mxtpu_sgd_destroy": (None, [H]),
        "mxtpu_sgd_keys": (ctypes.c_int64, [H, ctypes.POINTER(ctypes.c_int),
                                            ctypes.c_int64]),
        "mxtpu_sgd_state_size": (ctypes.c_int64, [H, ctypes.c_int]),
        "mxtpu_sgd_get_state": (ctypes.c_int, [H, ctypes.c_int, fp,
                                               ctypes.c_int64]),
        "mxtpu_sgd_set_state": (ctypes.c_int, [H, ctypes.c_int, fp,
                                               ctypes.c_int64]),
    }
    for name, (restype, argtypes) in sigs.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise MXNetError("native library %s lacks %s: it was not built "
                             "from mxnet_tpu_torch/native" % (lib._name, name))
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    """True once the library is loaded; builds it first if needed (a failed
    build raises rather than answer False)."""
    return lib() is not None


def has_jpeg() -> bool:
    """Whether this build decodes and encodes JPEG (libjpeg found)."""
    return bool(lib().mxtpu_has_jpeg())


def has_sgd() -> bool:
    return hasattr(lib(), "mxtpu_sgd_create")


def has_sgd_state() -> bool:
    """Momentum export/import (snapshot-capturable native SGD)."""
    return hasattr(lib(), "mxtpu_sgd_get_state")


def has_u8_loader() -> bool:
    return hasattr(lib(), "mxtpu_loader_open_u8")


def sgd_export_state(handle):
    """{key_id: np.float32 momentum table} of a native SGD handle."""
    L = lib()
    n = L.mxtpu_sgd_keys(handle, None, 0)
    check(n >= 0, "sgd_keys")
    if n == 0:
        return {}
    ids = (ctypes.c_int * n)()
    check(L.mxtpu_sgd_keys(handle, ids, n) == n, "sgd_keys")
    out = {}
    fp = ctypes.POINTER(ctypes.c_float)
    for kid in list(ids):
        size = L.mxtpu_sgd_state_size(handle, kid)
        check(size >= 0, "sgd_state_size")
        buf = np.empty(size, np.float32)
        check(L.mxtpu_sgd_get_state(handle, kid, buf.ctypes.data_as(fp),
                                    size) == 0, "sgd_get_state")
        out[int(kid)] = buf
    return out


def sgd_import_state(handle, states):
    """Install {key_id: float32 array} momentum tables into a handle."""
    L = lib()
    fp = ctypes.POINTER(ctypes.c_float)
    for kid, arr in states.items():
        a = np.ascontiguousarray(arr, np.float32)
        check(L.mxtpu_sgd_set_state(handle, int(kid),
                                    a.ctypes.data_as(fp), a.size) == 0,
              "sgd_set_state")


def last_error() -> str:
    return lib().mxtpu_last_error().decode("utf-8", "replace")


def check(cond, ctx=""):
    if not cond:
        raise MXNetError("native runtime error%s: %s"
                         % ((" (%s)" % ctx) if ctx else "", last_error()))

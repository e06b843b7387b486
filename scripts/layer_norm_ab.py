#!/usr/bin/env python3
"""Time the LayerNorm kernels against the variants their design weighed,
on one card, in turns, beside two copy yardsticks.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 scripts/layer_norm_ab.py

At the training shape (32768, 768), in bf16 and float32, it holds every
build against the source's and times the forward and the backward with
CUDA events (`chip_smoke.py`'s `time_ms`: inputs warm in L2) and the
backward's row kernel alone (the profiler), in turns (A B C D, D C B A):

* ``kernel``: `csrc/layer_norm.cu` as the port builds it;
* ``three_blocks``: the backward at three blocks an SM, gamma loaded from
  L1 for every row (ptxas's 80 registers leave spills);
* ``f32_two_blocks``: the float32 backward at two blocks an SM (128
  registers, with spills) instead of one;
* ``gamma_early``: the forward loading gamma and beta with x at every
  width, not only where a thread holds 8 elements or fewer;

beside two yardsticks that move the same bytes with no arithmetic:
``torch.add(x, dy, out=z)`` (the backward's two reads and a write) and
``z.copy_(x)`` (the forward's read and write), and the bytes bound.

The variants are not in the port: the script makes each from the
kernel's source by the edits in `VARIANTS` (each must match as often as
stated, so a source that has drifted fails here, not in silence) and
builds it with the port's nvcc flags under ``mxnet_tpu_torch/_build/``.
Every variant must give the source's y, mean, rstd and dx bit for bit,
and its dgamma and dbeta (summed over another split where the blocks an
SM differ) within `chip_smoke.py`'s ``REL_TOL``.  It prints ptxas's
registers and spill bytes of the backward kernel of every build, one
JSON line per dtype and the card's name and power limit, and writes
everything to ``chiprun_out/layer_norm_ab.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (REL_TOL, bound_ms, card_state,  # noqa: E402
                        rel_check, time_ms)
from mxnet_tpu_torch.ops.pallas_kernels import _build  # noqa: E402
from mxnet_tpu_torch.ops.pallas_kernels import layer_norm as ln  # noqa: E402

ROWS, N = 32768, 768
SOURCE = "layer_norm"
_VALUE = ("  static constexpr int value =\n"
          "      VW * sizeof(T) < 16 ? 1 : (fit < 2 ? fit : 2);")
# the edits of the kernel's source that make each variant: (old, new,
# times it must match)
VARIANTS = {
    "kernel": [],
    "three_blocks": [
        ("  static constexpr int fit = 256 / (EPT * int(sizeof(T)) * 5 / 4 "
         "+ 40);",
         "  static constexpr int fit = 256 / (EPT * int(sizeof(T)) + 32);",
         1),
        (_VALUE, "  static constexpr int value =\n"
         "      VW * sizeof(T) < 16 ? 1 : (fit < 3 ? fit : 3);", 1),
        ("    if constexpr (kFull) {\n      to_floats<T, VW>(gw[c], g);",
         "    if constexpr (kFull) {\n      load_vec<T, VW>(gamma + i, g);",
         1)],
    "f32_two_blocks": [
        (_VALUE, "  static constexpr int value =\n"
         "      sizeof(T) == 4 ? 2 : (fit < 2 ? fit : 2);", 1)],
    "gamma_early": [("  constexpr bool kEarly = EPT <= 8;",
                     "  constexpr bool kEarly = true;", 1)],
}


def build_variants():
    """{name: loaded library}, every variant built at once."""
    src = (_build.CSRC / ("%s.cu" % SOURCE)).read_text()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new, times in edits:
            if text.count(old) != times:
                raise SystemExit("variant %s: %r matches %d times, not %d"
                                 % (name, old[:60], text.count(old), times))
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / ("ab_%s_%s.cu" % (SOURCE, name))
        cu.write_text(text)
        lib = _build.BUILD_DIR / ("libab_%s_%s.so" % (SOURCE, name))
        log = open(_build.BUILD_DIR / ("ab_%s_%s.log" % (SOURCE, name)), "w")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=log, stderr=subprocess.STDOUT), log, lib)
    libs = {}
    for name, (proc, log, lib) in procs.items():
        rc = proc.wait()
        log.close()
        if rc:
            raise SystemExit("nvcc failed for %s:\n%s" % (name, Path(
                log.name).read_text()[-3000:]))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def ptxas_bwd(name, dtype):
    """Registers and spill bytes of the backward row kernel that runs the
    training shape in ``name``'s build, from its log."""
    tag = ("ln_bwd_kernelIfLi4ELi24EE" if dtype == torch.float32
           else "ln_bwd_kernelI13__nv_bfloat16Li8ELi24EE")
    lines = (_build.BUILD_DIR / ("ab_%s_%s.log" % (SOURCE, name))
             ).read_text().splitlines()
    at = next(i for i, ln_ in enumerate(lines)
              if "Compiling entry" in ln_ and tag in ln_)
    return " ".join(x.strip() for x in lines[at + 1:at + 3])


def use(lib, typed):
    """Point the wrapper at ``lib`` (its entries typed as ``typed``'s, the
    port's own library), with fresh plans (its occupancy)."""
    for name in ("mxt_layer_norm_fwd", "mxt_layer_norm_bwd",
                 "mxt_layer_norm_bwd_occupancy"):
        fn, ref = getattr(lib, name), getattr(typed, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    ln._lib = lambda: lib
    ln._occupancy_cache.clear()
    ln._bwd_plan_on.cache_clear()


def row_kernel_ms(fn):
    """Device ms of the backward's row kernel in one call (profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "ln_bwd_kernel" in e.name) / 10 / 1e3


def main():
    if not torch.cuda.is_available():
        print("layer_norm_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    real_lib = ln._lib
    typed = ln._lib()  # the port's own build, its entries typed
    libs = build_variants()
    order = list(VARIANTS) + list(reversed(VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card, "shape": [ROWS, N], "dtypes": {}}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(ROWS, N, device="cuda", generator=gen).to(dtype)
        dy = torch.randn(ROWS, N, device="cuda", generator=gen).to(dtype)
        g = (1 + 0.1 * torch.randn(N, device="cuda", generator=gen)
             ).to(dtype)
        b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dtype)
        z = torch.empty_like(x)
        isz = x.element_size()
        res = {"bound_fwd_ms": bound_ms(2 * ROWS * N * isz + 2 * N * isz
                                        + 8 * ROWS, 8 * ROWS * N, dtype)[0],
               "bound_bwd_ms": bound_ms(3 * ROWS * N * isz + 3 * N * isz
                                        + 8 * ROWS, 13 * ROWS * N, dtype)[0],
               "add_ms": time_ms(lambda: torch.add(x, dy, out=z)),
               "copy_ms": time_ms(lambda: z.copy_(x)), "variants": {}}
        use(libs["kernel"], typed)
        y, mean, rstd = ln.layer_norm_fwd(x, g, b, 1e-5)
        want = (y, mean, rstd) + ln.layer_norm_bwd(x, g, mean, rstd, dy)
        for name in order:
            use(libs[name], typed)
            fwd = lambda: ln.layer_norm_fwd(x, g, b, 1e-5)  # noqa: E731
            bwd = lambda: ln.layer_norm_bwd(x, g, mean, rstd, dy)  # noqa
            got = fwd() + bwd()
            torch.cuda.synchronize()
            # y, mean, rstd and dx do not depend on the grid; dgamma and
            # dbeta are summed over another split where the blocks an SM
            # differ, and are held to chip_smoke.py's REL_TOL
            rec = res["variants"].setdefault(name, {
                "same_bits": all(torch.equal(a, c)
                                 for a, c in zip(got[:4], want[:4])),
                "dgamma_dbeta_rel_err": rel_check(
                    dtype, list(zip(got[4:], want[4:])))[1],
                "bwd_blocks": ln._bwd_plan_on(
                    ROWS, N, dtype, 16, x.device.index).blocks,
                "ptxas_bwd": ptxas_bwd(name, dtype),
                "fwd_ms": [], "bwd_ms": [], "bwd_row_kernel_ms": []})
            rec["fwd_ms"].append(time_ms(fwd))
            rec["bwd_ms"].append(time_ms(bwd))
            rec["bwd_row_kernel_ms"].append(row_kernel_ms(bwd))
        ln._lib = real_lib
        ln._occupancy_cache.clear()
        ln._bwd_plan_on.cache_clear()
        out["dtypes"][str(dtype)] = res
        print(json.dumps({"dtype": str(dtype), **res}), flush=True)
        del x, dy, z, y, mean, rstd, want
        torch.cuda.empty_cache()
    out["card_after"] = card_state()
    bad = [(d, n) for d, r in out["dtypes"].items()
           for n, v in r["variants"].items() if not v["same_bits"]
           or v["dgamma_dbeta_rel_err"] > REL_TOL[getattr(torch, d[6:])]]
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/layer_norm_ab.json").write_text(
        json.dumps(out, indent=1))
    print(card, flush=True)
    if bad:
        print("layer_norm_ab: variants that changed the result: %s" % bad,
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

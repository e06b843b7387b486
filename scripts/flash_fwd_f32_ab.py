#!/usr/bin/env python3
"""Time the float32 flash-attention forward's kernel against the variants
its design weighed, on one card, in turns.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 scripts/flash_fwd_f32_ab.py [--parent DIR]

At each float32 forward shape of `chip_smoke.py`'s kernels line (rows 3,
5, 7 and 9 at their training shapes, causal, and row 3 at the serving
shape), it holds every kernel against the plain version (max |err| over
max |ref| of out and of lse, and the same bits twice) and times them with
CUDA events in turns (A B C, C B A, twice):

* ``kernel``: `mxt_flash_attention_fwd_f32` as the port builds it
  (`csrc/flash_attention_fwd_f32.cu`, two warpgroups a block);
* ``alt``: the same source with one warpgroup a block, the alternative
  the kernel's design rejects;
* ``parent`` (with ``--parent DIR``): the entry `mxt_flash_attention_fwd`
  (the same arguments) of ``DIR/mxnet_tpu_torch/csrc/flash_attention.cu``,
  the CUDA-core float32 forward of an earlier checkout;

beside SDPA's float32 time (`F.scaled_dot_product_attention`, TF32 off),
the 3xTF32 and CUDA-core bounds, the warpgroups and blocks an SM of the
kernel and its alternative, and the time of two probes: the kernel
without its softmax (p = s), and without the split of every key tile
after the first.  Their results are not the function's; the time each
saves is that phase's share.

``alt`` and the probes are not in the port: the script makes each from the
kernel's source by the edits in `VARIANTS` (each must match exactly once,
so a source that has drifted fails here, not in silence) and builds it
with the port's nvcc flags beside the port's libraries.  It prints
ptxas's registers and spill bytes of every build, one JSON line per shape
and the card's name and power limit, and writes everything to
``chiprun_out/flash_fwd_f32_ab.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (PEAK_FLOPS, PEAK_TF32, bound_ms,  # noqa: E402
                        card_state, ptxas_info, time_ms, visible_pairs)
from mxnet_tpu_torch.ops.pallas_kernels import _build  # noqa: E402
from mxnet_tpu_torch.ops.pallas_kernels import flash_attention as tfa  # noqa: E402

# (row, route, batch, heads, seq, head_dim): the kernels line's float32
# forward shapes, causal
SHAPES = [("3 serving", "hsd", 1, 12, 1024, 64),
          ("3", "hsd", 32, 12, 1024, 64),
          ("7", "bsd", 32, 6, 1024, 128),
          ("5", "ds", 8, 6, 4096, 128),
          ("9", "stream", 4, 6, 8192, 128)]

SOURCE = "flash_attention_fwd_f32"
_SOFTMAX = ("    // scores in the log2 domain",
            "    // this tile's P V in a fresh accumulator")
_SPLIT = ("    split_tile<D, kKeys, SC, false, NT>(kr,",
          "    split_tile<D, kKeys, SC, true, NT, false>(vr,")
# the edits of the kernel's source that make each variant: (old, new), or
# (first line, line after, new) to replace a span of lines
VARIANTS = {
    "kernel": [],
    "alt": [("constexpr int kWarpgroups = 2;",
             "constexpr int kWarpgroups = 1;"),
            ("__launch_bounds__(NT, 1)", "__launch_bounds__(NT, 2)")],
    "no_softmax": [(*_SOFTMAX, "    float corr[2] = {1.f, 1.f};\n\n")],
    "no_split": [(line, "    if (kb == 0)" + line[3:]) for line in _SPLIT],
}
# appended to every variant: its warpgroups a block and the blocks an SM
# holds at once, at head_dim in layout
OCCUPANCY = r"""
namespace {
template <int D, bool SC>
int ab_blocks(int* blocks) {
  auto kernel = flash_fwd_tf32_kernel<D, SC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, NT,
                                                      smem_bytes<D>());
  }
  return static_cast<int>(e);
}
}  // namespace

extern "C" int ab_occupancy(int head_dim, int layout, int* wgs,
                            int* blocks) {
  *wgs = kWarpgroups;
  if (head_dim == 64) {
    return layout ? ab_blocks<64, true>(blocks) : ab_blocks<64, false>(blocks);
  }
  return layout ? ab_blocks<128, true>(blocks)
                : ab_blocks<128, false>(blocks);
}
"""


def edited(src, edits):
    """``src`` with ``edits`` applied; each must match exactly once."""
    for edit in edits:
        if len(edit) == 2:
            old, new = edit
            if src.count(old) != 1:
                raise SystemExit("edit %r matches %d times" % (old,
                                                              src.count(old)))
            src = src.replace(old, new)
        else:
            first, after, new = edit
            if src.count(first) != 1 or src.count(after) != 1:
                raise SystemExit("span %r .. %r not found once" % (first,
                                                                   after))
            i, j = src.index(first), src.index(after)
            src = src[:i] + new + src[j:]
    return src


def build_variants():
    """Every variant of `VARIANTS`, built together: {name: library}."""
    src = (_build.CSRC / ("%s.cu" % SOURCE)).read_text()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        tag = "flash_fwd_f32_ab_%s" % name
        cu = _build.BUILD_DIR / ("%s.cu" % tag)
        cu.write_text(edited(src, edits) + OCCUPANCY)
        lib = _build.BUILD_DIR / ("lib%s.so" % tag)
        log = open(_build.BUILD_DIR / ("%s.log" % tag), "w")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, lib,
                       tag)
    libs = {}
    for name, (proc, log, lib, tag) in procs.items():
        rc = proc.wait()
        log.close()
        if rc:
            raise SystemExit("nvcc failed for %s:\n%s" % (
                name, _build.build_log(tag)[-3000:]))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def parent_lib(parent):
    """The parent checkout's CUDA-core forward, built with the port's
    flags into the build directory."""
    src = Path(parent) / "mxnet_tpu_torch" / "csrc" / "flash_attention.cu"
    _build.BUILD_DIR.mkdir(exist_ok=True)
    out = _build.BUILD_DIR / "libparent_flash_attention.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out)).mxt_flash_attention_fwd


def operands(route, batch, heads, seq, d, gen):
    """q, k, v as (B, H, S, D) views of (B, S, H, D) projections, and as
    the route hands them to the kernel: the same, or (B, H, D, S) copies
    on 'ds'."""
    views = [torch.randn(batch, seq, heads, d, device="cuda",
                         generator=gen).transpose(1, 2) for _ in range(3)]
    return views, [tfa._to_ds(t) if route == "ds" else t for t in views]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier checkout whose "
                    "csrc/flash_attention.cu to time beside the kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_f32_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = tfa._lib(SOURCE)
    variants = build_variants()
    ptxas = {"kernel": ptxas_info(SOURCE)}
    ptxas.update({n: ptxas_info("flash_fwd_f32_ab_%s" % n)
                  for n in VARIANTS if n != "kernel"})
    print(json.dumps({"ptxas": ptxas}), flush=True)
    types = lib.mxt_flash_attention_fwd_f32.argtypes
    fns = {n: v.mxt_flash_attention_fwd_f32 for n, v in variants.items()}
    if args.parent:
        fns["parent"] = parent_lib(args.parent)
    for fn in fns.values():
        fn.argtypes, fn.restype = types, ctypes.c_int
    for v in variants.values():
        v.ab_occupancy.argtypes = ([ctypes.c_int] * 2
                                   + [ctypes.POINTER(ctypes.c_int)] * 2)

    def shape_of(name, d, layout):
        wgs, blocks = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(variants[name].ab_occupancy(
            d, layout, ctypes.byref(wgs), ctypes.byref(blocks)), "occupancy")
        return {"warpgroups": wgs.value, "blocks_per_sm": blocks.value}

    # the port's own build is the kernel timed; its copy here is checked
    # to give the same bits
    entries = {"kernel": lib.mxt_flash_attention_fwd_f32,
               "kernel_copy": fns["kernel"], "alt": fns["alt"]}
    if args.parent:
        entries["parent"] = fns["parent"]
    probes = {"no_softmax": fns["no_softmax"], "no_split": fns["no_split"]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for row, route, batch, heads, seq, d in SHAPES:
        ds = route == "ds"
        views, (q, k, v) = operands(route, batch, heads, seq, d, gen)
        out = tfa._like(q)
        lse = torch.empty(batch, heads, seq, device="cuda")
        scale = 1.0 / math.sqrt(d)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            err = fn(0, d, int(ds), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), batch, heads, seq, seq,
                     *tfa._strides(q, k, v, out), 0, 0, 1, scale, stream)
            _build.check(err, "flash forward")

        ref = tfa._flash_fwd_plain(*views, 0, 0, scale, True)
        checks, first = {}, None
        for name, fn in entries.items():
            call(fn)
            once = (out.clone(), lse.clone())
            call(fn)
            got = out.transpose(2, 3) if ds else out
            checks[name] = {
                "out_rel_err": float((got - ref[0]).abs().max()
                                     / ref[0].abs().max()),
                "lse_rel_err": float((lse - ref[1]).abs().max()
                                     / ref[1].abs().max()),
                "bit_identical": torch.equal(once[0], out)
                and torch.equal(once[1], lse)}
            if name == "kernel":
                first = once
            elif name == "kernel_copy":
                checks[name]["same_bits_as_kernel"] = (
                    torch.equal(first[0], out) and torch.equal(first[1], lse))
        del ref, first
        timed = {n: entries[n] for n in entries if n != "kernel_copy"}
        timed.update(probes)
        samples = {name: [] for name in timed}
        order = list(timed) + list(reversed(timed))
        for name in order * 2:
            samples[name].append(time_ms(lambda: call(timed[name]), reps=9,
                                         per=3 if seq * batch > 8192 else 10))
        library = time_ms(lambda: F.scaled_dot_product_attention(
            *views, is_causal=True), reps=9, per=3)
        pairs = visible_pairs(seq, seq, True, 0, 0) * batch * heads
        nbytes = batch * heads * (4 * seq * d + seq) * 4
        rec = {
            "row": row, "route": route, "shape": [batch, heads, seq, seq, d],
            "ms": {n: statistics.median(s) for n, s in samples.items()},
            "ms_samples": samples, "library_ms": library,
            "bound_ms": bound_ms(nbytes, 3 * 4 * d * pairs, torch.float32,
                                 PEAK_TF32)[0],
            "bound_cuda_core_ms": bound_ms(nbytes, 4 * d * pairs,
                                           torch.float32)[0],
            "checks": checks,
            "block": {n: shape_of(n, d, int(ds)) for n in ("kernel", "alt")},
            "card_after": card_state()}
        # the time the kernel saves without each phase: its share
        rec["share"] = {n: 1 - rec["ms"][n] / rec["ms"]["kernel"]
                        for n in probes}
        rec["tflops"] = {n: 4 * d * pairs / (ms * 1e-3) / 1e12
                         for n, ms in rec["ms"].items()}
        rec["bound_share"] = {n: rec["bound_ms"] / ms
                              for n, ms in rec["ms"].items()}
        print(json.dumps(rec), flush=True)
        results.append(rec)
        bad = [n for n, c in checks.items() if not c["bit_identical"]
               or not c.get("same_bits_as_kernel", True)
               or max(c["out_rel_err"], c["lse_rel_err"]) > 1e-4]
        if bad:
            raise SystemExit("row %s: %s disagree with the plain version or "
                             "give other bits twice" % (row, bad))
        del views, q, k, v, out, lse
        torch.cuda.empty_cache()
    print(card, flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "flash_fwd_f32_ab.json").write_text(json.dumps(
        {"card": card, "peak_f32": PEAK_FLOPS[torch.float32],
         "ptxas": ptxas, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. print the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; build the kernels from ``mxnet_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, the
   forward kernels at the serving path's shapes and every kernel, forward
   and backward, at the training path's, with the tolerance stated beside
   each check, and time the kernel, the plain version and one PyTorch
   library call that computes the same function (a yardstick the port
   never calls) with CUDA events, beside the least time the card could
   take; the bf16 flash backward (tensor cores) is held against the plain
   backward in float32 on the same bf16 operands, must give bit-identical
   gradients twice, and reports its TFLOP/s, its share of the bound and
   ptxas's spill bytes;
3. serve 16 requests at GPT-2-small widths through the default (paged)
   `ServingEngine`, count each kernel's launches, and check the logits
   of two finished requests against the plain float32 path;
4. serve 4 long-prompt requests through the slot-cache engine, whose
   prefill runs the flash-attention kernel;
5. profile a few decode steps, and one long slot-cache prefill, to see
   where the eager loop's time goes;
6. train the GPT-2-small parity configuration of
   ``tools/benchmark_transformer.py`` (bhsd attention, bf16 compute,
   Adam) at full width for 7 steps through `SPMDTrainer`, counting each
   kernel's launches per step, timing and profiling the steps, and
   checking that the loss falls;
7. check one step's float32 gradients of the same model (batch 2) through
   the kernels against the same step through their plain versions;
8. train the transposeless configuration (6 heads of 128, 'bsd'
   attention, no biases) at full width for 3 steps;
9. hold the four fused CE kernels (stats forward, single-pass forward,
   dW/db, dx) and the 5-pass backward against their plain versions, in
   float32 and bf16, at the training head's shape (32768 tokens, 768,
   vocab 32768; timed beside `F.linear` + `F.cross_entropy`) and at a
   ragged one (1000 tokens, vocab 50257, ignored and out-of-range labels,
   no bias, grad_scale 1.7);
10. train bench.py's ``fused_`` configuration (the parity configuration
   with the fused CE head, Adam's second moment in bf16 with stochastic
   rounding) at full width for 5 steps, with exact launches per step and
   the rounding's cost; then 2 steps of the 5-pass structure
   (``MXNET_CE_SINGLE_PASS=0``) and one `SPMDTrainer.forward`, each with
   its launches; and one f32 step's gradients of the fused configuration
   through the kernels against their plain versions;
11. hold the dS route's kernels and the grid-streamed bsd route's against
   their plain versions, in float32 and bf16, at the long-context
   training shapes ((8, 6, 4096, 128) and (4, 6, 8192, 128), causal,
   timed beside SDPA) and at ragged ones with offsets and head 64, and
   check the plain pins (``MXNET_FLASH_IMPL=jnp``,
   ``MXNET_FLASH_BWD=jnp``) and a mistyped ``MXNET_FLASH_BSD_KERNEL``;
12. train `scripts/diag_round5.py`'s long-context configurations (6
   heads of 128, biases, bf16 Adam v) at full width for 5 steps each:
   S=4096 B=8 under ``MXNET_FLASH_LAYOUT=ds`` and S=8192 B=4 under
   ``MXNET_FLASH_BSD_KERNEL=stream``, with exact launches on the route's
   own counters; and one f32 step's gradients of the S=8192
   configuration at batch 1 through the kernels against their plain
   versions.

It prints each phase's seconds, a ``kernels`` JSON line (launches,
errors, times, bounds), the card's name and power limit, and as its last
line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  It writes the full
results to ``chiprun_out/chip_smoke.json``.  It exits non-zero without a
result when no CUDA device is present or the package is missing.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import attention as attention_mod
from mxnet_tpu_torch.ops import loss as loss_mod
from mxnet_tpu_torch.ops.pallas_kernels import _build
from mxnet_tpu_torch.ops.pallas_kernels import fused_ce as fce
from mxnet_tpu_torch.ops.pallas_kernels.flash_attention import (
    _delta, _flash_bwd_cuda, _flash_bwd_plain, _flash_fwd_cuda, _to_ds,
    flash_attention, flash_attention_bsd, flash_attention_bsd_plain,
    flash_attention_plain)
from mxnet_tpu_torch.ops.pallas_kernels.layer_norm import (
    _bwd_plain as layer_norm_bwd_plain, _fwd_plain as layer_norm_fwd_plain,
    layer_norm_bwd, layer_norm_fwd, layer_norm_plain)
from mxnet_tpu_torch.serving import (ServingEngine, TransformerKVModel,
                                     pool_bytes)
from mxnet_tpu_torch.serving import decode as decode_mod

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 on the
# CUDA cores, bf16 on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# GPT-2 small's published widths (vocab 50257, context 1024, 12 layers,
# 12 heads, embed 768, ffn 3072, biases on)
GPT2 = dict(vocab_size=50257, seq_len=1024, num_layers=12, num_heads=12,
            num_embed=768, num_ffn_hidden=3072, use_bias=True)

# Tolerances of the kernel checks, as (rtol, atol) on |kernel - plain|:
# * float32: kernel and plain version do the same float32 arithmetic and
#   differ only in the order of their sums (block tree vs torch reduction,
#   64-key vs 256-key softmax blocks) and in rsqrtf's last bit, a few ulp
#   (~1e-7 relative); 1e-5 leaves that 100x headroom and still catches any
#   wrong formula, mask or offset;
# * bfloat16 LayerNorm: both round the same float32 result to bf16, so an
#   element may land one bf16 ulp apart, at most 2**-7 of its value;
# * bfloat16 flash attention: the 7e-3 bar the JAX package's Pallas
#   kernels held against their jnp twins (pallas_parity).
# The bf16 flash backward (phases 2 and 11) is held to ``REL_TOL`` against
# the plain backward run in float32 on float32 copies of the same bf16
# operands and residuals: the tensor-core kernels round p and ds to bf16
# where the Pallas kernels do, the plain version does not, and the plain
# version's own bf16 output rounding (~2.8e-3 of max|ref|) would take
# most of the bar; the bf16 plain comparison is printed beside it.
TOL = {("layer_norm", torch.float32): (1e-5, 1e-5),
       ("layer_norm", torch.bfloat16): (2 ** -7, 1e-5),
       ("flash_attention", torch.float32): (1e-5, 1e-5),
       ("flash_attention", torch.bfloat16): (0.0, 7e-3)}

# Logit check of the served requests (phase 3): the engine's kernel path
# in float32 against the plain versions in float32.  The two differ only
# in summation order (LayerNorm reductions, GEMM blocking for one row vs
# many, chunked vs blockwise softmax), ~1e-6 relative per op, which 12
# layers keep far below 1e-3 on logits of magnitude ~1; bfloat16 keeps 8
# mantissa bits, so the same path in bf16 moves the logits by ~1e-2 and
# fails it (printed beside it).
LOGIT_TOL = 1e-3

# Tolerances of the training-shape checks (phase 2), as a bound on
# max |kernel - plain| over max |plain|, per output:
# * float32: the same float32 arithmetic summed in another order (over up
#   to 1024 keys or 32768 rows), ~1e-6 of the largest value; 1e-4 leaves
#   100x headroom;
# * bfloat16: the 7e-3 bar the JAX package's Pallas kernels held against
#   their jnp twins (BENCH_r05.json pallas_parity, flash_bwd_bsd_full_dq
#   0.007143).
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 7e-3}

# Gradient check (phase 7): one step's float32 gradients through the
# kernels against the plain versions, max |dg| / max |g| per parameter.
# The two differ in summation order only (LayerNorm reductions, attention
# blocks, and the embedding's scatter-add, whose atomics add in another
# order on every run): ~1e-6.  The key-projection biases' true gradient is
# exactly zero (q.b_k is the same for every key of a query, and the
# softmax cancels it), so theirs is rounding noise in both paths; they are
# held to the same bound against the largest gradient of the model
# instead of their own.  The bf16 kernel path's error (8 mantissa bits) is
# printed beside the bound and must exceed it.
GRAD_TOL = 1e-4

# H100 dense bf16 tensor-core peak (NVIDIA data sheet), the MFU yardstick
MFU_PEAK = PEAK_FLOPS[torch.bfloat16]

# The kernels line: one entry per TPU function ported, with the counters
# whose launches it reports (the first is its ``launches``).  The line
# reports bf16, so the backward rows name the tensor-core source; their
# float32 launches run flash_attention.cu's kernels.
TPU = "mxnet_tpu/ops/pallas_kernels/"
KERNEL_ROWS = [
    ("layer_norm", "layer_norm.cu", TPU + "layer_norm.py:93",
     ["layer_norm"]),
    ("layer_norm_bwd", "layer_norm.cu", TPU + "layer_norm.py:119",
     ["layer_norm_bwd"]),
    ("flash_attention", "flash_attention.cu", TPU + "flash_attention.py:155",
     ["flash_attention"]),
    ("flash_attention_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:372",
     ["flash_attention_dq", "flash_attention_dkv"]),
    ("flash_attention_bsd", "flash_attention.cu",
     TPU + "flash_attention.py:988", ["flash_attention_bsd"]),
    ("flash_attention_bsd_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:1158",
     ["flash_attention_bsd_dq", "flash_attention_bsd_dkv"]),
    # the dS layout: the kernels' S-contiguous orientation
    ("flash_attention_ds", "flash_attention.cu",
     TPU + "flash_attention.py:623", ["flash_attention_ds"]),
    ("flash_attention_ds_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:794",
     ["flash_attention_ds_dq", "flash_attention_ds_dkv"]),
    # the grid-streamed bsd structure: rows 7 and 8's kernels on their
    # own counters
    ("flash_attention_bsd_stream", "flash_attention.cu",
     TPU + "flash_attention.py:1342", ["flash_attention_bsd_stream"]),
    ("flash_attention_bsd_stream_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:1510",
     ["flash_attention_bsd_stream_dq", "flash_attention_bsd_stream_dkv"]),
    # the 5-pass backward (row 12) is kernels D and C; its launches are
    # D's, on the 5-pass run
    ("fused_ce_fwd", "fused_ce.cu", TPU + "fused_ce.py:155",
     ["fused_ce_fwd"]),
    ("fused_ce_bwd", "fused_ce.cu", TPU + "fused_ce.py:289",
     ["fused_ce_bwd_dx", "fused_ce_bwd_dw"]),
    ("fused_ce_fwd_sp", "fused_ce.cu", TPU + "fused_ce.py:520",
     ["fused_ce_fwd_sp"]),
    ("fused_ce_bwd_dw_rs", "fused_ce.cu", TPU + "fused_ce.py:700",
     ["fused_ce_bwd_dw"]),
    ("fused_ce_bwd_dx_rs", "fused_ce.cu", TPU + "fused_ce.py:744",
     ["fused_ce_bwd_dx"]),
]
# every launch counter, by name: (wrapper, attribute)
COUNTERS = {
    "layer_norm": (layer_norm_fwd, "launches"),
    "layer_norm_bwd": (layer_norm_bwd, "launches"),
    "flash_attention": (flash_attention, "launches"),
    "flash_attention_dq": (flash_attention, "dq_launches"),
    "flash_attention_dkv": (flash_attention, "dkv_launches"),
    "flash_attention_bsd": (flash_attention_bsd, "launches"),
    "flash_attention_bsd_dq": (flash_attention_bsd, "dq_launches"),
    "flash_attention_bsd_dkv": (flash_attention_bsd, "dkv_launches"),
    "flash_attention_ds": (flash_attention, "ds_launches"),
    "flash_attention_ds_dq": (flash_attention, "ds_dq_launches"),
    "flash_attention_ds_dkv": (flash_attention, "ds_dkv_launches"),
    "flash_attention_bsd_stream": (flash_attention_bsd, "stream_launches"),
    "flash_attention_bsd_stream_dq": (flash_attention_bsd,
                                      "stream_dq_launches"),
    "flash_attention_bsd_stream_dkv": (flash_attention_bsd,
                                       "stream_dkv_launches"),
    "fused_ce_fwd": (fce.fused_ce_fwd, "launches"),
    "fused_ce_fwd_sp": (fce.fused_ce_fwd_sp, "launches"),
    "fused_ce_bwd_dw": (fce.fused_ce_bwd_dw, "launches"),
    "fused_ce_bwd_dx": (fce.fused_ce_bwd_dx, "launches"),
}


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def pinned(**env):
    """Set the ``MXNET_*`` pins in ``env`` for the block and restore each
    as it was after it, as `scripts/diag_round5.py` does around a
    configuration."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old


# each flash layout of the training checks: its route's pins, its name in
# the checks and the kernels line, and the route its kernels count on
FLASH_LAYOUTS = {
    "bhsd": ({}, "flash_attention", "hsd"),
    "bsd": ({}, "flash_attention_bsd", "bsd_loop"),
    "ds": ({"MXNET_FLASH_LAYOUT": "ds"}, "flash_attention_ds", "ds"),
    "stream": ({"MXNET_FLASH_BSD_KERNEL": "stream"},
               "flash_attention_bsd_stream", "bsd_stream"),
}


def card_state():
    """The card's SM and memory clocks, power draw and temperature now, as
    nvidia-smi reads them: sampled right after each timed window."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip()


@functools.cache
def spin_cycles_per_ms():
    """Clock cycles `torch.cuda._sleep` spins per millisecond, measured
    once with CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def time_ms(fn, reps=25, per=10, warm=3):
    """Device time of one call of ``fn`` in ms: the median over ``reps``
    samples, each ``per`` back-to-back calls between two CUDA events,
    divided by ``per``.  A spin kernel runs before each sample for twice
    as long as the host takes to enqueue the sample's calls, so the events
    bracket device work alone, not the host's launch latency.  Inputs stay
    warm in L2, as on the serving path, where each call reads what the op
    before it wrote."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(per):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int(max(0.5, 2 * host_ms) * spin_cycles_per_ms())
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def time_with_launch_ms(fn, reps=25, warm=3):
    """Median time of one call of ``fn`` from an idle card, host launch
    included: what an eager caller waits for a tiny kernel."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_auto(fn, budget_ms=600.0):
    """`time_ms` with its sample count fitted to the call's length: 10
    calls a sample below half a millisecond, else one, and as many
    samples (3 to 25) as fit ``budget_ms``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = 1e3 * (time.perf_counter() - t0)
    per = 10 if one < 0.5 else 1
    reps = int(min(25, max(3, budget_ms / (one * per))))
    return time_ms(fn, reps=reps, per=per, warm=1)


def spill_bytes(name):
    """ptxas's spill stores and loads per kernel of source ``name``, from
    its build log: {mangled kernel name: (store bytes, load bytes)}."""
    out, kernel = {}, None
    for ln in _build.build_log(name).splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1]
        elif "spill stores" in ln and kernel is not None:
            words = ln.split()
            out[kernel] = (int(words[words.index("spill") - 2]),
                           int(words[words.index("loads") - 3]))
    return out


def bwd_spills(d, layout):
    """Spill bytes (stores, loads) of the bf16 backward's dq and dk/dv
    kernels at head_dim ``d`` in ``layout`` (0 or 1)."""
    tag = "ILi%dELb%dE" % (d, layout)
    return {k.split("flash_bwd_")[1].split("_mma")[0]: v
            for k, v in spill_bytes("flash_attention_bwd").items()
            if tag in k}


def check(name, dtype, got, ref):
    rtol, atol = TOL[(name, dtype)]
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    return float(err.max()), ok, (rtol, atol)


def rel_check(dtype, pairs):
    """(max abs error, its share of the largest reference value, ok) over
    the (got, ref) pairs, each held to ``REL_TOL[dtype]`` of its own
    reference's largest magnitude."""
    err, rel, ok = 0.0, 0.0, True
    for got, ref in pairs:
        got, ref = got.detach(), ref.detach()
        e = float((got.float() - ref.float()).abs().max())
        r = e / max(float(ref.float().abs().max()), 1e-30)
        err, rel, ok = max(err, e), max(rel, r), ok and r <= REL_TOL[dtype]
    return err, rel, ok


# -- phase 2: kernel checks ------------------------------------------------


def layer_norm_case(rows, dtype, gen, n=768):
    x = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    gamma = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    beta = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    y, mean, rstd = layer_norm_fwd(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    ry, rmean, rrstd = layer_norm_fwd_plain(x, gamma, beta, 1e-5)
    err, ok, tol = check("layer_norm", dtype, y, ry)
    # the statistics are float32 in both: held at the float32 tolerance
    for got, ref in ((mean, rmean), (rstd, rrstd)):
        e2, ok2, _ = check("layer_norm", torch.float32, got, ref)
        err, ok = max(err, e2), ok and ok2
    isz = x.element_size()
    nbytes = 2 * rows * n * isz + 2 * n * isz + 2 * rows * 4
    bnd, by = bound_ms(nbytes, 8 * rows * n, dtype)
    return {
        "kernel": "layer_norm", "shape": [rows, n], "dtype": str(dtype),
        "max_abs_err": err, "ok": ok, "rtol": tol[0], "atol": tol[1],
        "ms": time_ms(lambda: layer_norm_fwd(x, gamma, beta, 1e-5)),
        "ms_with_launch": time_with_launch_ms(
            lambda: layer_norm_fwd(x, gamma, beta, 1e-5)),
        "plain_ms": time_ms(lambda: layer_norm_fwd_plain(x, gamma, beta,
                                                         1e-5)),
        "library_ms": time_ms(lambda: F.layer_norm(x, (n,), gamma, beta,
                                                   1e-5)),
        "bound_ms": bnd, "bound_by": by}


def visible_pairs(sq, skv, causal, q_off, k_off):
    """(query, key) pairs the mask lets through: the work this input
    needs."""
    if not causal:
        return sq * skv
    qpos = q_off + np.arange(sq)
    return int(np.clip(qpos - k_off + 1, 0, skv).sum())


def flash_case(sq, skv, causal, q_off, k_off, dtype, gen, heads=12, d=64,
               batch=1, strided=False):
    """One flash check; ``strided`` passes (batch, seq, heads, d) tensors
    transposed to (batch, heads, seq, d) views, as the serving prefill
    does."""
    def make(s):
        t = torch.randn(batch, s, heads, d, device="cuda", generator=gen)
        t = t.to(dtype).transpose(1, 2)
        return t if strided else t.contiguous()
    q, k, v = make(sq), make(skv), make(skv)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    rout, rlse = flash_attention_plain(q, k, v, with_lse=True, **kw)
    err, ok, tol = check("flash_attention", dtype, out, rout)
    e2, ok2, _ = check("flash_attention", torch.float32, lse, rlse)
    err, ok = max(err, e2), ok and ok2
    if causal and (q_off, k_off) == (0, 0) and sq == skv:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    elif causal:
        qpos = q_off + torch.arange(sq, device="cuda")[:, None]
        mask = qpos >= k_off + torch.arange(skv, device="cuda")[None, :]
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    else:
        lib = lambda: F.scaled_dot_product_attention(q, k, v)
    isz = q.element_size()
    nbytes = batch * heads * (2 * sq * d + 2 * skv * d) * isz
    flops = 4 * d * batch * heads * visible_pairs(sq, skv, causal, q_off,
                                                  k_off)
    bnd, by = bound_ms(nbytes, flops, dtype)
    return {
        "kernel": "flash_attention", "shape": [batch, heads, sq, skv, d],
        "causal": causal, "q_offset": q_off, "k_offset": k_off,
        "strided": strided,
        "dtype": str(dtype), "max_abs_err": err, "ok": ok, "rtol": tol[0],
        "atol": tol[1],
        "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
        "ms_with_launch": time_with_launch_ms(
            lambda: flash_attention(q, k, v, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, **kw)),
        "library_ms": time_ms(lib), "bound_ms": bnd, "bound_by": by}


def kernel_checks():
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (8, 1024, 4096):
            cases.append(layer_norm_case(rows, dtype, gen))
        for s in (64, 1024):
            cases.append(flash_case(s, s, True, 0, 0, dtype, gen))
        cases.append(flash_case(300, 700, False, 400, 100, dtype, gen))
    # a chunk of a long prompt: causal, Sq != Skv, offsets cut the K loop
    cases.append(flash_case(256, 768, True, 512, 0, torch.float32, gen))
    # the kernel's other head width, with ragged tiles
    cases.append(flash_case(200, 200, True, 0, 0, torch.float32, gen, d=128))
    # batch and head strides of transposed views
    cases.append(flash_case(150, 150, True, 0, 0, torch.float32, gen,
                            batch=3, strided=True))
    # row widths off the 256-thread grid, up to the kernel's widest
    for rows, n in ((64, 1000), (16, 8192)):
        cases.append(layer_norm_case(rows, torch.float32, gen, n=n))
    for c in cases:
        log(describe(c))
    log("card after the kernel checks (sm clock, mem clock, power, temp): "
        "%s" % card_state())
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("kernel checks failed: %s" % bad)
    return cases


def _record(kernel, shape, dtype, err, timed, **times):
    """One training-shape check: its error against ``REL_TOL`` and, when
    timed, the kernel, plain, library and bound times."""
    e, rel, ok = err
    rec = {"kernel": kernel, "shape": shape, "dtype": str(dtype),
           "max_abs_err": e, "rel_err": rel, "rel_tol": REL_TOL[dtype],
           "ok": ok}
    if timed:
        rec.update(times)
    return rec


def _library_bwd_ms(fwd, leaves, cot):
    """Time of a library call's backward: its forward and backward through
    autograd, minus its forward."""
    def both():
        torch.autograd.grad(fwd(), leaves, cot)
    with torch.enable_grad():
        return time_auto(both) - time_auto(fwd)


def layer_norm_train_case(rows, dtype, gen, n=768, timed=True):
    """LayerNorm forward and backward at (rows, n): kernels against plain
    versions (the backward from the same statistics), and, when timed,
    both passes' times beside `F.layer_norm`'s."""
    def rnd(*shape, scale=1.0, shift=0.0):
        t = torch.randn(*shape, device="cuda", generator=gen)
        return (t * scale + shift).to(dtype)
    x, dy = rnd(rows, n), rnd(rows, n)
    gamma, beta = rnd(n, scale=0.1, shift=1.0), rnd(n, scale=0.1)
    y, mean, rstd = layer_norm_fwd(x, gamma, beta, 1e-5)
    dx, dg, db = layer_norm_bwd(x, gamma, mean, rstd, dy)
    torch.cuda.synchronize()
    ry, rmean, rrstd = layer_norm_fwd_plain(x, gamma, beta, 1e-5)
    rdx, rdg, rdb = layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
    f_err = rel_check(dtype, [(y, ry)])
    stats = rel_check(torch.float32, [(mean, rmean), (rstd, rrstd)])
    f_err = (max(f_err[0], stats[0]), max(f_err[1], stats[1]),
             f_err[2] and stats[2])
    b_err = rel_check(dtype, [(dx, rdx), (dg, rdg), (db, rdb)])
    if not timed:
        return [_record("layer_norm", [rows, n], dtype, f_err, False),
                _record("layer_norm_bwd", [rows, n], dtype, b_err, False)]
    isz = x.element_size()
    fb = bound_ms(2 * rows * n * isz + 2 * n * isz + 2 * rows * 4,
                  8 * rows * n, dtype)
    bb = bound_ms(3 * rows * n * isz + 3 * n * isz + 2 * rows * 4,
                  13 * rows * n, dtype)
    leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
    lib_fwd = lambda: F.layer_norm(leaves[0], (n,), leaves[1], leaves[2],
                                   1e-5)
    return [
        _record("layer_norm", [rows, n], dtype, f_err, True,
                ms=time_auto(lambda: layer_norm_fwd(x, gamma, beta, 1e-5)),
                plain_ms=time_auto(
                    lambda: layer_norm_fwd_plain(x, gamma, beta, 1e-5)),
                library_ms=time_auto(
                    lambda: F.layer_norm(x, (n,), gamma, beta, 1e-5)),
                bound_ms=fb[0], bound_by=fb[1]),
        _record("layer_norm_bwd", [rows, n], dtype, b_err, True,
                ms=time_auto(
                    lambda: layer_norm_bwd(x, gamma, mean, rstd, dy)),
                plain_ms=time_auto(
                    lambda: layer_norm_bwd_plain(x, gamma, mean, rstd, dy)),
                library_ms=_library_bwd_ms(lib_fwd, leaves, dy),
                bound_ms=bb[0], bound_by=bb[1])]


def flash_train_case(layout, batch, heads, d, dtype, gen, sq=1024,
                     skv=1024, causal=True, q_off=0, k_off=0, timed=True):
    """Flash attention forward and backward as training runs it: (B, H, S,
    D) views of (B, S, H, D) projections ('bhsd', the graph's transposes;
    'ds', the same through the dS route) or (B, S, E) operands through
    `flash_attention_bsd` ('bsd'; 'stream', the grid-streamed route's
    pin).  Out, lse, dq, dk and dv of the kernels (lse cotangent
    included) against the plain versions, with the launches counted on
    the layout's route alone; when timed, each pass's time beside
    `scaled_dot_product_attention`'s.  On 'ds' the kernels' times are
    those of the kernels on the dS operands; ``route_ms`` adds the
    route's boundary copies."""
    pins, name, route = FLASH_LAYOUTS[layout]
    with pinned(**pins):
        bsd = layout in ("bsd", "stream")
        fn = flash_attention_bsd if bsd else flash_attention
        plain = flash_attention_bsd_plain if bsd else flash_attention_plain
        extra = (heads,) if bsd else ()
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)

        def make(s):
            t = torch.randn(batch, s, heads, d, device="cuda", generator=gen)
            t = t.to(dtype)
            return t.reshape(batch, s, heads * d) if bsd else t.transpose(1, 2)

        def heads_view(t):
            return t.reshape(batch, t.shape[1], heads, d).transpose(1, 2) \
                if bsd else t

        q, k, v = make(sq), make(skv), make(skv)
        g = make(sq)
        glse = torch.randn(batch, heads, sq, device="cuda", generator=gen)

        def through(f):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out, lse = f(*leaves, *extra, with_lse=True, **kw)
            torch.autograd.backward((out, lse), (g, glse))
            return out, lse, [t.grad for t in leaves]

        reset_counts()
        out, lse, grads = through(fn)
        torch.cuda.synchronize()
        launched = {k: n for k, n in read_counts().items() if n}
        want = {k: 1 for k in (name, name + "_dq", name + "_dkv")}
        if launched != want:
            raise SystemExit("%s %s: launches %s, expected %s"
                             % (name, dtype, launched, want))
        rout, rlse, rgrads = through(plain)
        f_err = rel_check(dtype, [(out, rout)])
        lse_err = rel_check(torch.float32, [(lse, rlse)])
        f_err = (max(f_err[0], lse_err[0]), max(f_err[1], lse_err[1]),
                 f_err[2] and lse_err[2])
        shape = [batch, heads, sq, skv, d]
        # the kernel path's own residuals, (B, H, S, D) and in the
        # kernels' layout
        q4, k4, v4, g4, o4 = (heads_view(t.detach())
                              for t in (q, k, v, g, out))
        lse = lse.detach()
        scale = 1.0 / math.sqrt(d)
        args = (q_off, k_off, scale, causal)
        if layout == "ds":
            kq, kk, kv, ko, kg = (_to_ds(t) for t in (q4, k4, v4, o4, g4))
        else:
            kq, kk, kv, ko, kg = q4, k4, v4, o4, g4
        extra_bwd = {}
        if dtype == torch.bfloat16:
            # held against the plain backward in float32 on float32 copies
            # of the same operands (see REL_TOL); the bf16 plain one printed
            ref32 = _flash_bwd_plain(*(t.float() for t in (q4, k4, v4, o4)),
                                     lse, g4.float(), glse, *args)
            b_err = rel_check(dtype, [(heads_view(a), r)
                                      for a, r in zip(grads, ref32)])
            del ref32
            plain16 = rel_check(dtype, list(zip(grads, rgrads)))
            # two launches on the same inputs: bit-identical gradients
            once = _flash_bwd_cuda(kq, kk, kv, ko, lse, kg, glse, *args,
                                   route)
            again = _flash_bwd_cuda(kq, kk, kv, ko, lse, kg, glse, *args,
                                    route)
            same = all(torch.equal(a, b) for a, b in zip(once, again))
            del once, again
            b_err = (b_err[0], b_err[1], b_err[2] and same)
            extra_bwd = {"reference": "plain float32 on the bf16 operands",
                         "bf16_plain_rel_err": plain16[1],
                         "bit_identical": same}
        else:
            b_err = rel_check(dtype, list(zip(grads, rgrads)))
        if not timed:
            return [_record(name, shape, dtype, f_err, False),
                    dict(_record(name + "_bwd", shape, dtype, b_err, False),
                         **extra_bwd)]
        isz = q.element_size()
        pairs = visible_pairs(sq, skv, causal, q_off, k_off) * batch * heads
        # operations per visible pair: 2·d for each product the function
        # needs, Q Kᵀ and P V forward; Q Kᵀ once, dO Vᵀ, dV, dQ and dK
        # backward (the two-pass kernels' recompute of Q Kᵀ and dO Vᵀ is
        # not work the function needs)
        fb = bound_ms(batch * heads * d * (2 * sq + 2 * skv) * isz
                      + batch * heads * sq * 4, 4 * d * pairs, dtype)
        bb = bound_ms(batch * heads * d * (4 * sq + 4 * skv) * isz
                      + 2 * batch * heads * sq * 4, 10 * d * pairs, dtype)
        leaves = [t.clone().requires_grad_() for t in (q4, k4, v4)]
        sdpa = lambda: F.scaled_dot_product_attention(*leaves,
                                                      is_causal=causal)
        route_fwd = lambda: fn(q, k, v, *extra, with_lse=True, **kw)
        if layout == "ds":
            kernel_fwd = lambda: _flash_fwd_cuda(kq, kk, kv, *args, True,
                                                 route)
        else:
            kernel_fwd = route_fwd
        fwd = _record(name, shape, dtype, f_err, True,
                      ms=time_auto(kernel_fwd),
                      plain_ms=time_auto(lambda: plain(q, k, v, *extra,
                                                       with_lse=True, **kw)),
                      library_ms=time_auto(
                          lambda: F.scaled_dot_product_attention(
                              q4, k4, v4, is_causal=causal)),
                      bound_ms=fb[0], bound_by=fb[1])
        if layout == "ds":
            fwd["route_ms"] = time_auto(route_fwd)
        bwd = _record(name + "_bwd", shape, dtype, b_err, True,
                      ms=time_auto(lambda: _flash_bwd_cuda(
                          kq, kk, kv, ko, lse, kg, glse, *args, route)),
                      plain_ms=time_auto(lambda: _flash_bwd_plain(
                          q4, k4, v4, o4, lse, g4, glse, *args)),
                      library_ms=_library_bwd_ms(sdpa, leaves, g4),
                      bound_ms=bb[0], bound_by=bb[1], **extra_bwd)
        # the part of ``ms`` spent on delta = rowsum(dO * O) - glse, which
        # the wrapper computes in torch before the kernels
        bwd["delta_ms"] = time_auto(lambda: _delta(ko, kg, glse,
                                                   2 if layout == "ds" else 3))
        # the rate the function's 10·d operations a visible pair reach
        bwd["tflops"] = 10 * d * pairs / (bwd["ms"] * 1e-3) / 1e12
        bwd["bound_share"] = bwd["bound_ms"] / bwd["ms"]
        if dtype == torch.bfloat16:
            bwd["spill_bytes"] = bwd_spills(d, int(layout == "ds"))
        return [fwd, bwd]


def describe(c):
    """One check's line: its error against its tolerance and its times."""
    if "rel_tol" in c:
        tol = "rel err %.2e (tol %.0e of max|ref|)" % (c["rel_err"],
                                                        c["rel_tol"])
    else:
        tol = "(rtol %.1e atol %.1e)" % (c["rtol"], c["atol"])
    line = "check %-23s %-26s %-14s err %.3e %s %s" % (
        c["kernel"], c["shape"], c["dtype"], c["max_abs_err"], tol,
        "ok" if c["ok"] else "FAIL")
    if "ms" in c:
        line += (" | kernel %.4f ms  plain %.4f ms  library %.4f ms  bound "
                 "%.5f ms (%s)" % (c["ms"], c["plain_ms"], c["library_ms"],
                                   c["bound_ms"], c["bound_by"]))
    if "ms_with_launch" in c:
        line += "; kernel with launch %.4f ms" % c["ms_with_launch"]
    if "route_ms" in c:
        line += "; route with its boundary copies %.4f ms" % c["route_ms"]
    if "tflops" in c:
        line += ("; %.1f TFLOP/s (10·d a visible pair), %.3f of the bound; "
                 "the wrapper's delta %.4f ms of it"
                 % (c["tflops"], c["bound_share"], c["delta_ms"]))
    if "bf16_plain_rel_err" in c:
        line += ("; vs the plain f32 backward of the bf16 operands, beside "
                 "it the bf16 plain one %.2e; bit-identical twice: %s"
                 % (c["bf16_plain_rel_err"], c["bit_identical"]))
    if "spill_bytes" in c:
        line += "; ptxas spill (stores, loads) bytes %s" % c["spill_bytes"]
    return line


def training_kernel_checks():
    """Every kernel of the training path against its plain version, forward
    and backward, at the shapes the training phases give them (timed) and
    at the smaller and odd shapes of the backward's own checks."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += layer_norm_train_case(32768, dtype, gen)
        cases += layer_norm_train_case(8, dtype, gen, timed=False)
        cases += flash_train_case("bhsd", 4, 12, 64, dtype, gen, timed=False)
        cases += flash_train_case("bsd", 4, 6, 128, dtype, gen, timed=False)
        # not causal, Sq != Skv, offsets: the lse cotangent reaches every row
        cases += flash_train_case("bhsd", 2, 4, 64, dtype, gen, sq=300,
                                  skv=700, causal=False, q_off=400,
                                  k_off=100, timed=False)
        # the training shapes, timed
        cases += flash_train_case("bhsd", 32, 12, 64, dtype, gen)
        cases += flash_train_case("bsd", 32, 6, 128, dtype, gen)
    # causal with offsets: the dk/dv loop's first query tile moves
    cases += flash_train_case("bsd", 1, 2, 128, torch.float32, gen, sq=256,
                              skv=768, q_off=512, timed=False)
    # the bf16 backward's ragged tiles at head 128, in both layouts: the
    # causal diagonal 37 positions into a 64-position tile, a 13-position
    # tail (333 = 5 * 64 + 13, not a multiple of 8: the dS copies pad their
    # rows), and rows that see no key (k_off 50)
    for layout in ("bhsd", "ds"):
        cases += flash_train_case(layout, 2, 3, 128, torch.bfloat16, gen,
                                  sq=333, skv=333, q_off=37, timed=False)
        cases += flash_train_case(layout, 2, 2, 128, torch.bfloat16, gen,
                                  sq=200, skv=333, k_off=50, timed=False)
    for c in cases:
        log(describe(c))
    log("card after the training kernel checks (sm clock, mem clock, power, "
        "temp): %s" % card_state())
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("training kernel checks failed: %s" % bad)
    return cases


def longctx_kernel_checks():
    """The dS route's kernels (rows 5 and 6) and the grid-streamed bsd
    route's (rows 9 and 10) against the plain versions, in float32 and
    bf16: at the long-context training shapes, timed, and at ragged ones
    with offsets and at head 64."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += flash_train_case("ds", 1, 2, 128, dtype, gen, sq=1000,
                                  skv=1000, q_off=24, timed=False)
        cases += flash_train_case("ds", 2, 4, 64, dtype, gen, sq=520,
                                  skv=520, timed=False)
        cases += flash_train_case("ds", 2, 4, 64, dtype, gen, sq=300,
                                  skv=700, causal=False, q_off=400,
                                  k_off=100, timed=False)
        cases += flash_train_case("stream", 1, 2, 128, dtype, gen, sq=1000,
                                  skv=1000, q_off=24, timed=False)
        cases += flash_train_case("stream", 2, 4, 64, dtype, gen, sq=520,
                                  skv=520, timed=False)
        # the training shapes, timed
        cases += flash_train_case("ds", 8, 6, 128, dtype, gen, sq=4096,
                                  skv=4096)
        cases += flash_train_case("stream", 4, 6, 128, dtype, gen, sq=8192,
                                  skv=8192)
    cases += route_pin_checks(gen)
    for c in cases:
        log(describe(c))
    log("card after the long-context kernel checks (sm clock, mem clock, "
        "power, temp): %s" % card_state())
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("long-context kernel checks failed: %s" % bad)
    return cases


def route_pin_checks(gen):
    """The plain pins on the card: ``MXNET_FLASH_IMPL=jnp`` launches no
    kernel in either layout and gives the plain versions' result bit for
    bit; ``MXNET_FLASH_BWD=jnp`` launches the forward kernel alone and
    agrees with the plain versions to the float32 tolerance; a mistyped
    ``MXNET_FLASH_BSD_KERNEL`` raises."""
    x = torch.randn(2, 256, 4, 128, device="cuda", generator=gen)
    g = torch.randn(2, 256, 4, 128, device="cuda", generator=gen)
    cases = []
    for label, pins, fn, want, exact in (
            ("jnp", {"MXNET_FLASH_IMPL": "jnp"}, flash_attention, {}, True),
            ("jnp", {"MXNET_FLASH_IMPL": "jnp"}, flash_attention_bsd, {},
             True),
            ("bwd jnp", {"MXNET_FLASH_BWD": "jnp",
                         "MXNET_FLASH_LAYOUT": "ds"}, flash_attention,
             {"flash_attention_ds": 1}, False)):
        bsd = fn is flash_attention_bsd
        args = [t.reshape(2, 256, 512) if bsd else t.transpose(1, 2)
                for t in (x, x, x)]
        cot = g.reshape(2, 256, 512) if bsd else g.transpose(1, 2)
        extra = (4,) if bsd else ()
        plain = flash_attention_bsd_plain if bsd else flash_attention_plain

        def through(f):
            leaves = [t.detach().clone().requires_grad_() for t in args]
            out = f(*leaves, *extra, causal=True)
            out.backward(cot)
            return [out] + [t.grad for t in leaves]

        with pinned(**pins):
            reset_counts()
            got = through(fn)
            torch.cuda.synchronize()
            launched = {k: n for k, n in read_counts().items() if n}
        ref = through(plain)
        err, rel, ok = rel_check(torch.float32, list(zip(got, ref)))
        if exact:
            ok = all(torch.equal(a, b) for a, b in zip(got, ref))
        cases.append(_record("pin %s, %s" % (label, fn.__name__),
                             [2, 4, 256, 256, 128], torch.float32,
                             (err, rel, ok and launched == want), False))
        cases[-1]["launches"] = launched
    with pinned(MXNET_FLASH_BSD_KERNEL="streamed"):
        y = x.reshape(2, 256, 512)
        try:
            flash_attention_bsd(y, y, y, 4, causal=True)
            raised = False
        except mx.MXNetError:
            raised = True
    cases.append(_record("pin streamed raises", [2, 4, 256, 256, 128],
                         torch.float32, (0.0, 0.0, raised), False))
    return cases


# -- phase 9: the fused CE head's kernels ---------------------------------

# the training head's shape: 32 x 1024 tokens, embed 768, vocab 32768
CE_TRAIN = (32768, 768, 32768)
# a ragged one: no multiple of the tiles in tokens or vocabulary (GPT-2's)
CE_RAGGED = (1000, 768, 50257)
# the op's default tiles: a pin the kernels take (multiples of 32); the
# plain versions tile the vocabulary by block_v as the jnp twins do
CE_BLOCKS = (512, 2048)


def ce_operands(n, d, v, dtype, gen, ragged):
    """x, W, b, int32 labels, the loss-head arguments and r = grad_scale *
    valid.  ``ragged``: no bias (zeros), every 7th label -1 and every 11th
    past V (out of range), every 5th the ignore label 5 under use_ignore,
    grad_scale 1.7."""
    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (0.05 * torch.randn(v, d, device="cuda", generator=gen)).to(dtype)
    b = torch.zeros(v, device="cuda", dtype=dtype) if ragged else \
        (0.1 * torch.randn(v, device="cuda", generator=gen)).to(dtype)
    label = torch.randint(0, v, (n,), device="cuda", generator=gen,
                          dtype=torch.int32)
    head = (1.0, -1.0, False)
    if ragged:
        label[::7] = -1
        label[3::11] = v + 5
        label[1::5] = 5
        head = (1.7, 5.0, True)
    r, _ = fce._valid_coef(label, *head)
    return x, w, b, label, head, r


def combine(*errs):
    """One (max abs error, max rel error, ok) over several `rel_check`s."""
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            all(e[2] for e in errs))


def ce_case(shape, dtype, gen, ragged=False, timed=False):
    """Kernels A, B, C, D and the 5-pass backward (D + C) against their
    plain versions on the same inputs.  Outputs that are float32 by
    contract (nll, lse, the picked logit) are held to the float32
    tolerance; dxp (p rounded to W's dtype before p @ W), dx, dW and db to
    the dtype's.  When timed: each beside its bound and the library's
    `F.linear` + `F.cross_entropy`, forward for A and B, backward for the
    rest."""
    n, d, v = shape
    x, w, b, label, head, r = ce_operands(n, d, v, dtype, gen, ragged)
    gs, ign, use = head
    bv = CE_BLOCKS[1]
    got = {
        "fused_ce_fwd": fce.fused_ce_fwd(x, w, b, label, ign, use,
                                         *CE_BLOCKS),
        "fused_ce_fwd_sp": fce.fused_ce_fwd_sp(x, w, b, label, *CE_BLOCKS)}
    torch.cuda.synchronize()
    ref = {"fused_ce_fwd": fce._fwd_plain(x, w, b, label, ign, use, bv),
           "fused_ce_fwd_sp": fce._fwd_sp_plain(x, w, b, label, bv)}
    lse = ref["fused_ce_fwd"][1]
    got.update({
        "fused_ce_bwd_dw_rs": fce.fused_ce_bwd_dw(x, w, b, label, lse, r,
                                                  *CE_BLOCKS),
        "fused_ce_bwd_dx_rs": (fce.fused_ce_bwd_dx(x, w, b, label, lse, r,
                                                   *CE_BLOCKS),),
        "fused_ce_bwd": fce.fused_ce_bwd(x, w, b, label, lse, *head,
                                         *CE_BLOCKS)})
    torch.cuda.synchronize()
    ref.update({
        "fused_ce_bwd_dw_rs": fce._bwd_dw_rs_plain(x, w, b, label, lse, r,
                                                   bv),
        "fused_ce_bwd_dx_rs": (fce._bwd_dx_rs_plain(x, w, b, label, lse, r,
                                                    bv),),
        "fused_ce_bwd": fce._bwd_plain(x, w, b, label, lse, *head, bv)})
    f32_outputs = {"fused_ce_fwd": 2, "fused_ce_fwd_sp": 2}
    recs = []
    for name, outs in got.items():
        k = f32_outputs.get(name, 0)
        pairs = list(zip(outs, ref[name]))
        err = combine(rel_check(torch.float32, pairs[:k]),
                      rel_check(dtype, pairs[k:]))
        recs.append(_record(name, list(shape), dtype, err, False))
    if not timed:
        return recs
    isz = x.element_size()
    # one pass over the logit tiles; each kernel recomputes its scores, but
    # the 5-pass backward as a function needs them once, then dl @ W and
    # dl^T @ x: 3 passes, not D's 2 plus C's 2
    ops = 2 * n * v * d
    operands = (n * d + v * d + v) * isz + 4 * n
    bounds = {
        "fused_ce_fwd": bound_ms(operands + 8 * n, ops, dtype),
        "fused_ce_fwd_sp": bound_ms(operands + 8 * n + 4 * n * d, 2 * ops,
                                    dtype),
        "fused_ce_bwd_dw_rs": bound_ms(operands + 8 * n + (v * d + v) * isz,
                                       2 * ops, dtype),
        "fused_ce_bwd_dx_rs": bound_ms(operands + 8 * n + n * d * isz,
                                       2 * ops, dtype),
        "fused_ce_bwd": bound_ms(operands + 4 * n + (n * d + v * d + v)
                                 * isz, 3 * ops, dtype)}
    calls = {
        "fused_ce_fwd": (lambda: fce.fused_ce_fwd(x, w, b, label, ign, use,
                                                  *CE_BLOCKS),
                         lambda: fce._fwd_plain(x, w, b, label, ign, use,
                                                bv)),
        "fused_ce_fwd_sp": (lambda: fce.fused_ce_fwd_sp(x, w, b, label,
                                                        *CE_BLOCKS),
                            lambda: fce._fwd_sp_plain(x, w, b, label, bv)),
        "fused_ce_bwd_dw_rs": (
            lambda: fce.fused_ce_bwd_dw(x, w, b, label, lse, r, *CE_BLOCKS),
            lambda: fce._bwd_dw_rs_plain(x, w, b, label, lse, r, bv)),
        "fused_ce_bwd_dx_rs": (
            lambda: fce.fused_ce_bwd_dx(x, w, b, label, lse, r, *CE_BLOCKS),
            lambda: fce._bwd_dx_rs_plain(x, w, b, label, lse, r, bv)),
        "fused_ce_bwd": (
            lambda: fce.fused_ce_bwd(x, w, b, label, lse, *head, *CE_BLOCKS),
            lambda: fce._bwd_plain(x, w, b, label, lse, *head, bv))}
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    lab64 = label.long()
    lib_fwd = lambda: F.cross_entropy(F.linear(*leaves), lab64,  # noqa
                                      reduction="none")
    with torch.no_grad():
        lib = {"fwd": time_auto(lib_fwd)}
    lib["bwd"] = _library_bwd_ms(lib_fwd, leaves,
                                 torch.ones(n, device="cuda", dtype=dtype))
    del leaves
    for rec in recs:
        name = rec["kernel"]
        kern, plain = calls[name]
        bnd, by = bounds[name]
        rec.update(ms=time_auto(kern), plain_ms=time_auto(plain),
                   library_ms=lib["fwd" if "fwd" in name else "bwd"],
                   bound_ms=bnd, bound_by=by)
    return recs


def fused_ce_checks():
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += ce_case(CE_RAGGED, dtype, gen, ragged=True)
        cases += ce_case(CE_TRAIN, dtype, gen, timed=True)
        torch.cuda.empty_cache()
    for c in cases:
        log(describe(c))
    log("card after the fused CE checks (sm clock, mem clock, power, temp): "
        "%s" % card_state())
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("fused CE kernel checks failed: %s" % bad)
    return cases


# -- phases 3 and 4: the serving path --------------------------------------


def reset_counts():
    for w, attr in COUNTERS.values():
        setattr(w, attr, 0)


def read_counts():
    return {k: getattr(w, attr) for k, (w, attr) in COUNTERS.items()}


# the module globals through which the serving programs and the training
# ops call the kernels, and the plain version of each
_PLAIN = [(decode_mod, "layer_norm", layer_norm_plain),
          (decode_mod, "flash_attention", flash_attention_plain),
          (attention_mod, "layer_norm", layer_norm_plain),
          (attention_mod, "flash_attention", flash_attention_plain),
          (attention_mod, "flash_attention_bsd", flash_attention_bsd_plain),
          (loss_mod, "fused_softmax_ce", fce.fused_softmax_ce_plain)]


@contextlib.contextmanager
def plain_kernels():
    """Run the model's programs and ops through the kernels' plain
    versions: the reference the served logits and the training gradients
    are held against."""
    saved = [getattr(mod, name) for mod, name, _ in _PLAIN]
    for mod, name, plain in _PLAIN:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(_PLAIN, saved):
            setattr(mod, name, fn)


def serve(engine, requests):
    """Submit every (prompt, kwargs) pair at once, run the engine to idle
    and return the requests and the numbers phase 3/4 print."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, **kw) for p, kw in requests]
    steps = engine.run_until_idle(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    state = card_state()
    if not all(r.done for r in reqs):
        raise SystemExit("not every request finished")
    ttft = sorted(r.ttft_ms for r in reqs)
    gen_tokens = sum(len(r.tokens) for r in reqs)
    return reqs, {
        "requests": len(reqs), "completed": engine.stats["completed"],
        "generated_tokens": gen_tokens, "wall_s": wall, "steps": steps,
        "tokens_per_s": gen_tokens / wall,
        "ttft_ms_median": statistics.median(ttft),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "card_after": state, "stats": dict(engine.stats)}


def teacher_forced_kernel_logits(model, params, prompt, gen, block_size):
    """Logits at each generated position through the engine's own kind
    of launches: one paged prefill chunk over the prompt, then one paged
    decode per generated token (kernels on)."""
    dev = params["embed_weight"].device
    n_table = -(-model.seq_len // block_size)
    pool = model.init_block_pool(n_table + 1, block_size, device=dev)
    table = torch.arange(1, n_table + 1, device=dev)[None, :]
    bucket = 1 << max(4, (len(prompt) - 1).bit_length())
    toks = torch.zeros((1, min(bucket, model.seq_len)), dtype=torch.long,
                       device=dev)
    toks[0, :len(prompt)] = torch.tensor(prompt, device=dev)
    zero = torch.zeros((1,), dtype=torch.long, device=dev)
    logits, _ = model.prefill_paged(params, pool, toks, zero,
                                    zero + len(prompt), table)
    rows = [logits[0]]
    for j, t in enumerate(gen[:-1]):
        pos = torch.tensor([len(prompt) + j], device=dev)
        logits, _ = model.decode_paged(params, pool,
                                       torch.tensor([t], device=dev), pos,
                                       table)
        rows.append(logits[0])
    return torch.stack(rows).float()


def reference_logits(model, params, prompt, gen):
    """Plain float32 logits at each generated position: one slot-cache
    prefill of prompt + generated with one row per position, row j cut
    at length len(prompt) + j."""
    dev = params["embed_weight"].device
    seq = list(prompt) + list(gen[:-1])
    n = len(gen)
    toks = torch.tensor([seq] * n, device=dev)
    length = torch.arange(len(prompt), len(prompt) + n, device=dev)
    with plain_kernels():
        logits, _ = model.prefill(params, toks, length)
    return logits.float()


def logit_check(model, params, reqs, block_size):
    out = []
    bf16_model = copy.copy(model)
    bf16_model.dtype = torch.bfloat16
    bf16_params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    for r in reqs:
        ref = reference_logits(model, params, r.prompt, r.tokens)
        got = teacher_forced_kernel_logits(model, params, r.prompt,
                                           r.tokens, block_size)
        err = float((got - ref).abs().max())
        bf16 = teacher_forced_kernel_logits(bf16_model, bf16_params,
                                            r.prompt, r.tokens, block_size)
        err_bf16 = float((bf16 - ref).abs().max())
        # the token the engine emitted is a near-argmax of the reference
        # logits wherever it decoded greedily
        picked = ref.gather(1, torch.tensor(r.tokens,
                                            device=ref.device)[:, None])
        gap = float((ref.max(dim=1).values - picked[:, 0]).max())
        res = {"request": r.id, "prompt_len": len(r.prompt),
               "positions": len(r.tokens), "temperature": r.temperature,
               "max_abs_err": err, "tol": LOGIT_TOL,
               "bf16_max_abs_err": err_bf16,
               "greedy_argmax_gap": gap if r.temperature == 0 else None}
        log("logits request %d (prompt %d, %d positions, T=%.1f): f32 kernel "
            "path vs plain f32 err %.3e (tol %.0e); same path in bf16 err "
            "%.3e%s" % (r.id, len(r.prompt), len(r.tokens), r.temperature,
                        err, LOGIT_TOL, err_bf16,
                        "" if r.temperature else "; greedy argmax gap %.2e"
                        % gap))
        if not err <= LOGIT_TOL:
            raise SystemExit("served logits disagree with the plain path")
        if not err_bf16 > LOGIT_TOL:
            raise SystemExit("logit tolerance does not separate bf16 from f32")
        if r.temperature == 0 and not gap <= LOGIT_TOL:
            raise SystemExit("a greedy token is not the reference argmax")
        out.append(res)
    return out


def print_serving(label, res):
    log("%s: %d/%d requests, %d tokens in %.3f s = %.1f tok/s, ttft median "
        "%.1f ms p99 %.1f ms, %d steps, launches %s, max_memory_allocated "
        "%d B; card after (sm clock, mem clock, power, temp): %s"
        % (label, res["completed"], res["requests"], res["generated_tokens"],
           res["wall_s"], res["tokens_per_s"], res["ttft_ms_median"],
           res["ttft_ms_p99"], res["steps"], res["launches"],
           res["max_memory_allocated"], res["card_after"]))


def paged_path(model, params):
    engine = ServingEngine(model, params, max_batch=8)
    t0 = time.perf_counter()
    warm = engine.warmup()
    warm_s = time.perf_counter() - t0
    log("paged engine: %s, warmup %.2f s" % (warm, warm_s))
    rng = np.random.RandomState(0)
    lens = rng.randint(32, 769, size=16)
    requests = []
    for i, n in enumerate(lens):
        prompt = rng.randint(0, model.vocab_size, size=int(n)).tolist()
        kw = dict(max_new_tokens=32, seed=i)
        if i % 2:
            kw.update(temperature=0.8, top_k=50, top_p=0.95)
        requests.append((prompt, kw))
    reqs, res = serve(engine, requests)
    res["warmup_s"] = warm_s
    res["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in params.values())
    res["pool_bytes"] = pool_bytes(model.num_layers, engine.n_blocks,
                                   engine.block_size, model.num_embed,
                                   params["embed_weight"].element_size())
    print_serving("paged path (default engine)", res)
    log("paged memory: weights %d B, K/V pool %d B (%d blocks of %d), "
        "peak allocated %d B" % (res["weight_bytes"], res["pool_bytes"],
                                 engine.n_blocks, engine.block_size,
                                 res["max_memory_allocated"]))
    if res["launches"]["layer_norm"] == 0:
        raise SystemExit("the paged path launched no LayerNorm kernel")
    res["logit_checks"] = logit_check(model, params, reqs[:2],
                                      engine.block_size)
    return engine, res


def slot_path(model, params):
    engine = ServingEngine(model, params, max_batch=8, paged=False)
    t0 = time.perf_counter()
    warm = engine.warmup()
    warm_s = time.perf_counter() - t0
    log("slot engine: %s, warmup %.2f s" % (warm, warm_s))
    rng = np.random.RandomState(1)
    requests = [(rng.randint(0, model.vocab_size, size=int(n)).tolist(),
                 dict(max_new_tokens=32))
                for n in rng.randint(520, 1001, size=4)]
    _, res = serve(engine, requests)
    res["warmup_s"] = warm_s
    print_serving("slot path (paged=False)", res)
    if res["launches"]["flash_attention"] < 4 * model.num_layers:
        raise SystemExit("the slot path's prefills did not run the flash "
                         "kernel (%d launches)"
                         % res["launches"]["flash_attention"])
    if res["launches"]["layer_norm"] == 0:
        raise SystemExit("the slot path launched no LayerNorm kernel")
    return engine, res


def profiled(fn):
    """Run ``fn`` under `torch.profiler` and return the window's wall
    seconds, its device busy seconds (the sum of kernel and copy times),
    the device ops by name ``[(name, count, total ms)]`` largest first,
    and the host ops with the most self time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    device = sorted(((k[:60], n, us / 1e3) for k, (n, us) in
                     by_name.items()), key=lambda t: -t[2])
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host = [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in host[:10]]
    busy = sum(t[2] for t in device) / 1e3
    return wall, busy, device, host


def kernel_ms(device, name):
    """Total device ms of the ops whose name contains ``name``."""
    return sum(ms for k, _, ms in device if name in k)


def decode_profile(engine, model, steps=10):
    """Profile ``steps`` decode iterations of a full batch of 8 on the
    paged engine: wall time per step, device busy time, kernel launches
    per step, the device ops that take the most time and the host-side
    ops that cost most."""
    rng = np.random.RandomState(2)
    for _ in range(8):
        engine.submit(rng.randint(0, model.vocab_size, size=64).tolist(),
                      max_new_tokens=2 * steps + 4)
    for _ in range(4):
        engine.step()
    if len(engine._active) != 8:
        raise SystemExit("the profiled batch did not fill")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def run():
        for _ in range(steps):
            engine.step()
    wall_profiled, busy, device, host = profiled(run)
    engine.run_until_idle(timeout=120)
    n_dev = sum(n for _, n, _ in device)
    res = {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
           "profiled_wall_ms_per_step": 1e3 * wall_profiled / steps,
           "device_busy_ms_per_step": 1e3 * busy / steps,
           # the profiler slows the host; the idle share is of its window
           "device_idle_share": 1 - busy / wall_profiled if busy else None,
           "device_ops_per_step": n_dev / steps,
           "layer_norm_kernel_ms_per_step":
               kernel_ms(device, "ln_fwd_kernel") / steps,
           "top_device_ops_ms": device[:8], "top_host_ops_ms": host}
    log("decode profile (batch 8, %d steps): %.3f ms/step wall (%.3f under "
        "the profiler), device busy %.3f ms/step (idle share %s), %.1f "
        "device ops/step, LayerNorm kernel %.4f ms/step; top device ops "
        "(name, count, ms): %s; top host ops (name, calls, self cpu ms): %s"
        % (steps, res["wall_ms_per_step"], res["profiled_wall_ms_per_step"],
           res["device_busy_ms_per_step"],
           "not measured" if res["device_idle_share"] is None
           else "%.3f" % res["device_idle_share"],
           res["device_ops_per_step"],
           res["layer_norm_kernel_ms_per_step"], device[:8], host))
    return res


def prefill_profile(engine, model, n=1000):
    """Profile one slot-cache admission of an ``n``-token prompt (the
    1024 bucket's prefill and the first token): wall time, device busy
    time and the share of the flash and LayerNorm kernels in it."""
    rng = np.random.RandomState(3)
    req = engine.submit(rng.randint(0, model.vocab_size, size=n).tolist(),
                        max_new_tokens=1)
    wall, busy, device, host = profiled(engine.step)
    if not req.done:
        raise SystemExit("the profiled prefill did not finish")
    res = {"prompt": n, "wall_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy,
           "flash_kernel_ms": kernel_ms(device, "flash_fwd_kernel"),
           "layer_norm_kernel_ms": kernel_ms(device, "ln_fwd_kernel"),
           "top_device_ops_ms": device[:8], "top_host_ops_ms": host}
    log("prefill profile (slot engine, prompt %d): %.3f ms wall, device "
        "busy %.3f ms, flash kernel %.3f ms, LayerNorm kernel %.3f ms; top "
        "device ops (name, count, ms): %s"
        % (n, res["wall_ms"], res["device_busy_ms"], res["flash_kernel_ms"],
           res["layer_norm_kernel_ms"], device[:8]))
    return res


# -- phases 6 to 8: the training path --------------------------------------

# `tools/benchmark_transformer.py`'s defaults: vocab 32768, context 1024,
# 12 layers, embed 768, batch 32
TRAIN = dict(vocab_size=32768, seq_len=1024, num_layers=12, num_embed=768)
TRAIN_BATCH = 32
# the GPT-2-small parity configuration: 12 heads of 64, biases on, dense
# head, head-split ('bhsd') attention
PARITY = dict(TRAIN, num_heads=12, use_bias=True, attn_layout="bhsd")
# bench.py's tpu_geom_fast_ configuration: 6 heads of 128, no biases,
# transposeless ('bsd') attention
GEOM_FAST = dict(TRAIN, num_heads=6, use_bias=False, attn_layout="bsd")
# bench.py's fused_ configuration (`TBENCH_FUSED_HEAD=1`): the parity
# configuration with the fused CE head; its Adam keeps v in bf16 with
# stochastic rounding (`tools/benchmark_transformer.py:76`)
FUSED = dict(PARITY, fused_head=True)
FUSED_TRAINER = dict(adam_v_dtype="bfloat16")
# scripts/diag_round5.py's stage_longctx (`_make_lm_trainer(H=6, S, B)`,
# :73-101 and :393-403): 12 layers, embed 768, 6 heads of 128, vocab
# 32768, biases, dense head; bf16, Adam lr 1e-3 wd 0, v in bf16 (the
# ``FUSED_TRAINER`` keyword); S=4096 B=8 through the dS route ('bhsd'
# under MXNET_FLASH_LAYOUT=ds) and S=8192 B=4 through the grid-streamed
# route ('bsd' under MXNET_FLASH_BSD_KERNEL=stream): 32768 tokens a step,
# as the parity configuration
LONGCTX_DS = dict(TRAIN, seq_len=4096, num_heads=6, use_bias=True,
                  attn_layout="bhsd")
LONGCTX_DS_BATCH = 8
LONGCTX_STREAM = dict(LONGCTX_DS, seq_len=8192, attn_layout="bsd")
LONGCTX_STREAM_BATCH = 4


def lm_trainer(cfg, batch, dtype, seed=0, **kw):
    """`SPMDTrainer` over `get_transformer_lm(**cfg)` as the benchmark
    builds it: Adam at lr 1e-3, wd 0, on the card, from `random.seed`."""
    mx.random.seed(seed)
    net = mx.models.get_transformer_lm(**cfg)
    shape = (batch, cfg["seq_len"])
    return mx.SPMDTrainer(net, data_shapes={"data": shape,
                                            "softmax_label": shape},
                          optimizer="adam", lr=1e-3, wd=0.0, dtype=dtype,
                          **kw)


def lm_batch(batch, cfg):
    """The benchmark's batch: tokens and next-token labels from
    `RandomState(0)`."""
    rng = np.random.RandomState(0)
    shape = (batch, cfg["seq_len"])
    return {"data": rng.randint(0, cfg["vocab_size"], shape).astype(np.int32),
            "softmax_label": rng.randint(0, cfg["vocab_size"],
                                         shape).astype(np.float32)}


def mean_nll(out, labels):
    """Mean negative log-likelihood of the labels: under the softmax
    head's output rows, or the fused head's per-token NLL itself."""
    if out.dim() == 1:
        return float(out.float().mean())
    p = out.gather(1, labels.reshape(-1, 1).long()).float()
    return float(-torch.log(p).mean())


def flops_per_token(cfg):
    """`tools/benchmark_transformer.py`'s count: 6 per matmul parameter
    (the embedding lookup is a gather, not a matmul) plus causal
    attention's 12 * L * D * S / 2."""
    l, d = cfg["num_layers"], cfg["num_embed"]
    n_matmul = l * (4 * d * d + 2 * d * 4 * d) + d * cfg["vocab_size"]
    return 6 * n_matmul + 12 * l * d * cfg["seq_len"] // 2


def train_path(label, cfg, steps, expect, trainer_kw=None, falls=True,
               after=None, batch=TRAIN_BATCH, pins=None):
    """Train ``cfg`` at full width, in bf16, at ``batch`` (32 unless
    given) under the ``MXNET_*`` ``pins`` (set for the path and restored
    after): ``steps`` steps (the first a warm-up, left out of the timing)
    with the counts set to 0 before and read after, then one profiled
    step.  ``expect`` maps each counter to the launches it must show per
    step (every other counter must show none); ``falls`` asks for the
    last loss below the first.  ``after(trainer, batch)`` runs last, on
    the trained model, and its result joins the record."""
    with pinned(**(pins or {})):
        trainer = lm_trainer(cfg, batch, "bfloat16", **(trainer_kw or {}))
        dev = trainer.shard_batch(lm_batch(batch, cfg))
        labels = dev["softmax_label"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_ms, wall_ms = [], [], []
        for _ in range(steps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            outs = trainer.step(dev)
            b.record()
            b.synchronize()
            wall_ms.append(1e3 * (time.perf_counter() - t0))
            step_ms.append(a.elapsed_time(b))
            losses.append(mean_nll(outs[0], labels))
            del outs
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        state = card_state()
        wall, busy, device, host = profiled(lambda: trainer.step(dev))
        extra = after(trainer, dev) if after else {}
        del trainer, dev, labels
        torch.cuda.empty_cache()

        timed = step_ms[1:]
        step = statistics.median(timed)
        tokens = batch * cfg["seq_len"]
        fpt = flops_per_token(cfg)
        res = {
            "config": cfg, "batch": batch, "dtype": "bfloat16",
            "optimizer": "adam lr 1e-3 wd 0", "trainer_kw": trainer_kw or {},
            "pins": pins or {}, "steps": steps,
            "losses": losses, "step_ms": step_ms, "wall_ms": wall_ms,
            "step_ms_median": step, "tokens_per_s": tokens / (step / 1e3),
            "flops_per_token": fpt,
            "mfu": fpt * tokens / (step / 1e3) / MFU_PEAK,
            "launches": launches,
            "launches_per_step": {k: n / steps for k, n in launches.items()},
            "max_memory_allocated": peak, "card_after": state,
            "profiled_step_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy,
            "device_idle_share": 1 - busy / wall,
            "kernel_ms": {k: kernel_ms(device, k) for k in (
                "ln_fwd_kernel", "ln_bwd_kernel", "ln_bwd_reduce_kernel",
                "flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel", "flash_bwd_dq_mma_kernel",
                "flash_bwd_dkv_mma_kernel", "fused_ce_kernel")},
            "top_device_ops_ms": device[:10], "top_host_ops_ms": host}
        res.update(extra)
        log("%s: %d steps of batch %d x %d tokens, bf16, Adam; step ms (CUDA "
            "events) %s; median of the last %d %.2f ms = %.1f tokens/s, MFU "
            "%.4f (%.4g flops/token over the %.0f TFLOP/s dense bf16 peak); "
            "host wall ms %s"
            % (label, steps, batch, cfg["seq_len"],
               ["%.2f" % t for t in step_ms], len(timed), step,
               res["tokens_per_s"], res["mfu"], fpt, MFU_PEAK / 1e12,
               ["%.1f" % t for t in wall_ms]))
        log("%s: mean NLL per step %s" % (label, ["%.4f" % x for x in losses]))
        log("%s: launches per step %s; max_memory_allocated %d B; card after "
            "(sm clock, mem clock, power, temp): %s"
            % (label, {k: v for k, v in res["launches_per_step"].items() if v},
               peak, state))
        log("%s: profiled step %.2f ms wall, device busy %.2f ms (idle share "
            "%.4f); kernel ms %s; top device ops (name, count, ms): %s"
            % (label, res["profiled_step_ms"], res["device_busy_ms"],
               res["device_idle_share"],
               {k: round(v, 3) for k, v in res["kernel_ms"].items()},
               device[:10]))
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit("%s: a loss is not finite: %s" % (label, losses))
        if falls and not losses[-1] < losses[0]:
            raise SystemExit("%s: the loss did not fall: %s" % (label, losses))
        off = {k: n for k, n in launches.items()
               if n != expect.get(k, 0) * steps}
        if off:
            raise SystemExit("%s: launches %s in %d steps, expected %s a step"
                             % (label, off, steps, expect))
        return res


def grad_check(cfg, required, label="parity config", size=2, pins=None):
    """One step's float32 gradients of ``cfg`` at batch ``size`` through the
    kernels, under the ``MXNET_*`` ``pins``, against the same step through
    their plain versions, and the bf16 kernel path's distance from the
    same reference.  Each counter of ``required`` must show a launch."""
    with pinned(**(pins or {})):
        batch = lm_batch(size, cfg)
        trainer = lm_trainer(cfg, size, "float32")
        reset_counts()
        got = trainer.gradients(batch)
        launched = read_counts()
        with plain_kernels():
            reset_counts()
            ref = trainer.gradients(batch)
            if any(read_counts().values()):
                raise SystemExit("the plain path launched a kernel")
        trainer16 = lm_trainer(cfg, size, "bfloat16")
        mx.load_params(trainer16, *trainer.get_params())
        got16 = trainer16.gradients(batch)
        del trainer, trainer16
        gmax = max(float(g.abs().max()) for g in ref.values())

        def worst(grads):
            out = {}
            for n, r in ref.items():
                scale = gmax if n.endswith("_k_bias") else \
                    max(float(r.abs().max()), 1e-30)
                out[n] = float((grads[n].float() - r).abs().max()) / scale
            return out

        f32, bf16 = worst(got), worst(got16)
        name32 = max(f32, key=f32.get)
        res = {"config": label, "batch": size, "params": len(ref),
               "max_abs_grad": gmax,
               "worst_f32": f32[name32], "worst_f32_param": name32,
               "worst_bf16": max(bf16.values()), "tol": GRAD_TOL,
               "launches": launched, "per_param_f32": f32}
        log("gradients (%s, batch %d, %d parameters): f32 kernel path vs "
            "plain max |dg|/max |g| %.3e at %s (tol %.0e); bf16 kernel path "
            "%.3e; kernel launches %s"
            % (label, size, len(ref), res["worst_f32"], name32, GRAD_TOL,
               res["worst_bf16"], {k: v for k, v in launched.items() if v}))
        if not res["worst_f32"] <= GRAD_TOL:
            raise SystemExit("gradients through the kernels disagree with the "
                             "plain path")
        if not res["worst_bf16"] > GRAD_TOL:
            raise SystemExit("gradient tolerance does not separate bf16 "
                             "from f32")
        for k in required:
            if not launched[k]:
                raise SystemExit("the gradient step launched no %s kernel" % k)
        return res


# the fused CE kernels: counters and their launches per training step
CE_COUNTERS = ("fused_ce_fwd", "fused_ce_fwd_sp", "fused_ce_bwd_dw",
               "fused_ce_bwd_dx")


def rounding_cost(trainer):
    """The bf16 second moment's stochastic rounding alone: one
    `_store_v_bf16` over every parameter's float32 v (copies made first;
    rounding a bf16 value again leaves it as it is), as device ms (CUDA
    events) and host wall ms to the end of its work."""
    v32 = [t.float() for t in trainer._adam_v]
    dev_ms = time_auto(lambda: trainer._store_v_bf16(v32), budget_ms=2000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._store_v_bf16(v32)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    n = sum(t.numel() for t in v32)
    return {"elements": n, "device_ms": dev_ms, "wall_ms": wall_ms,
            "groups": len({tuple(t.shape) for t in v32})}


def forward_check(trainer, dev):
    """One `SPMDTrainer.forward` (no gradient, labels zeros): the fused
    head runs the statistics kernel alone."""
    torch.cuda.synchronize()
    reset_counts()
    out = trainer.forward({"data": dev["data"]})[0]
    torch.cuda.synchronize()
    launched = read_counts()
    tokens = TRAIN_BATCH * TRAIN["seq_len"]
    ok = tuple(out.shape) == (tokens,) and bool(torch.isfinite(out).all())
    want = {k: 0 for k in CE_COUNTERS}
    want["fused_ce_fwd"] = 1
    log("forward (fused config, no gradient): output %s finite %s, launches "
        "%s" % (tuple(out.shape), ok, {k: v for k, v in launched.items()
                                       if v}))
    if not ok:
        raise SystemExit("forward: the fused head's NLL is not finite or "
                         "not one per token")
    off = {k: launched[k] for k in want if launched[k] != want[k]}
    if off or not launched["layer_norm"]:
        raise SystemExit("forward: launches %s, expected %s and LayerNorm"
                         % (launched, want))
    return {"launches": launched, "shape": list(out.shape)}


def fused_extras(trainer, dev):
    res = {"rounding": rounding_cost(trainer),
           "forward": forward_check(trainer, dev)}
    log("bf16 second moment's stochastic rounding: %s" % res["rounding"])
    return res


def five_pass_path(expect):
    """2 steps of the fused configuration in the 5-pass structure,
    ``MXNET_CE_SINGLE_PASS=0`` set for them and restored after."""
    return train_path("train fused, 5-pass", FUSED, 2, expect,
                      FUSED_TRAINER, falls=False,
                      pins={"MXNET_CE_SINGLE_PASS": "0"})


def kernels_line(cases, paths):
    """One entry per ported TPU function: launches on each path, and the
    error and times of its check at the training shape, in bf16."""
    train = {"layer_norm": [32768, 768], "layer_norm_bwd": [32768, 768],
             "flash_attention": [32, 12, 1024, 1024, 64],
             "flash_attention_bwd": [32, 12, 1024, 1024, 64],
             "flash_attention_bsd": [32, 6, 1024, 1024, 128],
             "flash_attention_bsd_bwd": [32, 6, 1024, 1024, 128],
             "flash_attention_ds": [8, 6, 4096, 4096, 128],
             "flash_attention_ds_bwd": [8, 6, 4096, 4096, 128],
             "flash_attention_bsd_stream": [4, 6, 8192, 8192, 128],
             "flash_attention_bsd_stream_bwd": [4, 6, 8192, 8192, 128]}
    train.update({name: list(CE_TRAIN) for name, src, _, _ in KERNEL_ROWS
                  if src == "fused_ce.cu"})
    serving = {"layer_norm": [8, 768],
               "flash_attention": [1, 12, 1024, 1024, 64]}
    out = []
    for name, src, replaces, counters in KERNEL_ROWS:
        at = next(c for c in cases if c["kernel"] == name
                  and c["shape"] == train[name] and "ms" in c
                  and c["dtype"] == "torch.bfloat16")
        by_path = {p: {k: launches[k] for k in counters}
                   for p, launches in paths.items()}
        entry = {
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + src, "replaces": replaces,
            "launches": sum(v[counters[0]] for v in by_path.values()),
            "launches_by_path": by_path, "shape": at["shape"],
            "dtype": at["dtype"], "max_abs_err": at["max_abs_err"],
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "route_ms": at.get("route_ms"),
            "checks": [{k: c.get(k) for k in (
                "shape", "dtype", "max_abs_err", "rel_err", "rel_tol",
                "rtol", "atol")} for c in cases if c["kernel"] == name]}
        if name in serving:
            s = next(c for c in cases if c["kernel"] == name
                     and c["shape"] == serving[name]
                     and c["dtype"] == "torch.float32" and "rtol" in c)
            entry["serving_shape_ms"] = {"shape": s["shape"],
                                         "dtype": s["dtype"], "ms": s["ms"]}
        out.append(entry)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log("card: %s" % card)
    log("python %s, torch %s, CUDA %s, devices %d"
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))
    phases = {}

    @contextlib.contextmanager
    def phase(name):
        t0 = time.perf_counter()
        yield
        phases[name] = time.perf_counter() - t0
        log("phase %s: %.2f s" % (name, phases[name]))

    with phase("build"):
        took = _build.build()
    log("kernel build: per source %s"
        % {k: round(v, 2) for k, v in took.items()})
    for name in _build.KERNELS:
        regs = [ln.split(":", 1)[1].strip()
                for ln in _build.build_log(name).splitlines()
                if "registers" in ln]
        log("ptxas %s: %s" % (name, regs))
    log("ptxas spill (stores, loads) bytes, flash_attention_bwd: %s"
        % spill_bytes("flash_attention_bwd"))

    with phase("kernel checks"):
        cases = kernel_checks() + training_kernel_checks()

    with phase("serving"):
        model = TransformerKVModel(**GPT2)
        t0 = time.perf_counter()
        params = model.params_from_jax(
            model.init_params(np.random.RandomState(0)), "cuda")
        log("GPT-2 small weights (seed 0) on the card in %.2f s"
            % (time.perf_counter() - t0))
        engine, paged = paged_path(model, params)
        profile = decode_profile(engine, model)
        del engine
        torch.cuda.empty_cache()
        engine, slot = slot_path(model, params)
        prefill_prof = prefill_profile(engine, model)
        del engine, params
        torch.cuda.empty_cache()

    per_layer = {"layer_norm": 2 * TRAIN["num_layers"] + 1,
                 "layer_norm_bwd": 2 * TRAIN["num_layers"] + 1}

    def flash(prefix):
        return {prefix + k: TRAIN["num_layers"] for k in ("", "_dq", "_dkv")}

    with phase("train bhsd and bsd"):
        hsd = train_path("train bhsd (parity)", PARITY, 7,
                         dict(per_layer, **flash("flash_attention")))
        grads = grad_check(PARITY, ("layer_norm_bwd", "flash_attention_dq",
                                    "flash_attention_dkv"))
        bsd = train_path("train bsd (geom fast)", GEOM_FAST, 3,
                         dict(per_layer, **flash("flash_attention_bsd")))

    with phase("fused CE"):
        ce_cases = fused_ce_checks()
        cases += ce_cases
        hsd_flash = flash("flash_attention")
        fused = train_path(
            "train fused (bench fused_)", FUSED, 5,
            dict(per_layer, **hsd_flash, fused_ce_fwd_sp=1,
                 fused_ce_bwd_dw=1), FUSED_TRAINER, after=fused_extras)
        five = five_pass_path(dict(per_layer, **hsd_flash, fused_ce_fwd=1,
                                   fused_ce_bwd_dx=1, fused_ce_bwd_dw=1))
        fused_grads = grad_check(
            FUSED, ("layer_norm_bwd", "flash_attention_dq",
                    "flash_attention_dkv", "fused_ce_fwd_sp",
                    "fused_ce_bwd_dw"), "fused config")

    with phase("long-context kernel checks"):
        cases += longctx_kernel_checks()
    with phase("train longctx"):
        ds = train_path(
            "train longctx ds", LONGCTX_DS, 5,
            dict(per_layer, **flash("flash_attention_ds")), FUSED_TRAINER,
            batch=LONGCTX_DS_BATCH, pins={"MXNET_FLASH_LAYOUT": "ds"})
        stream = train_path(
            "train longctx stream", LONGCTX_STREAM, 5,
            dict(per_layer, **flash("flash_attention_bsd_stream")),
            FUSED_TRAINER, batch=LONGCTX_STREAM_BATCH,
            pins={"MXNET_FLASH_BSD_KERNEL": "stream"})
        stream_grads = grad_check(
            LONGCTX_STREAM, ("layer_norm_bwd",
                             "flash_attention_bsd_stream_dq",
                             "flash_attention_bsd_stream_dkv"),
            "longctx stream config", size=1,
            pins={"MXNET_FLASH_BSD_KERNEL": "stream"})

    kernels = kernels_line(cases, {
        "paged": paged["launches"], "slot": slot["launches"],
        "train_bhsd": hsd["launches"], "train_bsd": bsd["launches"],
        "train_fused": fused["launches"],
        "train_fused_5pass": five["launches"],
        "forward_fused": fused["forward"]["launches"],
        "train_longctx_ds": ds["launches"],
        "train_longctx_stream": stream["launches"]})
    log("phase seconds: %s" % {k: round(v, 2) for k, v in phases.items()})
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": took, "phase_s": phases, "cases": cases, "paged": paged,
         "slot": slot, "decode_profile": profile,
         "prefill_profile": prefill_prof, "train_bhsd": hsd,
         "gradients": grads, "train_bsd": bsd, "train_fused": fused,
         "train_fused_5pass": five, "gradients_fused": fused_grads,
         "train_longctx_ds": ds, "train_longctx_stream": stream,
         "gradients_longctx_stream": stream_grads, "kernels": kernels},
        indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

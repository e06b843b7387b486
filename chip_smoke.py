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
   take;
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
   attention, no biases) at full width for 3 steps.

It prints a ``kernels`` JSON line (launches, errors, times, bounds), the
card's name and power limit, and as its last line
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
from mxnet_tpu_torch.ops.pallas_kernels import _build
from mxnet_tpu_torch.ops.pallas_kernels.flash_attention import (
    _flash_bwd_cuda, _flash_bwd_plain, flash_attention, flash_attention_bsd,
    flash_attention_bsd_plain, flash_attention_plain)
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
# whose launches it reports (the first is its ``launches``).
TPU = "mxnet_tpu/ops/pallas_kernels/"
KERNEL_ROWS = [
    ("layer_norm", "layer_norm.cu", TPU + "layer_norm.py:93",
     ["layer_norm"]),
    ("layer_norm_bwd", "layer_norm.cu", TPU + "layer_norm.py:119",
     ["layer_norm_bwd"]),
    ("flash_attention", "flash_attention.cu", TPU + "flash_attention.py:155",
     ["flash_attention"]),
    ("flash_attention_bwd", "flash_attention.cu",
     TPU + "flash_attention.py:372",
     ["flash_attention_dq", "flash_attention_dkv"]),
    ("flash_attention_bsd", "flash_attention.cu",
     TPU + "flash_attention.py:988", ["flash_attention_bsd"]),
    ("flash_attention_bsd_bwd", "flash_attention.cu",
     TPU + "flash_attention.py:1158",
     ["flash_attention_bsd_dq", "flash_attention_bsd_dkv"]),
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
}


def log(*args):
    print(*args, flush=True)


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
    D) views of (B, S, H, D) projections ('bhsd', the graph's transposes)
    or (B, S, E) operands through `flash_attention_bsd` ('bsd').  Out,
    lse, dq, dk and dv of the kernels (lse cotangent included) against
    the plain versions; when timed, each pass's time beside
    `scaled_dot_product_attention`'s."""
    bsd = layout == "bsd"
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

    out, lse, grads = through(fn)
    torch.cuda.synchronize()
    rout, rlse, rgrads = through(plain)
    f_err = rel_check(dtype, [(out, rout)])
    lse_err = rel_check(torch.float32, [(lse, rlse)])
    f_err = (max(f_err[0], lse_err[0]), max(f_err[1], lse_err[1]),
             f_err[2] and lse_err[2])
    b_err = rel_check(dtype, list(zip(grads, rgrads)))
    name = "flash_attention_bsd" if bsd else "flash_attention"
    shape = [batch, heads, sq, skv, d]
    if not timed:
        return [_record(name, shape, dtype, f_err, False),
                _record(name + "_bwd", shape, dtype, b_err, False)]
    q4, k4, v4, g4, o4 = (heads_view(t.detach()) for t in (q, k, v, g, out))
    lse = lse.detach()
    scale = 1.0 / math.sqrt(d)
    args = (q_off, k_off, scale, causal)
    isz = q.element_size()
    pairs = visible_pairs(sq, skv, causal, q_off, k_off) * batch * heads
    fb = bound_ms(batch * heads * d * (2 * sq + 2 * skv) * isz
                  + batch * heads * sq * 4, 4 * d * pairs, dtype)
    bb = bound_ms(batch * heads * d * (4 * sq + 4 * skv) * isz
                  + 2 * batch * heads * sq * 4, 14 * d * pairs, dtype)
    leaves = [t.clone().requires_grad_() for t in (q4, k4, v4)]
    sdpa = lambda: F.scaled_dot_product_attention(*leaves, is_causal=causal)
    return [
        _record(name, shape, dtype, f_err, True,
                ms=time_auto(lambda: fn(q, k, v, *extra, with_lse=True,
                                        **kw)),
                plain_ms=time_auto(lambda: plain(q, k, v, *extra,
                                                 with_lse=True, **kw)),
                library_ms=time_auto(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal)),
                bound_ms=fb[0], bound_by=fb[1]),
        _record(name + "_bwd", shape, dtype, b_err, True,
                ms=time_auto(lambda: _flash_bwd_cuda(
                    q4, k4, v4, o4, lse, g4, glse, *args, fn)),
                plain_ms=time_auto(lambda: _flash_bwd_plain(
                    q4, k4, v4, o4, lse, g4, glse, *args)),
                library_ms=_library_bwd_ms(sdpa, leaves, g4),
                bound_ms=bb[0], bound_by=bb[1])]


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
    for c in cases:
        log(describe(c))
    log("card after the training kernel checks (sm clock, mem clock, power, "
        "temp): %s" % card_state())
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("training kernel checks failed: %s" % bad)
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
          (attention_mod, "flash_attention_bsd", flash_attention_bsd_plain)]


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


def lm_trainer(cfg, batch, dtype, seed=0):
    """`SPMDTrainer` over `get_transformer_lm(**cfg)` as the benchmark
    builds it: Adam at lr 1e-3, wd 0, on the card, from `random.seed`."""
    mx.random.seed(seed)
    net = mx.models.get_transformer_lm(**cfg)
    shape = (batch, cfg["seq_len"])
    return mx.SPMDTrainer(net, data_shapes={"data": shape,
                                            "softmax_label": shape},
                          optimizer="adam", lr=1e-3, wd=0.0, dtype=dtype)


def lm_batch(batch, cfg):
    """The benchmark's batch: tokens and next-token labels from
    `RandomState(0)`."""
    rng = np.random.RandomState(0)
    shape = (batch, cfg["seq_len"])
    return {"data": rng.randint(0, cfg["vocab_size"], shape).astype(np.int32),
            "softmax_label": rng.randint(0, cfg["vocab_size"],
                                         shape).astype(np.float32)}


def mean_nll(probs, labels):
    """Mean negative log-likelihood of the labels under the softmax head's
    output rows."""
    p = probs.gather(1, labels.reshape(-1, 1).long()).float()
    return float(-torch.log(p).mean())


def flops_per_token(cfg):
    """`tools/benchmark_transformer.py`'s count: 6 per matmul parameter
    (the embedding lookup is a gather, not a matmul) plus causal
    attention's 12 * L * D * S / 2."""
    l, d = cfg["num_layers"], cfg["num_embed"]
    n_matmul = l * (4 * d * d + 2 * d * 4 * d) + d * cfg["vocab_size"]
    return 6 * n_matmul + 12 * l * d * cfg["seq_len"] // 2


def train_path(label, cfg, steps, expect):
    """Train ``cfg`` at full width, batch 32, in bf16: ``steps`` steps (the
    first a warm-up, left out of the timing) with the counts set to 0
    before and read after, then one profiled step.  ``expect`` maps each
    counter to the launches it must show per step."""
    trainer = lm_trainer(cfg, TRAIN_BATCH, "bfloat16")
    dev = trainer.shard_batch(lm_batch(TRAIN_BATCH, cfg))
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
    del trainer, dev, labels
    torch.cuda.empty_cache()

    timed = step_ms[1:]
    step = statistics.median(timed)
    tokens = TRAIN_BATCH * cfg["seq_len"]
    fpt = flops_per_token(cfg)
    res = {
        "config": cfg, "batch": TRAIN_BATCH, "dtype": "bfloat16",
        "optimizer": "adam lr 1e-3 wd 0", "steps": steps,
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
            "flash_bwd_dkv_kernel")},
        "top_device_ops_ms": device[:10], "top_host_ops_ms": host}
    log("%s: %d steps of batch %d x %d tokens, bf16, Adam; step ms (CUDA "
        "events) %s; median of the last %d %.2f ms = %.1f tokens/s, MFU "
        "%.4f (%.4g flops/token over the %.0f TFLOP/s dense bf16 peak); "
        "host wall ms %s"
        % (label, steps, TRAIN_BATCH, cfg["seq_len"],
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
    if not losses[-1] < losses[0]:
        raise SystemExit("%s: the loss did not fall: %s" % (label, losses))
    off = {k: n for k, n in launches.items()
           if n != expect.get(k, 0) * steps}
    if off:
        raise SystemExit("%s: launches %s in %d steps, expected %s a step"
                         % (label, off, steps, expect))
    return res


def grad_check(cfg):
    """One step's float32 gradients of ``cfg`` at batch 2 through the kernels
    against the same step through their plain versions, and the bf16
    kernel path's distance from the same reference."""
    batch = lm_batch(2, cfg)
    trainer = lm_trainer(cfg, 2, "float32")
    reset_counts()
    got = trainer.gradients(batch)
    launched = read_counts()
    with plain_kernels():
        reset_counts()
        ref = trainer.gradients(batch)
        if any(read_counts().values()):
            raise SystemExit("the plain path launched a kernel")
    trainer16 = lm_trainer(cfg, 2, "bfloat16")
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
    res = {"batch": 2, "params": len(ref), "max_abs_grad": gmax,
           "worst_f32": f32[name32], "worst_f32_param": name32,
           "worst_bf16": max(bf16.values()), "tol": GRAD_TOL,
           "launches": launched, "per_param_f32": f32}
    log("gradients (parity config, batch 2, %d parameters): f32 kernel path "
        "vs plain max |dg|/max |g| %.3e at %s (tol %.0e); bf16 kernel path "
        "%.3e; kernel launches %s"
        % (len(ref), res["worst_f32"], name32, GRAD_TOL, res["worst_bf16"],
           {k: v for k, v in launched.items() if v}))
    if not res["worst_f32"] <= GRAD_TOL:
        raise SystemExit("gradients through the kernels disagree with the "
                         "plain path")
    if not res["worst_bf16"] > GRAD_TOL:
        raise SystemExit("gradient tolerance does not separate bf16 from f32")
    for k in ("layer_norm_bwd", "flash_attention_dq", "flash_attention_dkv"):
        if not launched[k]:
            raise SystemExit("the gradient step launched no %s kernel" % k)
    return res


def kernels_line(cases, paths):
    """One entry per ported TPU function: launches on each path, and the
    error and times of its check at the training shape, in bf16."""
    train = {"layer_norm": [32768, 768], "layer_norm_bwd": [32768, 768],
             "flash_attention": [32, 12, 1024, 1024, 64],
             "flash_attention_bwd": [32, 12, 1024, 1024, 64],
             "flash_attention_bsd": [32, 6, 1024, 1024, 128],
             "flash_attention_bsd_bwd": [32, 6, 1024, 1024, 128]}
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
    t0 = time.perf_counter()
    took = _build.build()
    log("kernel build: %.2f s wall, per source %s"
        % (time.perf_counter() - t0, {k: round(v, 2) for k, v in took.items()}))
    for name in _build.KERNELS:
        regs = [ln.split(":", 1)[1].strip()
                for ln in _build.build_log(name).splitlines()
                if "registers" in ln]
        log("ptxas %s: %s" % (name, regs))

    cases = kernel_checks() + training_kernel_checks()

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
    hsd = train_path("train bhsd (parity)", PARITY, 7, dict(
        per_layer, **{k: TRAIN["num_layers"] for k in (
            "flash_attention", "flash_attention_dq",
            "flash_attention_dkv")}))
    grads = grad_check(PARITY)
    bsd = train_path("train bsd (geom fast)", GEOM_FAST, 3, dict(
        per_layer, **{k: TRAIN["num_layers"] for k in (
            "flash_attention_bsd", "flash_attention_bsd_dq",
            "flash_attention_bsd_dkv")}))

    kernels = kernels_line(cases, {
        "paged": paged["launches"], "slot": slot["launches"],
        "train_bhsd": hsd["launches"], "train_bsd": bsd["launches"]})
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": took, "cases": cases, "paged": paged, "slot": slot,
         "decode_profile": profile, "prefill_profile": prefill_prof,
         "train_bhsd": hsd, "gradients": grads, "train_bsd": bsd,
         "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

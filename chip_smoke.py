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
   take; the bf16 flash forward and backward (tensor cores) are held
   against the plain versions in float32 on the same bf16 operands, must
   give bit-identical results twice, and report their TFLOP/s, their
   share of the bound and ptxas's spill bytes; the float32 flash forward
   and backward (tensor cores, 3xTF32) must give bit-identical results
   twice too, their bound the 3xTF32 one with the CUDA-core bound beside
   it; the forward in both dtypes, and the bf16 backward, also on a k
   whose rows the kernels cannot copy 16 bytes at a time (the wrappers'
   aligned copy); flash
   attention at head widths 16 (the plain route), 32, 48, 80 and 96
   (zero-padded to the kernels' widths) and 160 (refused), forward and
   backward, float32 and bf16, on all four kernel routes, each on its
   route's counters; and LayerNorm, forward and backward, each twice bit
   for bit, in every layout and vector width its plans pick (N = 30 in
   bf16, 768, 1000, 1024, 8192, rows wider than its registers hold at
   12300 and 16384, a view one element past a 16-byte boundary, and the
   decode shape (8, 768)), at the training shape (32768, 768) timed with
   its inputs warm in L2 and cold, beside the bytes bound, with ptxas's
   registers and spills of the kernels that ran;
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
   attention, no biases) at full width for 3 steps, and check one f32
   step's gradients of it (batch 2); then the parity configuration in
   float32, the trainer's default dtype, for 3 steps (its flash forward
   and backward run the 3xTF32 kernels);
9. hold the four fused CE kernels (stats forward, single-pass forward,
   dW/db, dx) and the 5-pass backward against their plain versions, in
   float32 (tensor cores, 3xTF32) and bf16 (tensor cores, against the
   plain version in bf16), each twice bit for bit, at the training
   head's shape (32768 tokens, 768, vocab 32768; timed beside `F.linear`
   + `F.cross_entropy`, with TFLOP/s, share of the bound, in float32 the
   3xTF32 bound with the CUDA-core one beside it, and ptxas's registers
   and spills) and at ragged ones with ignored and
   out-of-range labels, no bias and grad_scale 1.7: 1000 tokens at 768
   and vocab 50257, GPT-2 medium's width (8192 tokens, 1024, 50257),
   GPT-2 XL's (1000, 1600, 50257: past the widest float32 cluster, in
   windows), LLaMA-7B's 4096 (300 tokens, vocab 5000: past the widest
   cluster in both dtypes, in windows), in bf16 (333, 772, 1000), whose
   d the wrapper zero-pads to 776 and counts, and (333, 30, 1000) in both
   dtypes, zero-padded to 32 and counted;
10. train bench.py's ``fused_`` configuration (the parity configuration
   with the fused CE head, Adam's second moment in bf16 with stochastic
   rounding) at full width for 5 steps, with exact launches per step and
   the rounding's cost; then 2 steps of the 5-pass structure
   (``MXNET_CE_SINGLE_PASS=0``) and one `SPMDTrainer.forward`, each with
   its launches; the same configuration in float32 with the trainer's
   default float32 v (the float32 kernels B and C) for 3 steps, its
   `forward` (A), and 2 steps of its 5-pass structure (A, D and C), each
   with its launches, step time and the CE kernels' time by mode; one
   f32 step's gradients of the fused configuration
   through the kernels against their plain versions; and the fused head
   at GPT-2 medium's widths (2 layers, embed 1024, 16 heads, vocab
   50257): one f32 step's gradients at batch 1 against the plain path,
   and 2 bf16 steps at batch 4 with exact launches;
11. hold the dS route's kernels and the grid-streamed bsd route's against
   their plain versions (bf16 as in phase 2), in float32 and bf16, at the
   long-context training shapes ((8, 6, 4096, 128) and (4, 6, 8192,
   128), causal, timed beside SDPA) and at ragged ones with offsets and
   head 64, and check the plain pins (``MXNET_FLASH_IMPL=jnp``,
   ``MXNET_FLASH_BWD=jnp``) and a mistyped ``MXNET_FLASH_BSD_KERNEL``;
12. train `scripts/diag_round5.py`'s long-context configurations (6
   heads of 128, biases, bf16 Adam v) at full width for 5 steps each:
   S=4096 B=8 under ``MXNET_FLASH_LAYOUT=ds`` and S=8192 B=4 under
   ``MXNET_FLASH_BSD_KERNEL=stream``, with exact launches on the route's
   own counters; and one f32 step's gradients of each configuration at
   batch 1 through the kernels against their plain versions;
13. the reference training API on `BASELINE.json`'s first configuration:
   `tools/make_mnist.py` writes 20000 training and 4000 test images, and
   `model.FeedForward(models.get_mlp())` trains on `io.MNISTIter` (batch
   128, SGD lr 0.1 momentum 0.9, `Xavier`) for 2 epochs on the card, with
   ms a batch, images/s, the train and validation accuracy and peak
   memory; the same on the CPU, whose parameters after 10 batches and
   after the first epoch must match the card's to 1e-4 of max|w| and
   whose validation accuracy after the first epoch must be within 0.01;
   the same CPU run on 1, 2 and 4 threads measures how far rounding
   alone moves the end of training, and the card's final train and
   validation accuracy must lie within the larger of 0.01 and twice that
   spread of the CPU run's (`MNIST_SPREAD_MULT`); the card's checkpoint
   must load on the CPU, save the same bytes again and score the same;
14. the parity configuration in float32 at batch 8 through
   `Symbol.simple_bind` (``grad_req='write'``) and Adam through
   `optimizer.get_fused_updater`: step 1's gradients against
   `SPMDTrainer(dtype='float32')` on the same parameters and batch
   (1e-4), 6 steps each with exactly 25/25 LayerNorm and 12/12/12 float32
   flash launches, the loss finite and falling, ms a step and tokens/s
   beside the trainer's own steps at the same batch, and peak memory;
15. ResNet-50 at `bench.py`'s headline geometry (224 pixels, 1000
   classes, 'valid' pooling, bf16, batch 128, SGD lr 0.1 momentum 0.9 wd
   1e-4) through `SPMDTrainer` on one synthetic batch staged on the card:
   10 steps, ms a step by CUDA events (median of steps 2 on), images/s
   and MFU (`bench.py`'s 3 x 2 x 4.089e9 flops an image over 989
   TFLOP/s), one profiled step (idle share, device ms of convolutions and
   products against the rest, top ops), peak memory; the mean NLL must
   fall below the first step's by the last, every aux state be finite
   and have moved from 0 and 1, and no kernel of the table launch; then
   a float32 convolution (ResNet-50's stem, a bottleneck's 3x3 and 1x1,
   FCN-8s's 16x upscore), forward and backward through the op with
   ``cudnn.allow_tf32 = True``, within 1e-5 of float64 on the card, where
   the raw cuDNN call under that flag must miss the bar;
16. ResNet-50 in the reference's 'full' geometry at batch 4 in float32,
   ``cudnn.allow_tf32 = True`` around it: `SPMDTrainer.forward` and
   `gradients` on the card against the same on the CPU from the card's
   initial parameters (forward 1e-4 of the largest output, moving
   statistics 1e-5, gradients 1e-4 of each parameter's largest or twice
   the spread of the same CPU run on 1, 2 and 4 threads against all,
   where larger: this BatchNorm network amplifies rounding through its
   backward, `CONV_SPREAD_MULT`);
17. ResNet-50 through `model.FeedForward` as `examples/train_imagenet.py
   --trainer feedforward` runs it ('full' pooling, SGD lr 0.1,
   `Xavier(gaussian, 2)`, kvstore 'device', float32) on an `NDArrayIter`
   of 8 synthetic batches of 64 (cut from 256): ms a batch, images/s,
   the running cross-entropy finite;
18. the other `BASELINE.json` configurations, 2 steps each through
   `SPMDTrainer` (ms a step, the mean NLL finite, no kernel of the table
   launched) and the check of phase 16 at a small size: Inception-BN at
   224 (bf16, batch 32; checked at batch 2), the LSTM LM at
   `examples/lstm_bucketing.py`'s defaults (2 layers, hidden and embed
   64, vocab 64, batch 32, bucket 32, Adam; checked at batch 4) and
   FCN-8s at `examples/fcn_xs.py`'s (21 classes, 64x64, batch 4, SGD,
   bilinear upscore kernels; checked at batch 1 with its Dropouts at
   p = 0).

It prints each phase's seconds, a ``kernels`` JSON line (launches,
errors, times, bounds; the float32 flash forward's and backward's routes
and float32 fused CE functions as entries of their own, launched on the
float32 paths; a kernel launched on no path fails the run), the card's
name and power limit, and as its last line ``{"ok": true, "device":
{"platform": "gpu", ...}}``.  It writes the full
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
import re
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
from mxnet_tpu_torch.ops.pallas_kernels import layer_norm as lnm
from mxnet_tpu_torch.ops.pallas_kernels.flash_attention import (
    _delta, _flash_bwd_cuda, _flash_bwd_plain, _flash_fwd_cuda,
    _flash_fwd_plain, _to_ds, flash_attention, flash_attention_bsd,
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
# TF32 on the tensor cores: the float32 flash forward's and backward's
# and the fused CE head's products run there in 3xTF32, three TF32
# products for each float32 one, so their least time is 3x their
# operations at this rate
PEAK_TF32 = 495e12

# GPT-2 small's published widths (vocab 50257, context 1024, 12 layers,
# 12 heads, embed 768, ffn 3072, biases on)
GPT2 = dict(vocab_size=50257, seq_len=1024, num_layers=12, num_heads=12,
            num_embed=768, num_ffn_hidden=3072, use_bias=True)

# Tolerances of the kernel checks, as (rtol, atol) on |kernel - plain|:
# * float32: kernel and plain version do the same float32 arithmetic and
#   differ only in the order of their sums (block tree vs torch reduction,
#   32-key vs 256-key softmax blocks) and in rsqrtf's last bit, a few ulp
#   (~1e-7 relative), and the flash forward's products run in 3xTF32
#   (~2**-22 of each, ~1e-6 of the output); 1e-5 still catches any wrong
#   formula, mask or offset;
# * bfloat16 LayerNorm: both round the same float32 result to bf16, so an
#   element may land one bf16 ulp apart, at most 2**-7 of its value;
# * bfloat16 flash attention: ``REL_TOL`` below.
# The bf16 flash forward and backward (phases 2 and 11) are held to
# ``REL_TOL`` (7e-3 of max|ref|) against the plain versions run in
# float32 on float32 copies of the same bf16 operands and residuals: the
# tensor-core kernels round p (and ds) to bf16 as the mma's operand where
# the plain version does not, and the plain version's own bf16 output
# rounding (~2.8e-3 of max|ref|) would take most of the bar; the bf16
# plain comparison is printed beside it.  lse is float32 in both and held
# at the float32 tolerance.
TOL = {("layer_norm", torch.float32): (1e-5, 1e-5),
       ("layer_norm", torch.bfloat16): (2 ** -7, 1e-5),
       ("flash_attention", torch.float32): (1e-5, 1e-5)}

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
#   to 1024 keys or 32768 rows), ~1e-6 of the largest value; the float32
#   flash and fused CE products run in 3xTF32 (each operand split into two
#   TF32 terms; the dropped lo * lo term and lo's rounding cost ~2**-22 of
#   each product), which keeps it near that; 1e-4 leaves 100x headroom;
# * bfloat16: the 7e-3 bar the JAX package's Pallas kernels held against
#   their jnp twins (BENCH_r05.json pallas_parity, flash_bwd_bsd_full_dq
#   0.007143).
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 7e-3}

# Gradient check (phase 7): one step's float32 gradients through the
# kernels against the plain versions, max |dg| / max |g| per parameter.
# The two differ in summation order (LayerNorm reductions, attention
# blocks, and the embedding's scatter-add, whose atomics add in another
# order on every run) and in the flash kernels' 3xTF32 products (~2**-22
# of each): ~1e-6.  The key-projection biases' true gradient is
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
# reports bf16, so the flash and fused CE rows name the bf16 tensor-core
# sources; their float32 launches run the sources of `F32_SOURCE` (the
# float32 flash forward and backward and fused CE head, on the tensor
# cores in 3xTF32), which have entries of their own (`F32_ROWS`).
TPU = "mxnet_tpu/ops/pallas_kernels/"
KERNEL_ROWS = [
    ("layer_norm", "layer_norm.cu", TPU + "layer_norm.py:93",
     ["layer_norm"]),
    ("layer_norm_bwd", "layer_norm.cu", TPU + "layer_norm.py:119",
     ["layer_norm_bwd"]),
    ("flash_attention", "flash_attention_fwd.cu",
     TPU + "flash_attention.py:155",
     ["flash_attention"]),
    ("flash_attention_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:372",
     ["flash_attention_dq", "flash_attention_dkv"]),
    ("flash_attention_bsd", "flash_attention_fwd.cu",
     TPU + "flash_attention.py:988", ["flash_attention_bsd"]),
    ("flash_attention_bsd_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:1158",
     ["flash_attention_bsd_dq", "flash_attention_bsd_dkv"]),
    # the dS layout: the kernels' S-contiguous orientation
    ("flash_attention_ds", "flash_attention_fwd.cu",
     TPU + "flash_attention.py:623", ["flash_attention_ds"]),
    ("flash_attention_ds_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:794",
     ["flash_attention_ds_dq", "flash_attention_ds_dkv"]),
    # the grid-streamed bsd structure: rows 7 and 8's kernels on their
    # own counters
    ("flash_attention_bsd_stream", "flash_attention_fwd.cu",
     TPU + "flash_attention.py:1342", ["flash_attention_bsd_stream"]),
    ("flash_attention_bsd_stream_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:1510",
     ["flash_attention_bsd_stream_dq", "flash_attention_bsd_stream_dkv"]),
    # the 5-pass backward (row 12) is kernels D and C; its launches are
    # D's, on the 5-pass run
    ("fused_ce_fwd", "fused_ce_bf16.cu", TPU + "fused_ce.py:155",
     ["fused_ce_fwd"]),
    ("fused_ce_bwd", "fused_ce_bf16.cu", TPU + "fused_ce.py:289",
     ["fused_ce_bwd_dx", "fused_ce_bwd_dw"]),
    ("fused_ce_fwd_sp", "fused_ce_bf16.cu", TPU + "fused_ce.py:520",
     ["fused_ce_fwd_sp"]),
    ("fused_ce_bwd_dw_rs", "fused_ce_bf16.cu", TPU + "fused_ce.py:700",
     ["fused_ce_bwd_dw"]),
    ("fused_ce_bwd_dx_rs", "fused_ce_bf16.cu", TPU + "fused_ce.py:744",
     ["fused_ce_bwd_dx"]),
]
F32_SOURCE = {"layer_norm.cu": "layer_norm.cu",
              "flash_attention_fwd.cu": "flash_attention_fwd_f32.cu",
              "flash_attention_bwd.cu": "flash_attention_bwd_f32.cu",
              "fused_ce_bf16.cu": "fused_ce_f32.cu"}
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
# each flash route's calls whose head width was zero-padded to the
# kernels' or sent to the plain versions (below 32)
for _name, _fn, _prefix in (
        ("flash_attention", flash_attention, ""),
        ("flash_attention_ds", flash_attention, "ds_"),
        ("flash_attention_bsd", flash_attention_bsd, ""),
        ("flash_attention_bsd_stream", flash_attention_bsd, "stream_")):
    COUNTERS[_name + "_padded"] = (_fn, _prefix + "padded_calls")
    COUNTERS[_name + "_narrow"] = (_fn, _prefix + "narrow_calls")
# the bf16 fused CE calls whose d was zero-padded to a multiple of 8
for _name in ("fused_ce_fwd", "fused_ce_fwd_sp", "fused_ce_bwd_dw",
              "fused_ce_bwd_dx"):
    COUNTERS[_name + "_padded"] = (COUNTERS[_name][0], "padded_calls")
del _name, _fn, _prefix


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


def bound_ms(nbytes, flops, dtype, peak=None):
    """The least time for ``nbytes`` of memory traffic and ``flops``
    operations at ``peak`` (the dtype's `PEAK_FLOPS` unless given), and
    which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
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


def ptxas_info(name):
    """ptxas's registers and spill bytes per kernel of source ``name``, from
    its build log: {mangled kernel name: {"registers": n, "spill_bytes":
    (stores, loads)}}."""
    out, kernel = {}, None
    for ln in _build.build_log(name).splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1]
            out[kernel] = {}
        elif "spill stores" in ln and kernel is not None:
            words = ln.split()
            out[kernel]["spill_bytes"] = (
                int(words[words.index("spill") - 2]),
                int(words[words.index("loads") - 3]))
        elif "Used" in ln and "registers" in ln and kernel is not None:
            out[kernel]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def mma_ptxas(source, d, layout):
    """ptxas's registers and spill bytes of the tensor-core flash kernels of
    ``source`` at head_dim ``d`` in ``layout`` (0 or 1), by kernel: 'fwd',
    or the backward's 'bwd_dq' and 'bwd_dkv' (bf16 `wgmma`, or the float32
    ones in 3xTF32)."""
    tag = "ILi%dELb%dE" % (d, layout)
    return {re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_(mma|tf32)_kernel",
                      k).group(1):
            v for k, v in ptxas_info(source).items() if tag in k}


def ce_ptxas(dtype, mode, d):
    """ptxas's registers and spill bytes of the fused CE kernel that runs
    ``mode`` (0 A, 1 B, 2 C, 3 D) at width ``d``: the tensor-core template
    at the cluster size and warpgroup width that `launch_d` picks, in
    `csrc/fused_ce_bf16.cu` (chunks of 64 columns a warpgroup) or
    `csrc/fused_ce_f32.cu` (64 or 96 columns a warpgroup)."""
    if dtype == torch.bfloat16:
        chunks = -(-(d + d % 8) // 64)
        cl = next((c for c in (1, 2, 4, 8) if 6 * c >= chunks), 8)
        tag = "fused_ce_mma_kernelILi%dELi%dELi%dELb%dE" % (
            mode, cl, min(3, -(-chunks // (2 * cl))), chunks > 48)
        source = "fused_ce_bf16"
    else:
        cl = next((c for c in (1, 2, 4, 8) if 192 * c >= d), 8)
        tag = "fused_ce_tf32_kernelILi%dELi%dELi%dELb%dE" % (
            mode, cl, 64 if 128 * cl >= d else 96, d > 1536)
        source = "fused_ce_f32"
    return next(v for k, v in ptxas_info(source).items() if tag in k)


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
               batch=1, strided=False, misaligned=False):
    """One flash check; ``strided`` passes (batch, seq, heads, d) tensors
    transposed to (batch, heads, seq, d) views, as the serving prefill
    does; ``misaligned`` hands over a k whose sequence stride (d + 2) is
    no multiple of 16 bytes, which the float32 wrapper copies.  Every
    kernel must give the same bits twice."""
    def make(s):
        t = torch.randn(batch, s, heads, d, device="cuda", generator=gen)
        t = t.to(dtype).transpose(1, 2)
        return t if strided else t.contiguous()
    q, k, v = make(sq), make(skv), make(skv)
    if misaligned:
        k = torch.zeros(batch, heads, skv, d + 2, device="cuda",
                        dtype=dtype)[..., :d].copy_(k)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    again = flash_attention(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    rout, rlse = flash_attention_plain(q, k, v, with_lse=True, **kw)
    same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    if dtype == torch.bfloat16:
        # held against the plain version in float32 on the same operands
        # (see REL_TOL); the bf16 plain one printed beside it
        r32, rlse = flash_attention_plain(q.float(), k.float(), v.float(),
                                          with_lse=True, **kw)
        err, rel, ok = rel_check(dtype, [(out, r32)])
        extra = {"rel_err": rel, "rel_tol": REL_TOL[dtype],
                 "reference": "plain float32 on the bf16 operands",
                 "bf16_plain_rel_err": rel_check(dtype, [(out, rout)])[1]}
    else:
        err, ok, tol = check("flash_attention", dtype, out, rout)
        extra = {"rtol": tol[0], "atol": tol[1]}
    extra["bit_identical"] = same
    ok = ok and same
    e2, ok2, _ = check("flash_attention", torch.float32, lse, rlse)
    err, ok = max(err, e2), ok and ok2
    lk = k.contiguous() if misaligned else k  # SDPA refuses such rows
    if causal and (q_off, k_off) == (0, 0) and sq == skv:
        lib = lambda: F.scaled_dot_product_attention(q, lk, v, is_causal=True)
    elif causal:
        qpos = q_off + torch.arange(sq, device="cuda")[:, None]
        mask = qpos >= k_off + torch.arange(skv, device="cuda")[None, :]
        lib = lambda: F.scaled_dot_product_attention(q, lk, v, attn_mask=mask)
    else:
        lib = lambda: F.scaled_dot_product_attention(q, lk, v)
    isz = q.element_size()
    nbytes = batch * heads * (2 * sq * d + 2 * skv * d) * isz
    flops = 4 * d * batch * heads * visible_pairs(sq, skv, causal, q_off,
                                                  k_off)
    bnd, by = bound_ms(nbytes, flops, dtype)
    if dtype == torch.float32:
        # 3xTF32 on the tensor cores, the CUDA-core bound beside it
        extra["bound_cuda_core_ms"] = bnd
        bnd, by = bound_ms(nbytes, 3 * flops, dtype, PEAK_TF32)
    return {
        "kernel": "flash_attention", "shape": [batch, heads, sq, skv, d],
        "causal": causal, "q_offset": q_off, "k_offset": k_off,
        "strided": strided, "misaligned": misaligned,
        "dtype": str(dtype), "max_abs_err": err, "ok": ok, **extra,
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
    # a k whose rows the float32 kernel cannot copy 16 bytes at a time: the
    # wrapper's aligned copy, at head 128 with an offset
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(flash_case(200, 260, True, 60, 0, dtype, gen, heads=4,
                                d=128, misaligned=True))
    # row widths off the 256-thread grid, up to the register kernels' widest
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


def time_cold_ms(fn, reps=25, scratch_mb=128):
    """Device time of one call of ``fn`` from a cold L2: before each call
    a ``scratch_mb`` MB buffer (over twice the H100's 50 MB L2) is written,
    then a spin kernel covers the host's enqueue of the call, which runs
    alone between two CUDA events; the median over ``reps`` calls."""
    scratch = torch.empty(scratch_mb << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int(max(0.2, 2 * host_ms) * spin_cycles_per_ms())
    times = []
    for i in range(reps):
        scratch.fill_(i)
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del scratch
    return statistics.median(times)


def ln_plans(x, gamma, dy):
    """The forward's and backward's launch plans for these operands, as
    the wrappers make them."""
    rows, n = x.shape
    sms = lnm._sm_count(x.device.index)
    align = lnm._alignment(x.data_ptr(), gamma.data_ptr(), dy.data_ptr())
    fwd = lnm._plan_fwd(rows, n, x.dtype, align, sms)
    bwd = lnm._bwd_plan_on(rows, n, x.dtype, align, x.device.index)
    return {"fwd": fwd._asdict(), "bwd": bwd._asdict()}


def ln_ptxas(dtype, plan, kind):
    """ptxas's registers and spill bytes of the LayerNorm kernel that runs
    ``plan`` (a dict of `ln_plans`) for ``kind`` ('fwd' or 'bwd')."""
    t = "f" if dtype == torch.float32 else "13__nv_bfloat16"
    vw = plan["vec_bytes"] // (4 if dtype == torch.float32 else 2)
    tag = ("ln_%s_wide_kernelI%sLi%dEE" % (kind, t, vw)
           if plan["layout"] == "wide" else
           "ln_%s_kernelI%sLi%dELi%dEE" % (kind, t, vw, plan["ept"]))
    return next(v for k, v in ptxas_info("layer_norm").items() if tag in k)


def layer_norm_train_case(rows, dtype, gen, n=768, timed=True, offset=0):
    """LayerNorm forward and backward at (rows, n): kernels against plain
    versions (the backward from the same statistics), each launched twice
    on the same inputs and required to give the same bits, with the plans
    they ran; ``offset`` starts x and dy that many elements past a 16-byte
    boundary (a sliced view: a narrower vector).  When timed, both
    passes' times with inputs warm in L2 and cold (`time_cold_ms`), each
    beside the bytes bound, `F.layer_norm`'s and the plain version's, and
    the ptxas numbers of the kernels that ran."""
    def rnd(*shape, scale=1.0, shift=0.0):
        t = torch.randn(*shape, device="cuda", generator=gen)
        return (t * scale + shift).to(dtype)

    def view(t):
        # the rows of a buffer ``offset`` elements longer, from element
        # ``offset`` on
        if not offset:
            return t
        out = torch.empty(rows * n + offset, device="cuda", dtype=dtype)
        out = out[offset:].view(rows, n)
        return out.copy_(t)
    x, dy = view(rnd(rows, n)), view(rnd(rows, n))
    gamma, beta = rnd(n, scale=0.1, shift=1.0), rnd(n, scale=0.1)
    y, mean, rstd = layer_norm_fwd(x, gamma, beta, 1e-5)
    dx, dg, db = layer_norm_bwd(x, gamma, mean, rstd, dy)
    fwd2 = layer_norm_fwd(x, gamma, beta, 1e-5)
    bwd2 = layer_norm_bwd(x, gamma, mean, rstd, dy)
    torch.cuda.synchronize()
    same_f = all(torch.equal(a, b) for a, b in zip((y, mean, rstd), fwd2))
    same_b = all(torch.equal(a, b) for a, b in zip((dx, dg, db), bwd2))
    del fwd2, bwd2
    ry, rmean, rrstd = layer_norm_fwd_plain(x, gamma, beta, 1e-5)
    rdx, rdg, rdb = layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
    f_err = rel_check(dtype, [(y, ry)])
    stats = rel_check(torch.float32, [(mean, rmean), (rstd, rrstd)])
    f_err = (max(f_err[0], stats[0]), max(f_err[1], stats[1]),
             f_err[2] and stats[2] and same_f)
    b_err = rel_check(dtype, [(dx, rdx), (dg, rdg), (db, rdb)])
    b_err = (b_err[0], b_err[1], b_err[2] and same_b)
    plans = ln_plans(x, gamma, dy)
    extra = [{"bit_identical": same_f, "plan": plans["fwd"]},
             {"bit_identical": same_b, "plan": plans["bwd"]}]
    if offset:
        extra[0]["offset"] = extra[1]["offset"] = offset
    if not timed:
        return [dict(_record("layer_norm", [rows, n], dtype, f_err, False),
                     **extra[0]),
                dict(_record("layer_norm_bwd", [rows, n], dtype, b_err,
                             False), **extra[1])]
    isz = x.element_size()
    fb = bound_ms(2 * rows * n * isz + 2 * n * isz + 2 * rows * 4,
                  8 * rows * n, dtype)
    bb = bound_ms(3 * rows * n * isz + 3 * n * isz + 2 * rows * 4,
                  13 * rows * n, dtype)
    leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
    lib_fwd = lambda: F.layer_norm(leaves[0], (n,), leaves[1], leaves[2],
                                   1e-5)
    fwd = lambda: layer_norm_fwd(x, gamma, beta, 1e-5)
    bwd = lambda: layer_norm_bwd(x, gamma, mean, rstd, dy)
    recs = [
        _record("layer_norm", [rows, n], dtype, f_err, True,
                ms=time_auto(fwd), cold_ms=time_cold_ms(fwd),
                plain_ms=time_auto(
                    lambda: layer_norm_fwd_plain(x, gamma, beta, 1e-5)),
                library_ms=time_auto(
                    lambda: F.layer_norm(x, (n,), gamma, beta, 1e-5)),
                bound_ms=fb[0], bound_by=fb[1]),
        _record("layer_norm_bwd", [rows, n], dtype, b_err, True,
                ms=time_auto(bwd), cold_ms=time_cold_ms(bwd),
                plain_ms=time_auto(
                    lambda: layer_norm_bwd_plain(x, gamma, mean, rstd, dy)),
                library_ms=_library_bwd_ms(lib_fwd, leaves, dy),
                bound_ms=bb[0], bound_by=bb[1])]
    for rec, more, kind in zip(recs, extra, ("fwd", "bwd")):
        rec.update(more)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["cold_bound_share"] = rec["bound_ms"] / rec["cold_ms"]
        rec["ptxas"] = ln_ptxas(dtype, more["plan"], kind)
    if n == 768:
        # the backward's two kernels: the row kernel and the column sums
        # of the blocks' partial rows, from one profiled call
        _, _, device, _ = profiled(bwd)
        recs[1]["kernel_split_ms"] = {
            "rows": kernel_ms(device, "ln_bwd_kernel"),
            "column_sums": kernel_ms(device, "ln_bwd_reduce_kernel")}
    return recs


def layer_norm_layout_checks(gen):
    """LayerNorm forward and backward in each layout and vector width the
    plans pick, each against the plain version and twice bit for bit: N
    = 30 in bf16 (4-byte vectors; a prefill's 1000 rows take 4 warps a
    row), 1000 in float32 (64 rows: 8 warps a row), GPT-2 medium's 1024 in
    both dtypes (a warp a row, 32 elements a lane), 8192 (a block of 8
    warps a row) in both, 12300 in bf16 (the wide loop at 8-byte vectors,
    in `training_kernel_checks`), and x and dy one element past a 16-byte
    boundary (single elements) at 768; decode's (8, 768) takes 8 warps a
    row (`training_kernel_checks`)."""
    cases = []
    for rows, n, dtype, offset in (
            (1000, 30, torch.bfloat16, 0), (64, 1000, torch.float32, 0),
            (2048, 1024, torch.float32, 0), (2048, 1024, torch.bfloat16, 0),
            (256, 8192, torch.float32, 0), (256, 8192, torch.bfloat16, 0),
            (2000, 768, torch.bfloat16, 1), (2000, 768, torch.float32, 1)):
        cases += layer_norm_train_case(rows, dtype, gen, n=n, timed=False,
                                       offset=offset)
    return cases


def flash_train_case(layout, batch, heads, d, dtype, gen, sq=1024,
                     skv=1024, causal=True, q_off=0, k_off=0, timed=True,
                     misaligned=False):
    """Flash attention forward and backward as training runs it: (B, H, S,
    D) views of (B, S, H, D) projections ('bhsd', the graph's transposes;
    'ds', the same through the dS route) or (B, S, E) operands through
    `flash_attention_bsd` ('bsd'; 'stream', the grid-streamed route's
    pin).  Out, lse, dq, dk and dv of the kernels (lse cotangent
    included) against the plain versions, with the launches counted on
    the layout's route alone; when timed, each pass's time beside
    `scaled_dot_product_attention`'s.  On 'ds' the kernels' times are
    those of the kernels on the dS operands; ``route_ms`` adds the
    route's boundary copies.  ``misaligned`` ('bhsd') hands over a k whose
    sequence stride (d + 2) is no multiple of 16 bytes, which the
    wrappers copy before both passes."""
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
        if misaligned:
            k = torch.zeros(batch, heads, skv, d + 2, device="cuda",
                            dtype=dtype)[..., :d].copy_(k)
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
        extra_fwd, extra_bwd = {}, {}
        if dtype == torch.bfloat16:
            # held against the plain forward in float32 on float32 copies
            # of the same operands (see REL_TOL); the bf16 plain one printed
            out32, lse32 = _flash_fwd_plain(
                *(t.float() for t in (q4, k4, v4)), *args)
            f_err = combine(rel_check(dtype, [(o4, out32)]),
                            rel_check(torch.float32, [(lse, lse32)]))
            del out32, lse32
            extra_fwd = {"reference": "plain float32 on the bf16 operands",
                         "bf16_plain_rel_err": rel_check(
                             dtype, [(out, rout)])[1]}
        else:
            f_err = combine(rel_check(dtype, [(out, rout)]),
                            rel_check(torch.float32, [(lse, rlse)]))
        # two launches on the same inputs: bit-identical out and lse (no
        # atomics, in either dtype)
        once = _flash_fwd_cuda(kq, kk, kv, *args, True, route)
        again = _flash_fwd_cuda(kq, kk, kv, *args, True, route)
        same = all(torch.equal(a, b) for a, b in zip(once, again))
        del once, again
        f_err = (f_err[0], f_err[1], f_err[2] and same)
        extra_fwd["bit_identical"] = same
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
            # two launches of the 3xTF32 kernels on the same inputs:
            # bit-identical gradients (no atomics)
            once = _flash_bwd_cuda(kq, kk, kv, ko, lse, kg, glse, *args,
                                   route)
            again = _flash_bwd_cuda(kq, kk, kv, ko, lse, kg, glse, *args,
                                    route)
            same = all(torch.equal(a, b) for a, b in zip(once, again))
            del once, again
            b_err = (b_err[0], b_err[1], b_err[2] and same)
            extra_bwd = {"bit_identical": same}
        if misaligned:
            extra_fwd["misaligned"] = extra_bwd["misaligned"] = True
        if not timed:
            return [dict(_record(name, shape, dtype, f_err, False),
                         **extra_fwd),
                    dict(_record(name + "_bwd", shape, dtype, b_err, False),
                         **extra_bwd)]
        isz = q.element_size()
        pairs = visible_pairs(sq, skv, causal, q_off, k_off) * batch * heads
        # operations per visible pair: 2·d for each product the function
        # needs, Q Kᵀ and P V forward; Q Kᵀ once, dO Vᵀ, dV, dQ and dK
        # backward (the two-pass kernels' recompute of Q Kᵀ and dO Vᵀ is
        # not work the function needs)
        fwd_bytes = (batch * heads * d * (2 * sq + 2 * skv) * isz
                     + batch * heads * sq * 4)
        fb = bound_ms(fwd_bytes, 4 * d * pairs, dtype)
        bwd_bytes = (batch * heads * d * (4 * sq + 4 * skv) * isz
                     + 2 * batch * heads * sq * 4)
        bb = bound_ms(bwd_bytes, 10 * d * pairs, dtype)
        if dtype == torch.float32:
            # the float32 kernels' products run in 3xTF32 on the tensor
            # cores, three TF32 products for each: their least time is at
            # that rate; the CUDA-core bounds are kept beside them
            fb_cuda_core, bb_cuda_core = fb[0], bb[0]
            fb = bound_ms(fwd_bytes, 3 * 4 * d * pairs, dtype, PEAK_TF32)
            bb = bound_ms(bwd_bytes, 3 * 10 * d * pairs, dtype, PEAK_TF32)
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
                      bound_ms=fb[0], bound_by=fb[1], **extra_fwd)
        if layout == "ds":
            fwd["route_ms"] = time_auto(route_fwd)
        # the rate the function's 4·d operations a visible pair reach
        fwd["tflops"] = 4 * d * pairs / (fwd["ms"] * 1e-3) / 1e12
        fwd["bound_share"] = fwd["bound_ms"] / fwd["ms"]
        if dtype == torch.bfloat16:
            fwd["ptxas"] = mma_ptxas("flash_attention_fwd", d,
                                     int(layout == "ds"))
        else:
            fwd["bound_cuda_core_ms"] = fb_cuda_core
            fwd["ptxas"] = mma_ptxas("flash_attention_fwd_f32", d,
                                     int(layout == "ds"))
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
            bwd["ptxas"] = mma_ptxas("flash_attention_bwd", d,
                                     int(layout == "ds"))
        else:
            bwd["bound_cuda_core_ms"] = bb_cuda_core
            bwd["ptxas"] = mma_ptxas("flash_attention_bwd_f32", d,
                                     int(layout == "ds"))
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
    if "cold_ms" in c:
        line += ("; cold L2 %.4f ms; bound share warm %.3f, cold %.3f"
                 % (c["cold_ms"], c["bound_share"], c["cold_bound_share"]))
    if "kernel_split_ms" in c:
        line += "; kernels %s" % c["kernel_split_ms"]
    if "plan" in c:
        line += "; plan %s" % c["plan"]
    if "ms_with_launch" in c:
        line += "; kernel with launch %.4f ms" % c["ms_with_launch"]
    if "route_ms" in c:
        line += "; route with its boundary copies %.4f ms" % c["route_ms"]
    if "tflops" in c and c["kernel"].startswith("fused_ce"):
        line += ("; %.1f TFLOP/s (2·n·V·d a logit pass), %.3f of the bound"
                 % (c["tflops"], c["bound_share"]))
    elif "tflops" in c:
        line += ("; %.1f TFLOP/s (%s·d a visible pair), %.3f of the bound"
                 % (c["tflops"], 10 if "delta_ms" in c else 4,
                    c["bound_share"]))
    if "bound_cuda_core_ms" in c:
        line += ("; the bound is 3xTF32's, the CUDA-core one %.4f ms"
                 % c["bound_cuda_core_ms"])
    if "delta_ms" in c:
        line += "; the wrapper's delta %.4f ms of it" % c["delta_ms"]
    if "bf16_plain_rel_err" in c:
        line += ("; vs the plain f32 version on the bf16 operands, beside "
                 "it the bf16 plain one %.2e; bit-identical twice: %s"
                 % (c["bf16_plain_rel_err"], c["bit_identical"]))
    if c.get("reference") == "plain bf16" or (
            "bit_identical" in c and "bf16_plain_rel_err" not in c):
        line += "; bit-identical twice: %s" % c["bit_identical"]
    if any(c.get("padded_calls", {}).values()):
        line += "; padded calls %s" % c["padded_calls"]
    if "ptxas" in c:
        line += "; ptxas registers, spill (stores, loads) bytes %s" % c[
            "ptxas"]
    return line


def width_case(d, dtype, layout, gen, batch=2, heads=3, s=200, q_off=24):
    """Flash attention at head_dim ``d`` through the public function and
    route of ``layout`` (a key of `FLASH_LAYOUTS`), forward and backward
    (lse cotangent included), against the plain versions: float32 against
    float32 at ``REL_TOL``; bf16 against the plain versions in float32 on
    the same bf16 operands, as the kernels' own checks.  The call must
    count on its route: below 32 one plain-route call and no launch; 32
    to 127 one padded call and one forward, dq and dk/dv launch."""
    pins, name, route = FLASH_LAYOUTS[layout]
    bsd = layout in ("bsd", "stream")
    fn = flash_attention_bsd if bsd else flash_attention
    plain = flash_attention_bsd_plain if bsd else flash_attention_plain
    extra = (heads,) if bsd else ()

    def make():
        t = torch.randn(batch, s, heads, d, device="cuda", generator=gen)
        t = t.to(dtype)
        return t.reshape(batch, s, heads * d) if bsd else t.transpose(1, 2)

    q, k, v, g = make(), make(), make(), make()
    glse = torch.randn(batch, heads, s, device="cuda", generator=gen)

    def through(f, ts):
        leaves = [t.detach().clone().requires_grad_() for t in ts]
        out, lse = f(*leaves, *extra, causal=True, q_offset=q_off,
                     with_lse=True)
        torch.autograd.backward((out, lse), (g.to(out.dtype), glse))
        return [out, lse] + [t.grad for t in leaves]

    with pinned(**pins):
        reset_counts()
        got = through(fn, (q, k, v))
        torch.cuda.synchronize()
        launched = {c: n for c, n in read_counts().items() if n}
    want = ({name + "_narrow": 1} if d < 32 else
            {name: 1, name + "_dq": 1, name + "_dkv": 1, name + "_padded": 1})
    ref = through(plain, [t.float() for t in (q, k, v)])
    err = combine(rel_check(dtype, [(got[0], ref[0])] + list(zip(got[2:],
                                                                  ref[2:]))),
                  rel_check(torch.float32, [(got[1], ref[1])]))
    rec = _record("flash_attention width %d (%s)" % (d, layout),
                  [batch, heads, s, s, d], dtype,
                  (err[0], err[1], err[2] and launched == want), False)
    rec["launches"] = launched
    return rec


def width_checks(gen):
    """The head widths the kernels do not take natively, on every route in
    both dtypes, and a head of 160, which the kernel routes refuse."""
    cases = [width_case(d, dtype, layout, gen)
             for d in (16, 32, 48, 80, 96)
             for dtype in (torch.float32, torch.bfloat16)
             for layout in FLASH_LAYOUTS]
    x = torch.zeros(1, 2, 64, 160, device="cuda")
    for fn, args in ((flash_attention, (x, x, x)),
                     (flash_attention_bsd, (x[0], x[0], x[0], 1))):
        try:
            fn(*args, causal=True)
            raised = False
        except mx.MXNetError as e:
            raised = "160" in str(e)
        cases.append(_record("%s width 160 raises" % fn.__name__,
                             [1, 2, 64, 64, 160], torch.float32,
                             (0.0, 0.0, raised), False))
    return cases


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
    # the bf16 kernels' ragged tiles at head 128, in both layouts: the
    # causal diagonal 37 positions into a 64-position tile, a 13-position
    # tail (333 = 5 * 64 + 13, not a multiple of 8: the dS copies pad their
    # rows), and rows that see no key (k_off 50)
    for layout in ("bhsd", "ds"):
        cases += flash_train_case(layout, 2, 3, 128, torch.bfloat16, gen,
                                  sq=333, skv=333, q_off=37, timed=False)
        cases += flash_train_case(layout, 2, 2, 128, torch.bfloat16, gen,
                                  sq=200, skv=333, k_off=50, timed=False)
    # a bf16 k the kernels cannot read in place (sequence stride d + 2):
    # copied by the wrappers before the forward and both backward passes
    cases += flash_train_case("bhsd", 2, 4, 128, torch.bfloat16, gen,
                              sq=200, skv=260, q_off=60, timed=False,
                              misaligned=True)
    cases += width_checks(gen)
    # rows wider than the LayerNorm register kernels hold: the wide-row
    # kernels, at a power of two (timed) and a ragged width
    for dtype in (torch.float32, torch.bfloat16):
        cases += layer_norm_train_case(1024, dtype, gen, n=16384)
        cases += layer_norm_train_case(64, dtype, gen, n=12300, timed=False)
    cases += layer_norm_layout_checks(gen)
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
# ragged ones: no multiple of the tiles in tokens or vocabulary (GPT-2's),
# at GPT-2 small's, medium's and XL's widths (1600: past the widest float32
# cluster's 1536 columns), at 4096 (past the widest bf16 cluster's 3072),
# and one whose bf16 d the wrapper zero-pads from 772 to 776
CE_RAGGED = (1000, 768, 50257)
CE_MEDIUM = (8192, 1024, 50257)
CE_XL = (1000, 1600, 50257)
CE_WIDE = (300, 4096, 5000)
CE_PADDED = (333, 772, 1000)
# d = 30 (`get_transformer_lm(num_embed=30)`'s head): no multiple of either
# granule, zero-padded to 32 in both dtypes
CE_NARROW = (333, 30, 1000)
# the op's default tiles: a pin the kernels take (multiples of 32); the
# plain versions tile the vocabulary by block_v as the jnp twins do
CE_BLOCKS = (512, 2048)
# each checked function's kernel modes (0 A, 1 B, 2 C, 3 D)
CE_MODES = {"fused_ce_fwd": (0,), "fused_ce_fwd_sp": (1,),
            "fused_ce_bwd_dw_rs": (2,), "fused_ce_bwd_dx_rs": (3,),
            "fused_ce_bwd": (3, 2)}


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
    plain versions on the same inputs, in the same dtype.  Outputs that
    are float32 by contract (nll, lse, the picked logit) are held to the
    float32 tolerance; dxp (p rounded to W's dtype before p @ W), dx, dW
    and db to the dtype's.  Every kernel runs twice and must give the
    same bits, and a bf16 d of 4 more than a multiple of 8 must be counted
    as padded on every wrapper.  When timed: each beside its bound (in
    float32 the 3xTF32 one, the CUDA-core one beside it) and the
    library's `F.linear` + `F.cross_entropy`, forward for A and B,
    backward for the rest, with its TFLOP/s, share of the bound and
    ptxas's registers and spills."""
    n, d, v = shape
    x, w, b, label, head, r = ce_operands(n, d, v, dtype, gen, ragged)
    gs, ign, use = head
    bv = CE_BLOCKS[1]
    kernels = {
        "fused_ce_fwd": lambda: fce.fused_ce_fwd(x, w, b, label, ign, use,
                                                 *CE_BLOCKS),
        "fused_ce_fwd_sp": lambda: fce.fused_ce_fwd_sp(x, w, b, label,
                                                       *CE_BLOCKS)}
    reset_counts()
    got = {k: fn() for k, fn in kernels.items()}
    torch.cuda.synchronize()
    ref = {"fused_ce_fwd": fce._fwd_plain(x, w, b, label, ign, use, bv),
           "fused_ce_fwd_sp": fce._fwd_sp_plain(x, w, b, label, bv)}
    lse = ref["fused_ce_fwd"][1]
    kernels.update({
        "fused_ce_bwd_dw_rs": lambda: fce.fused_ce_bwd_dw(
            x, w, b, label, lse, r, *CE_BLOCKS),
        "fused_ce_bwd_dx_rs": lambda: (fce.fused_ce_bwd_dx(
            x, w, b, label, lse, r, *CE_BLOCKS),),
        "fused_ce_bwd": lambda: fce.fused_ce_bwd(x, w, b, label, lse, *head,
                                                 *CE_BLOCKS)})
    got.update({k: kernels[k]() for k in ("fused_ce_bwd_dw_rs",
                                          "fused_ce_bwd_dx_rs",
                                          "fused_ce_bwd")})
    torch.cuda.synchronize()
    padded = {k: n for k, n in read_counts().items()
              if k.startswith("fused_ce") and k.endswith("_padded")}
    ref.update({
        "fused_ce_bwd_dw_rs": fce._bwd_dw_rs_plain(x, w, b, label, lse, r,
                                                   bv),
        "fused_ce_bwd_dx_rs": (fce._bwd_dx_rs_plain(x, w, b, label, lse, r,
                                                    bv),),
        "fused_ce_bwd": fce._bwd_plain(x, w, b, label, lse, *head, bv)})
    # every wrapper pads a d off the kernels' 16-byte granule (4 float32
    # or 8 bf16 columns), each call (the 5-pass backward calls D and C once
    # more), and no other
    want_pad = 1 if d % (8 if dtype == torch.bfloat16 else 4) else 0
    pad_ok = padded == {"fused_ce_fwd_padded": want_pad,
                        "fused_ce_fwd_sp_padded": want_pad,
                        "fused_ce_bwd_dw_padded": 2 * want_pad,
                        "fused_ce_bwd_dx_padded": 2 * want_pad}
    f32_outputs = {"fused_ce_fwd": 2, "fused_ce_fwd_sp": 2}
    recs = []
    for name, outs in got.items():
        k = f32_outputs.get(name, 0)
        pairs = list(zip(outs, ref[name]))
        err = combine(rel_check(torch.float32, pairs[:k]),
                      rel_check(dtype, pairs[k:]))
        # a second launch on the same inputs: the same bits
        again = kernels[name]()
        same = all(torch.equal(a, c) for a, c in zip(outs, again))
        del again
        extra = {"padded_calls": padded, "padded_ok": pad_ok,
                 "bit_identical": same}
        if dtype == torch.bfloat16:
            extra["reference"] = "plain bf16"
        err = (err[0], err[1], err[2] and same and pad_ok)
        recs.append(dict(_record(name, list(shape), dtype, err, False),
                         **extra))
    if not timed:
        return recs
    isz = x.element_size()
    # one pass over the logit tiles; each kernel recomputes its scores, but
    # the 5-pass backward as a function needs them once, then dl @ W and
    # dl^T @ x: 3 passes, not D's 2 plus C's 2
    ops = 2 * n * v * d
    passes = {"fused_ce_fwd": 1, "fused_ce_fwd_sp": 2,
              "fused_ce_bwd_dw_rs": 2, "fused_ce_bwd_dx_rs": 2,
              "fused_ce_bwd": 3}
    operands = (n * d + v * d + v) * isz + 4 * n
    nbytes = {"fused_ce_fwd": operands + 8 * n,
              "fused_ce_fwd_sp": operands + 8 * n + 4 * n * d,
              "fused_ce_bwd_dw_rs": operands + 8 * n + (v * d + v) * isz,
              "fused_ce_bwd_dx_rs": operands + 8 * n + n * d * isz,
              "fused_ce_bwd": operands + 4 * n + (n * d + v * d + v) * isz}
    bounds = {k: bound_ms(b, passes[k] * ops, dtype)
              for k, b in nbytes.items()}
    if dtype == torch.float32:
        # the float32 kernels' products run in 3xTF32 on the tensor cores,
        # three TF32 products for each: their least time is at that rate;
        # the CUDA-core bound is kept beside it
        cuda_core = {k: b[0] for k, b in bounds.items()}
        bounds = {k: bound_ms(b, 3 * passes[k] * ops, dtype, PEAK_TF32)
                  for k, b in nbytes.items()}
    plains = {
        "fused_ce_fwd": lambda: fce._fwd_plain(x, w, b, label, ign, use,
                                               bv),
        "fused_ce_fwd_sp": lambda: fce._fwd_sp_plain(x, w, b, label, bv),
        "fused_ce_bwd_dw_rs": lambda: fce._bwd_dw_rs_plain(x, w, b, label,
                                                           lse, r, bv),
        "fused_ce_bwd_dx_rs": lambda: fce._bwd_dx_rs_plain(x, w, b, label,
                                                           lse, r, bv),
        "fused_ce_bwd": lambda: fce._bwd_plain(x, w, b, label, lse, *head,
                                               bv)}
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
        bnd, by = bounds[name]
        rec.update(ms=time_auto(kernels[name]),
                   plain_ms=time_auto(plains[name]),
                   library_ms=lib["fwd" if "fwd" in name else "bwd"],
                   bound_ms=bnd, bound_by=by)
        # the rate the function's passes over the logit tiles reach
        rec["tflops"] = passes[name] * ops / (rec["ms"] * 1e-3) / 1e12
        rec["bound_share"] = bnd / rec["ms"]
        if dtype == torch.float32:
            rec["bound_cuda_core_ms"] = cuda_core[name]
        rec["ptxas"] = {m: ce_ptxas(dtype, m, d) for m in CE_MODES[name]}
    return recs


def fused_ce_checks():
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += ce_case(CE_RAGGED, dtype, gen, ragged=True)
        cases += ce_case(CE_TRAIN, dtype, gen, timed=True)
        torch.cuda.empty_cache()
        cases += ce_case(CE_MEDIUM, dtype, gen, ragged=True)
        cases += ce_case(CE_XL, dtype, gen, ragged=True)
        cases += ce_case(CE_WIDE, dtype, gen, ragged=True)
        torch.cuda.empty_cache()
    cases += ce_case(CE_PADDED, torch.bfloat16, gen, ragged=True)
    # a d off the granule in both dtypes: zero-padded to 32
    for dtype in (torch.float32, torch.bfloat16):
        cases += ce_case(CE_NARROW, dtype, gen, ragged=True)
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


def ce_mode_ms(device):
    """Device ms of the fused CE kernels by mode (A, B, C, D), from the
    template's first argument in each kernel's name."""
    out = {}
    for k, _, ms in device:
        m = re.search(r"fused_ce_(?:\w+_)?kernel<(\d)", k)
        if m:
            mode = "ABCD"[int(m.group(1))]
            out[mode] = out.get(mode, 0.0) + ms
    return out


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
           "flash_kernel_ms": kernel_ms(device, "flash_fwd_"),
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
# the fused head at GPT-2 medium's published widths (vocab 50257, context
# 1024, embed 1024, 16 heads of 64, biases), cut to 2 of its 24 layers:
# the width the CE kernels refused before
MEDIUM_FUSED = dict(vocab_size=50257, seq_len=1024, num_layers=2,
                    num_embed=1024, num_heads=16, use_bias=True,
                    attn_layout="bhsd", fused_head=True)
MEDIUM_BATCH = 4


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
               after=None, batch=TRAIN_BATCH, pins=None, dtype="bfloat16"):
    """Train ``cfg`` at full width, in ``dtype`` (bf16 unless given), at
    ``batch`` (32 unless given) under the ``MXNET_*`` ``pins`` (set for
    the path and restored after): ``steps`` steps (the first a warm-up,
    left out of the timing) with the counts set to 0 before and read
    after, then one profiled step.  ``expect`` maps each counter to the
    launches it must show per step (every other counter must show none);
    ``falls`` asks for the last loss below the first.  ``after(trainer,
    batch)`` runs last, on the trained model, and its result joins the
    record."""
    with pinned(**(pins or {})):
        trainer = lm_trainer(cfg, batch, dtype, **(trainer_kw or {}))
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
            "config": cfg, "batch": batch, "dtype": dtype,
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
                "flash_fwd_tf32_kernel", "flash_fwd_mma_kernel",
                "flash_bwd_dq_tf32_kernel", "flash_bwd_dkv_tf32_kernel",
                "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel",
                "fused_ce_kernel", "fused_ce_mma_kernel",
                "fused_ce_tf32_kernel")},
            "ce_mode_ms": ce_mode_ms(device),
            "top_device_ops_ms": device[:10], "top_host_ops_ms": host}
        res.update(extra)
        log("%s: %d steps of batch %d x %d tokens, %s, Adam; step ms (CUDA "
            "events) %s; median of the last %d %.2f ms = %.1f tokens/s, MFU "
            "%.4f (%.4g flops/token over the %.0f TFLOP/s dense bf16 peak); "
            "host wall ms %s"
            % (label, steps, batch, cfg["seq_len"], dtype,
               ["%.2f" % t for t in step_ms], len(timed), step,
               res["tokens_per_s"], res["mfu"], fpt, MFU_PEAK / 1e12,
               ["%.1f" % t for t in wall_ms]))
        log("%s: mean NLL per step %s" % (label, ["%.4f" % x for x in losses]))
        log("%s: launches per step %s; max_memory_allocated %d B; card after "
            "(sm clock, mem clock, power, temp): %s"
            % (label, {k: v for k, v in res["launches_per_step"].items() if v},
               peak, state))
        log("%s: profiled step %.2f ms wall, device busy %.2f ms (idle share "
            "%.4f); kernel ms %s; fused CE kernel ms by mode %s; top device "
            "ops (name, count, ms): %s"
            % (label, res["profiled_step_ms"], res["device_busy_ms"],
               res["device_idle_share"],
               {k: round(v, 3) for k, v in res["kernel_ms"].items()},
               res["ce_mode_ms"], device[:10]))
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


def five_pass_path(expect, dtype="bfloat16", after=None):
    """2 steps of the fused configuration in the 5-pass structure,
    ``MXNET_CE_SINGLE_PASS=0`` set for them and restored after; in bf16
    with `FUSED_TRAINER`'s bf16 v, in float32 with the trainer's default
    float32 v."""
    bf16 = dtype == "bfloat16"
    return train_path("train fused, 5-pass" + ("" if bf16 else " f32"),
                      FUSED, 2, expect, FUSED_TRAINER if bf16 else None,
                      falls=False, pins={"MXNET_CE_SINGLE_PASS": "0"},
                      dtype=dtype, after=after)


# --- the reference training API (phases 13 and 14) -------------------------

# BASELINE.json's first configuration, `examples/train_mnist.py`: the MLP
# (784-128-64-10) on MNIST at batch 128, SGD lr 0.1 momentum 0.9, Xavier,
# 2 epochs, on idx files `tools/make_mnist.py` writes (20000 train, 4000
# test; no network here, so rendered digits in place of MNIST's)
MNIST = dict(train=20000, test=4000, batch=128, epochs=2, lr=0.1,
             momentum=0.9)
# its bars, the card against the CPU: max |dw| over max |w| after the
# first 10 batches and after the first epoch (float32 on both, cuBLAS and
# the CPU's GEMM summing in another order: ~1e-7 after 10 batches, ~5e-7
# after 157; TF32 stays off), and the validation accuracy after the first
# epoch within MNIST_ACC_TOL.  In the second epoch two runs part in one
# batch where a ReLU input within rounding of zero lands on either side
# of it (the JAX package's runs too: `scripts/mnist_spread.py`), and CPU
# runs that differ only in their thread count end as far apart as the
# card and the CPU.  So the end of training is held to what rounding
# alone does in the same call: the CPU run on 1, 2 and 4 threads beside
# the one on all, and the card's final train and validation accuracy
# within the larger of MNIST_ACC_TOL and MNIST_SPREAD_MULT times the
# spread (max - min) over those CPU runs of the all-threads run's
MNIST_PARAM_TOL = 1e-4
MNIST_ACC_TOL = 0.01
MNIST_SPREAD_THREADS = (1, 2, 4)
MNIST_SPREAD_MULT = 2.0
# the LM through `simple_bind`: the parity configuration in float32 at
# batch 8, Adam lr 1e-3 through `get_fused_updater`
API_LM_BATCH = 8


def mnist_fit(mx_ctx, files, epochs, epoch_size=None):
    """`README.md`'s quickstart on the MNIST files: FeedForward(get_mlp())
    fit on `MNISTIter` with the validation iterator.  Returns the model,
    the wall seconds of each batch (in the callback, after the batch's
    metric update read its outputs back), the train and validation
    metric at each epoch's end, the parameters after each epoch and the
    validation iterator."""
    mx.random.seed(0)
    train = mx.io.MNISTIter(image=files["train-images"],
                            label=files["train-labels"],
                            batch_size=MNIST["batch"], flat=True)
    val = mx.io.MNISTIter(image=files["t10k-images"],
                          label=files["t10k-labels"],
                          batch_size=MNIST["batch"], flat=True,
                          shuffle=False)
    model = mx.model.FeedForward(
        mx.models.get_mlp(), ctx=mx_ctx, num_epoch=epochs,
        epoch_size=epoch_size, optimizer="sgd", learning_rate=MNIST["lr"],
        momentum=MNIST["momentum"], initializer=mx.init.Xavier())
    ticks, train_acc, val_acc, snaps = [time.perf_counter()], {}, {}, []

    def on_batch(p):
        ticks.append(time.perf_counter())
        train_acc[p.epoch] = p.eval_metric.get()[1]

    def on_eval(p):
        val_acc[p.epoch] = p.eval_metric.get()[1]

    def on_epoch(epoch, sym, arg, aux):
        snaps.append({k: v.asnumpy() for k, v in arg.items()})

    model.fit(train, eval_data=None if epoch_size else val,
              batch_end_callback=on_batch, eval_batch_end_callback=on_eval,
              epoch_end_callback=on_epoch)
    return model, np.diff(ticks), train_acc, val_acc, snaps, val


def _param_gap(a, b):
    """max |a - b| over max |b|, over every parameter."""
    wmax = max(float(np.abs(w).max()) for w in b.values())
    return max(float(np.abs(a[k] - w).max()) for k, w in b.items()) / wmax


def mnist_api_path():
    """The MLP on MNIST through `FeedForward` on the card: 2 epochs timed,
    held against the same run on the CPU; the checkpoint saved from the
    card loads on the CPU and saves the same bytes again."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "tools/make_mnist.py", "--out", tmp,
                        "--train", str(MNIST["train"]), "--test",
                        str(MNIST["test"])], check=True, capture_output=True)
        made_s = time.perf_counter() - t0
        files = {k: os.path.join(tmp, "%s-idx%d-ubyte"
                                 % (k, 3 if k.endswith("images") else 1))
                 for k in ("train-images", "train-labels", "t10k-images",
                           "t10k-labels")}
        # the first 10 batches on each device
        first = [mnist_fit(c, files, 1, epoch_size=10)[4][0]
                 for c in (mx.gpu(0), mx.cpu())]
        gap_10 = _param_gap(*first)
        # 2 epochs on the card, counts and peak memory from 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        gpu, batch_s, train_acc, val_acc, snaps, val = mnist_fit(
            mx.gpu(0), files, MNIST["epochs"])
        fit_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        state = card_state()
        cpu_model, _, cpu_train, cpu_val, cpu_snaps, cpu_val_iter = \
            mnist_fit(mx.cpu(), files, MNIST["epochs"])
        gaps = [_param_gap(a, b) for a, b in zip(snaps, cpu_snaps)]
        acc_gpu = gpu.score(val)
        acc_cpu = cpu_model.score(cpu_val_iter)
        # the same CPU run on fewer threads: how far apart rounding alone
        # puts runs of this configuration by its end
        threads = torch.get_num_threads()
        spread_runs = {}
        try:
            for n in MNIST_SPREAD_THREADS:
                if n == threads:
                    continue
                torch.set_num_threads(n)
                run = mnist_fit(mx.cpu(), files, MNIST["epochs"])
                spread_runs[n] = {
                    "val_acc": run[0].score(run[5]),
                    "train_acc": run[2][MNIST["epochs"] - 1],
                    "param_gap_by_epoch": [_param_gap(a, b) for a, b in
                                           zip(run[4], cpu_snaps)]}
        finally:
            torch.set_num_threads(threads)
        last = MNIST["epochs"] - 1
        cpu_vals = [acc_cpu] + [r["val_acc"] for r in spread_runs.values()]
        cpu_trains = [cpu_train[last]] + [r["train_acc"]
                                          for r in spread_runs.values()]
        val_bar = max(MNIST_ACC_TOL,
                      MNIST_SPREAD_MULT * (max(cpu_vals) - min(cpu_vals)))
        train_bar = max(MNIST_ACC_TOL, MNIST_SPREAD_MULT
                        * (max(cpu_trains) - min(cpu_trains)))
        # the checkpoint from the card, loaded on the CPU
        prefix = os.path.join(tmp, "mlp")
        gpu.save(prefix)
        back = mx.model.FeedForward.load(prefix, MNIST["epochs"],
                                         ctx=mx.cpu())
        mx.model.save_checkpoint(prefix + "-again", MNIST["epochs"],
                                 back.symbol, back.arg_params,
                                 back.aux_params)
        name = "-%04d.params" % MNIST["epochs"]
        same_bytes = Path(prefix + name).read_bytes() == \
            Path(prefix + "-again" + name).read_bytes()
        on_cpu = all(v.context == mx.cpu() for v in back.arg_params.values())
        val.reset()
        pred_gap = float(np.abs(back.predict(val) - gpu.predict(val)).max())
        acc_loaded = back.score(val)
    # steady state: the batches after each epoch's first
    per_epoch = len(batch_s) // MNIST["epochs"]
    steady = [t for i, t in enumerate(batch_s) if i % per_epoch]
    ms = 1e3 * statistics.median(steady)
    res = {"config": dict(MNIST, net="get_mlp() 784-128-64-10",
                          source="BASELINE.json configs[0]; README.md:19-41"),
           "mnist_files_s": made_s, "fit_s": fit_s,
           "batches": len(batch_s), "ms_per_batch_median": ms,
           "images_per_s": MNIST["batch"] / (ms / 1e3),
           "train_acc_by_epoch": train_acc, "val_acc_by_epoch": val_acc,
           "cpu_train_acc_by_epoch": cpu_train,
           "cpu_val_acc_by_epoch": cpu_val, "val_acc": acc_gpu,
           "val_acc_cpu_run": acc_cpu, "val_acc_card_model_on_cpu":
           acc_loaded, "param_gap_10_batches": gap_10,
           "param_gap_by_epoch": gaps, "param_tol": MNIST_PARAM_TOL,
           "cpu_threads": threads, "cpu_runs_by_threads": spread_runs,
           "acc_tol": MNIST_ACC_TOL, "spread_mult": MNIST_SPREAD_MULT,
           "final_val_bar": val_bar, "final_train_bar": train_bar,
           "checkpoint_same_bytes_on_cpu": same_bytes,
           "checkpoint_loaded_on_cpu": on_cpu,
           "predict_gap_card_vs_cpu_load": pred_gap,
           "launches": launches, "max_memory_allocated": peak,
           "card_after": state}
    log("api mnist: FeedForward(get_mlp()) on the card, %d batches of %d in "
        "%.2f s: median %.3f ms a batch (host clock, metric read each "
        "batch) = %.1f images/s; train acc by epoch %s, validation %s (CPU "
        "run %s, %s); card vs CPU max|dw|/max|w| after 10 batches %.3e, "
        "after each epoch %s (tol %.0e after 10 batches and epoch 1); "
        "final validation acc %.4f on the card, %.4f in the CPU run, %.4f "
        "for the card's model loaded on the CPU; the CPU run on other "
        "thread counts than %d (threads: final validation acc, final "
        "train acc, max|dw|/max|w| by epoch) %s; final bars: validation "
        "%.4f, train %.4f; checkpoint loads on the "
        "CPU (%s) and saves the same bytes (%s), predictions within %.2e; "
        "max_memory_allocated %d B; launches %s; card after %s; idx files "
        "made in %.2f s"
        % (len(batch_s), MNIST["batch"], fit_s, ms, res["images_per_s"],
           train_acc, val_acc, cpu_train, cpu_val, gap_10,
           ["%.3e" % g for g in gaps], MNIST_PARAM_TOL, acc_gpu, acc_cpu,
           acc_loaded, threads,
           {n: ("%.4f" % r["val_acc"], "%.4f" % r["train_acc"],
                ["%.3e" % g for g in r["param_gap_by_epoch"]])
            for n, r in spread_runs.items()}, val_bar, train_bar, on_cpu, same_bytes, pred_gap, peak,
           {k: v for k, v in launches.items() if v}, state, made_s))
    if not (gap_10 <= MNIST_PARAM_TOL and gaps[0] <= MNIST_PARAM_TOL):
        raise SystemExit("api mnist: the card's parameters disagree with the "
                         "CPU's")
    if not abs(val_acc[0] - cpu_val[0]) <= MNIST_ACC_TOL:
        raise SystemExit("api mnist: validation accuracy after epoch 1 %.4f "
                         "on the card, %.4f on the CPU"
                         % (val_acc[0], cpu_val[0]))
    if not (abs(acc_gpu - acc_cpu) <= val_bar and
            abs(train_acc[last] - cpu_train[last]) <= train_bar):
        raise SystemExit("api mnist: final accuracy on the card (validation "
                         "%.4f, train %.4f) beyond what rounding alone moves "
                         "on the CPU (%.4f, %.4f; bars %.4f, %.4f)"
                         % (acc_gpu, train_acc[last], acc_cpu,
                            cpu_train[last], val_bar, train_bar))
    if not (same_bytes and on_cpu and pred_gap < 1e-4 and
            abs(acc_loaded - acc_gpu) <= MNIST_ACC_TOL):
        raise SystemExit("api mnist: the card's checkpoint does not load on "
                         "the CPU as saved")
    if any(launches.values()):
        raise SystemExit("api mnist: the MLP launched a kernel of the table")
    if not min(acc_gpu, acc_cpu) > 0.5:
        raise SystemExit("api mnist: validation accuracy %.4f / %.4f, not "
                         "learning" % (acc_gpu, acc_cpu))
    return res


def api_lm_path(expect, steps=6):
    """The parity configuration in float32 through `simple_bind`: step 1's
    gradients held against `SPMDTrainer(dtype='float32')` on the same
    parameters and batch, then ``steps`` steps of forward, backward and
    Adam through `get_fused_updater`, each with exact launches, and the
    trainer's own steps at the same batch for comparison (the median of
    steps 2 on; the first allocates the optimizer state)."""
    cfg, batch = PARITY, API_LM_BATCH
    shapes = {"data": (batch, cfg["seq_len"]),
              "softmax_label": (batch, cfg["seq_len"])}
    mx.random.seed(0)
    net = mx.models.get_transformer_lm(**cfg)
    exe = net.simple_bind(mx.gpu(0), grad_req="write", **shapes)
    init = mx.init.Uniform(0.07)
    names = [n for n in net.list_arguments() if n not in shapes]
    for n in names:
        init(n, exe.arg_dict[n])
    host = lm_batch(batch, cfg)
    labels = torch.as_tensor(host["softmax_label"]).cuda()

    # the trainer on the same parameters and batch
    trainer = lm_trainer(cfg, batch, "float32")
    mx.load_params(trainer, {n: exe.arg_dict[n].data for n in names})
    ref = trainer.gradients(host)
    dev = trainer.shard_batch(host)
    trainer_ms = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        trainer.step(dev)
        b.record()
        b.synchronize()
        trainer_ms.append(a.elapsed_time(b))
    t_wall, t_busy, _, _ = profiled(lambda: trainer.step(dev))
    del trainer, dev
    torch.cuda.empty_cache()

    updater = mx.optimizer.get_fused_updater(
        mx.optimizer.Adam(learning_rate=1e-3, rescale_grad=1.0 / batch))
    idx = [net.list_arguments().index(n) for n in names]
    weights = [exe.arg_arrays[i] for i in idx]
    grads = [exe.grad_arrays[i] for i in idx]

    def step():
        outs = exe.forward(is_train=True, data=host["data"],
                           softmax_label=host["softmax_label"])
        exe.backward()
        updater(list(range(len(idx))), grads, weights)
        return outs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, wall_ms, per_step = [], [], [], []
    got = None
    for i in range(steps):
        reset_counts()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        if i == 0:
            # step 1's gradients, before the update
            outs = exe.forward(is_train=True, data=host["data"],
                               softmax_label=host["softmax_label"])
            exe.backward()
            got = {n: exe.grad_dict[n].data.clone() for n in names}
            updater(list(range(len(idx))), grads, weights)
        else:
            outs = step()
        b.record()
        b.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
        step_ms.append(a.elapsed_time(b))
        per_step.append(read_counts())
        losses.append(mean_nll(outs[0].data, labels))
    peak = torch.cuda.max_memory_allocated()
    state = card_state()
    wall, busy, device, _ = profiled(step)
    gmax = max(float(g.abs().max()) for g in ref.values())
    worst = {}
    for n, r in ref.items():
        scale = gmax if n.endswith("_k_bias") else \
            max(float(r.abs().max()), 1e-30)
        worst[n] = float((got[n] - r).abs().max()) / scale
    name = max(worst, key=worst.get)
    del exe, got, ref, outs
    torch.cuda.empty_cache()

    ms = statistics.median(step_ms[1:])
    tms = statistics.median(trainer_ms[1:])
    tokens = batch * cfg["seq_len"]
    launches = {k: sum(s[k] for s in per_step) for k in per_step[0]}
    res = {"config": cfg, "batch": batch, "dtype": "float32",
           "optimizer": "Adam lr 1e-3 (get_fused_updater)",
           "losses": losses, "step_ms": step_ms, "wall_ms": wall_ms,
           "step_ms_median": ms, "tokens_per_s": tokens / (ms / 1e3),
           "trainer_step_ms": trainer_ms, "trainer_step_ms_median": tms,
           "executor_over_trainer": ms / tms,
           "profiled_step_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy,
           "device_idle_share": 1 - busy / wall,
           "trainer_profiled_step_ms": 1e3 * t_wall,
           "trainer_device_busy_ms": 1e3 * t_busy,
           "trainer_device_idle_share": 1 - t_busy / t_wall,
           "grad_worst": worst[name], "grad_worst_param": name,
           "grad_tol": GRAD_TOL, "launches": launches,
           "launches_by_step": per_step, "max_memory_allocated": peak,
           "card_after": state, "top_device_ops_ms": device[:10]}
    log("api lm: simple_bind of the parity configuration, float32, batch "
        "%d, Adam through get_fused_updater: step ms (CUDA events) %s, "
        "median of the last %d %.2f ms = %.1f tokens/s (SPMDTrainer f32 at "
        "the same batch %s, median %.2f ms: ratio %.3f); profiled step "
        "%.2f ms wall, device busy %.2f ms (idle share %.4f; trainer's "
        "%.4f); mean NLL per step %s; step 1 gradients vs SPMDTrainer max "
        "|dg|/max |g| %.3e at %s (tol %.0e); launches per step %s; "
        "max_memory_allocated %d B; card after %s"
        % (batch, ["%.2f" % t for t in step_ms], steps - 1, ms,
           res["tokens_per_s"], ["%.2f" % t for t in trainer_ms], tms,
           ms / tms, res["profiled_step_ms"], res["device_busy_ms"],
           res["device_idle_share"], res["trainer_device_idle_share"],
           ["%.4f" % x for x in losses], worst[name], name, GRAD_TOL,
           [{k: v for k, v in s.items() if v} for s in per_step], peak,
           state))
    if not worst[name] <= GRAD_TOL:
        raise SystemExit("api lm: the executor's gradients disagree with "
                         "SPMDTrainer's")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise SystemExit("api lm: the loss is not finite or did not fall: "
                         "%s" % losses)
    for i, counts in enumerate(per_step):
        off = {k: n for k, n in counts.items() if n != expect.get(k, 0)}
        if off:
            raise SystemExit("api lm: step %d launched %s, expected %s"
                             % (i + 1, off, expect))
    return res


# the entries of the kernels line for the float32 kernels on the tensor
# cores (the flash forward and backward, the fused CE head): the bf16 row
# each one shares its TPU function with
F32_ROWS = ("flash_attention", "flash_attention_bwd", "flash_attention_bsd",
            "flash_attention_bsd_bwd", "flash_attention_ds",
            "flash_attention_ds_bwd", "flash_attention_bsd_stream",
            "flash_attention_bsd_stream_bwd", "fused_ce_fwd", "fused_ce_bwd",
            "fused_ce_fwd_sp", "fused_ce_bwd_dw_rs", "fused_ce_bwd_dx_rs")


# -- the conv nets (phases 15-18) ---------------------------------------------

# bench.py's headline (`bench.py:126-173`, `BASELINE.json` configs[1]):
# ResNet-50, 1000 classes, 224 pixels, 'valid' pooling (stages of
# 56/28/14/7), bf16 compute, batch 128, SGD lr 0.1 momentum 0.9 wd 1e-4
# through `SPMDTrainer` (its default Uniform(0.07) initializer), one
# batch from `RandomState(0)` staged on the card once
RESNET = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
              pooling_convention="valid")
RESNET_BATCH = 128
RESNET_STEPS = 10
RESNET_SGD = dict(optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-4)
# `bench.py:196-201`: 4.089 G multiply-accumulates an image forward
# (torchvision's count), 2 operations each, training ~3x forward
RESNET_FLOPS_PER_IMAGE = 3 * 2 * 4.089e9
# The card-vs-CPU checks of the conv nets (phases 15 and 17): float32
# on both, the card's convolutions on cuDNN (TF32 off inside the ops
# whatever the flag says), the CPU's on oneDNN, each summing in its own
# order.  Forward outputs and moving statistics are held to
# CONV_FWD_TOL and CONV_AUX_TOL of their largest magnitude.  Gradients
# are held to GRAD_TOL of each parameter's largest, or to
# CONV_SPREAD_MULT times the rounding spread, where that is larger: the
# distance between CPU runs that differ only in their thread count
# (CONV_SPREAD_THREADS against all) or in float64 (`grads_f64`), and
# between the card's float32 and float64 gradients.  At initialization
# these BatchNorm networks amplify rounding in their backward (a
# convolution before a BatchNorm has a gradient orthogonal to its
# filters, a difference of two large terms), and a ReLU input within
# rounding of zero lands on either side in two runs.  ResNet-50 at batch
# 4 on the CPU: float32 against float64 parts by 0.21 of some
# parameter's largest gradient, 1 thread against 8 by 0.14; Inception-BN
# at batch 2 by 0.18 (`tests/test_torch_zoo_resnet.py` measures the same
# effect against the JAX package).  At this level the check cannot tell
# TF32 from float32 (its ~3e-4 a product is rounding beside 0.1-0.2):
# CONV_F32_CASES hold the convolutions to float64 directly
CONV_FWD_TOL = 1e-4
CONV_AUX_TOL = 1e-5
CONV_SPREAD_THREADS = (1, 2, 4)
CONV_SPREAD_MULT = 2.0
# the direct check that a float32 convolution keeps float32 products
# with ``cudnn.allow_tf32 = True``: forward, dx and dw against float64
# on the card, within CONV_F32_TOL of the largest (a weight gradient
# sums up to 12544 products, batch 4 x 56 x 56: ~1e-5 of rounding in
# float32); TF32 (10 mantissa bits) errs ~3e-4 and must exceed it.
# Shapes: ResNet-50's stem and a bottleneck's 3x3 and 1x1 at batch 4,
# FCN-8s's 16x upscore
CONV_F32_TOL = 5e-5
CONV_F32_CASES = [
    ("Convolution", (4, 3, 224, 224),
     dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=64,
          no_bias=True)),
    ("Convolution", (4, 64, 56, 56),
     dict(kernel=(3, 3), pad=(1, 1), num_filter=64, no_bias=True)),
    ("Convolution", (4, 256, 56, 56),
     dict(kernel=(1, 1), num_filter=64, no_bias=True)),
    ("Deconvolution", (4, 21, 8, 8),
     dict(kernel=(16, 16), stride=(8, 8), pad=(4, 4), num_filter=21)),
]
# `examples/train_imagenet.py --trainer feedforward` (:77-97): ResNet-50
# ('full' pooling, the model's default), FeedForward, SGD lr 0.1 (no
# momentum), Xavier(gaussian, magnitude 2), kvstore 'device', 8
# synthetic batches from RandomState(0) in one NDArrayIter, float32; the
# batch cut from 256 to 64 to keep the script inside its time limit
FF_BATCH = 64
FF_BATCHES = 8
FF_IMAGE = (3, 224, 224)
# the other `BASELINE.json` configurations, trained a few steps each
# through `SPMDTrainer` and checked card against CPU at a small size:
# (build function, data shapes at the training size, at the check size,
# dtype, optimizer, initializer, steps, kind of head)
OTHER_NETS = {
    # `examples/train_imagenet.py --network inception-bn` at 224, bf16
    "inception_bn": (
        lambda: mx.models.get_inception_bn(num_classes=1000,
                                           image_shape=(3, 224, 224)),
        {"data": (32, 3, 224, 224), "softmax_label": (32,)},
        {"data": (2, 3, 224, 224), "softmax_label": (2,)}, "bfloat16",
        dict(optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-4),
        lambda: mx.init.Xavier(rnd_type="gaussian", magnitude=2.0), 2,
        "image"),
    # `examples/lstm_bucketing.py`'s defaults: 2 layers, hidden 64, embed
    # 64, batch 32, vocab 64 (its synthetic sentences), Adam lr 0.01, at
    # its largest bucket (32)
    "lstm": (
        lambda: mx.models.lstm_unroll(2, 32, 64, 64, 64, 64),
        dict({"data": (32, 32), "softmax_label": (32, 32)},
             **{"l%d_init_%s" % (i, t): (32, 64) for i in range(2)
                for t in "ch"}),
        dict({"data": (4, 32), "softmax_label": (4, 32)},
             **{"l%d_init_%s" % (i, t): (4, 64) for i in range(2)
                for t in "ch"}), "float32",
        dict(optimizer="adam", lr=0.01, wd=0.0),
        lambda: mx.init.Xavier(), 2, "lstm"),
    # `examples/fcn_xs.py`'s defaults: FCN-8s, 21 classes, 64x64, batch
    # 4, SGD lr 1e-2 momentum 0.9 wd 5e-4, Xavier(magnitude 2) with
    # bilinear upscore kernels; checked with its Dropouts at p = 0 (the
    # card's and the CPU's generators draw different masks) and from
    # Xavier for every weight: with one bilinear kernel on every (input,
    # output) channel pair the scores are the same for every class, and
    # every gradient is zero in exact arithmetic (rounding noise in
    # float32, ~1e-14 in float64)
    "fcn8s": (
        lambda: mx.models.get_fcn_xs(num_classes=21, variant="fcn8s"),
        {"data": (4, 3, 64, 64), "softmax_label": (4, 64, 64)},
        {"data": (1, 3, 64, 64), "softmax_label": (1, 64, 64)}, "float32",
        dict(optimizer="sgd", lr=1e-2, momentum=0.9, wd=5e-4),
        lambda: mx.init.Mixed(["upscore|score2_|score4_", ".*"],
                              [mx.init.Bilinear(),
                               mx.init.Xavier(magnitude=2.0)]), 2,
        "pixels"),
}


def net_batch(shapes, kind, classes, seed=0):
    """Synthetic inputs for ``shapes`` from ``RandomState(seed)``: images
    and labels as `bench.py` draws them, token ids whose label is the next
    id (`examples/lstm_bucketing.py`'s grammar) and zero LSTM states,
    per-pixel labels."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in shapes.items():
        if n == "data" and kind == "lstm":
            out[n] = rng.randint(0, classes, s).astype(np.float32)
        elif n == "data":
            out[n] = rng.randn(*s).astype(np.float32)
        elif n.endswith("label"):
            out[n] = (out["data"] + 1) % classes if kind == "lstm" else \
                rng.randint(0, classes, s).astype(np.float32)
        else:
            out[n] = np.zeros(s, np.float32)
    return out


def head_nll(out, labels, kind):
    """Mean negative log-likelihood of the labels under a SoftmaxOutput's
    rows: (batch, classes), the LSTM's time-major (seq * batch, vocab), or
    per pixel (batch, classes, h, w); a probability that underflowed to 0
    counts as 1e-30 (NLL 69)."""
    if kind == "lstm":
        labels = labels.t().reshape(-1)
    if kind == "pixels":
        p = out.gather(1, labels.long().unsqueeze(1)).float()
    else:
        p = out.gather(1, labels.reshape(-1, 1).long()).float()
    return float(-torch.log(p.clamp_min(1e-30)).mean())


def by_kind(device):
    """Device ms of the profiled ops: cuDNN/cuBLAS convolutions and
    products (by kernel name) and the rest (elementwise, reductions,
    copies)."""
    keys = ("conv", "implicit", "wgrad", "dgrad", "fprop", "xmma", "gemm",
            "cutlass", "sm90_", "sm80_", "cudnn")
    mat = sum(ms for k, _, ms in device if any(s in k.lower() for s in keys))
    return {"conv_and_gemm_ms": mat,
            "other_ms": sum(ms for _, _, ms in device) - mat}


def resnet_path():
    """ResNet-50 at bench.py's geometry, bf16, batch 128, SGD through
    `SPMDTrainer`: RESNET_STEPS steps (the first a warm-up, left out of
    the timing) with the counts set to 0 before and read after, then one
    profiled step; the loss must fall, the aux states be finite and have
    moved from 0 and 1, and no kernel of the table launch."""
    mx.random.seed(0)
    shapes = {"data": (RESNET_BATCH,) + RESNET["image_shape"],
              "softmax_label": (RESNET_BATCH,)}
    t0 = time.perf_counter()
    trainer = mx.SPMDTrainer(mx.models.get_resnet(**RESNET),
                             data_shapes=shapes, dtype="bfloat16",
                             **RESNET_SGD)
    build_s = time.perf_counter() - t0
    dev = trainer.shard_batch(net_batch(shapes, "image",
                                        RESNET["num_classes"]))
    labels = dev["softmax_label"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_ms, wall_ms = [], [], []
    for _ in range(RESNET_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        outs = trainer.step(dev)
        b.record()
        b.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
        step_ms.append(a.elapsed_time(b))
        losses.append(head_nll(outs[0], labels, "image"))
        del outs
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    state = card_state()
    wall, busy, device, host = profiled(lambda: trainer.step(dev))
    aux = {n: a.float() for n, a in trainer.aux.items()}
    finite = all(bool(torch.isfinite(a).all()) for a in aux.values())
    moved = {n: bool((a != (1.0 if n.endswith("moving_var") else 0.0))
                     .any()) for n, a in aux.items()}
    del trainer, dev, labels, aux
    torch.cuda.empty_cache()
    step = statistics.median(step_ms[1:])
    ips = RESNET_BATCH / (step / 1e3)
    res = {"config": dict(RESNET, batch=RESNET_BATCH, dtype="bfloat16",
                          optimizer="sgd lr 0.1 momentum 0.9 wd 1e-4",
                          source="bench.py:126-173; BASELINE.json "
                                 "configs[1]"),
           "steps": RESNET_STEPS, "trainer_build_s": build_s,
           "losses": losses, "step_ms": step_ms, "wall_ms": wall_ms,
           "step_ms_median": step, "images_per_s": ips,
           "flops_per_image": RESNET_FLOPS_PER_IMAGE,
           "mfu": RESNET_FLOPS_PER_IMAGE * ips / MFU_PEAK,
           "launches": launches, "max_memory_allocated": peak,
           "card_after": state, "profiled_step_ms": 1e3 * wall,
           "device_busy_ms": 1e3 * busy,
           "device_idle_share": 1 - busy / wall,
           "device_ms_by_kind": by_kind(device),
           "top_device_ops_ms": device[:12], "top_host_ops_ms": host,
           "aux_finite": finite, "aux_moved": sum(moved.values()),
           "aux_states": len(moved)}
    log("resnet50: %d steps of batch %d at 224, bf16, SGD; step ms (CUDA "
        "events) %s; median of the last %d %.2f ms = %.1f images/s, MFU "
        "%.4f (%.4g flops an image over %.0f TFLOP/s); host wall ms %s"
        % (RESNET_STEPS, RESNET_BATCH, ["%.2f" % t for t in step_ms],
           len(step_ms) - 1, step, ips, res["mfu"], RESNET_FLOPS_PER_IMAGE,
           MFU_PEAK / 1e12, ["%.1f" % t for t in wall_ms]))
    log("resnet50: mean NLL per step %s; max_memory_allocated %d B; card "
        "after %s; aux states finite %s, moved from 0/1 %d of %d"
        % (["%.4f" % x for x in losses], peak, state, finite,
           res["aux_moved"], res["aux_states"]))
    log("resnet50: profiled step %.2f ms wall, device busy %.2f ms (idle "
        "share %.4f), by kind %s; top device ops (name, count, ms): %s"
        % (res["profiled_step_ms"], res["device_busy_ms"],
           res["device_idle_share"],
           {k: round(v, 3) for k, v in res["device_ms_by_kind"].items()},
           device[:12]))
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit("resnet50: a loss is not finite: %s" % losses)
    if not losses[-1] < losses[0]:
        raise SystemExit("resnet50: the loss did not fall: %s" % losses)
    if not (finite and all(moved.values())):
        raise SystemExit("resnet50: aux states not finite or not moved")
    if any(launches.values()):
        raise SystemExit("resnet50: launched a kernel of the table: %s"
                         % {k: v for k, v in launches.items() if v})
    return res


def conv_f32_checks():
    """Each of CONV_F32_CASES through the op, forward and backward, in
    float32 with ``cudnn.allow_tf32 = True``, against float64 on the card;
    the raw cuDNN call under the same flag (TF32) beside it must miss the
    bar."""
    from mxnet_tpu_torch.ops import registry

    out = []
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, shape, params in CONV_F32_CASES:
            op = registry.get(name)
            p = op.parse_params(params)
            shapes = op.infer_shape(p, [shape] + [None] * (
                len(op.list_arguments(p)) - 1))[0]
            gen = torch.Generator(device="cuda").manual_seed(0)
            ins = [torch.randn(s, device="cuda", dtype=torch.float64,
                               generator=gen) for s in shapes]
            res = {}
            for dt in (torch.float32, torch.float64):
                leaves = [t.detach().to(dt).clone().requires_grad_()
                          for t in ins]
                y = op.apply(mx.ops.OpCtx(), p, leaves, [])[0][0]
                cot = torch.ones_like(y)
                y.backward(cot)
                res[dt] = [y.detach()] + [t.grad for t in leaves[:2]]
            raw_fn = F.conv_transpose2d if name == "Deconvolution" else \
                F.conv2d
            raw = raw_fn(ins[0].float(), ins[1].float(), stride=p["stride"],
                         padding=p["pad"])
            ref = res[torch.float64]
            errs = [float((a.double() - r).abs().max() / r.abs().max())
                    for a, r in zip(res[torch.float32], ref)]
            y0 = ref[0] - (ins[2].reshape(1, -1, 1, 1)
                           if len(ins) > 2 else 0)
            tf32 = float((raw.double() - y0).abs().max() / y0.abs().max())
            out.append({"op": name, "shape": shape, "params": params,
                        "f32_err_y_dx_dw": errs, "tf32_raw_err_y": tf32,
                        "tol": CONV_F32_TOL})
            log("conv f32 check %s %s %s: op in float32 vs float64, max "
                "|err|/max (y, dx, dw) %s (tol %.0e); raw cuDNN under "
                "allow_tf32 %.3e"
                % (name, shape, params, ["%.2e" % e for e in errs],
                   CONV_F32_TOL, tf32))
            if not max(errs) <= CONV_F32_TOL:
                raise SystemExit("conv f32 check: %s in float32 is off by "
                                 "%s" % (name, errs))
    finally:
        torch.backends.cudnn.allow_tf32 = old
    # cuDNN takes TF32 only where its heuristics pick a tensor-core
    # algorithm (not for the 21-channel upscore): at least one raw call
    # must miss the bar, or the check could not tell the two apart
    if not max(c["tf32_raw_err_y"] for c in out) > CONV_F32_TOL:
        raise SystemExit("conv f32 check: no raw TF32 call misses the bar, "
                         "so the check does not separate them")
    return out


def grads_f64(t, batch):
    """The gradients and aux updates of trainer ``t``'s training step on
    ``batch`` with every floating argument in float64 (through the
    symbol's graph function; the trainer itself computes in float32 or
    bf16), as float32 host tensors."""
    dev = t.shard_batch(batch)
    leaves = {n: p.detach().double().requires_grad_()
              for n, p in t.params.items()}
    args = [leaves[n] if n not in dev else
            dev[n].double() if dev[n].is_floating_point() and
            "label" not in n else dev[n] for n in t.arg_names]
    fn = mx.executor._build_graph_fn(t.symbol)
    with torch.enable_grad():
        outs, new_aux = fn(args, [t.aux[n] for n in t.aux_names], None, True)
        grads = torch.autograd.grad(
            outs, [leaves[n] for n in t.param_names],
            [torch.ones_like(o) for o in outs], allow_unused=True)
    return ({n: (torch.zeros_like(leaves[n]) if g is None else g).float()
             .cpu() for n, g in zip(t.param_names, grads)},
            {n: a.detach().float().cpu()
             for n, a in zip(t.aux_names, new_aux)})


def card_cpu_check(label, build, shapes, batch, trainer_kw=None,
                   init=None):
    """One `SPMDTrainer.forward` and one `gradients` of ``build()`` in
    float32 on the card (``cudnn.allow_tf32 = True`` around it) and on the
    CPU from the card's initial parameters (`init.Load`), at ``shapes``:
    forward outputs within CONV_FWD_TOL of their largest, the moving
    statistics after the gradient step within CONV_AUX_TOL (or twice their
    CPU thread spread), and every gradient within the larger of GRAD_TOL
    and CONV_SPREAD_MULT times the network's CPU thread spread, of its
    largest.  The thread spread is measured by the same CPU trainer on
    CONV_SPREAD_THREADS threads and in float64 (`grads_f64`) against the
    float32 one on all threads, and by the card's float32 gradients
    against its own float64 ones.  A parameter whose float64 gradient is
    below 1e-4 of the model's largest (a convolution's bias before a
    BatchNorm, zero in exact arithmetic: both devices compute rounding
    noise there) is left out of the network's spread and held against
    the model's largest gradient, as the LM's key biases are.  The card's
    bf16 gradients' distance is printed beside."""

    def trainer(ctx, initializer, dtype="float32"):
        mx.random.seed(0)
        return mx.SPMDTrainer(build(), data_shapes=shapes, ctx=ctx,
                              dtype=dtype, initializer=initializer,
                              **(trainer_kw or {}))

    def run(t):
        fwd = [o.float().cpu() for o in t.forward(batch)]
        grads = {n: g.float().cpu() for n, g in t.gradients(batch).items()}
        return fwd, grads, {n: a.float().cpu() for n, a in t.aux.items()}

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        t = trainer(None, init() if init else None)
        start = {n: p.detach().cpu().numpy() for n, p in t.params.items()}
        aux0 = dict(t.aux)
        card = run(t)
        t.aux = aux0
        card64 = grads_f64(t, batch)
        del t
        card16 = run(trainer(None, mx.init.Load(start), "bfloat16"))
        card_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = old
    threads = torch.get_num_threads()
    t0 = time.perf_counter()
    t = trainer("cpu", mx.init.Load(start))
    aux0 = dict(t.aux)
    cpu = run(t)
    spread_runs = {}
    try:
        for n in CONV_SPREAD_THREADS:
            if n < threads:
                torch.set_num_threads(n)
                t.aux = dict(aux0)
                spread_runs[n] = run(t)
    finally:
        torch.set_num_threads(threads)
    t.aux = dict(aux0)
    spread_runs["f64"] = (None,) + grads_f64(t, batch)
    del t
    cpu_s = time.perf_counter() - t0

    def dist(a, b):
        return float((a.double() - b.double()).abs().max())

    fwd_err = max(dist(a, b) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(card[0], cpu[0]))
    gmax = max(float(g.abs().max()) for g in cpu[1].values())
    noise = sorted(n for n, g in spread_runs["f64"][1].items()
                   if float(g.abs().max()) < 1e-4 * gmax)
    size = {n: gmax if n in noise else max(float(g.abs().max()), 1e-30)
            for n, g in cpu[1].items()}
    own = {n: max(dist(r[1][n], g) for r in spread_runs.values())
           for n, g in cpu[1].items()}
    # the card's own rounding: its float32 gradients against its float64
    card_own = max([dist(card[1][n], card64[0][n]) / size[n]
                    for n in size if n not in noise] or [0.0])
    spread = max([own[n] / size[n] for n in size if n not in noise]
                 + [card_own])
    bar = {n: max(max(GRAD_TOL, CONV_SPREAD_MULT * spread) * size[n],
                  CONV_SPREAD_MULT * own[n]) for n in size}
    ratio = {n: dist(card[1][n], g) / bar[n] for n, g in cpu[1].items()}
    worst = max(ratio, key=ratio.get)
    g16 = max(dist(card16[1][n], g) / size[n] for n, g in cpu[1].items()
              if n not in noise)
    aux_size = {n: max(float(a.abs().max()), 1e-30)
                for n, a in cpu[2].items()}
    aux_err = max([dist(card[2][n], a) / aux_size[n]
                   for n, a in cpu[2].items()] or [0.0])
    aux_spread = max([dist(r[2][n], a) / aux_size[n]
                      for r in spread_runs.values()
                      for n, a in cpu[2].items()] or [0.0])
    aux_bar = max(CONV_AUX_TOL, CONV_SPREAD_MULT * aux_spread)
    res = {"config": label, "shapes": shapes, "params": len(size),
           "forward_err": fwd_err, "forward_tol": CONV_FWD_TOL,
           "cpu_threads": threads,
           "spread_runs": sorted(str(k) for k in spread_runs),
           "rounding_spread": spread, "card_f32_vs_f64": card_own,
           "zero_gradient_params": noise,
           "grad_bar_rel": max(GRAD_TOL, CONV_SPREAD_MULT * spread),
           "worst_grad_param": worst,
           "worst_grad_err_rel": dist(card[1][worst], cpu[1][worst])
           / size[worst], "worst_grad_err_over_bar": ratio[worst],
           "aux_err": aux_err, "aux_spread": aux_spread, "aux_bar": aux_bar,
           "worst_bf16_grad_err": g16, "card_s": card_s, "cpu_s": cpu_s,
           "per_param_err_rel": {n: dist(card[1][n], g) / size[n]
                                 for n, g in cpu[1].items()}}
    log("card vs CPU (%s, data %s): forward max |d|/max %.3e (tol %.0e); "
        "CPU runs on %s threads and in float64 against %d threads, and "
        "the card's float32 against its float64 (%.3e), part by up to "
        "%.3e of a gradient's largest (%d parameters of zero gradient "
        "held against the largest), so gradients "
        "are held to %.3e; worst %s at %.3e (%.3f of its bar); moving "
        "statistics %.3e (spread %.3e, bar %.3e); bf16 gradients %.3e; "
        "card %.1f s, CPU %.1f s"
        % (label, shapes["data"], fwd_err, CONV_FWD_TOL,
           sorted(k for k in spread_runs if k != "f64"), threads,
           card_own, spread, len(noise),
           res["grad_bar_rel"], worst, res["worst_grad_err_rel"],
           ratio[worst], aux_err, aux_spread, aux_bar, g16, card_s, cpu_s))
    if not (fwd_err <= CONV_FWD_TOL and ratio[worst] <= 1.0
            and aux_err <= aux_bar):
        raise SystemExit("%s: the card disagrees with the CPU" % label)
    return res


def resnet_grad_check():
    """ResNet-50 in the reference's default 'full' geometry (57/29/15/8)
    at batch 4, card against CPU (`card_cpu_check`)."""
    shapes = {"data": (4,) + RESNET["image_shape"], "softmax_label": (4,)}
    return card_cpu_check(
        "resnet50 full, batch 4",
        lambda: mx.models.get_resnet(
            **dict(RESNET, pooling_convention="full")), shapes,
        net_batch(shapes, "image", RESNET["num_classes"], seed=1),
        trainer_kw=RESNET_SGD)


def resnet_feedforward_path():
    """ResNet-50 through `FeedForward` as `examples/train_imagenet.py
    --trainer feedforward` runs it, on the card, float32: ms a batch (host
    clock between batch ends, each reading its metric back), images/s,
    the running cross-entropy finite."""
    mx.random.seed(0)
    rng = np.random.RandomState(0)
    n = FF_BATCH * FF_BATCHES
    X = rng.randn(n, *FF_IMAGE).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.float32)
    model = mx.model.FeedForward(
        mx.models.get_resnet(num_classes=1000, num_layers=50),
        ctx=mx.gpu(0), num_epoch=1, optimizer="sgd", learning_rate=0.1,
        initializer=mx.init.Xavier(rnd_type="gaussian", magnitude=2.0))
    ticks, ce = [], []

    def on_batch(p):
        ce.append(p.eval_metric.get()[1])
        ticks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    model.fit(mx.io.NDArrayIter(X, y, batch_size=FF_BATCH), kvstore="device",
              eval_metric="ce", batch_end_callback=on_batch)
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    state = card_state()
    del model, X, y
    torch.cuda.empty_cache()
    batch_ms = [1e3 * b for b in np.diff([t0] + ticks)]
    ms = statistics.median(batch_ms[1:])
    res = {"config": dict(net="get_resnet(num_layers=50), 'full'",
                          batch=FF_BATCH, batches=FF_BATCHES,
                          dtype="float32", optimizer="sgd lr 0.1",
                          initializer="Xavier(gaussian, 2)",
                          kvstore="device", reduced="batch 256 -> 64",
                          source="examples/train_imagenet.py:77-97"),
           "fit_s": fit_s, "batch_ms": batch_ms, "ms_per_batch_median": ms,
           "images_per_s": FF_BATCH / (ms / 1e3), "cross_entropy": ce,
           "launches": launches, "max_memory_allocated": peak,
           "card_after": state}
    log("resnet50 FeedForward: %d batches of %d, float32, kvstore device, "
        "in %.2f s; ms a batch (host clock) %s; median of the last %d "
        "%.2f ms = %.1f images/s; running cross-entropy %s; "
        "max_memory_allocated %d B; card after %s"
        % (FF_BATCHES, FF_BATCH, fit_s, ["%.1f" % t for t in batch_ms],
           len(batch_ms) - 1, ms, res["images_per_s"],
           ["%.4f" % c for c in ce], peak, state))
    if len(ce) != FF_BATCHES or not all(math.isfinite(c) for c in ce):
        raise SystemExit("resnet50 FeedForward: a loss is not finite or a "
                         "batch is missing: %s" % ce)
    if any(launches.values()):
        raise SystemExit("resnet50 FeedForward: launched a kernel of the "
                         "table")
    return res


def _without_dropout(sym):
    """``sym`` with every Dropout at p = 0 (identity in training too)."""
    import re

    return mx.sym.loads(re.sub(r'"p": "[0-9.]+"', '"p": "0.0"',
                               sym.tojson()))


def other_net_path(name):
    """One of OTHER_NETS: its steps through `SPMDTrainer` on the card (the
    first a warm-up; step ms of the rest by CUDA events), the loss finite
    and no kernel of the table launched, then the card-vs-CPU check at
    its check size."""
    build, shapes, check_shapes, dtype, opt, init, steps, kind = \
        OTHER_NETS[name]
    classes = {"image": 1000, "lstm": 64, "pixels": 21}[kind]
    mx.random.seed(0)
    trainer = mx.SPMDTrainer(build(), data_shapes=shapes, dtype=dtype,
                             initializer=init(), **opt)
    dev = trainer.shard_batch(net_batch(shapes, kind, classes))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_ms = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        outs = trainer.step(dev)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(head_nll(outs[0], dev["softmax_label"], kind))
        del outs
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    del trainer, dev
    torch.cuda.empty_cache()
    log("%s: %d steps, %s, shapes %s: step ms %s, mean NLL %s, "
        "max_memory_allocated %d B"
        % (name, steps, dtype, shapes["data"], ["%.2f" % t for t in step_ms],
           ["%.4f" % x for x in losses], peak))
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit("%s: a loss is not finite: %s" % (name, losses))
    if any(launches.values()):
        raise SystemExit("%s: launched a kernel of the table" % name)
    check_build, check_init = build, init
    if kind == "pixels":
        check_build = lambda: _without_dropout(build())  # noqa: E731
        check_init = lambda: mx.init.Xavier(magnitude=2.0)  # noqa: E731
    check = card_cpu_check(name, check_build, check_shapes,
                           net_batch(check_shapes, kind, classes, seed=1),
                           trainer_kw=opt, init=check_init)
    return {"shapes": shapes, "dtype": dtype, "optimizer": opt,
            "steps": steps, "step_ms": step_ms, "losses": losses,
            "launches": launches, "max_memory_allocated": peak,
            "check": check}


def kernels_line(cases, paths, f32_paths):
    """One entry per ported TPU function: launches on each path, and the
    error and times of its check at the training shape, in bf16; then one
    entry per route of the float32 flash forward and backward
    (`flash_attention_fwd_f32.cu`, `flash_attention_bwd_f32.cu`) and per
    float32 fused CE function (`fused_ce_f32.cu`), their launches those of
    the float32 paths ``f32_paths``."""
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
                  if src == "fused_ce_bf16.cu"})
    serving = {"layer_norm": [8, 768],
               "flash_attention": [1, 12, 1024, 1024, 64]}

    def serving_ms(name):
        # the served f32 path's check at its shape
        s = next(c for c in cases if c["kernel"] == name
                 and c["shape"] == serving[name]
                 and c["dtype"] == "torch.float32" and "rtol" in c)
        return {"shape": s["shape"], "dtype": s["dtype"], "ms": s["ms"],
                "ms_with_launch": s.get("ms_with_launch")}

    out = []
    for name, src, replaces, counters in KERNEL_ROWS:
        at = next(c for c in cases if c["kernel"] == name
                  and c["shape"] == train[name] and "ms" in c
                  and c["dtype"] == "torch.bfloat16")
        by_path = {p: {k: launches[k] for k in counters}
                   for p, launches in paths.items()}
        entry = {
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + src,
            "source_f32": "mxnet_tpu_torch/csrc/" + F32_SOURCE[src],
            "replaces": replaces,
            "launches": sum(v[counters[0]] for v in by_path.values()),
            "launches_by_path": by_path, "shape": at["shape"],
            "dtype": at["dtype"], "max_abs_err": at["max_abs_err"],
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "route_ms": at.get("route_ms"),
            **{k: at[k] for k in ("tflops", "bound_share", "ptxas",
                                  "bit_identical", "bf16_plain_rel_err",
                                  "cold_ms", "cold_bound_share", "plan",
                                  "kernel_split_ms")
               if k in at},
            "checks": [{k: c.get(k) for k in (
                "shape", "dtype", "max_abs_err", "rel_err", "rel_tol",
                "rtol", "atol")} for c in cases if c["kernel"] == name]}
        if name in serving:
            entry["serving_shape_ms"] = serving_ms(name)
        out.append(entry)
    for name, src, replaces, counters in KERNEL_ROWS:
        if name not in F32_ROWS:
            continue
        at = next(c for c in cases if c["kernel"] == name
                  and c["shape"] == train[name] and "ms" in c
                  and c["dtype"] == "torch.float32")
        by_path = {p: {k: launches[k] for k in counters}
                   for p, launches in f32_paths.items()}
        entry = {
            "name": name + "_f32", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + F32_SOURCE[src],
            "replaces": replaces,
            "launches": sum(v[counters[0]] for v in by_path.values()),
            "launches_by_path": by_path, "shape": at["shape"],
            "dtype": at["dtype"],
            **{k: at[k] for k in (
                "max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "tflops", "bound_share",
                "bound_cuda_core_ms", "bit_identical", "ptxas")},
            "route_ms": at.get("route_ms")}
        if name in serving:
            entry["serving_shape_ms"] = serving_ms(name)
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
    for name in ("layer_norm", "flash_attention_fwd",
                 "flash_attention_fwd_f32", "flash_attention_bwd",
                 "flash_attention_bwd_f32", "fused_ce_bf16", "fused_ce_f32"):
        log("ptxas registers, spill (stores, loads) bytes, %s: %s"
            % (name, ptxas_info(name)))

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
        bsd_grads = grad_check(
            GEOM_FAST, ("layer_norm_bwd", "flash_attention_bsd_dq",
                        "flash_attention_bsd_dkv"), "bsd config")

    with phase("train bhsd f32"):
        # the trainer's default dtype: every flash forward, dq and dk/dv
        # runs the float32 kernels
        hsd32 = train_path("train bhsd (parity) f32", PARITY, 3,
                           dict(per_layer, **flash("flash_attention")),
                           dtype="float32")

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
        # the fused head in the trainer's default dtype with its default
        # float32 v: kernels B and C (5-pass: A, D and C; `forward`: A) run
        # the float32 source
        fused32 = train_path(
            "train fused f32", FUSED, 3,
            dict(per_layer, **hsd_flash, fused_ce_fwd_sp=1,
                 fused_ce_bwd_dw=1), dtype="float32",
            after=lambda t, d: {"forward": forward_check(t, d)})
        five32 = five_pass_path(dict(per_layer, **hsd_flash, fused_ce_fwd=1,
                                     fused_ce_bwd_dx=1, fused_ce_bwd_dw=1),
                                dtype="float32")
        fused_grads = grad_check(
            FUSED, ("layer_norm_bwd", "flash_attention_dq",
                    "flash_attention_dkv", "fused_ce_fwd_sp",
                    "fused_ce_bwd_dw"), "fused config")
        medium_grads = grad_check(
            MEDIUM_FUSED, ("layer_norm_bwd", "flash_attention_dq",
                           "flash_attention_dkv", "fused_ce_fwd_sp",
                           "fused_ce_bwd_dw"),
            "fused head at GPT-2 medium widths", size=1)
        medium_layers = MEDIUM_FUSED["num_layers"]
        medium = train_path(
            "train fused GPT-2 medium widths", MEDIUM_FUSED, 2,
            {"layer_norm": 2 * medium_layers + 1,
             "layer_norm_bwd": 2 * medium_layers + 1,
             "flash_attention": medium_layers,
             "flash_attention_dq": medium_layers,
             "flash_attention_dkv": medium_layers,
             "fused_ce_fwd_sp": 1, "fused_ce_bwd_dw": 1},
            FUSED_TRAINER, falls=False, batch=MEDIUM_BATCH)

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
        ds_grads = grad_check(
            LONGCTX_DS, ("layer_norm_bwd", "flash_attention_ds_dq",
                         "flash_attention_ds_dkv"),
            "longctx ds config", size=1, pins={"MXNET_FLASH_LAYOUT": "ds"})

    with phase("reference API"):
        api_mnist = mnist_api_path()
        api_lm = api_lm_path(dict(per_layer, **flash("flash_attention")))

    with phase("conv nets"):
        resnet = resnet_path()
        conv_f32 = conv_f32_checks()
        resnet_grads = resnet_grad_check()
        resnet_ff = resnet_feedforward_path()
        others = {n: other_net_path(n) for n in OTHER_NETS}
    # the LM's LayerNorm launches join the LayerNorm rows; its float32
    # flash launches the float32 flash rows
    api_lm_ln = {k: (n if k.startswith("layer_norm") else 0)
                 for k, n in api_lm["launches"].items()}

    kernels = kernels_line(cases, {
        "paged": paged["launches"], "slot": slot["launches"],
        "train_bhsd": hsd["launches"], "train_bsd": bsd["launches"],
        "train_fused": fused["launches"],
        "train_fused_5pass": five["launches"],
        "forward_fused": fused["forward"]["launches"],
        "train_fused_medium": medium["launches"],
        "train_longctx_ds": ds["launches"],
        "train_longctx_stream": stream["launches"],
        "api_lm_simple_bind": api_lm_ln}, {
        "slot": slot["launches"],
        "train_bhsd_f32": hsd32["launches"],
        "train_fused_f32": fused32["launches"],
        "train_fused_5pass_f32": five32["launches"],
        "forward_fused_f32": fused32["forward"]["launches"],
        "gradients_parity": grads["launches"],
        "gradients_bsd": bsd_grads["launches"],
        "gradients_fused": fused_grads["launches"],
        "gradients_fused_medium": medium_grads["launches"],
        "gradients_longctx_ds": ds_grads["launches"],
        "gradients_longctx_stream": stream_grads["launches"],
        "api_lm_simple_bind_f32": api_lm["launches"]})
    idle = [e["name"] for e in kernels if not e["launches"]]
    if idle:
        raise SystemExit("kernels launched on no path: %s" % idle)
    log("phase seconds: %s" % {k: round(v, 2) for k, v in phases.items()})
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": took,
         "ptxas": {name: ptxas_info(name) for name in _build.KERNELS},
         "phase_s": phases, "cases": cases, "paged": paged,
         "slot": slot, "decode_profile": profile,
         "prefill_profile": prefill_prof, "train_bhsd": hsd,
         "gradients": grads, "train_bsd": bsd, "gradients_bsd": bsd_grads,
         "train_bhsd_f32": hsd32,
         "train_fused": fused,
         "train_fused_5pass": five, "train_fused_f32": fused32,
         "train_fused_5pass_f32": five32, "gradients_fused": fused_grads,
         "train_fused_medium": medium,
         "gradients_fused_medium": medium_grads,
         "train_longctx_ds": ds, "train_longctx_stream": stream,
         "gradients_longctx_stream": stream_grads,
         "gradients_longctx_ds": ds_grads, "api_mnist": api_mnist,
         "api_lm": api_lm, "resnet50": resnet, "conv_f32": conv_f32,
         "resnet50_gradients": resnet_grads,
         "resnet50_feedforward": resnet_ff, "other_nets": others,
         "kernels": kernels},
        indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Pair phase 3's serving numbers of two checkouts on one card, in turns.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 scripts/serve_ab.py BASE_CHECKOUT [--rounds 2]

Three arms, each a process of its own started from its checkout's root:
``base`` (the other checkout), ``off`` (this one under
``MXNET_SERVE_TRACING=0``) and ``on`` (this one, tracing on, its default),
run base, off, on, then on, off, base, as many rounds as asked.  Each
process builds the LayerNorm and float32 flash-forward kernels (once per
checkout), draws GPT-2 small in float32 from seed 0 as `chip_smoke.py`
does, and serves, twice each after a warmup, phase 3's 16 requests on
the default paged engine and its 4 long prompts on the slot engine
(`chip_smoke.serve`: every request submitted at once, the engine run to
idle on this thread).  A process prints one JSON line: tokens/s, TTFT
median and p99, LayerNorm launches and the steps of every serve.

The script prints each process's line, then the median tokens/s of each
arm and workload and the card's name and power limit, and writes all of
it to ``chiprun_out/serve_ab.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r'''
import json, time
import numpy as np
import torch
import chip_smoke as c
from mxnet_tpu_torch.ops.pallas_kernels import _build
from mxnet_tpu_torch.serving import ServingEngine, TransformerKVModel

_build.build(("layer_norm", "flash_attention_fwd_f32"))
torch.backends.cuda.matmul.allow_tf32 = False
model = TransformerKVModel(**c.GPT2)
params = model.params_from_jax(model.init_params(np.random.RandomState(0)),
                               "cuda")
rng = np.random.RandomState(0)
paged_reqs = []
for i, n in enumerate(rng.randint(32, 769, size=16)):
    kw = dict(max_new_tokens=32, seed=i)
    if i % 2:
        kw.update(temperature=0.8, top_k=50, top_p=0.95)
    paged_reqs.append((rng.randint(0, model.vocab_size, size=int(n)).tolist(),
                       kw))
rng = np.random.RandomState(1)
slot_reqs = [(rng.randint(0, model.vocab_size, size=int(n)).tolist(),
              dict(max_new_tokens=32))
             for n in rng.randint(520, 1001, size=4)]
out = {}
for label, paged, reqs in (("paged", True, paged_reqs),
                           ("slot", False, slot_reqs)):
    engine = ServingEngine(model, params, max_batch=8, paged=paged)
    engine.warmup()
    runs = []
    for _ in range(2):
        _, res = c.serve(engine, reqs)
        runs.append({k: res[k] for k in ("tokens_per_s", "ttft_ms_median",
                                         "ttft_ms_p99", "steps", "wall_s")}
                    | {"layer_norm": res["launches"].get("layer_norm", 0)})
    out[label] = runs
    del engine
    torch.cuda.empty_cache()
print("SERVE_AB " + json.dumps(out))
'''


def card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip()


def run_arm(label, checkout, tracing):
    env = dict(os.environ, PYTHONPATH=str(checkout))
    if tracing is not None:
        env["MXNET_SERVE_TRACING"] = tracing
    r = subprocess.run([sys.executable, "-c", CHILD], cwd=checkout, env=env,
                       capture_output=True, text=True, timeout=900)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("SERVE_AB ")]
    if r.returncode != 0 or not line:
        raise SystemExit("%s failed (rc %d): %s" % (label, r.returncode,
                                                    r.stderr[-3000:]))
    res = json.loads(line[-1][len("SERVE_AB "):])
    print("%s: %s" % (label, json.dumps(res)), flush=True)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("base", help="the checkout to hold this one against")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    base = Path(args.base).resolve()
    arms = [("base", base, None), ("off", ROOT, "0"), ("on", ROOT, "1")]
    order = []
    for _ in range(args.rounds):
        order += arms + arms[::-1]
    name = card()
    print("card: %s" % name, flush=True)
    runs = [(label, run_arm(label, where, tr)) for label, where, tr in order]
    summary = {}
    for label, _, _ in arms:
        for wl in ("paged", "slot"):
            tps = [x["tokens_per_s"] for lb, res in runs if lb == label
                   for x in res[wl]]
            summary["%s %s" % (label, wl)] = {
                "tokens_per_s": tps,
                "median_tokens_per_s": statistics.median(tps)}
    print(json.dumps({"card": name, "summary": summary}))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "serve_ab.json").write_text(json.dumps(
        {"card": name, "order": [lb for lb, _, _ in order],
         "runs": [res for _, res in runs], "summary": summary}, indent=1))


if __name__ == "__main__":
    main()

"""Quantized-against-oracle output parity (the serving quantization gate).

A port of `mxnet_tpu/quant/parity.py`.  `parity_report` runs one request
set through a quantized serving model and its full-precision oracle
with the paged programs alone (no engine, so no scheduling enters the
measurement) and reports the first sampling decision's logit error
(max-abs and relative to the oracle's largest logit; the
``serve.quant_logit_err`` gauge) and the greedy token-match rate at T=0:
the mean leading-agreement fraction of the generated streams.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError

__all__ = ["greedy_paged", "parity_report"]


def greedy_paged(model, params, prompt, max_new, block_size=16,
                 device=None):
    """Greedy decode of ONE prompt through the paged programs: a
    single-chunk prefill over contiguous blocks, then ``max_new - 1``
    single-token decode steps.  ``params`` is the model's ``{name:
    tensor}`` dict (quantized by `quantize_params` for a quantized
    model); the pool goes on ``device``, by default the parameters'.
    Returns ``(tokens, first_logits)``: the generated ids and the prefill
    head's logits (numpy f32), the logit-error probe."""
    prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
    if not prompt:
        raise MXNetError("greedy_paged: empty prompt")
    if device is None:
        device = next(iter(params.values())).device
    bs = int(block_size)
    total = len(prompt) + int(max_new)
    if total > model.seq_len:
        raise MXNetError("greedy_paged: prompt+max_new %d exceeds seq_len "
                         "%d" % (total, model.seq_len))
    n_table = -(-model.seq_len // bs)
    need = -(-total // bs)
    pool = model.init_block_pool(need + 1, bs, device=device)
    table = np.zeros((1, n_table), np.int32)
    table[0, :need] = np.arange(1, need + 1)
    table_d = torch.as_tensor(table, device=device)
    c = -(-len(prompt) // bs) * bs
    toks = np.zeros((1, c), np.int32)
    toks[0, :len(prompt)] = prompt

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    with torch.no_grad():
        logits, pool = model.prefill_paged(params, pool, dev(toks), dev([0]),
                                           dev([len(prompt)]), table_d)
        first_logits = logits[0].float().cpu().numpy()
        tok = int(np.argmax(first_logits))
        out = [tok]
        pos = len(prompt)
        for _ in range(int(max_new) - 1):
            logits, pool = model.decode_paged(params, pool, dev([tok]),
                                              dev([pos]), table_d)
            tok = int(torch.argmax(logits[0]).item())
            out.append(tok)
            pos += 1
    return out, first_logits


def parity_report(ref_model, ref_params, qmodel, qparams, prompts,
                  max_new=8, block_size=16):
    """Quantized-against-oracle parity over a request set at T=0: a dict
    with ``logit_err_max`` / ``logit_err_rel`` (first-decision logits),
    ``token_match_rate`` (mean leading-agreement fraction of the greedy
    streams) and the per-request ``streams``.  Sets the
    ``serve.quant_logit_err`` gauge to ``logit_err_rel``."""
    err_max = 0.0
    rel_max = 0.0
    matches = []
    streams = []
    prompts = list(prompts)
    for p in prompts:
        ref_toks, ref_logits = greedy_paged(ref_model, ref_params, p,
                                            max_new, block_size)
        q_toks, q_logits = greedy_paged(qmodel, qparams, p, max_new,
                                        block_size)
        err = float(np.max(np.abs(q_logits - ref_logits)))
        err_max = max(err_max, err)
        denom = float(np.max(np.abs(ref_logits)))
        rel_max = max(rel_max, err / denom if denom > 0 else err)
        lead = 0
        for a, b in zip(ref_toks, q_toks):
            if a != b:
                break
            lead += 1
        matches.append(lead / float(max(len(ref_toks), 1)))
        streams.append({"ref": ref_toks, "quant": q_toks})
    report = {
        "prompts": len(prompts),
        "max_new": int(max_new),
        "logit_err_max": round(err_max, 6),
        "logit_err_rel": round(rel_max, 6),
        "token_match_rate": round(float(np.mean(matches)) if matches
                                  else 1.0, 4),
        "streams": streams,
    }
    telemetry.set_gauge("serve.quant_logit_err", report["logit_err_rel"])
    return report

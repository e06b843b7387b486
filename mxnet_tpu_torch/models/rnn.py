"""Vanilla RNN language model (reference `example/rnn/rnn.py`).

Same explicit-unroll pattern as the LSTM zoo entry: one fused i2h+h2h
matmul per step, tanh nonlinearity, optional per-step Dropout and
BatchNorm (`rnn.py:17-35`), embedding in, per-step softmax heads out.
"""
from __future__ import annotations

from collections import namedtuple

from .. import symbol as sym

RNNState = namedtuple("RNNState", ["h"])
RNNParam = namedtuple("RNNParam", ["i2h_weight", "i2h_bias",
                                   "h2h_weight", "h2h_bias"])


def rnn_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
             dropout=0.0, batch_norm=False):
    """One vanilla-RNN step (reference `rnn.py:17-35`)."""
    if dropout > 0.0:
        indata = sym.Dropout(data=indata, p=dropout)
    i2h = sym.FullyConnected(data=indata, weight=param.i2h_weight,
                             bias=param.i2h_bias, num_hidden=num_hidden,
                             name="t%d_l%d_i2h" % (seqidx, layeridx))
    h2h = sym.FullyConnected(data=prev_state.h, weight=param.h2h_weight,
                             bias=param.h2h_bias, num_hidden=num_hidden,
                             name="t%d_l%d_h2h" % (seqidx, layeridx))
    hidden = sym.Activation(data=i2h + h2h, act_type="tanh")
    if batch_norm:
        hidden = sym.BatchNorm(data=hidden,
                               name="t%d_l%d_bn" % (seqidx, layeridx))
    return RNNState(h=hidden)


def rnn_unroll(num_rnn_layer, seq_len, input_size, num_hidden, num_embed,
               num_label, dropout=0.0, batch_norm=False):
    """Unrolled RNN LM (reference `rnn.py:40-88`)."""
    embed_weight = sym.Variable("embed_weight")
    cls_weight = sym.Variable("cls_weight")
    cls_bias = sym.Variable("cls_bias")
    param_cells = []
    last_states = []
    for i in range(num_rnn_layer):
        param_cells.append(RNNParam(
            i2h_weight=sym.Variable("l%d_i2h_weight" % i),
            i2h_bias=sym.Variable("l%d_i2h_bias" % i),
            h2h_weight=sym.Variable("l%d_h2h_weight" % i),
            h2h_bias=sym.Variable("l%d_h2h_bias" % i)))
        last_states.append(RNNState(h=sym.Variable("l%d_init_h" % i)))

    outs = []
    for seqidx in range(seq_len):
        data = sym.Variable("t%d_data" % seqidx)
        hidden = sym.Embedding(data=data, weight=embed_weight,
                               input_dim=input_size, output_dim=num_embed,
                               name="t%d_embed" % seqidx)
        for i in range(num_rnn_layer):
            state = rnn_cell(num_hidden, hidden, last_states[i],
                             param_cells[i], seqidx, i, dropout=dropout,
                             batch_norm=batch_norm)
            hidden = state.h
            last_states[i] = state
        fc = sym.FullyConnected(data=hidden, weight=cls_weight,
                                bias=cls_bias, num_hidden=num_label,
                                name="t%d_cls" % seqidx)
        outs.append(sym.SoftmaxOutput(data=fc, name="t%d_sm" % seqidx))
    return sym.Group(outs)

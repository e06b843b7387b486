"""Explicitly-unrolled LSTM (reference `example/rnn/lstm.py:17-41`) and the
model-parallel stacked variant (`example/model-parallel-lstm/lstm.py:48-118`,
layers pinned to devices via `ctx_group` AttrScope).

As `mxnet_tpu/models/lstm.py` builds it: one explicitly unrolled graph per
(bucket) length, the gates of each step one sum of two products (i2h +
h2h).  The ``ctx_group`` attributes are kept; the port's `Executor`
refuses ``group2ctx`` over more than one device (ROADMAP queue 5), so the
model-parallel variant runs on one device.
"""
from __future__ import annotations

from collections import namedtuple

from .. import attribute
from .. import symbol as sym

LSTMState = namedtuple("LSTMState", ["c", "h"])
LSTMParam = namedtuple("LSTMParam", ["i2h_weight", "i2h_bias",
                                     "h2h_weight", "h2h_bias"])


def lstm_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
              dropout=0.0):
    """One LSTM step (reference `lstm.py:17-41`)."""
    if dropout > 0.0:
        indata = sym.Dropout(data=indata, p=dropout)
    i2h = sym.FullyConnected(data=indata, weight=param.i2h_weight,
                             bias=param.i2h_bias, num_hidden=num_hidden * 4,
                             name="t%d_l%d_i2h" % (seqidx, layeridx))
    h2h = sym.FullyConnected(data=prev_state.h, weight=param.h2h_weight,
                             bias=param.h2h_bias, num_hidden=num_hidden * 4,
                             name="t%d_l%d_h2h" % (seqidx, layeridx))
    gates = i2h + h2h
    slice_gates = sym.SliceChannel(data=gates, num_outputs=4,
                                   name="t%d_l%d_slice" % (seqidx, layeridx))
    in_gate = sym.Activation(data=slice_gates[0], act_type="sigmoid")
    in_transform = sym.Activation(data=slice_gates[1], act_type="tanh")
    forget_gate = sym.Activation(data=slice_gates[2], act_type="sigmoid")
    out_gate = sym.Activation(data=slice_gates[3], act_type="sigmoid")
    next_c = (forget_gate * prev_state.c) + (in_gate * in_transform)
    next_h = out_gate * sym.Activation(data=next_c, act_type="tanh")
    return LSTMState(c=next_c, h=next_h)


def lstm_unroll(num_lstm_layer, seq_len, input_size, num_hidden, num_embed,
                num_label, dropout=0.0, ctx_groups=None):
    """Unrolled LSTM LM (reference `lstm.py` lstm_unroll / the
    model-parallel `lstm.py:48-118` when ctx_groups is given).

    ctx_groups: optional list of group names per layer (+"embed"/"decode")
    applied via AttrScope(ctx_group=...), the reference's model-parallel
    placement mechanism.
    """

    def scope(group):
        if ctx_groups is None:
            return attribute.AttrScope()
        return attribute.AttrScope(ctx_group=group)

    with scope("embed"):
        embed_weight = sym.Variable("embed_weight")
    with scope("decode"):
        cls_weight = sym.Variable("cls_weight")
        cls_bias = sym.Variable("cls_bias")
    param_cells = []
    last_states = []
    for i in range(num_lstm_layer):
        with scope("layer%d" % i):
            param_cells.append(LSTMParam(
                i2h_weight=sym.Variable("l%d_i2h_weight" % i),
                i2h_bias=sym.Variable("l%d_i2h_bias" % i),
                h2h_weight=sym.Variable("l%d_h2h_weight" % i),
                h2h_bias=sym.Variable("l%d_h2h_bias" % i),
            ))
            last_states.append(LSTMState(
                c=sym.Variable("l%d_init_c" % i),
                h=sym.Variable("l%d_init_h" % i),
            ))

    with scope("embed"):
        data = sym.Variable("data")
        embed = sym.Embedding(data=data, input_dim=input_size,
                              weight=embed_weight, output_dim=num_embed,
                              name="embed")
        wordvec = sym.SliceChannel(data=embed, num_outputs=seq_len,
                                   axis=1, squeeze_axis=True)

    hidden_all = []
    for seqidx in range(seq_len):
        hidden = wordvec[seqidx]
        for i in range(num_lstm_layer):
            with scope("layer%d" % i):
                next_state = lstm_cell(
                    num_hidden, indata=hidden, prev_state=last_states[i],
                    param=param_cells[i], seqidx=seqidx, layeridx=i,
                    dropout=dropout if i > 0 else 0.0,
                )
                hidden = next_state.h
                last_states[i] = next_state
        if dropout > 0.0:
            hidden = sym.Dropout(data=hidden, p=dropout)
        hidden_all.append(hidden)

    with scope("decode"):
        hidden_concat = sym.Concat(*hidden_all, dim=0)
        pred = sym.FullyConnected(data=hidden_concat, num_hidden=num_label,
                                  weight=cls_weight, bias=cls_bias,
                                  name="pred")
        # label (batch, seq) -> transpose -> flatten so rows align with the
        # timestep-major hidden_concat (reference `lstm.py:102-104`)
        label = sym.Variable("softmax_label")
        label_t = sym.transpose(label, name="label_t")
        label_flat = sym.Reshape(data=label_t, shape=(-1,), name="label_flat")
        out = sym.SoftmaxOutput(data=pred, label=label_flat, name="softmax")
    return out

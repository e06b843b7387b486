"""Decoder-only transformer LM, as a symbol graph.

A port of `mxnet_tpu/models/transformer.py`, unchanged in what it builds:
pre-LN GPT-style blocks whose projections run as (batch*seq, embed)
matrix products, the `DotProductAttention` op in the 'bhsd' (head split
and merge transposes) or 'bsd' (transposeless) layout, and a dense
FullyConnected + SoftmaxOutput head, or with ``fused_head=True`` the
`FusedSoftmaxCE` head.  Both packages build the same graph, the same
parameter names and the same JSON from the same arguments, including the
``attn_layout='auto'`` rule ('bsd' where the head width is a multiple of
128).
"""
from __future__ import annotations

from .. import symbol as sym


def _proj(x_flat, name, num_hidden, weight=None, bias=None,
          use_bias=True):
    kwargs = {}
    if weight is not None:
        kwargs["weight"] = weight
    if bias is not None:
        kwargs["bias"] = bias
    return sym.FullyConnected(data=x_flat, num_hidden=num_hidden,
                              name=name, no_bias=not use_bias, **kwargs)


def transformer_block(x, name, seq_len, num_heads, num_embed,
                      num_ffn_hidden, dropout=0.0, causal=True,
                      use_bias=True, attn_layout="bhsd"):
    """One pre-LN block.  x: (batch, seq, embed) symbol.

    ``attn_layout`` must be resolved here ('bsd' or 'bhsd') — 'auto' is
    a `get_transformer_lm`-level value."""
    if attn_layout not in ("bsd", "bhsd"):
        raise ValueError(
            "transformer_block attn_layout must be 'bsd' or 'bhsd', got "
            "%r ('auto' is resolved by get_transformer_lm)"
            % (attn_layout,))
    head_dim = num_embed // num_heads

    # --- attention sublayer ---
    h = sym.LayerNorm(data=x, name=name + "_ln1")
    hf = sym.Reshape(data=h, shape=(-1, num_embed), name=name + "_ln1_flat")

    if attn_layout == "bsd":
        # transposeless path: projections feed the attention op in their
        # natural (batch, seq, embed) layout; heads are carved on the
        # lane axis inside the kernel (flash_attention_bsd) — no head
        # split/merge transposes, no kernel-boundary layout copies
        def heads(role):
            p = _proj(hf, "%s_%s" % (name, role), num_embed,
                      use_bias=use_bias)
            return sym.Reshape(data=p, shape=(-1, seq_len, num_embed),
                               name="%s_%s_seq" % (name, role))

        attn = sym.DotProductAttention(
            query=heads("q"), key=heads("k"), value=heads("v"),
            causal=causal, layout="bsd", num_heads=num_heads,
            name=name + "_attn")
        attn = sym.Reshape(data=attn, shape=(-1, num_embed),
                           name=name + "_attn_merge")
    else:
        def heads(role):
            p = _proj(hf, "%s_%s" % (name, role), num_embed,
                      use_bias=use_bias)
            p = sym.Reshape(data=p,
                            shape=(-1, seq_len, num_heads, head_dim),
                            name="%s_%s_split" % (name, role))
            return sym.transpose(p, axes=(0, 2, 1, 3),
                                 name="%s_%s_t" % (name, role))

        attn = sym.DotProductAttention(
            query=heads("q"), key=heads("k"), value=heads("v"),
            causal=causal, name=name + "_attn")
        attn = sym.transpose(attn, axes=(0, 2, 1, 3),
                             name=name + "_attn_t")
        attn = sym.Reshape(data=attn, shape=(-1, num_embed),
                           name=name + "_attn_merge")
    attn = _proj(attn, name + "_attn_out", num_embed, use_bias=use_bias)
    if dropout > 0.0:
        attn = sym.Dropout(data=attn, p=dropout, name=name + "_attn_drop")
    attn = sym.Reshape(data=attn, shape=(-1, seq_len, num_embed),
                       name=name + "_attn_unflat")
    x = x + attn

    # --- feed-forward sublayer ---
    h = sym.LayerNorm(data=x, name=name + "_ln2")
    hf = sym.Reshape(data=h, shape=(-1, num_embed), name=name + "_ln2_flat")
    ffn = _proj(hf, name + "_ffn1", num_ffn_hidden, use_bias=use_bias)
    ffn = sym.Activation(data=ffn, act_type="gelu", name=name + "_gelu")
    ffn = _proj(ffn, name + "_ffn2", num_embed, use_bias=use_bias)
    if dropout > 0.0:
        ffn = sym.Dropout(data=ffn, p=dropout, name=name + "_ffn_drop")
    ffn = sym.Reshape(data=ffn, shape=(-1, seq_len, num_embed),
                      name=name + "_ffn_unflat")
    return x + ffn


def get_transformer_lm(vocab_size, seq_len, num_layers=2, num_heads=4,
                       num_embed=128, num_ffn_hidden=None, dropout=0.0,
                       causal=True, fused_head=False, use_bias=True,
                       attn_layout="auto"):
    """Decoder-only LM.  data: (batch, seq) token ids; softmax_label:
    (batch, seq) next-token ids.  Loss rows are position-major like the
    reference's unrolled-LSTM head (`example/rnn/lstm.py:102-104`) is
    batch-major — here rows stay (batch*seq, vocab) with labels reshaped to
    match.

    ``fused_head=True`` ends in `FusedSoftmaxCE` (projection and softmax
    CE fused, the logits never materialized; the graph's output is then
    the per-token NLL) instead of FullyConnected + SoftmaxOutput, with
    the same ``pred_weight``/``pred_bias`` parameters.

    ``use_bias=False`` drops every projection bias (the PaLM-style LM
    convention); GPT-2 parity keeps biases (the default).

    ``attn_layout='bsd'`` feeds attention (batch, seq, embed) operands
    (no head split/merge transposes; the kernels read each head through
    strides); 'bhsd' builds the classic head-split transposes.  'auto'
    picks 'bsd' whenever the head width is a multiple of 128, the JAX
    package's rule, kept so both packages build the same graph.  The
    parameter set is the same in both layouts."""
    if num_embed % num_heads != 0:
        raise ValueError("num_embed must be divisible by num_heads")
    if attn_layout not in ("auto", "bsd", "bhsd"):
        raise ValueError(
            "attn_layout must be 'auto', 'bsd', or 'bhsd', got %r"
            % (attn_layout,))
    if attn_layout == "auto":
        attn_layout = "bsd" if (num_embed // num_heads) % 128 == 0 \
            else "bhsd"
    if num_ffn_hidden is None:
        num_ffn_hidden = 4 * num_embed

    data = sym.Variable("data")
    embed = sym.Embedding(data=data, input_dim=vocab_size,
                          output_dim=num_embed, name="embed")
    pos_weight = sym.Variable("pos_embed_weight",
                              shape=(1, seq_len, num_embed))
    x = sym.broadcast_plus(embed, pos_weight, name="pos_add")
    if dropout > 0.0:
        x = sym.Dropout(data=x, p=dropout, name="embed_drop")

    for i in range(num_layers):
        x = transformer_block(x, "layer%d" % i, seq_len, num_heads,
                              num_embed, num_ffn_hidden, dropout=dropout,
                              causal=causal, use_bias=use_bias,
                              attn_layout=attn_layout)

    x = sym.LayerNorm(data=x, name="final_ln")
    xf = sym.Reshape(data=x, shape=(-1, num_embed), name="final_flat")
    label = sym.Variable("softmax_label")
    label_flat = sym.Reshape(data=label, shape=(-1,), name="label_flat")
    if fused_head:
        # no_bias follows use_bias, as for every other projection
        return sym.FusedSoftmaxCE(data=xf, label=label_flat,
                                  num_hidden=vocab_size, name="pred",
                                  no_bias=not use_bias)
    logits = sym.FullyConnected(data=xf, num_hidden=vocab_size,
                                name="pred", no_bias=not use_bias)
    return sym.SoftmaxOutput(data=logits, label=label_flat, name="softmax")

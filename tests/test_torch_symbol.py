"""The port's symbol layer against the JAX package's, on the CPU.

Both packages build the transformer LM as a Symbol graph.  From the same
arguments they must give the same argument and auxiliary-state names in
the same order, the same inferred shapes and the same JSON, and each
package must load the JSON the other saves.  Each package counts its
automatic names per process, so every graph here is built under a fresh
`NameManager` of both.
"""
import contextlib
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import models as jmodels
from mxnet_tpu_torch.base import MXNetError

V, S, L, H, E = 61, 32, 2, 2, 32
SHAPES = {"data": (4, S), "softmax_label": (4, S)}


@contextlib.contextmanager
def fresh_names():
    with jmx.name.NameManager(), tmx.name.NameManager():
        yield


def _both(**kw):
    args = dict(vocab_size=V, seq_len=S, num_layers=L, num_heads=H,
                num_embed=E)
    args.update(kw)
    with fresh_names():
        return (jmodels.get_transformer_lm(**args),
                tmx.models.get_transformer_lm(**args))


CONFIGS = [dict(attn_layout=layout, use_bias=bias)
           for layout in ("bhsd", "bsd") for bias in (True, False)]
# the fused CE head (`FusedSoftmaxCE`), with and without its bias
CONFIGS += [dict(attn_layout="bhsd", use_bias=bias, fused_head=True)
            for bias in (True, False)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_transformer_lm_graph_equals_jax(kw):
    jnet, tnet = _both(**kw)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    assert tnet.list_outputs() == jnet.list_outputs()
    assert tnet.infer_shape(**SHAPES) == jnet.infer_shape(**SHAPES)
    assert tnet.tojson() == jnet.tojson()
    assert ("layer0_q_bias" in tnet.list_arguments()) == kw["use_bias"]
    assert ("pred_bias" in tnet.list_arguments()) == kw["use_bias"]


@pytest.mark.parametrize("kw", CONFIGS)
def test_each_package_loads_the_others_json(kw):
    jnet, tnet = _both(**kw)
    from_jax = tmx.symbol.loads(jnet.tojson())
    from_port = jmx.symbol.loads(tnet.tojson())
    assert from_jax.tojson() == jnet.tojson()
    assert from_port.tojson() == tnet.tojson()
    assert from_jax.infer_shape(**SHAPES) == jnet.infer_shape(**SHAPES)


def test_auto_layout_follows_the_head_width():
    """'auto' is 'bsd' where the head width is a multiple of 128 (as the
    JAX package decides), 'bhsd' otherwise; both packages agree."""
    for e, heads, want in ((256, 2, "bsd"), (256, 4, "bhsd")):
        jauto, tauto = _both(num_embed=e, num_heads=heads)
        _, tfixed = _both(num_embed=e, num_heads=heads, attn_layout=want)
        assert tauto.tojson() == jauto.tojson() == tfixed.tojson()
    _, bsd = _both(attn_layout="bsd")
    _, bhsd = _both(attn_layout="bhsd")
    assert bsd.list_arguments() == bhsd.list_arguments()
    assert bsd.tojson() != bhsd.tojson()


def test_variable_shape_hint_add_and_group():
    """`Variable(shape=)` completes shape inference; `+` builds `_Plus` (and
    `_PlusScalar` for a number); `Group` lists both heads, as in JAX."""
    built = []
    for mx in (jmx, tmx):
        with fresh_names():
            a = mx.sym.Variable("a", shape=(2, 3))
            b = mx.sym.Variable("b")
            c = mx.sym.Activation(data=a + b, act_type="relu", name="act")
            built.append(mx.sym.Group([c, a + 1.5]))
    jg, tg = built
    assert tg.list_outputs() == jg.list_outputs()
    assert tg.infer_shape() == jg.infer_shape()
    assert tg.infer_shape()[0] == [(2, 3), (2, 3)]
    assert tg.tojson() == jg.tojson()
    assert json.loads(tg.tojson())["nodes"][0]["attr"] == {
        "__shape__": "(2, 3)"}


def test_symbol_errors_are_readable():
    with pytest.raises(MXNetError, match="unknown operator"):
        tmx.symbol.loads(json.dumps({
            "nodes": [{"op": "NoSuchOp", "name": "x", "inputs": []}],
            "arg_nodes": [], "heads": [[0, 0]]}))
    with pytest.raises(MXNetError, match="unknown parameters"):
        tmx.sym.FullyConnected(data=tmx.sym.Variable("x"), num_hidden=2,
                               bogus=1)
    with pytest.raises(MXNetError, match="not an argument"):
        tmx.sym.Variable("x").infer_shape(y=(2,))
    with pytest.raises(ValueError, match="attn_layout must be"):
        tmx.models.get_transformer_lm(V, S, attn_layout="ds")
    _, tnet = _both()
    assert tnet.infer_shape(data=(4, S)) == (None, None, None)


def test_infer_shape_gives_the_parameter_shapes():
    _, tnet = _both(use_bias=True)
    arg, out, aux = tnet.infer_shape(**SHAPES)
    shapes = dict(zip(tnet.list_arguments(), arg))
    assert shapes["embed_weight"] == (V, E)
    assert shapes["pos_embed_weight"] == (1, S, E)
    assert shapes["layer0_ffn1_weight"] == (4 * E, E)
    assert shapes["pred_weight"] == (V, E) and shapes["pred_bias"] == (V,)
    assert out == [(4 * S, V)] and aux == []
    assert np.prod(shapes["final_ln_gamma"]) == E


def test_fused_head_outputs_the_per_token_nll():
    """``fused_head=True`` ends in `FusedSoftmaxCE`: one float32 NLL per
    token, over the dense head's ``pred_weight``/``pred_bias``."""
    jnet, tnet = _both(fused_head=True)
    arg, out, _ = tnet.infer_shape(**SHAPES)
    shapes = dict(zip(tnet.list_arguments(), arg))
    assert out == [(4 * S,)] == jnet.infer_shape(**SHAPES)[1]
    assert shapes["pred_weight"] == (V, E) and shapes["pred_bias"] == (V,)
    assert tnet.list_outputs() == ["pred_output"]
    _, dense = _both()
    assert sorted(dense.list_arguments()) == sorted(tnet.list_arguments())

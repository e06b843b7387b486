"""The port's rematerialization pins against the JAX package's, on the CPU.

The counterparts of `tests/test_remat_policy.py`: the policy selector
(`_mirror_policy`: precedence and errors), remat invisible to the
numerics, ``attn`` on a small transformer, ``force_mirroring`` segments
(the plan equal to `mxnet_tpu.executor._mirror_segments` node for node)
and segment remat with aux states; then Dropout under every setting,
`SPMDTrainer` honouring the pins, a whole-graph policy's regions cut on
the graph's edges whatever its nodes are called, ``act_out`` copied only
where a policy keeps it, and the 'ds' route's operands copied once.

Bars: within the port, every setting's outputs, gradients and aux states
are bit for bit the plain walk's (remat changes when values are
computed, never what: the same ops run on the same inputs, randomness
included, since each Dropout node builds its generator from the step's
key inside the recomputed region).  Against the JAX package, the same
numpy inputs and parameters give outputs and gradients within 1e-4 of
each array's largest magnitude (float32 on both sides, sums in another
order); a bias whose true gradient is zero (the LM's key projections',
a bias just before a BatchNorm) within 1e-4 of the model's largest
gradient.  The flash forward's calls a step are counted through
`_forward`: L with nothing kept or ``attn``/``streams`` (its out and lse
kept), 2L where it is recomputed (``dots``, ``nothing``, MIRROR_STEP).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401
from mxnet_tpu import executor as jexe
from mxnet_tpu import name as jname
from mxnet_tpu.symbol import _topo_order as j_topo
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import executor as texe
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch import remat
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.pallas_kernels import flash_attention as tfa
from mxnet_tpu_torch.symbol import _topo_order as t_topo
from test_torch_kernels import _one_thread  # noqa: F401


PK = {"jax": jmx, "torch": tmx}
PINS = ("MXNET_BACKWARD_DO_MIRROR", "MXNET_BACKWARD_MIRROR_POLICY",
        "MXNET_BACKWARD_MIRROR_STEP")
REL = 1e-4
SETTINGS = {
    "dots": {"MXNET_BACKWARD_MIRROR_POLICY": "dots"},
    "attn": {"MXNET_BACKWARD_MIRROR_POLICY": "attn"},
    "streams": {"MXNET_BACKWARD_MIRROR_POLICY": "streams"},
    "nothing": {"MXNET_BACKWARD_MIRROR_POLICY": "nothing"},
    "do_mirror": {"MXNET_BACKWARD_DO_MIRROR": "1"},
    "step2": {"MXNET_BACKWARD_MIRROR_STEP": "2"},
    "step1": {"MXNET_BACKWARD_MIRROR_STEP": "1"},
    "step3+nothing": {"MXNET_BACKWARD_MIRROR_STEP": "3",
                      "MXNET_BACKWARD_MIRROR_POLICY": "nothing"},
    "block": {"MXNET_BACKWARD_MIRROR_STEP": "block"},
}


@pytest.fixture(autouse=True)
def own_names():
    """Each test names its nodes in managers of its own, so the packages'
    global name counters (``plus<n>``), which other test files compare
    across packages, move alike."""
    with tname.NameManager(), jname.NameManager():
        yield


def _with_env(monkeypatch, **env):
    for k in PINS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _close(got, want, what, scale=None):
    """Within `REL` of max|want| (of ``scale`` where given: the model's
    largest gradient, for a gradient whose true value is zero)."""
    scale = max(float(np.abs(want).max()) if scale is None else scale,
                1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= REL, "%s: %.2e of max|ref|" % (what, err)


def _mlp(mx, dropout=0.0):
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data=net, num_hidden=16, name="fc1")
    net = mx.sym.Activation(data=net, act_type="tanh", name="t1")
    if dropout:
        net = mx.sym.Dropout(data=net, p=dropout, name="drop1")
    net = mx.sym.FullyConnected(data=net, num_hidden=8, name="fc2")
    net = mx.sym.Activation(data=net, act_type="relu", name="r1")
    net = mx.sym.FullyConnected(data=net, num_hidden=4, name="fc3")
    return mx.sym.SoftmaxOutput(data=net, name="softmax")


def _bn_net(mx):
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data=net, num_hidden=8, name="fc1")
    net = mx.sym.BatchNorm(data=net, name="bn1")
    net = mx.sym.Activation(data=net, act_type="relu", name="r1")
    net = mx.sym.FullyConnected(data=net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(data=net, name="softmax")


def _lm(mx):
    return mx.models.get_transformer_lm(vocab_size=13, seq_len=8,
                                        num_layers=2, num_heads=2,
                                        num_embed=16)


def _run(which, net, shapes, seed=0, classes=4, tokens=False):
    """One training forward and backward through ``bind`` in package
    ``which`` from seeded numpy inputs: (outputs, grads, aux), numpy."""
    mx = PK[which]
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = net.infer_shape(**shapes)
    args, grads = {}, {}
    for name, s in zip(net.list_arguments(), arg_shapes):
        if name == "softmax_label" or (tokens and name == "data"):
            a = rng.randint(0, classes, s).astype(np.float32)
        elif name == "data":
            a = rng.randn(*s).astype(np.float32)
        else:
            a = (rng.randn(*s) * 0.3).astype(np.float32)
        args[name] = mx.nd.array(a, ctx=mx.cpu())
        grads[name] = mx.nd.zeros(s, ctx=mx.cpu())
    aux = [mx.nd.array(np.ones(s, np.float32) if n.endswith("var")
                       else np.zeros(s, np.float32), ctx=mx.cpu())
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)]
    exe = net.bind(mx.cpu(), args, args_grad=grads, aux_states=aux)
    exe.forward(is_train=True)
    exe.backward()
    return ([o.asnumpy() for o in exe.outputs],
            {k: g.asnumpy() for k, g in grads.items()},
            {n: a.asnumpy() for n, a in zip(net.list_auxiliary_states(),
                                            exe.aux_arrays)})


def _same(a, b):
    """Bit for bit: outputs, gradients and aux states."""
    for x, y in zip(a[0], b[0]):
        assert np.array_equal(x, y)
    for part in (1, 2):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert np.array_equal(a[part][k], b[part][k]), k


@pytest.fixture()
def flash_calls(monkeypatch):
    """Counts the flash forward's runs (the kernel's, or on the CPU its
    plain version's)."""
    calls = [0]
    forward = tfa._forward

    def counted(*a, **k):
        calls[0] += 1
        return forward(*a, **k)

    monkeypatch.setattr(tfa, "_forward", counted)
    return calls


def test_policy_selector(monkeypatch):
    """The precedence and errors of the JAX selector: unset is None,
    DO_MIRROR=1 or 'dots' is `_mirror_saveable`, an explicit 'none' wins
    over DO_MIRROR, an unknown policy raises with the JAX message."""
    _with_env(monkeypatch)
    assert texe._mirror_policy() is None
    for env in ({"MXNET_BACKWARD_DO_MIRROR": "1"},
                {"MXNET_BACKWARD_DO_MIRROR": "true"},
                {"MXNET_BACKWARD_MIRROR_POLICY": "dots"},
                {"MXNET_BACKWARD_MIRROR_POLICY": "DOTS"}):
        _with_env(monkeypatch, **env)
        assert texe._mirror_policy() is texe._mirror_saveable
        assert jexe._mirror_policy() is jexe._mirror_saveable
    for pol, names in (("attn", {"attn_out"}), ("attn_out", {"attn_out"}),
                       ("streams", {"attn_out", "act_out"})):
        _with_env(monkeypatch, MXNET_BACKWARD_MIRROR_POLICY=pol)
        assert texe._mirror_policy().names == names
    _with_env(monkeypatch, MXNET_BACKWARD_MIRROR_POLICY="nothing")
    assert texe._mirror_policy() is remat.nothing_saveable
    _with_env(monkeypatch, MXNET_BACKWARD_DO_MIRROR="0")
    assert texe._mirror_policy() is None
    _with_env(monkeypatch, MXNET_BACKWARD_DO_MIRROR="1",
              MXNET_BACKWARD_MIRROR_POLICY="none")
    assert texe._mirror_policy() is None
    assert jexe._mirror_policy() is None
    _with_env(monkeypatch, MXNET_BACKWARD_MIRROR_POLICY="bogus")
    with pytest.raises(jmx.base.MXNetError) as jerr:
        jexe._mirror_policy()
    with pytest.raises(MXNetError) as terr:
        texe._mirror_policy()
    assert str(terr.value) == str(jerr.value)
    # the executor reads the pin at bind: a bad one refuses the bind
    with pytest.raises(MXNetError, match="MXNET_BACKWARD_MIRROR_POLICY"):
        _mlp(tmx).simple_bind(tmx.cpu(), data=(6, 10), softmax_label=(6,))


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_remat_is_invisible_to_numerics(monkeypatch, setting):
    """Each setting: the port's outputs and gradients bit for bit its plain
    walk's, and within 1e-4 of the JAX package's under the same pins."""
    shapes = {"data": (6, 10), "softmax_label": (6,)}
    _with_env(monkeypatch)
    ref = _run("torch", _mlp(tmx), shapes)
    _with_env(monkeypatch, **SETTINGS[setting])
    got = _run("torch", _mlp(tmx), shapes)
    _same(got, ref)
    want = _run("jax", _mlp(jmx), shapes)
    _close(got[0][0], want[0][0], "out")
    for k in want[1]:
        _close(got[1][k], want[1][k], k)


@pytest.mark.parametrize("setting,calls", [
    ("none", 2), ("attn", 2), ("streams", 2), ("dots", 4), ("nothing", 4),
    ("block", 4)])
def test_attn_policy_on_transformer(monkeypatch, flash_calls, setting,
                                    calls):
    """The small transformer under each policy: gradients bit for bit the
    plain walk's and within 1e-4 of the JAX package's; the flash forward
    runs once a layer where its out and lse are kept, twice where the
    backward recomputes it."""
    shapes = {"data": (2, 8), "softmax_label": (2, 8)}
    kw = dict(classes=13, tokens=True, seed=1)
    _with_env(monkeypatch)
    ref = _run("torch", _lm(tmx), shapes, **kw)
    _with_env(monkeypatch, **SETTINGS.get(setting, {}))
    flash_calls[0] = 0
    got = _run("torch", _lm(tmx), shapes, **kw)
    assert flash_calls[0] == calls
    _same(got, ref)
    want = _run("jax", _lm(jmx), shapes, **kw)
    # the key-projection biases' true gradient is zero (the softmax
    # cancels them): rounding noise, held against the largest gradient
    top = max(float(np.abs(g).max()) for g in want[1].values())
    for k in want[1]:
        _close(got[1][k], want[1][k], k,
               scale=top if k.endswith("k_bias") else None)


def _plan(segments, order=None):
    """A segment plan by node name or, given the topological order, by
    each node's position in it and its op (auto-generated names count
    every symbol a process has built)."""
    if segments is None:
        return None
    if order is None:
        return [([n.name for n in nodes], keep) for nodes, keep in segments]
    at = {id(n): i for i, n in enumerate(order)}
    return [([(at[id(n)], n.op.name) for n in nodes], keep)
            for nodes, keep in segments]


def test_force_mirroring_attr_segments(monkeypatch):
    """force_mirroring='0' pins a node as a boundary, truthy keeps the run
    going past the step count: the port's plan is the JAX package's node
    for node, at steps 1, 2 and 3 and per block, and the numerics are the
    plain walk's."""
    def build(mx):
        data = mx.sym.Variable("data")
        h = mx.sym.FullyConnected(data=data, num_hidden=16, name="fc1")
        with mx.AttrScope(force_mirroring="1"):
            h = mx.sym.Activation(data=h, act_type="tanh", name="t1")
        with mx.AttrScope(force_mirroring="0"):
            h = mx.sym.FullyConnected(data=h, num_hidden=8, name="fc2")
        h = mx.sym.Activation(data=h, act_type="relu", name="r1")
        h = mx.sym.FullyConnected(data=h, num_hidden=4, name="fc3")
        return mx.sym.SoftmaxOutput(data=h, name="softmax")

    tnet, jnet = build(tmx), build(jmx)
    for step in ("1", "2", "3", "block"):
        _with_env(monkeypatch, MXNET_BACKWARD_MIRROR_STEP=step)
        got = _plan(texe._mirror_segments(t_topo(tnet._heads)))
        assert got == _plan(jexe._mirror_segments(j_topo(jnet._heads)))
    _with_env(monkeypatch, MXNET_BACKWARD_MIRROR_STEP="2")
    segs = _plan(texe._mirror_segments(t_topo(tnet._heads)))
    by_node = {n: keep for names, keep in segs for n in names}
    assert by_node["fc2"] is False and by_node["fc1"] and by_node["t1"]
    assert max(len(names) for names, keep in segs if keep) == 2
    # the LM per block: its layers are the segments, in both packages
    _with_env(monkeypatch, MXNET_BACKWARD_MIRROR_STEP="block")
    t_order, j_order = t_topo(_lm(tmx)._heads), j_topo(_lm(jmx)._heads)
    got = _plan(texe._mirror_segments(t_order), t_order)
    assert got == _plan(jexe._mirror_segments(j_order), j_order)
    assert any(keep for _, keep in got) and not all(keep for _, keep in got)

    shapes = {"data": (6, 10), "softmax_label": (6,)}
    _with_env(monkeypatch)
    ref = _run("torch", build(tmx), shapes)
    _with_env(monkeypatch, MXNET_BACKWARD_MIRROR_STEP="2")
    got = _run("torch", build(tmx), shapes)
    _same(got, ref)
    want = _run("jax", build(jmx), shapes)
    for k in want[1]:
        _close(got[1][k], want[1][k], k)


@pytest.mark.parametrize("setting", ["step2", "nothing", "dots"])
def test_segment_remat_with_aux_state(monkeypatch, setting):
    """BatchNorm inside a region: its moving statistics take the forward's
    update once (the backward's recompute writes none), bit for bit the
    plain walk's and within 1e-4 of the JAX package's."""
    shapes = {"data": (6, 10), "softmax_label": (6,)}
    _with_env(monkeypatch)
    ref = _run("torch", _bn_net(tmx), shapes, seed=2)
    _with_env(monkeypatch, **SETTINGS[setting])
    got = _run("torch", _bn_net(tmx), shapes, seed=2)
    _same(got, ref)
    want = _run("jax", _bn_net(jmx), shapes, seed=2)
    # fc1's bias, just before the BatchNorm, has a true gradient of zero
    top = max(float(np.abs(g).max()) for g in want[1].values())
    for k in want[1]:
        _close(got[1][k], want[1][k], k,
               scale=top if k == "fc1_bias" else None)
    for k in want[2]:
        _close(got[2][k], want[2][k], k)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_dropout_under_every_setting(monkeypatch, setting):
    """Dropout(0.3) under each setting: the recompute draws the forward's
    mask (the node's generator is built from the step's key inside the
    region), so outputs and gradients are bit for bit the plain walk's."""
    shapes = {"data": (6, 10), "softmax_label": (6,)}
    _with_env(monkeypatch)
    ref = _run("torch", _mlp(tmx, dropout=0.3), shapes, seed=4)
    assert (ref[1]["fc2_weight"] != 0).any()
    _with_env(monkeypatch, **SETTINGS[setting])
    got = _run("torch", _mlp(tmx, dropout=0.3), shapes, seed=4)
    _same(got, ref)


@pytest.mark.parametrize("setting,calls", [
    ("none", 2), ("attn", 2), ("dots", 4), ("nothing", 4), ("block", 4)])
def test_spmd_trainer_honours_the_pins(monkeypatch, flash_calls, setting,
                                       calls):
    """`SPMDTrainer` reads the pins at construction: each setting's
    gradients and two `run_steps` of Adam are bit for bit the plain
    trainer's, and the flash forward runs as the policy says."""
    shapes = {"data": (2, 8), "softmax_label": (2, 8)}
    rng = np.random.RandomState(5)
    batch = {n: rng.randint(0, 13, s).astype(np.float32)
             for n, s in shapes.items()}

    def trainer():
        tmx.random.seed(3)
        return tmx.SPMDTrainer(_lm(tmx), data_shapes=shapes, ctx="cpu",
                               optimizer="adam", lr=0.01)

    _with_env(monkeypatch)
    plain = trainer()
    ref = plain.gradients(batch)
    plain.run_steps(batch, 2)
    _with_env(monkeypatch, **SETTINGS.get(setting, {}))
    t = trainer()
    flash_calls[0] = 0
    got = t.gradients(batch)
    assert flash_calls[0] == calls
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    t.run_steps(batch, 2)
    for k in plain.params:
        assert torch.equal(t.params[k], plain.params[k]), k


def _memcost_net(mx, depth=24, width=4, prefix="conv"):
    """`examples/memcost.py`'s deep net (narrow), its nodes named from
    ``prefix``."""
    x = mx.sym.Variable("data")
    for i in range(depth):
        x = mx.sym.Convolution(data=x, kernel=(3, 3), pad=(1, 1),
                               num_filter=width, name="%s%d" % (prefix, i))
        x = mx.sym.Activation(data=x, act_type="relu",
                              name="%s_relu%d" % (prefix, i))
    x = mx.sym.Pooling(data=x, pool_type="avg", kernel=(8, 8), name="gap")
    x = mx.sym.Flatten(data=x)
    x = mx.sym.FullyConnected(data=x, num_hidden=10, name="fc")
    return mx.sym.SoftmaxOutput(data=x, name="softmax")


def _crossing(order, heads, nodes_before):
    """The entries made by ``nodes_before`` that a later op reads (heads
    not counted)."""
    made = {id(n) for n in nodes_before}
    heads = {(id(s), i) for s, i in heads}
    return {(id(s), i) for n in order if not n.is_variable
            and id(n) not in made for s, i in n.inputs
            if id(s) in made and (id(s), i) not in heads}


@pytest.mark.parametrize("which", ["memcost", "lm"])
def test_policy_regions_do_not_depend_on_names(which):
    """A whole-graph policy's regions (`_sqrt_runs`): about sqrt(N) runs
    of the N op nodes, in order, each at least ceil(sqrt(N)) long but the
    last, cut where the fewest entries cross (one activation on these
    chains), and the same plan whatever the nodes are called."""
    if which == "memcost":
        nets = [_memcost_net(tmx, prefix=p) for p in ("conv", "layer")]
    else:
        nets = [tmx.models.get_transformer_lm(
            vocab_size=13, seq_len=8, num_layers=12, num_heads=2,
            num_embed=16) for _ in range(2)]
        # the second with no ``layer<k>_`` name left
        for node in t_topo(nets[1]._heads):
            node.name = "n%d" % id(node)
    plans = []
    for net in nets:
        order = t_topo(net._heads)
        runs = texe._sqrt_runs(order, net._heads)
        ops = [n for n in order if not n.is_variable]
        assert [n for run in runs for n in run] == ops
        size = int(np.ceil(np.sqrt(len(ops))))
        assert all(len(run) >= size for run in runs[:-1])
        assert len(runs) <= len(ops) / size + 1
        done = []
        for run in runs[:-1]:
            done += run
            assert len(_crossing(order, net._heads, done)) == 1
        at = {id(n): i for i, n in enumerate(ops)}
        plans.append([[at[id(n)] for n in run] for run in runs])
    assert plans[0] == plans[1]


@pytest.mark.parametrize("setting,copies", [
    ("none", 0), ("dots", 0), ("attn", 0), ("nothing", 0), ("streams", 4)])
def test_act_out_copied_only_where_kept(monkeypatch, setting, copies):
    """``Activation`` tags ``act_out`` through ``mxt::checkpoint_name`` (a
    copy) only inside a region whose policy keeps it: ``streams`` copies
    each of the LM's 2 GELU outputs in the forward and the recompute;
    the other policies copy nothing."""
    calls = [0]
    tag = remat._checkpoint_name

    def counted(x, name):
        calls[0] += 1
        return tag(x, name)

    monkeypatch.setattr(remat, "_checkpoint_name", counted)
    _with_env(monkeypatch, **SETTINGS.get(setting, {}))
    _run("torch", _lm(tmx), {"data": (2, 8), "softmax_label": (2, 8)},
         classes=13, tokens=True, seed=1)
    assert calls[0] == copies


def test_ds_residuals_copied_once(monkeypatch):
    """On the 'ds' route the flash op hands its backward the (B, H, D, S)
    copies of q, k and v that its forward made: three copies a call, none
    again in the backward, under a remat policy too."""
    copies = [0]
    to_ds = tfa._to_ds

    def counted(t):
        copies[0] += 1
        return to_ds(t)

    monkeypatch.setattr(tfa, "_to_ds", counted)
    monkeypatch.setenv("MXNET_FLASH_LAYOUT", "ds")
    rng = np.random.RandomState(6)
    q, k, v = (torch.tensor(rng.randn(1, 2, 8, 16), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    want = torch.autograd.grad(
        tfa.flash_attention_plain(q, k, v, causal=True).sum(), (q, k, v))
    got = torch.autograd.grad(
        tfa.flash_attention(q, k, v, causal=True).sum(), (q, k, v))
    assert copies[0] == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    copies[0] = 0

    def f(q, k, v):
        return tfa.flash_attention(q, k, v, causal=True, name="attn_out")

    out = remat.run_region(f, remat.save_only_these_names("attn_out"),
                           q, k, v)
    again = torch.autograd.grad(out.sum(), (q, k, v))
    assert copies[0] == 3
    for a, b in zip(again, want):
        assert torch.equal(a, b)

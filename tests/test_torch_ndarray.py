"""The port's Context and NDArray against the JAX package's, on the CPU.

* Every op, view and creation function gives the JAX `NDArray`'s values
  on the same numpy inputs (exactly: each is one float32 operation).
* A view (`slice`, `__getitem__`, `reshape`) writes through to the array
  it came from.  The JAX package's `reshape` is a copy; the port's is the
  reference's view (`ndarray.h:241-250`).
* `nd.save` writes the JAX package's bytes: a file saved by either
  package loads in the other, and saving what was loaded gives the same
  bytes again.
* Deliberate difference: `current_context()` with no ``with`` scope is
  ``gpu(0)`` in the port (``cpu(0)`` in the JAX package), and without a
  card its `torch_device()` raises rather than running on the CPU.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError


def _x(shape=(4, 3), seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + 0.1).astype(dtype)


def _both(fn, *arrays):
    """fn over NDArrays of each package made from the same numpy arrays."""
    j = fn(jmx, *[jmx.nd.array(a, dtype=a.dtype) for a in arrays])
    t = fn(tmx, *[tmx.nd.array(a, ctx=tmx.cpu(), dtype=a.dtype)
                  for a in arrays])
    return j, t


def _same(j, t):
    assert t.shape == j.shape
    assert np.dtype(t.dtype) == np.dtype(j.dtype)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


BINARY = {
    "add": lambda mx, a, b: a + b, "sub": lambda mx, a, b: a - b,
    "mul": lambda mx, a, b: a * b, "div": lambda mx, a, b: a / b,
    "pow": lambda mx, a, b: (a * a) ** b, "eq": lambda mx, a, b: a == a.copy(),
    "add_s": lambda mx, a, b: a + 2.5, "radd_s": lambda mx, a, b: 2.5 + a,
    "rsub_s": lambda mx, a, b: 1.5 - a, "rmul_s": lambda mx, a, b: 3 * a,
    "rdiv_s": lambda mx, a, b: 2.0 / a, "neg": lambda mx, a, b: -a,
    "eq_s": lambda mx, a, b: a == 0.0,
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_arithmetic_matches_the_jax_ndarray(op):
    _same(*_both(BINARY[op], _x(), _x(seed=1)))


INPLACE = {"iadd": "__iadd__", "isub": "__isub__", "imul": "__imul__",
           "idiv": "__itruediv__"}


@pytest.mark.parametrize("op", sorted(INPLACE))
def test_inplace_operators_match(op):
    def run(mx, a, b):
        getattr(a, INPLACE[op])(b)
        getattr(a, INPLACE[op])(0.5)
        return a

    _same(*_both(run, _x(), _x(seed=1)))


VIEWS = {
    "slice": lambda mx, a: a.slice(1, 3),
    "getitem_int": lambda mx, a: a[2],
    "getitem_slice": lambda mx, a: a[1:],
    "reshape": lambda mx, a: a.reshape((3, 4)),
    "astype_int": lambda mx, a: a.astype(np.int32),
    "astype_f16": lambda mx, a: a.astype(np.float16),
    "copy": lambda mx, a: a.copy(),
    "T": lambda mx, a: a.T,
    "copyto_ctx": lambda mx, a: a.copyto(mx.cpu()),
    "as_in_context": lambda mx, a: a.as_in_context(mx.cpu()),
}


@pytest.mark.parametrize("op", sorted(VIEWS))
def test_views_and_conversions_match(op):
    _same(*_both(VIEWS[op], _x()))


def test_properties_and_scalars_match():
    j, t = _both(lambda mx, a: a, _x())
    assert (t.shape, t.size, len(t)) == (j.shape, j.size, len(j))
    assert np.dtype(t.dtype) == np.dtype(j.dtype)
    assert str(t.context) == str(j.context) == "cpu(0)"
    j1, t1 = _both(lambda mx, a: a, _x((1,)))
    assert t1.asscalar() == j1.asscalar()
    with pytest.raises(MXNetError):
        t.asscalar()


SETITEM = {
    "all_scalar": lambda mx, a, b: a.__setitem__(slice(None), 1.25),
    "all_array": lambda mx, a, b: a.__setitem__(slice(None), b),
    "row_scalar": lambda mx, a, b: a.__setitem__(1, -2.0),
    "rows_array": lambda mx, a, b: a.__setitem__(slice(1, 3), b[:2]),
    "copyto": lambda mx, a, b: b.copyto(a),
}


@pytest.mark.parametrize("op", sorted(SETITEM))
def test_setitem_and_copyto_match(op):
    def run(mx, a, b):
        SETITEM[op](mx, a, b)
        return a

    _same(*_both(run, _x(), _x(seed=1)))


def test_views_write_through():
    a = tmx.nd.array(_x(), ctx=tmx.cpu())
    ref = _x()
    a.slice(1, 3)[:] = 5.0
    ref[1:3] = 5.0
    a[0][:] = -1.0
    ref[0] = -1.0
    v = a.reshape((12,))
    v[3:5] = 7.0
    ref.reshape(12)[3:5] = 7.0
    np.testing.assert_array_equal(a.asnumpy(), ref)
    # the JAX package's reshape is a copy: the same write leaves it as is
    j = jmx.nd.array(_x())
    j.reshape((12,))[3:5] = 7.0
    np.testing.assert_array_equal(j.asnumpy(), _x())


def test_errors_are_mxnet_errors():
    a = tmx.nd.array(_x(), ctx=tmx.cpu())
    with pytest.raises(MXNetError):
        a.copyto(tmx.nd.zeros((2, 2), ctx=tmx.cpu()))
    with pytest.raises(MXNetError):
        a[1:3] = np.zeros((3, 3), np.float32)
    with pytest.raises(MXNetError):
        a[::2]
    with pytest.raises(MXNetError):
        a.slice(0, 3).T.reshape((12,))


CREATE = {
    "zeros": lambda mx, c: mx.nd.zeros((2, 3), c),
    "ones_int": lambda mx, c: mx.nd.ones((2, 3), c, dtype=np.int32),
    "full": lambda mx, c: mx.nd.full((3,), 2.5, c),
    "empty": lambda mx, c: mx.nd.empty((4,), c),
    "array_list": lambda mx, c: mx.nd.array([[1, 2], [3, 4]], ctx=c),
    "array_f64": lambda mx, c: mx.nd.array(np.arange(5.0), ctx=c),
    "array_int": lambda mx, c: mx.nd.array(np.arange(5, dtype=np.int32),
                                           ctx=c),
    "arange": lambda mx, c: mx.nd.arange(1, 7, 1.5, ctx=c),
    "arange_stop": lambda mx, c: mx.nd.arange(4, ctx=c),
    "concatenate": lambda mx, c: mx.nd.concatenate(
        [mx.nd.ones((2, 2), c), mx.nd.zeros((1, 2), c)]),
    "onehot": lambda mx, c: mx.nd.onehot_encode(
        mx.nd.array([2, 0, 3], ctx=c), mx.nd.zeros((3, 4), c)),
}


@pytest.mark.parametrize("op", sorted(CREATE))
def test_creation_matches(op):
    _same(CREATE[op](jmx, jmx.cpu()), CREATE[op](tmx, tmx.cpu()))


def _params():
    return {"w": _x((3, 4)), "b": _x((4,), 1), "h": _x((2, 2), 2, np.float16),
            "i": np.arange(6, dtype=np.int32).reshape(2, 3),
            "u": np.arange(5, dtype=np.uint8),
            "bf": _x((3,), 3).astype(ml_dtypes.bfloat16)}


def _nd_dict(mx, params):
    out = {}
    for k, v in params.items():
        if v.dtype == ml_dtypes.bfloat16 and mx is tmx:
            t = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
            out[k] = tmx.nd.NDArray(t, tmx.cpu())
        else:
            out[k] = mx.nd.array(v, ctx=mx.cpu(), dtype=v.dtype)
    return out


@pytest.mark.parametrize("first", ["torch", "jax"])
def test_save_load_across_packages_same_bytes(tmp_path, first):
    pk = {"torch": tmx, "jax": jmx}
    a, b = pk[first], pk["jax" if first == "torch" else "torch"]
    params = _params()
    f1, f2 = tmp_path / "a.params", tmp_path / "b.params"
    a.nd.save(str(f1), _nd_dict(a, params))
    loaded = b.nd.load(str(f1))
    assert sorted(loaded) == sorted(params)
    for k, v in params.items():
        got = loaded[k].asnumpy()
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      v.astype(np.float32))
        assert str(loaded[k].context) == "cpu(0)"
    b.nd.save(str(f2), loaded)
    assert f1.read_bytes() == f2.read_bytes()
    # a list (no names) round-trips too
    a.nd.save(str(f1), [a.nd.array(_x(), ctx=a.cpu())])
    (arr,) = b.nd.load(str(f1))
    np.testing.assert_array_equal(arr.asnumpy(), _x())


def test_load_rejects_a_corrupt_file(tmp_path):
    p = tmp_path / "bad.params"
    tmx.nd.save(str(p), {"w": tmx.nd.array(_x(), ctx=tmx.cpu())})
    p.write_bytes(p.read_bytes()[:40])
    with pytest.raises(MXNetError):
        tmx.nd.load(str(p))
    p.write_bytes(b"\x00" * 32)
    with pytest.raises(MXNetError):
        tmx.nd.load(str(p))


def test_contexts_and_their_type_ids():
    assert tmx.tpu(1) == tmx.gpu(1) and hash(tmx.tpu(1)) == hash(tmx.gpu(1))
    assert tmx.cpu(1) != tmx.cpu(0)
    assert tmx.gpu(0).device_typeid == jmx.tpu(0).device_typeid == 2
    assert tmx.cpu(3).device_typeid == jmx.cpu(3).device_typeid == 1
    assert tmx.cpu(1).torch_device() == torch.device("cpu")
    assert str(tmx.Context(tmx.cpu(2))) == "cpu(2)"
    with pytest.raises(MXNetError):
        tmx.Context("fpga")
    assert tmx.context.num_devices("cpu") == 1


def test_default_context_is_the_card(monkeypatch):
    """Deliberate difference: the JAX package's default is cpu(0)."""
    assert jmx.current_context() == jmx.cpu(0)
    assert tmx.current_context() == tmx.gpu(0)
    with tmx.cpu(1):
        assert tmx.current_context() == tmx.cpu(1)
        assert tmx.nd.zeros((2,)).context == tmx.cpu(1)
    assert tmx.current_context() == tmx.gpu(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.current_context().torch_device()
    with pytest.raises(MXNetError):
        tmx.nd.zeros((2,))


def test_sync_points_run_on_the_cpu():
    a = tmx.nd.array(_x(), ctx=tmx.cpu())
    a.wait_to_read()
    a.wait_to_write()
    tmx.nd.waitall()
    assert "4x3" in repr(a)

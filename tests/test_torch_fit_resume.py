"""Mid-epoch auto-checkpoints and exact resume in the port, on the CPU.

* `Module.fit` with ``auto_checkpoint``/``checkpoint_every`` interrupted
  mid-epoch (after a checkpoint; the exception stands in for a kill)
  and finished by a fresh module with ``resume="auto"`` ends at the
  uninterrupted run's parameters bit for bit, with a shuffling iterator,
  SGD momentum, in every kvstore mode: none, 'local' over two CPU
  contexts, 'device' and a store object (both update on the store);
  `FeedForward.fit` the same through `model._train_multi_device`.
* `checkpoint.save_auto`/`load_auto`/`restore_auto`: the cursor, the
  optimizer state, counts and a changed lr round-trip, and a torn
  temporary file (a kill during the write) is never read.
* The file is the JAX package's: a checkpoint the JAX package wrote
  resumes in the port and ends at the JAX straight run's parameters, and
  the other way round, within 1e-4 of each parameter's max|w| (the two
  packages' float32 sums differ in order).
* A ``kill -9`` in a subprocess, then a resume in a fresh process, ends
  at the straight run's parameters bit for bit.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint
from mxnet_tpu_torch.optimizer import SGD, get_fused_updater

PK = {"jax": jmx, "torch": tmx}
ROOT = str(Path(__file__).resolve().parents[1])
OPT = {"learning_rate": 0.1, "momentum": 0.9}


class _Interrupt(Exception):
    pass


def _data(n=128, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 10).astype(np.float32)
    return X, rng.randint(0, 3, n).astype(np.float32)


def _net(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=8)
    act = mx.sym.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = mx.sym.FullyConnected(data=act, name="fc2", num_hidden=3)
    return mx.sym.SoftmaxOutput(data=fc2, name="softmax")


def _module(mx, devices=1):
    return mx.mod.Module(_net(mx),
                         context=[mx.cpu(i) for i in range(devices)])


def _iter(mx):
    X, y = _data()
    return mx.io.NDArrayIter(X, y, batch_size=16, shuffle=True)


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _boom(p):
    if p.epoch == 1 and p.nbatch == 4:
        raise _Interrupt()  # mid-epoch, after the nbatch=3 checkpoint


KV = {"none": (1, "local"), "local2": (2, "local"),
      "device2": (2, "device"), "store": (1, "store")}


def _fit_module(mx, prefix, kv, **kw):
    devices, kvstore = KV[kv]
    if kvstore == "store":
        kvstore = mx.kv.create("local")
    mx.random.seed(42)
    mod = _module(mx, devices)
    mod.fit(_iter(mx), num_epoch=3, kvstore=kvstore,
            auto_checkpoint=prefix, checkpoint_every=3,
            optimizer_params=dict(OPT), **kw)
    return mod


@pytest.mark.parametrize("kv", sorted(KV))
def test_module_resume_is_bit_for_bit(tmp_path, kv):
    ref = _params(_fit_module(tmx, str(tmp_path / "ref"), kv))
    prefix = str(tmp_path / "auto")
    with pytest.raises(_Interrupt):
        _fit_module(tmx, prefix, kv, batch_end_callback=_boom)
    state = checkpoint.load_auto(prefix)
    assert (state["epoch"], state["nbatch"]) == (1, 3)
    assert state.get("states"), "the optimizer state must be in the file"
    resumed = _fit_module(tmx, prefix, kv, resume="auto")
    assert resumed.stats["train.resumes"] == 1
    # epoch 1 from batch 3 (checkpoints at 6 and the epoch's end), and
    # epoch 2 (3, 6 and its end)
    assert resumed.stats["train.auto_checkpoints"] == 5
    res = _params(resumed)
    assert sorted(res) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)


def _feedforward(mx):
    X, y = _data(64, seed=1)
    mx.random.seed(7)
    m = mx.model.FeedForward(symbol=_net(mx), ctx=mx.cpu(), num_epoch=3,
                             learning_rate=0.1, momentum=0.9,
                             numpy_batch_size=16)
    return m, X, y


def test_feedforward_resume_is_bit_for_bit(tmp_path):
    ref_m, X, y = _feedforward(tmx)
    ref_m.fit(X, y, auto_checkpoint=str(tmp_path / "ref"),
              checkpoint_every=2)
    ref = {k: v.asnumpy() for k, v in ref_m.arg_params.items()}
    assert ref_m.stats["train.auto_checkpoints"] == 3 * (2 + 1)

    def boom(p):
        if p.epoch == 1 and p.nbatch == 3:
            raise _Interrupt()

    prefix = str(tmp_path / "ff")
    m, X, y = _feedforward(tmx)
    with pytest.raises(_Interrupt):
        m.fit(X, y, auto_checkpoint=prefix, checkpoint_every=2,
              batch_end_callback=boom)
    state = checkpoint.load_auto(prefix)
    assert (state["epoch"], state["nbatch"]) == (1, 2)
    m2, X, y = _feedforward(tmx)
    m2.fit(X, y, auto_checkpoint=prefix, checkpoint_every=2, resume="auto")
    assert m2.stats["train.resumes"] == 1
    for k in ref:
        np.testing.assert_array_equal(m2.arg_params[k].asnumpy(), ref[k],
                                      err_msg=k)


def test_auto_checkpoint_atomic_and_cursor(tmp_path):
    """The cursor, random snapshots, optimizer state, counts and a
    changed lr round-trip; a torn temporary file is never read."""
    prefix = str(tmp_path / "ck")
    w = {"w": tmx.nd.array(np.arange(4, dtype=np.float32), ctx=tmx.cpu())}
    upd = get_fused_updater(SGD(learning_rate=0.1, momentum=0.9))
    upd([0], [tmx.nd.ones((4,), tmx.cpu())], [w["w"]])
    upd.optimizer.lr = 0.025
    size = checkpoint.save_auto(prefix, w, {}, updater=upd, epoch=2,
                                nbatch=7, epoch_rng=tmx.random.get_state())
    assert size == os.path.getsize(prefix + "-auto.ckpt")
    with open(prefix + "-auto.ckpt.tmp.999", "wb") as f:
        f.write(b"torn")
    state = checkpoint.load_auto(prefix)
    assert state["format"] == 1
    assert (state["epoch"], state["nbatch"], state["iter_pos"]) == (2, 7, 7)
    np.testing.assert_array_equal(state["arg"]["w"].asnumpy(),
                                  w["w"].asnumpy())
    assert state["opt_counts"][0] == {0: 1}
    fresh = get_fused_updater(SGD(learning_rate=0.1, momentum=0.9))
    checkpoint.restore_auto(state, fresh)
    np.testing.assert_array_equal(fresh.states[0].asnumpy(),
                                  upd.states[0].asnumpy())
    assert fresh.optimizer.num_update == 1
    assert fresh.optimizer.lr == 0.025
    assert checkpoint.load_auto(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """The writer's interrupted run, resumed by the other package, ends
    at the writer's straight run (1e-4 of max|w|)."""
    reader = "torch" if writer == "jax" else "jax"
    ref = _params(_fit_module(PK[writer], str(tmp_path / "ref"), "none"))
    prefix = str(tmp_path / "auto")
    with pytest.raises(_Interrupt):
        _fit_module(PK[writer], prefix, "none", batch_end_callback=_boom)
    resumed = _params(_fit_module(PK[reader], prefix, "none",
                                  resume="auto"))
    assert sorted(resumed) == sorted(ref)
    for k in ref:
        scale = np.abs(ref[k]).max()
        assert np.abs(resumed[k] - ref[k]).max() <= 1e-4 * scale, k


KILL9_SCRIPT = textwrap.dedent("""
    import hashlib, os
    import numpy as np
    import mxnet_tpu_torch as mx

    mx.random.seed(42)
    rng = np.random.RandomState(0)
    X = rng.randn(128, 10).astype(np.float32)
    y = rng.randint(0, 3, 128).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=16, shuffle=True)
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=8)
    net = mx.sym.SoftmaxOutput(data=fc1, name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    kill_at = int(os.environ.get("KILL_AT", "0"))

    def cb(p):
        if kill_at and p.epoch == 1 and p.nbatch == kill_at:
            os.kill(os.getpid(), 9)

    mod.fit(it, num_epoch=3, auto_checkpoint=os.environ["CKPT"],
            checkpoint_every=1,
            resume="auto" if os.environ.get("RESUME") else None,
            batch_end_callback=cb,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    arg, _ = mod.get_params()
    h = hashlib.sha256()
    for k in sorted(arg):
        h.update(arg[k].asnumpy().tobytes())
    print("PARAMS_SHA", h.hexdigest(), flush=True)
""")


def _run_kill9(env_extra):
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", KILL9_SCRIPT],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=ROOT)
    sha = [ln.split()[1] for ln in proc.stdout.splitlines()
           if ln.startswith("PARAMS_SHA")]
    return proc.returncode, sha


def test_kill9_resume_roundtrip(tmp_path):
    rc, ref = _run_kill9({"CKPT": str(tmp_path / "ref")})
    assert rc == 0 and ref
    prefix = str(tmp_path / "k9")
    rc, sha = _run_kill9({"CKPT": prefix, "KILL_AT": "5"})
    assert rc == -9 and not sha
    state = checkpoint.load_auto(prefix)
    assert (state["epoch"], state["nbatch"]) == (1, 5)
    rc, sha = _run_kill9({"CKPT": prefix, "RESUME": "1"})
    assert rc == 0 and sha == ref

#!/usr/bin/env python3
"""How far rounding alone moves the end of training of `BASELINE.json`'s
first configuration, in the JAX package and in its PyTorch port, on the
CPU.

Usage (from the root of a checkout; CPU only, a few minutes):

    python3 scripts/mnist_spread.py [--train 20000] [--test 4000]

`chip_smoke.py`'s phase 13 trains the MLP (784-128-64-10) on MNIST idx
files from `tools/make_mnist.py` for 2 epochs (batch 128, SGD lr 0.1
momentum 0.9) on the card and on the CPU.  The two agree to ~5e-7 of
max|w| after the first epoch and end ~4e-2 apart, as two CPU runs on
different thread counts do.  This script asks whether the JAX package's
run amplifies a rounding difference the same way.  From each of two
initial parameter sets it trains:

* ``jax`` and ``torch``: each package from that set;
* ``jax_ulp_fc1`` ... ``torch_ulp_fc3``: each package from the same set
  with one weight (``fcN_weight[0, 0]``, N = 1, 2 or 3) moved up by one
  float32 ulp;
* ``torch_1_thread``: the port on one thread;
* ``torch_again``: the port's first run once more (run-to-run
  determinism).

The sets: ``phase13``, the parameters phase 13 starts from (the port's
`Xavier` after ``random.seed(0)``, drawn as `FeedForward.fit` draws
them; the JAX package draws the same bits), and ``numpy``, Xavier's
uniform drawn with numpy's ``RandomState(0)``, biases zero.

Each run is its own process, which imports one package only.  The
script prints, and writes to ``chiprun_out/mnist_spread.json``, each
run's train and validation accuracy after each epoch and the gap
max|w_a - w_b| / max|w_b| between pairs of runs after each epoch.

Then, for each package and moved weight on the phase13 set, it trains
the unmoved and the moved parameters side by side (the same training
written out with `Symbol.simple_bind` and `get_fused_updater`) and
reports the first batch after which the gap exceeds `JUMP`, the gaps
before and after it, and on that batch each run's smallest |ReLU input|
of each hidden layer, recomputed on the host from the run's parameters
(numpy's rounding, not the package's): where two runs part, a ReLU
input within rounding of zero may land on either side of it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CONFIG = dict(batch=128, epochs=2, lr=0.1, momentum=0.9)
# get_mlp(): (name, (out, in)) of each FullyConnected
LAYERS = [("fc1", (128, 784)), ("fc2", (64, 128)), ("fc3", (10, 64))]
# the weights moved by one ulp, one a run
ULPS = ("fc1", "fc2", "fc3")
# run: (package, moved weight or None, threads); threads 0 leaves
# torch's default
RUNS = {"jax": ("jax", None, 0), "torch": ("torch", None, 0)}
for _layer in ULPS:
    RUNS["jax_ulp_" + _layer] = ("jax", _layer, 0)
    RUNS["torch_ulp_" + _layer] = ("torch", _layer, 0)
RUNS["torch_1_thread"] = ("torch", None, 1)
RUNS["torch_again"] = ("torch", None, 0)
PAIRS = ([("%s_ulp_%s" % (p, l), p) for p in ("jax", "torch") for l in ULPS]
         + [("torch_1_thread", "torch"), ("torch_again", "torch"),
            ("torch", "jax")])


def initial_params(seed=0):
    """Xavier's uniform (magnitude 3, average fan) and zero biases."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, (fan_out, fan_in) in LAYERS:
        scale = np.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
        params[name + "_weight"] = rng.uniform(
            -scale, scale, (fan_out, fan_in)).astype(np.float32)
        params[name + "_bias"] = np.zeros(fan_out, np.float32)
    return params


def worker(package, init, threads, data, out):
    """Train one run and save its parameters after each epoch and its
    accuracies; with ``out`` "-", write the phase13 set to ``init``."""
    if package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import mxnet_tpu as mx
        import mxnet_tpu.models  # noqa: F401
    else:
        import torch

        if threads:
            torch.set_num_threads(threads)
        import mxnet_tpu_torch as mx
    mx.random.seed(0)
    np.random.seed(0)

    def files(kind):
        return os.path.join(data, "%s-idx%d-ubyte"
                            % (kind, 3 if kind.endswith("images") else 1))

    train = mx.io.MNISTIter(image=files("train-images"),
                            label=files("train-labels"),
                            batch_size=CONFIG["batch"], flat=True)
    val = mx.io.MNISTIter(image=files("t10k-images"),
                          label=files("t10k-labels"),
                          batch_size=CONFIG["batch"], flat=True,
                          shuffle=False)
    model = mx.model.FeedForward(
        mx.models.get_mlp(), ctx=mx.cpu(), num_epoch=CONFIG["epochs"],
        optimizer="sgd", learning_rate=CONFIG["lr"],
        momentum=CONFIG["momentum"], initializer=mx.init.Xavier())
    if out == "-":
        model._init_params(dict(train.provide_data + train.provide_label))
        np.savez(init, **{k: v.asnumpy() for k, v in
                          model.arg_params.items()})
        return
    model.arg_params = {k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in np.load(init).items()}
    train_acc, val_acc, snaps = {}, {}, {}

    def on_batch(p):
        train_acc[p.epoch] = p.eval_metric.get()[1]

    def on_eval(p):
        val_acc[p.epoch] = p.eval_metric.get()[1]

    def on_epoch(epoch, sym, arg, aux):
        for k, v in arg.items():
            snaps["e%d:%s" % (epoch, k)] = v.asnumpy()

    model.fit(train, eval_data=val, batch_end_callback=on_batch,
              eval_batch_end_callback=on_eval, epoch_end_callback=on_epoch)
    np.savez(out + ".npz", **snaps)
    Path(out + ".json").write_text(json.dumps(
        {"train_acc": [train_acc[e] for e in sorted(train_acc)],
         "val_acc": [val_acc[e] for e in sorted(val_acc)]}))


# lockstep: the gap that marks the two runs parting
JUMP = 1e-5


def lockstep(package, init, moved, data, out):
    """Train ``init`` and ``moved`` side by side; write where they part."""
    if package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import mxnet_tpu as mx
        import mxnet_tpu.models  # noqa: F401
    else:
        import mxnet_tpu_torch as mx
    mx.random.seed(0)
    np.random.seed(0)
    train = mx.io.MNISTIter(
        image=os.path.join(data, "train-images-idx3-ubyte"),
        label=os.path.join(data, "train-labels-idx1-ubyte"),
        batch_size=CONFIG["batch"], flat=True)
    sym = mx.models.get_mlp()
    exes, updaters = [], []
    for path in (init, moved):
        exe = sym.simple_bind(mx.cpu(), grad_req="write",
                              data=(CONFIG["batch"], 784),
                              softmax_label=(CONFIG["batch"],))
        for k, v in np.load(path).items():
            exe.arg_dict[k][:] = v
        exes.append(exe)
        updaters.append(mx.optimizer.get_fused_updater(mx.optimizer.SGD(
            learning_rate=CONFIG["lr"], momentum=CONFIG["momentum"],
            rescale_grad=1.0 / CONFIG["batch"])))
    names = [n for n in exes[0].arg_dict if n not in ("data",
                                                      "softmax_label")]
    res, before, nbatch = {"batch": None}, 0.0, 0
    for _ in range(CONFIG["epochs"]):
        train.reset()
        for batch in train:
            x = batch.data[0].asnumpy()
            pre = []
            for exe, update in zip(exes, updaters):
                h = x
                mins = []
                for layer in ("fc1", "fc2"):
                    h = h @ exe.arg_dict[layer + "_weight"].asnumpy().T \
                        + exe.arg_dict[layer + "_bias"].asnumpy()
                    mins.append(float(np.abs(h).min()))
                    h = np.maximum(h, 0)
                pre.append(mins)
                exe.arg_dict["data"][:] = x
                exe.arg_dict["softmax_label"][:] = batch.label[0].asnumpy()
                exe.forward(is_train=True)
                exe.backward()
                update(list(range(len(names))),
                       [exe.grad_dict[n] for n in names],
                       [exe.arg_dict[n] for n in names])
            nbatch += 1
            a, b = ({n: e.arg_dict[n].asnumpy() for n in names}
                    for e in exes)
            now = max(float(np.abs(a[n] - b[n]).max()) for n in names) \
                / max(float(np.abs(w).max()) for w in a.values())
            if now > JUMP:
                res = {"batch": nbatch, "gap_before": before,
                       "gap_after": now,
                       "min_abs_relu_input_fc1_fc2": pre}
                break
            before = now
        if res["batch"] is not None:
            break
    Path(out).write_text(json.dumps(res))


def gap(a, b, epoch):
    """max |a - b| over max |b|, over every parameter after ``epoch``."""
    keys = [k for k in b if k.startswith("e%d:" % epoch)]
    wmax = max(float(np.abs(b[k]).max()) for k in keys)
    return max(float(np.abs(a[k] - b[k]).max()) for k in keys) / wmax


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", type=int, default=20000)
    ap.add_argument("--test", type=int, default=4000)
    ap.add_argument("--worker", nargs=5, metavar=("PACKAGE", "INIT",
                                                  "THREADS", "DATA", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--lockstep", nargs=5, metavar=("PACKAGE", "INIT",
                                                    "MOVED", "DATA", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        package, init, threads, data, out = args.worker
        worker(package, init, int(threads), data, out)
        return
    if args.lockstep:
        lockstep(*args.lockstep)
        return
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "mnist")
        subprocess.run([sys.executable, str(ROOT / "tools/make_mnist.py"),
                        "--out", data, "--train", str(args.train),
                        "--test", str(args.test)], check=True,
                       capture_output=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT))

        def run_worker(*argv, mode="--worker"):
            subprocess.run([sys.executable, __file__, mode]
                           + [str(a) for a in argv], check=True, env=env,
                           cwd=ROOT)

        sets = {"phase13": os.path.join(tmp, "phase13.npz"),
                "numpy": os.path.join(tmp, "numpy.npz")}
        run_worker("torch", sets["phase13"], 0, data, "-")
        np.savez(sets["numpy"], **initial_params())
        res = {"config": dict(CONFIG, train=args.train, test=args.test,
                              net="get_mlp() 784-128-64-10")}
        for name, path in sets.items():
            inits = {None: path}
            for layer in ULPS:
                params = dict(np.load(path))
                w = params[layer + "_weight"]
                w[0, 0] = np.nextafter(w[0, 0], np.float32(np.inf))
                inits[layer] = path.replace(".npz", "_%s.npz" % layer)
                np.savez(inits[layer], **params)
            snaps, accs = {}, {}
            for run, (package, moved, threads) in RUNS.items():
                out = os.path.join(tmp, "%s_%s" % (name, run))
                run_worker(package, inits[moved], threads, data, out)
                snaps[run] = dict(np.load(out + ".npz"))
                accs[run] = json.loads(Path(out + ".json").read_text())
            res[name] = {
                "runs": accs,
                "param_gap_by_epoch": {
                    "%s vs %s" % (a, b): [gap(snaps[a], snaps[b], e)
                                          for e in range(CONFIG["epochs"])]
                    for a, b in PAIRS}}
            if name != "phase13":
                continue
            res[name]["lockstep"] = {}
            for package in ("jax", "torch"):
                for layer in ULPS:
                    out = os.path.join(tmp, "lockstep.json")
                    run_worker(package, path, inits[layer], data, out,
                               mode="--lockstep")
                    res[name]["lockstep"]["%s_ulp_%s" % (package, layer)] \
                        = json.loads(Path(out).read_text())
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "mnist_spread.json").write_text(
        json.dumps(res, indent=1))
    print(json.dumps(res))


if __name__ == "__main__":
    main()

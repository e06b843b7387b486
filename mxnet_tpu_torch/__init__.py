"""PyTorch/CUDA port of mxnet_tpu, slice by slice.

This package sits beside the JAX package `mxnet_tpu`, keeps its module
names where that helps a reader find the counterpart, and imports
neither JAX nor anything of `mxnet_tpu`.  It serves and trains:

* serving the transformer LM (`serving.ServingEngine` over
  `serving.TransformerKVModel`), with the host-DRAM block tier,
  sessions, and `quant`'s int8/fp8 weights and int8 K/V pool;
* training it: `models.get_transformer_lm` builds the symbol graph
  (`symbol`, the ops of `ops`), `executor._build_graph_fn` runs it, and
  `parallel.SPMDTrainer` steps forward, backward and the optimizer update
  on one device, with `random` and `initializer` drawing the JAX
  package's initial parameters bit for bit.

Hand-written CUDA kernels for Hopper carry both paths: LayerNorm forward
and backward, flash attention forward, dq and dk/dv, and the fused
projection + softmax-CE head of ``fused_head=True`` (statistics forward,
single-pass forward, dW/db, dx) (`ops/pallas_kernels/`, sources under
`csrc/`).  `optimizer.stochastic_round_bf16` stores Adam's second moment
in bf16 for ``SPMDTrainer(adam_v_dtype='bfloat16')``.

The reference training API runs over the same graph walk and kernels:
`Context` (`cpu`, `gpu`, `tpu` an alias of `gpu`, `current_context`),
`ndarray` (`nd`), `Symbol.simple_bind`/`bind` and `executor.Executor`,
the `optimizer` classes and `lr_scheduler`, `kvstore` (`kv`, local and
device), `io`, `metric`, `callback`, `executor_manager`, `checkpoint`
and `model.FeedForward`:

    net = mx.models.get_mlp()
    model = mx.model.FeedForward(net, ctx=mx.gpu(0), num_epoch=2,
                                 optimizer="sgd", learning_rate=0.1,
                                 momentum=0.9, initializer=mx.init.Xavier())
    model.fit(mx.io.NDArrayIter(X, y, batch_size=128, shuffle=True))
    model.save("mlp")

The Module API (`module`, also `mod`: `Module`, `BucketingModule`,
`SequentialModule`, `PythonModule`, `SPMDModule`) and `monitor.Monitor`
run over the same stack; `BaseModule.fit` and `FeedForward.fit` stage
their input on the devices ahead of the step, accumulate the metric
there (``MXNET_METRIC_INTERVAL``), and write and resume from
mid-epoch auto-checkpoints in the JAX package's format:

    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.fit(train_iter, num_epoch=2, optimizer="adam",
            auto_checkpoint="run", checkpoint_every=100, resume="auto")

The training half of the JAX package's fault tolerance runs on them:
``MXNET_NONFINITE_GUARD=1`` skips a step with a nonfinite gradient on
the device, ``MXNET_NONFINITE_BACKOFF`` backs the lr off after it,
`chaos` injects ``nan_grad:N`` (its other clauses raise), and
`telemetry` (counters, gauges, histograms, events, JSONL step records,
the retrace watch, the staged health moments) reports them; `storage`
(the pooled scratch allocator, device memory counters) and `resource`
come with them.

The host runtime comes with the data path: `engine` (the host dependency
engine: threaded, naive, and native over `_native`, the port's own copy
of the C++ runtime under `native/`, built with g++ at first use),
`recordio` (packs byte for byte the JAX package's), `image`
(`ImageAugmenter` on the current context's device) and
`io.ImageRecordIter`, which feeds a model from a pack:

    it = mx.io.ImageRecordIter(path_imgrec="train.rec",
                               data_shape=(3, 224, 224),
                               record_shape=(3, 256, 256), batch_size=64,
                               rand_crop=True, rand_mirror=True)
    model.fit(it, kvstore="device")

The JAX package's op set and model zoo are ported too (`ops`,
`models`): convolution, pooling, BatchNorm and the rest run as torch
calls (cuDNN on the card; float32 convolutions without TF32 whatever
``torch.backends.cudnn.allow_tf32`` says), every op also as an
imperative `nd.<op>`, and ResNet, Inception-BN, LeNet, AlexNet, VGG,
GoogLeNet, Inception-v3, the LSTM and RNN LMs and FCN-xs build as they do
in the JAX package:

    net = mx.models.get_resnet(num_layers=50, pooling_convention="valid")
    trainer = mx.SPMDTrainer(
        net, data_shapes={"data": (128, 3, 224, 224),
                          "softmax_label": (128,)},
        lr=0.1, momentum=0.9, wd=1e-4, dtype="bfloat16")
    trainer.step({"data": images, "softmax_label": labels})

Entry points run on ``cuda:0`` unless given ``ctx="cpu"`` (or
``mx.cpu()``); without a GPU and without that argument they raise
(`context.resolve`).  `current_context()` with no ``with`` scope is
``gpu(0)``, where the JAX package's is ``cpu(0)``.

    import mxnet_tpu_torch as mx
    mx.random.seed(0)
    net = mx.models.get_transformer_lm(vocab_size=32768, seq_len=1024,
                                       num_layers=12, num_heads=12,
                                       num_embed=768)
    trainer = mx.parallel.SPMDTrainer(
        net, data_shapes={"data": (32, 1024), "softmax_label": (32, 1024)},
        optimizer="adam", lr=1e-3, wd=0.0, dtype="bfloat16")
    outputs = trainer.step({"data": tokens, "softmax_label": labels})
"""
from __future__ import annotations

from . import attribute, initializer, models, name, ops, optimizer
from . import parallel, random
from . import symbol
from . import symbol as sym
from . import context, ndarray
from . import ndarray as nd
from . import lr_scheduler, metric, callback, io, kvstore
from . import kvstore as kv
from . import executor, executor_manager, checkpoint, model, monitor
from . import telemetry, chaos, storage, resource, tracing
from . import engine, recordio, image
from . import serving
from . import quant
from . import module
from . import module as mod
from .attribute import AttrScope
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, resolve, tpu
from .executor import Executor
from .model import FeedForward
from .ndarray import NDArray
from .parallel import SPMDTrainer, load_params
from .symbol import Symbol

ops.populate_nd(nd.__dict__)

init = initializer
opt = optimizer

__all__ = ["AttrScope", "Context", "Executor", "FeedForward", "MXNetError",
           "NDArray", "SPMDTrainer", "Symbol", "attribute", "callback",
           "checkpoint", "context", "cpu", "current_context", "engine",
           "executor",
           "executor_manager", "gpu", "image", "init", "initializer", "io",
           "kv",
           "kvstore", "load_params", "lr_scheduler", "metric", "mod",
           "model", "models", "module", "monitor", "name", "nd", "ndarray",
           "ops", "opt", "optimizer", "chaos", "recordio", "resource",
           "storage",
           "telemetry",
           "parallel", "random", "resolve", "sym", "symbol", "tpu"]

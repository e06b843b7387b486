"""The Module API (`mxnet_tpu/module/`, the reference's
`python/mxnet/module/`).

The intermediate training API: bind, init_params, init_optimizer,
forward, backward, update, and `BaseModule`'s generic loops (`fit`,
`score`, `predict`) over `Module` (a symbol on executor groups),
`BucketingModule` (a module a bucket, one set of parameters),
`SequentialModule`, `PythonModule` and `SPMDModule` (the fused
`parallel.SPMDTrainer`).
"""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule
from .spmd_module import SPMDModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "SPMDModule"]

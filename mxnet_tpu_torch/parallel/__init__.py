"""Training of the port: the fused `SPMDTrainer`, on one device so far
(a port of `mxnet_tpu/parallel/trainer.py`)."""
from .trainer import SPMDTrainer, load_params

__all__ = ["SPMDTrainer", "load_params"]

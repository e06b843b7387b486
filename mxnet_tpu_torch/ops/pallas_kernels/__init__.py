"""Hand-written CUDA kernels for Hopper, each in place of one Pallas TPU
kernel of `mxnet_tpu/ops/pallas_kernels/`.

The module names stay those of the JAX package so a reader finds the
counterpart: `layer_norm`, `flash_attention` and `fused_ce` (import the
functions from those modules).  Each module holds a plain PyTorch version beside
its kernel: a CPU tensor takes the plain version, a CUDA tensor launches
the kernel (built from `mxnet_tpu_torch/csrc/` at first use by `_build`)
or raises.  Each public wrapper carries a ``launches`` count of its
kernel launches.
"""

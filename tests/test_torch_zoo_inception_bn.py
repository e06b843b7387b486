"""The port's Inception-BN against the JAX package's, on the CPU: one
training forward and backward through the port's `Executor` against the
JAX `Executor`, from the same parameters and aux states.

The bar (`tests/test_torch_zoo.py`'s `fwd_bwd_against_jax` with its
spread): every output, gradient and aux state within 1e-4 of its own
largest magnitude (float32 on both sides, summed in another order), or,
where larger, twice the rounding spread, the distance rounding alone
puts between each package's float32 run and its own float64 run (the
JAX package under ``jax.enable_x64``).  Inception-BN at initialization
amplifies rounding through its backward (the BatchNorm statistics'
float32 path, in both packages), so that its own float32 and float64
weight gradients part by up to ~6e-2 of their largest (seed 0).

It runs at its default small-image stem (28 pixels), batch 2, so its
BatchNorms see a batch.
"""
from test_torch_zoo import net_matches_jax
from test_torch_kernels import _one_thread  # noqa: F401


def test_inception_bn_forward_backward_matches_the_jax_executor():
    net_matches_jax("inception_bn", lambda m: m.get_inception_bn(),
                    {"data": (2, 3, 28, 28), "softmax_label": (2,)}, 10)

"""The port's Inception-v3 against the JAX package's, on the CPU: one
training forward and backward through the port's `Executor` against the
JAX `Executor`, from the same parameters and aux states.

The bar (`tests/test_torch_zoo.py`'s `fwd_bwd_against_jax` with its
spread): every output, gradient and aux state within 1e-4 of its own
largest magnitude (float32 on both sides, summed in another order), or,
where larger, twice the rounding spread, the distance rounding alone
puts between the port's float32 run and its float64 run.  Inception-v3
at batch 1 amplifies rounding through its BatchNorms' backward: the
port's float32 and float64 weight gradients part by up to ~0.29 of
their largest (seed 0), the JAX package's by up to ~0.36, so the port's
spread alone is the tighter bar, and the JAX package's float64 compile
is not run; its forward agrees to ~2e-5.

It ends in a fixed 8x8 average pool, so it runs at its published 299
pixels, batch 1.
"""
from test_torch_zoo import net_matches_jax
from test_torch_kernels import _one_thread  # noqa: F401


def test_inception_v3_forward_backward_matches_the_jax_executor():
    net_matches_jax("inception_v3",
                    lambda m: m.get_inception_v3(num_classes=10),
                    {"data": (1, 3, 299, 299), "softmax_label": (1,)}, 10,
                    spread_from=("torch",))

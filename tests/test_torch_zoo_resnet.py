"""The port's ResNet-50 against the JAX package's, on the CPU: one
training forward and backward (bottleneck blocks, the 7x7 stem and its
max pool, 'valid' pooling as `bench.py` builds it) at 64 pixels, batch
2, through the port's `Executor` against the JAX `Executor`, from the
same parameters and aux states.

The bar (`tests/test_torch_zoo.py`'s `fwd_bwd_against_jax` with its
spread): every output, gradient and aux state within 1e-4 of its own
largest magnitude (float32 on both sides, summed in another order), or,
where larger, twice the rounding spread, the distance rounding alone
puts between each package's float32 run and its own float64 run (the
JAX package under ``jax.enable_x64``).  At 64 pixels its last stage's
BatchNorms see 2x2 maps, and its own float32 and float64 weight
gradients part by up to ~0.27 of their largest (seed 0).
"""
from test_torch_zoo import net_matches_jax


def test_resnet50_forward_backward_matches_the_jax_executor():
    net_matches_jax(
        "resnet-50", lambda m: m.get_resnet(num_classes=10, num_layers=50,
                                            image_shape=(3, 64, 64),
                                            pooling_convention="valid"),
        {"data": (2, 3, 64, 64), "softmax_label": (2,)}, 10)

"""The port's GoogLeNet and FCN-8s against the JAX package's, on the CPU:
one training forward and backward of each through the port's `Executor`
against the JAX `Executor`, from the same parameters, Dropout the
identity in both.

The bar (`tests/test_torch_zoo.py`'s `fwd_bwd_against_jax` with its
spread): every output, gradient and aux state within 1e-4 of its own
largest magnitude (float32 on both sides, summed in another order), or,
where larger, twice the rounding spread, the distance rounding alone
puts between the port's float32 run and its float64 run.  The JAX
package's own float32-to-float64 distance widens no bar here: with it
the spreads are the same (googlenet bwd 0.0102, fcn8s 1.6e-6, seed 0),
so its float64 compile is not run.  GoogLeNet holds millions of ReLU
inputs; at seed 0 one lies at 5.6e-7 in the port's float32 run and
-1.8e-6 in float64, which moves its first layers' gradients by ~1e-2 of
their largest.

GoogLeNet ends in a fixed 7x7 average pool, so it runs at its published
224 pixels, batch 1; FCN-8s at 32 pixels (a 1x1 map after its fifth
pool), batch 1.
"""
import pytest

from test_torch_zoo import net_matches_jax, no_dropout  # noqa: F401
from test_torch_kernels import _one_thread  # noqa: F401


NETS = {
    "googlenet": (lambda m: m.get_googlenet(num_classes=10),
                  {"data": (1, 3, 224, 224), "softmax_label": (1,)}, 10),
    "fcn8s": (lambda m: m.get_fcn_xs(num_classes=3),
              {"data": (1, 3, 32, 32), "softmax_label": (1, 32, 32)}, 3),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_forward_backward_matches_the_jax_executor(name, no_dropout):
    net_matches_jax(name, *NETS[name], spread_from=("torch",))

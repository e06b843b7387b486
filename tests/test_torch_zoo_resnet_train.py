"""The port's ResNet-18 training trajectory against the JAX package's, on
the CPU.

Three SGD-momentum steps (lr 0.01, momentum 0.9, wd 1e-4) of
`SPMDTrainer` on ``get_resnet(num_layers=18, image_shape=(3, 32,
32))`` (basic blocks, the small-image stem) at batch 4, in float32,
from the same seed in both packages: the same initial parameters bit
for bit, and the parameters and the BatchNorm aux states after each
step within rtol 1e-4 / atol 1e-5, the trajectory bars of
`tests/test_torch_train.py` (float32 on both sides, summed in another
order), on one batch, as `tests/test_torch_train.py` repeats its
batch; the two trajectories stay within 1.2e-7.  At `bench.py`'s lr
0.1 this network at initialization amplifies rounding from step to
step: the port alone, on 1 thread and on all, parts by 1.4e-4 after
step 2 and 3.4e-3 after step 3 with a new batch each step (its step-1
gradients 2e-6 apart); at lr 0.01 the same two runs stay within
1.2e-7.  With a new batch each step (seeds 0, 1, 2) the port and the
JAX package agree to an ulp through step 2, then part by 1.6e-5 at
one convolution's weights in step 3 (9e-3 of its update), a single
jump of the kind a ReLU input within rounding of zero makes.
"""
import numpy as np

import mxnet_tpu_torch as tmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer, make_mesh
from test_torch_kernels import _one_thread  # noqa: F401


B = 4
SHAPES = {"data": (B, 3, 32, 32), "softmax_label": (B,)}
SGD = dict(optimizer="sgd", lr=0.01, momentum=0.9, wd=1e-4)


def _batch():
    rng = np.random.RandomState(0)
    return {"data": rng.randn(*SHAPES["data"]).astype(np.float32),
            "softmax_label": rng.randint(0, 10, B).astype(np.float32)}


def _host(d):
    return {n: np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
            for n, v in d.items()}


def _same(got, want, what):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-5,
                                   err_msg="%s %s" % (what, n))


def test_resnet18_trainer_walks_the_jax_trajectory():
    import mxnet_tpu as jmx

    jmx.random.seed(0)
    jt = JaxTrainer(jmodels.get_resnet(num_classes=10, num_layers=18,
                                       image_shape=(3, 32, 32)),
                    make_mesh(shape=(1,), axis_names=("data",)),
                    data_shapes=SHAPES, **SGD)
    tmx.random.seed(0)
    tt = tmx.SPMDTrainer(tmx.models.get_resnet(num_classes=10, num_layers=18,
                                               image_shape=(3, 32, 32)),
                         data_shapes=SHAPES, ctx="cpu", **SGD)
    assert tt.param_names == list(jt.params)
    assert tt.aux_names == list(jt.aux)
    jarg, jaux = (_host(d) for d in jt.get_params())
    targ, taux = tt.get_params()
    for n, v in jarg.items():
        np.testing.assert_array_equal(targ[n], v, err_msg=n)
    _same(taux, jaux, "aux")
    batch = _batch()
    for step in range(3):
        jout = np.asarray(jt.step(batch)[0])
        tout = tt.step(batch)[0].numpy()
        np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-6)
        jarg, jaux = (_host(d) for d in jt.get_params())
        targ, taux = tt.get_params()
        _same(targ, jarg, "step %d param" % step)
        _same(taux, jaux, "step %d aux" % step)
    moved = [n for n in jaux if n.endswith("moving_mean")]
    assert moved and all(np.abs(jaux[n]).max() > 0 for n in moved)

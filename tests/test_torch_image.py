"""The port's image augmenter and ImageRecordIter against the JAX package's.

Both augmenters fold their step into ``PRNGKey(seed)`` and draw with
`jax.random`'s uniform, randint and bernoulli, which the port's `random`
gives bit for bit, so from the same seed:

* crops (random, centered, explicit origin), mirrors, the mean image,
  mean RGB and scale give the JAX batch exactly (integer offsets, flips,
  one float32 subtraction and product each);
* contrast, illumination, the affine warp, the HSL jitter and
  crop-resize agree within 1e-5 of max|ref|: a batch mean summed in
  another order, XLA's fused multiply-adds and its cos/sin move a few
  float32 ulps (~1e-6 of max|ref| here).

`ImageRecordIter` gives the JAX iterator's batches, labels and pads over
two epochs with ``use_native`` True and False, with and without
augmentation, with the lazy mean file and with JPEG payloads (libjpeg in
the native loader, PIL in the Python path); a truncated JPEG is counted
and zero-filled.  The port's iterator runs on the CPU here
(``with mx.cpu()``); on the card it augments there.
"""
import inspect

import numpy as np
import pytest

import mxnet_tpu as mj
from mxnet_tpu import image as jimage
import jax

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import recordio as trec

TOL = 1e-5

AUG = {
    "rand_crop": (dict(data_shape=(3, 8, 9), rand_crop=True), 0.0),
    "center_crop": (dict(data_shape=(3, 8, 8)), 0.0),
    "crop_origin": (dict(data_shape=(3, 8, 8), crop_y_start=2,
                         crop_x_start=30), 0.0),
    "mirror": (dict(rand_mirror=True), 0.0),
    "mean_img": (dict(mean_img=np.random.RandomState(5).rand(3, 12, 14)
                      .astype(np.float32) * 100), 0.0),
    "mean_rgb_scale": (dict(mean_rgb=[10, 20, 30], scale=1 / 255), 0.0),
    "contrast": (dict(max_random_contrast=0.5), TOL),
    "illumination": (dict(max_random_illumination=20), TOL),
    "affine": (dict(max_rotate_angle=10, max_shear_ratio=0.1,
                    max_random_scale=1.1, min_random_scale=0.9,
                    max_aspect_ratio=0.1), TOL),
    "rotate_fixed": (dict(rotate=30, fill_value=0), TOL),
    "hsl": (dict(random_h=10, random_s=20, random_l=20), TOL),
    "crop_resize": (dict(data_shape=(3, 8, 8), min_crop_size=9,
                         max_crop_size=12, rand_crop=True), TOL),
}


def _batch(seed=0, n=5, h=12, w=14):
    return (np.random.RandomState(seed).rand(n, 3, h, w) * 255).astype(
        np.float32)


def _gap(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(AUG))
def test_augmenter_matches_the_jax_augmenter(name):
    kw, tol = AUG[name]
    batch = _batch()
    ref = jimage.ImageAugmenter(seed=3, **kw)
    aug = timage.ImageAugmenter(seed=3, **kw)
    for _ in range(2):  # two steps: the key folds in the step
        want = np.asarray(ref(batch))
        with mt.cpu():
            got = aug(batch)
        assert got.device.type == "cpu"
        got = got.numpy()
        assert got.shape == want.shape
        if tol:
            assert _gap(got, want) <= tol
        else:
            np.testing.assert_array_equal(got, want)


def test_augmenter_refuses_what_the_jax_one_refuses():
    with pytest.raises(mt.MXNetError):
        timage.ImageAugmenter(data_shape=(3, 8, 8), min_crop_size=4)
    with pytest.raises(mt.MXNetError):
        timage.ImageAugmenter(data_shape=(3, 8, 8), min_crop_size=6,
                              max_crop_size=4)
    with mt.cpu(), pytest.raises(mt.MXNetError):
        timage.ImageAugmenter(data_shape=(3, 16, 16))(_batch(h=8, w=8))
    assert inspect.signature(timage.ImageAugmenter) == \
        inspect.signature(jimage.ImageAugmenter)


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 33), (0, 256), (-7, 1000),
                                   (3, 3), (5, 2), (1, 2 ** 20 + 3),
                                   (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)])
def test_randint_is_jax_bit_for_bit(lo, hi):
    for seed in (0, 11):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
        want = np.asarray(jax.random.randint(key, (257,), lo, hi))
        got = trandom.randint(trandom.fold_in(trandom.prng_key(seed), 4),
                              (257,), lo, hi, "cpu").numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.5, 0.1, 0.97])
def test_bernoulli_is_jax_bit_for_bit(p):
    for seed in (0, 11):
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p,
                                               (3, 101)))
        got = trandom.bernoulli(trandom.prng_key(seed), p, (3, 101),
                                "cpu").numpy()
        np.testing.assert_array_equal(got, want)


def test_compute_mean_image_matches(tmp_path):
    X = _batch(n=10, h=6, w=6)
    want = jimage.compute_mean_image(
        mj.io.NDArrayIter(X, np.zeros(10, np.float32), batch_size=4),
        path=str(tmp_path / "j.npy"))
    got = timage.compute_mean_image(
        mt.io.NDArrayIter(X, np.zeros(10, np.float32), batch_size=4),
        path=str(tmp_path / "t.npy"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), want)


def _npy_pack(path, n=21, shape=(3, 12, 12), seed=0):
    rng = np.random.RandomState(seed)
    w = trec.MXRecordIO(str(path), "w")
    for i in range(n):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        w.write(trec.pack_img((0, float(rng.randint(0, 10)), i, 0), img))
    w.close()


def _jpeg_pack(path, n=9, hw=(12, 10), seed=1, c=3):
    rng = np.random.RandomState(seed)
    w = trec.MXRecordIO(str(path), "w")
    for i in range(n):
        img = rng.randint(0, 256, hw + ((c,) if c > 1 else ())).astype(
            np.uint8)
        w.write(trec.pack_img((0, float(i), i, 0), img, img_fmt=".jpg"))
    w.close()


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
        it.reset()
    return out


def _same_batches(got, want, tol):
    assert [len(e) for e in got] == [len(e) for e in want]
    for eg, ew in zip(got, want):
        for (d1, l1, p1), (d2, l2, p2) in zip(eg, ew):
            assert d1.shape == d2.shape and p1 == p2
            np.testing.assert_array_equal(l1, l2)
            if tol:
                assert _gap(d1, d2) <= tol
            else:
                np.testing.assert_array_equal(d1, d2)


ITER_AUG = {
    "plain": (dict(), 0.0),
    "crop_mirror_scale": (dict(data_shape=(3, 10, 9), rand_crop=True,
                               rand_mirror=True, scale=1 / 255), 0.0),
    "affine_hsl": (dict(data_shape=(3, 10, 9), rand_crop=True,
                        max_rotate_angle=10, max_shear_ratio=0.1,
                        max_random_scale=1.1, min_random_scale=0.9,
                        random_h=10, random_s=20, random_l=20), TOL),
}


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("aug", sorted(ITER_AUG))
def test_image_record_iter_matches_the_jax_iterator(tmp_path, use_native,
                                                    aug):
    path = tmp_path / "p.rec"
    _npy_pack(path)
    extra, tol = ITER_AUG[aug]
    kw = dict(path_imgrec=str(path), data_shape=(3, 12, 12),
              record_shape=(3, 12, 12), batch_size=8,
              use_native=use_native)
    kw.update(extra)
    epochs = 1 if tol else 2  # two to see reset(); the warp costs more
    want = _epochs(mj.io.ImageRecordIter(**kw), epochs)
    with mt.cpu():
        it = mt.io.ImageRecordIter(**kw)
    assert it._native == use_native
    _same_batches(_epochs(it, epochs), want, tol)
    it.close()


@pytest.mark.parametrize("part", [0, 1, 2])
def test_sharded_iterators_match_and_cover_the_pack(tmp_path, part):
    path = tmp_path / "s.rec"
    _npy_pack(path, n=23, shape=(2, 4, 4), seed=part)
    labels = []
    for use_native in (True, False):
        kw = dict(path_imgrec=str(path), data_shape=(2, 4, 4), batch_size=4,
                  part_index=part, num_parts=3, use_native=use_native)
        with mt.cpu():
            got = _epochs(mt.io.ImageRecordIter(**kw), 1)
        _same_batches(got, _epochs(mj.io.ImageRecordIter(**kw), 1), 0.0)
        labels.append([l for d, lab, p in got[0] for l in lab[:4 - p]])
    assert labels[0] == labels[1]


def test_lazy_mean_file_matches(tmp_path):
    """mean_img naming a missing file: one raw pass computes and caches
    it before the first batch, which is normalized with it."""
    path = tmp_path / "m.rec"
    _npy_pack(path, n=10, shape=(3, 6, 6))
    kw = dict(path_imgrec=str(path), data_shape=(3, 6, 6), batch_size=4,
              use_native=False)
    want = mj.io.ImageRecordIter(mean_img=str(tmp_path / "j.npy"), **kw)
    want = want.next().data[0].asnumpy()
    with mt.cpu():
        it = mt.io.ImageRecordIter(mean_img=str(tmp_path / "t.npy"), **kw)
        got = it.next().data[0].asnumpy()
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  np.load(tmp_path / "j.npy"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 1])
def test_jpeg_packs_decode_the_same_on_every_path(tmp_path, channels):
    """libjpeg in the native loader (the uint8 fast path) and PIL in the
    Python path, in both packages: bit for bit, a colour pack read as 1
    channel too (PIL's luma)."""
    path = tmp_path / "j.rec"
    _jpeg_pack(path)
    kw = dict(path_imgrec=str(path), data_shape=(channels, 12, 10),
              batch_size=4, preprocess_threads=2)
    want = _epochs(mj.io.ImageRecordIter(use_native=False, **kw))
    for use_native in (True, False):
        with mt.cpu():
            it = mt.io.ImageRecordIter(use_native=use_native, **kw)
        assert it._native_u8 == use_native
        _same_batches(_epochs(it), want, 0.0)


def test_png_packs_take_the_python_path(tmp_path):
    path = tmp_path / "p.rec"
    img = np.random.RandomState(2).randint(0, 256, (8, 8, 3)).astype(
        np.uint8)
    w = trec.MXRecordIO(str(path), "w")
    w.write(trec.pack_img((0, 7.0, 0, 0), img, img_fmt=".png"))
    w.close()
    with mt.cpu():
        it = mt.io.ImageRecordIter(path_imgrec=str(path),
                                   data_shape=(3, 8, 8), batch_size=1)
        assert not it._native
        got = it.next().data[0].asnumpy()
    np.testing.assert_array_equal(got[0].transpose(1, 2, 0), img)


def test_a_truncated_jpeg_is_counted_and_zero_filled(tmp_path):
    rng = np.random.RandomState(8)
    good = trec.pack_img((0, 1.0, 0, 0),
                         rng.randint(0, 256, (16, 16, 3)).astype(np.uint8),
                         img_fmt=".jpg")
    path = tmp_path / "bad.rec"
    w = trec.MXRecordIO(str(path), "w")
    for rec in (good, good[:40], good):
        w.write(rec)
    w.close()
    kw = dict(path_imgrec=str(path), data_shape=(3, 16, 16), batch_size=3,
              use_native=True)
    with mt.cpu():
        it = mt.io.ImageRecordIter(**kw)
        got = it.next().data[0].asnumpy()
    ref = mj.io.ImageRecordIter(**kw)
    np.testing.assert_array_equal(got, ref.next().data[0].asnumpy())
    assert it.decode_failures == 1
    assert float(np.abs(got[1]).sum()) == 0.0
    assert got[0].mean() > 1 and got[2].mean() > 1
    it.close()


def test_the_keyword_set_is_the_jax_iterators(tmp_path):
    assert inspect.signature(mt.io.ImageRecordIter) == \
        inspect.signature(mj.io.ImageRecordIter)
    path = tmp_path / "k.rec"
    _npy_pack(path, n=2, shape=(1, 2, 2))
    with pytest.raises(TypeError):
        mt.io.ImageRecordIter(path_imgrec=str(path), data_shape=(1, 2, 2),
                              batch_size=1, shuffle=True)


def _flat_mlp(mx):
    h = mx.sym.Flatten(data=mx.sym.Variable("data"))
    h = mx.sym.FullyConnected(data=h, name="fc1", num_hidden=16)
    h = mx.sym.Activation(data=h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(data=h, name="fc2", num_hidden=10)
    return mx.sym.SoftmaxOutput(data=h, name="softmax")


def test_feedforward_trains_from_a_pack_as_the_jax_package_does(tmp_path):
    """`examples/train_imagenet.py`'s feedforward path at a tiny size:
    the same pack, crops and flips feed both packages' FeedForward (the
    port's through its device prefetcher, whose thread calls `next`), and
    the parameters after one epoch agree to the trajectory bars of
    `tests/test_torch_model.py` (rtol 1e-4, atol 1e-5: float32 sums in
    another order)."""
    path = tmp_path / "t.rec"
    _npy_pack(path, n=24, shape=(3, 8, 8))
    kw = dict(path_imgrec=str(path), data_shape=(3, 6, 6),
              record_shape=(3, 8, 8), batch_size=8, rand_crop=True,
              rand_mirror=True, scale=1 / 255)
    params = {}
    for mx in (mj, mt):
        mx.random.seed(0)
        with mx.cpu():
            it = mx.io.ImageRecordIter(**kw)
        model = mx.model.FeedForward(
            _flat_mlp(mx), ctx=mx.cpu(), num_epoch=1, optimizer="sgd",
            learning_rate=0.1, initializer=mx.init.Xavier())
        model.fit(it, kvstore="device")
        params[mx] = {k: v.asnumpy() for k, v in model.arg_params.items()}
    assert sorted(params[mt]) == sorted(params[mj])
    for k, want in params[mj].items():
        np.testing.assert_allclose(params[mt][k], want, rtol=1e-4,
                                   atol=1e-5, err_msg=k)

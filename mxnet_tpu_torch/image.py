"""Batch image augmentation and normalization on the device.

A port of `mxnet_tpu/image.py`.  Reference: `src/io/image_augmenter.h`
(affine rotation/shear/scale/aspect warp, random crop/resize, HSL color
jitter — applied per image on OMP host threads via OpenCV) and
`src/io/iter_normalize.h` (mean-image subtract with a cached mean.bin,
scale, mirror).

As in the JAX package, the whole batch is augmented at once, on the
device of `context.current_context()` (the card unless a ``with
mx.cpu()`` scope says otherwise): the affine family
(max_rotate_angle/rotate/max_shear_ratio/max_random_scale/
max_aspect_ratio, `image_augmenter.h:196-228`) is a batched inverse-affine
bilinear resample, random crops a batched gather, mirrors a masked flip,
the HSL jitter (`image_augmenter.h:288-307`) an elementwise
RGB->HLS->RGB pass on OpenCV's value ranges (H in [0,180], L/S in
[0,255], the additive jitter clamped like the reference's loop), and
contrast/illumination one elementwise pass.  The affine warp renders into
a canvas of the input size (min/max_img_size clamp the scale), and
min/max_crop_size + resize is one bilinear resample.  inter_method is
accepted; bilinear is used.

The random draws are the JAX package's bit for bit: the batch's key is
``fold_in(PRNGKey(seed), step)``, split as the JAX class splits it, and
`random.uniform_from_bits`, `random.randint` and `random.bernoulli` give
`jax.random`'s values.  So crops, flips, mean and scale equal the JAX
augmenter's exactly; contrast, illumination, the warp and the HSL pass
agree to float32 rounding (a mean summed in another order, XLA's fused
multiply-adds, its cos/sin).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .context import current_context
from .ndarray import NDArray

__all__ = ["ImageAugmenter", "compute_mean_image"]


def _uniform(key, shape, minval, maxval, device):
    """`jax.random.uniform(key, shape, minval=..., maxval=...)`."""
    return _random.uniform_from_bits(
        _random.random_bits(key, shape, device), minval, maxval)


def _rgb_to_hls(r, g, b):
    """RGB [0,255] -> OpenCV-range HLS: H in [0,180], L/S in [0,255]."""
    r, g, b = r / 255.0, g / 255.0, b / 255.0
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    l = (vmax + vmin) / 2.0
    d = vmax - vmin
    pos = d > 0
    safe_d = torch.where(pos, d, 1.0)
    s = torch.where(
        pos,
        torch.where(l < 0.5, d / torch.clamp(vmax + vmin, min=1e-12),
                    d / torch.clamp(2.0 - vmax - vmin, min=1e-12)),
        0.0)
    hr = torch.remainder((g - b) / safe_d, 6.0)
    hg = (b - r) / safe_d + 2.0
    hb = (r - g) / safe_d + 4.0
    h = torch.where(vmax == r, hr, torch.where(vmax == g, hg, hb))
    h = torch.where(pos, h * 30.0, 0.0)  # 60 deg -> 30 OpenCV half-units
    return h, l * 255.0, s * 255.0


def _hls_to_rgb(h, l, s):
    """Inverse of _rgb_to_hls (OpenCV ranges in, RGB [0,255] out)."""
    h = h / 30.0  # back to [0,6)
    l = l / 255.0
    s = s / 255.0
    c = (1.0 - torch.abs(2.0 * l - 1.0)) * s
    x = c * (1.0 - torch.abs(torch.remainder(h, 2.0) - 1.0))
    m = l - c / 2.0

    def sel(i, a, cc):
        return torch.where((h >= i) & (h < i + 1), a, cc)

    r = torch.zeros_like(h)
    g = torch.zeros_like(h)
    b = torch.zeros_like(h)
    r = sel(0, c, r); g = sel(0, x, g)
    r = sel(1, x, r); g = sel(1, c, g)
    g = sel(2, c, g); b = sel(2, x, b)
    g = sel(3, x, g); b = sel(3, c, b)
    r = sel(4, x, r); b = sel(4, c, b)
    r = torch.where(h >= 5, c, r); b = torch.where(h >= 5, x, b)
    return (r + m) * 255.0, (g + m) * 255.0, (b + m) * 255.0


def _bilinear_sample(img, ys, xs, fill):
    """Sample each NCHW image at its float coords (ys, xs) [N, H', W']
    with a constant-fill border (cv::BORDER_CONSTANT)."""
    n, c, h, w = img.shape
    flat = img.reshape(n, c, h * w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            yy = y0 + dy
            xx = x0 + dx
            inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yi = torch.clamp(yy, 0, h - 1).long()
            xi = torch.clamp(xx, 0, w - 1).long()
            idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
            v = torch.gather(flat, 2, idx).reshape(n, c, *ys.shape[1:])
            v = torch.where(inb[:, None], v, fill)
            wgt = ((wy if dy else 1 - wy) * (wx if dx else 1 - wx))[:, None]
            out = wgt * v if out is None else out + wgt * v
    return out


class ImageAugmenter:
    """Batched augmentation pipeline over NCHW float batches.

    Parameters mirror the reference's `ImageAugmentParam`
    (`image_augmenter.h`): rand_crop, rand_mirror, crop (data_shape),
    max_random_contrast, max_random_illumination (brightness), plus the
    normalizer's mean/scale (`iter_normalize.h`).
    """

    def __init__(self, data_shape=None, rand_crop=False, rand_mirror=False,
                 max_random_contrast=0.0, max_random_illumination=0.0,
                 mean_img=None, mean_rgb=None, scale=1.0, seed=0,
                 max_rotate_angle=0, rotate=-1, max_shear_ratio=0.0,
                 max_random_scale=1.0, min_random_scale=1.0,
                 max_aspect_ratio=0.0, max_img_size=1e10, min_img_size=0.0,
                 random_h=0, random_s=0, random_l=0, fill_value=255,
                 crop_y_start=-1, crop_x_start=-1, max_crop_size=-1,
                 min_crop_size=-1, inter_method=1):
        self.data_shape = tuple(data_shape) if data_shape else None
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.max_contrast = float(max_random_contrast)
        self.max_illum = float(max_random_illumination)
        self.scale = float(scale)
        # affine family (image_augmenter.h:29-54); rotate >= 0 forces the
        # angle like the reference's `rotate` param
        self.max_rotate_angle = float(max_rotate_angle)
        self.rotate = float(rotate)
        self.max_shear_ratio = float(max_shear_ratio)
        self.max_random_scale = float(max_random_scale)
        self.min_random_scale = float(min_random_scale)
        self.max_aspect_ratio = float(max_aspect_ratio)
        self.max_img_size = float(max_img_size)
        self.min_img_size = float(min_img_size)
        self.random_h = float(random_h)
        self.random_s = float(random_s)
        self.random_l = float(random_l)
        self.fill_value = float(fill_value)
        self.crop_y_start = int(crop_y_start)
        self.crop_x_start = int(crop_x_start)
        self.max_crop_size = int(max_crop_size)
        self.min_crop_size = int(min_crop_size)
        if self.max_crop_size > 0 or self.min_crop_size > 0:
            # reference CHECKs res.cols >= max_crop_size >= min_crop_size
            # (`image_augmenter.h:233-253`); a lone min_crop_size would make
            # randint(lo, max+1) an inverted range producing garbage sizes
            if self.max_crop_size <= 0:
                raise MXNetError(
                    "min_crop_size=%d requires max_crop_size > 0"
                    % self.min_crop_size)
            if 0 < self.max_crop_size < self.min_crop_size:
                raise MXNetError(
                    "max_crop_size=%d < min_crop_size=%d"
                    % (self.max_crop_size, self.min_crop_size))
        self.inter_method = int(inter_method)  # accepted; bilinear used
        self._mean = None
        self._mean_path = None
        if mean_img is not None:
            if isinstance(mean_img, str):
                if os.path.exists(mean_img):
                    self._mean = np.load(mean_img)
                else:
                    # the owning iterator computes it on first use
                    # (ImageRecordIter._ensure_mean) and calls set_mean
                    self._mean_path = mean_img
            else:
                self._mean = np.asarray(mean_img, np.float32)
        self._mean_rgb = (np.asarray(mean_rgb, np.float32).reshape(1, -1, 1, 1)
                          if mean_rgb is not None else None)
        self._key = _random.prng_key(seed)
        self._step = 0
        self._on_device = {}  # the mean arrays as tensors, by device

    @property
    def needs_mean(self):
        """True when a mean_img path was given but not computed yet."""
        return self._mean_path is not None and self._mean is None

    # -- mean image (iter_normalize.h: computed once, cached) -------------
    def set_mean(self, mean, path=None):
        self._mean = np.asarray(mean, np.float32)
        self._on_device.clear()
        if path is None:
            path = self._mean_path
        if path:
            np.save(path, self._mean)

    def _const(self, name, arr, device):
        t = self._on_device.get((name, device))
        if t is None:
            t = self._on_device[(name, device)] = torch.as_tensor(
                arr, device=device)
        return t

    @property
    def _needs_affine(self):
        """Same activation condition as `image_augmenter.h:173-177`."""
        return (self.max_rotate_angle > 0 or self.max_shear_ratio > 0
                or self.rotate >= 0 or self.max_random_scale != 1.0
                or self.min_random_scale != 1.0
                or self.max_aspect_ratio != 0.0
                or self.max_img_size != 1e10 or self.min_img_size != 0.0)

    def _affine_warp(self, x, key):
        """Batched rotation/shear/scale/aspect warp, reference matrix math
        (`image_augmenter.h:186-228`), rendered into a same-size canvas by
        inverse-mapping bilinear sampling with fill_value borders."""
        n, c, h, w = x.shape
        dev = x.device
        ka, ks, kc, kr = _random.split(key, 4)
        shear = _uniform(ks, (n,), -self.max_shear_ratio,
                         self.max_shear_ratio if self.max_shear_ratio
                         else 1e-9, dev)
        if self.rotate >= 0:
            angle = torch.full((n,), self.rotate, device=dev)
        else:
            angle = _uniform(ka, (n,), -self.max_rotate_angle,
                             self.max_rotate_angle or 1e-9, dev)
        scale = _uniform(kc, (n,), self.min_random_scale,
                         self.max_random_scale, dev)
        # min/max_img_size clamp the resulting image size; with a fixed
        # canvas that is a clamp on the scale factor
        maxdim = float(max(h, w))
        scale = torch.clamp(
            scale, self.min_img_size / maxdim if self.min_img_size else 0.0,
            self.max_img_size / maxdim if self.max_img_size != 1e10
            else math.inf)
        ratio = 1.0 + _uniform(kr, (n,), -self.max_aspect_ratio,
                               self.max_aspect_ratio or 1e-9, dev)
        # the draws are float32 (JAX's); the matrix and the grid take the
        # batch's dtype, so a float64 batch is warped in float64 throughout
        shear, angle, scale, ratio = (v.to(x.dtype)
                                      for v in (shear, angle, scale, ratio))
        a = torch.cos(angle * (np.pi / 180.0))
        b = torch.sin(angle * (np.pi / 180.0))
        hs = 2.0 * scale / (1.0 + ratio)
        ws = ratio * hs
        # source->target matrix (image_augmenter.h:208-212)
        m00 = hs * a - shear * b * ws
        m01 = hs * b + shear * a * ws
        m10 = -b * ws
        m11 = a * ws
        det = m00 * m11 - m01 * m10
        det = torch.where(torch.abs(det) < 1e-8, 1e-8, det)
        i00, i01 = m11 / det, -m01 / det
        i10, i11 = -m10 / det, m00 / det
        ys_t, xs_t = torch.meshgrid(
            torch.arange(h, dtype=x.dtype, device=dev),
            torch.arange(w, dtype=x.dtype, device=dev), indexing="ij")
        dx = xs_t - (w - 1) / 2.0
        dy = ys_t - (h - 1) / 2.0
        i00, i01, i10, i11 = (v[:, None, None] for v in (i00, i01, i10, i11))
        sx = i00 * dx + i01 * dy + (w - 1) / 2.0
        sy = i10 * dx + i11 * dy + (h - 1) / 2.0
        return _bilinear_sample(x, sy, sx, self.fill_value)

    def _hsl_jitter(self, x, key):
        """HSL color jitter (`image_augmenter.h:288-307`): OpenCV ranges,
        additive per-image offsets, CLAMPED like the reference's loop.
        Expects raw 0..255-scale RGB input."""
        n = x.shape[0]
        kh, ks, kl = _random.split(key, 3)
        dh = _uniform(kh, (n, 1, 1), -self.random_h, self.random_h or 1e-9,
                      x.device)
        ds = _uniform(ks, (n, 1, 1), -self.random_s, self.random_s or 1e-9,
                      x.device)
        dl = _uniform(kl, (n, 1, 1), -self.random_l, self.random_l or 1e-9,
                      x.device)
        h_, l_, s_ = _rgb_to_hls(x[:, 0], x[:, 1], x[:, 2])
        h_ = torch.clamp(h_ + dh, 0.0, 180.0)
        l_ = torch.clamp(l_ + dl, 0.0, 255.0)
        s_ = torch.clamp(s_ + ds, 0.0, 255.0)
        return torch.stack(_hls_to_rgb(h_, l_, s_), dim=1)

    def _crop_resize(self, x, key, out_hw):
        """min/max_crop_size: random square crop then resize to data_shape
        (`image_augmenter.h:233-253`), folded into one bilinear resample."""
        n, c, h, w = x.shape
        dev = x.device
        kh_, kw_ = out_hw
        if self.max_crop_size > min(h, w):
            raise MXNetError(
                "max_crop_size=%d exceeds image size %dx%d"
                % (self.max_crop_size, h, w))
        kcs, ky, kx = _random.split(key, 3)
        lo = self.min_crop_size if self.min_crop_size > 0 \
            else self.max_crop_size
        cs = _random.randint(kcs, (n,), lo, self.max_crop_size + 1, dev)
        max_y = h - cs
        max_x = w - cs
        if self.rand_crop:
            y0 = (_uniform(ky, (n,), 0.0, 1.0, dev) * (max_y + 1)).to(
                torch.int32)
            x0 = (_uniform(kx, (n,), 0.0, 1.0, dev) * (max_x + 1)).to(
                torch.int32)
        else:
            y0 = max_y // 2
            x0 = max_x // 2
        iy = torch.arange(kh_, dtype=torch.float32, device=dev)
        ix = torch.arange(kw_, dtype=torch.float32, device=dev)
        fy = (cs.to(torch.float32) / kh_)[:, None]
        fx = (cs.to(torch.float32) / kw_)[:, None]
        sy = y0[:, None] + (iy + 0.5) * fy - 0.5  # cv::resize coord mapping
        sx = x0[:, None] + (ix + 0.5) * fx - 0.5
        yy = sy[:, :, None].expand(n, kh_, kw_)
        xx = sx[:, None, :].expand(n, kh_, kw_)
        return _bilinear_sample(x, yy, xx, self.fill_value)

    def _augment(self, batch, key, out_hw):
        """The pipeline body: batch NCHW float32/compute dtype."""
        n, c, h, w = batch.shape
        dev = batch.device
        kh, kw = out_hw
        k1, k2, k3, k4, k5, k6, k7 = _random.split(key, 7)
        x = batch
        if self._needs_affine:
            x = self._affine_warp(x, k5)
        if (self.random_h or self.random_s or self.random_l) and c == 3:
            x = self._hsl_jitter(x, k6)
        if self._mean is not None:
            x = x - self._const("mean", self._mean, dev)
        elif self._mean_rgb is not None:
            x = x - self._const("mean_rgb", self._mean_rgb, dev)
        # crop: random-size crop+resize, else plain crop with random /
        # explicit (crop_y_start) / centered origin
        if self.max_crop_size > 0 or self.min_crop_size > 0:
            x = self._crop_resize(x, k7, (kh, kw))
        elif (h, w) != (kh, kw):
            if self.crop_y_start >= 0 or self.crop_x_start >= 0:
                oy = torch.full((n,), max(self.crop_y_start, 0), device=dev)
                ox = torch.full((n,), max(self.crop_x_start, 0), device=dev)
            elif self.rand_crop:
                oy = _random.randint(k1, (n,), 0, h - kh + 1, dev)
                ox = _random.randint(k2, (n,), 0, w - kw + 1, dev)
            else:
                oy = torch.full((n,), (h - kh) // 2, device=dev)
                ox = torch.full((n,), (w - kw) // 2, device=dev)
            # lax.dynamic_slice clamps the origin into the image
            oy = oy.long().clamp(0, h - kh)
            ox = ox.long().clamp(0, w - kw)
            rows = oy[:, None] + torch.arange(kh, device=dev)
            cols = ox[:, None] + torch.arange(kw, device=dev)
            x = x[torch.arange(n, device=dev)[:, None, None, None],
                  torch.arange(c, device=dev)[None, :, None, None],
                  rows[:, None, :, None], cols[:, None, None, :]]
        if self.rand_mirror:
            flip = _random.bernoulli(k3, 0.5, (n,), dev)
            x = torch.where(flip[:, None, None, None], x.flip(-1), x)
        if self.max_contrast > 0 or self.max_illum > 0:
            kc, ki = _random.split(k4)
            contrast = 1.0 + _uniform(kc, (n, 1, 1, 1), -self.max_contrast,
                                      self.max_contrast, dev)
            illum = _uniform(ki, (n, 1, 1, 1), -self.max_illum,
                             self.max_illum, dev)
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            x = (x - mean) * contrast + mean + illum
        return x * self.scale

    def __call__(self, batch):
        """Augment one NCHW batch (numpy, tensor or NDArray) -> a tensor on
        the current context's device."""
        dev = current_context().torch_device()
        if isinstance(batch, NDArray):
            batch = batch.data
        if not isinstance(batch, torch.Tensor):
            batch = torch.as_tensor(np.asarray(batch))
        if batch.dtype == torch.float64:
            batch = batch.float()  # the JAX package has no float64 either
        batch = batch.to(dev)
        if batch.ndim != 4:
            raise MXNetError("ImageAugmenter: batch must be NCHW 4D")
        out_hw = (self.data_shape[1], self.data_shape[2]) \
            if self.data_shape else tuple(batch.shape[2:])
        if batch.shape[2] < out_hw[0] or batch.shape[3] < out_hw[1]:
            raise MXNetError(
                "ImageAugmenter: input %s smaller than crop %s"
                % (tuple(batch.shape[2:]), out_hw))
        self._step += 1
        key = _random.fold_in(self._key, self._step)
        return self._augment(batch, key, out_hw)


def compute_mean_image(data_iter, path=None):
    """One pass over `data_iter` -> per-pixel mean image (the
    `iter_normalize.h` mean.bin computation; cached to `path` as .npy)."""
    total = None
    count = 0
    data_iter.reset()
    for batch in data_iter:
        n = batch.data[0].shape[0] - batch.pad
        arr = batch.data[0].asnumpy()[:n]
        s = arr.sum(axis=0)
        total = s if total is None else total + s
        count += n
    if count == 0:
        raise MXNetError("compute_mean_image: empty iterator")
    mean = (total / count).astype(np.float32)
    if path:
        np.save(path, mean)
    data_iter.reset()
    return mean

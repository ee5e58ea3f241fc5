"""cv2's three resizes of the train pipeline, emulated bit for bit without
cv2 (``polyphonicformer_tpu/data/pipeline.py`` calls ``cv2.resize`` at
:37, :40-41, :45 and :97-98).

- :func:`resize_linear_u8`: ``INTER_LINEAR`` on uint8 images, OpenCV's
  fixed-point bilinear with 11-bit coefficients.  The source coordinate of
  output pixel d is ``f = float32((d + 0.5) * scale - 0.5)`` with ``scale``
  in double; ``s = floor(f)``, ``f -= s``.  Along x, ``s < 0`` becomes
  ``f = 0, s = 0`` and ``s >= ssize - 1`` becomes ``f = 0, s = ssize - 1``;
  along y only the two rows read are clipped to the image and the weights
  stay.  The coefficients are ``rint(float32(1 - f) * 2048)`` and
  ``rint(float32(f) * 2048)``; the horizontal pass sums in int32, the
  vertical pass is OpenCV's ``VResizeLinearVec_32s8u``.  Its body runs in
  the port's native host library (``native/resize_linear.cpp``);
  :func:`resize_linear_u8_plain` is the numpy version the tests hold it to.
- :func:`resize_nearest`: ``INTER_NEAREST`` on the uint8 masks and f32
  depth, a gather of source index ``min(floor(d * (1 / (dsize / ssize))),
  ssize - 1)`` on each axis, as two ``np.take``.
- :func:`downsample_linear_x4`: ``INTER_LINEAR`` on f32 masks from the
  padded size to stride 4.  At a factor of exactly 4 every output pixel
  lies midway between source pixels 4i+1 and 4i+2 on both axes; cv2
  computes it as the lerps ``p + (q - p) * 0.5`` along x, then along y
  (bit-equal on any f32 input, where ``0.25 * (a + b + c + d)`` is not);
  any other factor raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def linear_taps(ssize: int, dsize: int, clamp: bool
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(source index (dsize,) int32, weights (dsize, 2) int16) of cv2's
    fixed-point bilinear along one axis; ``clamp`` is the x axis's rule."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if clamp:
        low, high = s < 0, s >= ssize - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = ssize - 1
    one = np.float32(1.0)
    w = np.stack([np.rint((one - f) * np.float32(COEF_SCALE)),
                  np.rint(f * np.float32(COEF_SCALE))], axis=1)
    return s.astype(np.int32), w.astype(np.int16)


def _check_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"need a (h, w) or (h, w, c) uint8 image, got {img.dtype} {img.shape}")
    return img if img.ndim == 3 else img[..., None]


def resize_linear_u8_plain(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)`` of a
    uint8 image, in numpy."""
    x = _check_u8(img)
    h, w = x.shape[:2]
    xofs, xa = linear_taps(w, nw, clamp=True)
    yofs, yb = linear_taps(h, nh, clamp=False)
    x1 = np.minimum(xofs + 1, w - 1)
    a = xa.astype(np.int32)
    hp = (x[:, xofs].astype(np.int32) * a[None, :, 0:1]
          + x[:, x1].astype(np.int32) * a[None, :, 1:2])
    r0 = np.clip(yofs, 0, h - 1)
    r1 = np.clip(yofs.astype(np.int64) + 1, 0, h - 1)
    b = yb.astype(np.int32)[:, :, None, None]
    out = (((b[:, 0] * (hp[r0] >> 4)) >> 16) + ((b[:, 1] * (hp[r1] >> 4)) >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def resize_linear_u8(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """:func:`resize_linear_u8_plain` in the native host library (built on
    first use; a library that does not build raises)."""
    from ..ops import native

    x = _check_u8(img)
    h, w = x.shape[:2]
    xofs, xa = linear_taps(w, nw, clamp=True)
    yofs, yb = linear_taps(h, nh, clamp=False)
    out = native.resize_linear_u8(x, nh, nw, xofs, xa, yofs, yb)
    return out if img.ndim == 3 else out[..., 0]


def nearest_index(ssize: int, dsize: int) -> np.ndarray:
    """cv2 ``INTER_NEAREST``'s source index along one axis."""
    ifx = 1.0 / (dsize / ssize)
    return np.minimum(np.floor(np.arange(dsize) * ifx).astype(np.int64), ssize - 1)


def resize_nearest(x: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``cv2.resize(x, (nw, nh), interpolation=cv2.INTER_NEAREST)`` over the
    last two axes of ``x`` (a stack of masks (N, h, w) or one (h, w) map)."""
    h, w = x.shape[-2:]
    rows = np.take(x, nearest_index(h, nh), axis=-2)
    return np.take(rows, nearest_index(w, nw), axis=-1)


def downsample_linear_x4(m: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """``cv2.resize(m.astype(np.float32), (ow, oh), interpolation=
    cv2.INTER_LINEAR)`` of one (H, W) mask at H = 4 oh, W = 4 ow, as f32."""
    h, w = m.shape
    if (h, w) != (4 * oh, 4 * ow):
        raise NotImplementedError(
            f"downsample_linear_x4: {h}x{w} -> {oh}x{ow} is not a factor of exactly 4")
    m = m.astype(np.float32, copy=False)
    half = np.float32(0.5)

    def lerp(p, q):
        return p + (q - p) * half

    return lerp(lerp(m[1::4, 1::4], m[1::4, 2::4]), lerp(m[2::4, 1::4], m[2::4, 2::4]))

"""The port's emulation of cv2's train-pipeline resizes
(``polyphonicformer_torch/data/resize.py`` and its native body
``native/resize_linear.cpp``) against real
cv2, which the CPU tests have and the port does not import.

Tolerance: none.  Every case is bit-equal to ``cv2.resize``: the uint8
bilinear (numpy and C++) at 24 seeded (size, ratio) pairs, 1024x2048
among them, plus odd, one-row and one-column sizes and ratio 1; the nearest
resize of uint8 mask stacks and of f32 depth; the x4 f32 downsample on
0/1 masks and on arbitrary f32 values.  The C++ bilinear equals the numpy
version, and a downsample factor other than 4 raises.
"""
import cv2
import numpy as np
import pytest

from polyphonicformer_torch.data import resize


def _cases():
    rng = np.random.RandomState(0)
    cases = [(1024, 2048, 2.0), (1024, 2048, 1.37), (7, 9, 1.5), (1, 5, 1.9), (13, 1, 1.2),
             (33, 47, 1.0), (33, 47, 1.0001), (100, 200, 1.999)]
    while len(cases) < 24:
        cases.append((int(rng.randint(1, 300)), int(rng.randint(1, 300)),
                      float(rng.uniform(1.0, 2.0))))
    return cases


CASES = _cases()


def _scaled(h, w, ratio):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


@pytest.mark.parametrize("h,w,ratio", CASES)
def test_linear_u8_matches_cv2(h, w, ratio):
    img = np.random.RandomState(h * 1000 + w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    nh, nw = _scaled(h, w, ratio)
    want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    plain = resize.resize_linear_u8_plain(img, nh, nw)
    native = resize.resize_linear_u8(img, nh, nw)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(native, want)
    # a flipped (negative-stride) view, as the pipeline never passes but may
    np.testing.assert_array_equal(resize.resize_linear_u8(img[:, ::-1], nh, nw),
                                  cv2.resize(np.ascontiguousarray(img[:, ::-1]), (nw, nh),
                                             interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("h,w,ratio", CASES[:12])
def test_nearest_matches_cv2(h, w, ratio):
    rng = np.random.RandomState(h + w)
    nh, nw = _scaled(h, w, ratio)
    masks = (rng.rand(3, h, w) > 0.5).astype(np.uint8)
    want = np.stack([cv2.resize(m, (nw, nh), interpolation=cv2.INTER_NEAREST) for m in masks])
    np.testing.assert_array_equal(resize.resize_nearest(masks, nh, nw), want)
    depth = (rng.rand(h, w) * 80).astype(np.float32)
    got = resize.resize_nearest(depth, nh, nw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, cv2.resize(depth, (nw, nh),
                                                  interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("hw", [(4, 4), (36, 68), (128, 256), (1056, 2080)])
def test_downsample_x4_matches_cv2(hw):
    h, w = hw
    rng = np.random.RandomState(h)
    for m in ((rng.rand(h, w) > 0.5).astype(np.uint8).astype(np.float32),
              (rng.randn(h, w) * 10).astype(np.float32)):
        want = cv2.resize(m, (w // 4, h // 4), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(resize.downsample_linear_x4(m, h // 4, w // 4), want)


def test_native_matches_plain():
    rng = np.random.RandomState(1)
    for _ in range(20):
        h, w = rng.randint(1, 120, 2)
        nh, nw = rng.randint(1, 240, 2)  # down- and upsampling, either axis
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(resize.resize_linear_u8(img, nh, nw),
                                      resize.resize_linear_u8_plain(img, nh, nw))


def test_other_factor_raises():
    with pytest.raises(NotImplementedError):
        resize.downsample_linear_x4(np.zeros((64, 128), np.float32), 32, 64)
    with pytest.raises(NotImplementedError):
        resize.downsample_linear_x4(np.zeros((66, 128), np.float32), 16, 32)


def test_taps_rules():
    """x is clamped at the borders, y is not (only its rows are clipped)."""
    xofs, xa = resize.linear_taps(4, 8, clamp=True)
    yofs, yb = resize.linear_taps(4, 8, clamp=False)
    assert xofs[0] == 0 and tuple(xa[0]) == (2048, 0)
    assert xofs[-1] == 3 and tuple(xa[-1]) == (2048, 0)
    assert yofs[0] == -1 and tuple(yb[0]) == (512, 1536)
    assert yofs[-1] == 3 and tuple(yb[-1]) == (1536, 512)

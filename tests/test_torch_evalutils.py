"""The port's evaluation code against the JAX package's on the same inputs,
made from a seed with numpy: ``vpq_eval`` (the native core and the plain
Python version), ``evaluate_dvpq`` over dumps written by JAX's
``save_frame`` in both depth encodings, STQ, ``frame_stats``,
``metrics_from_stats``, the depth metrics and threshold, the general branch
of ``fuse_panoptic`` and the demo's MAGMA table (against cv2).

The JAX package's ``vpq_eval`` takes its native library when that is built
and its Python path otherwise; the two add a class's IoUs in different
orders.  So each comparison pins the JAX side to one path: its native
library built from its own sources into a temporary directory (the
in-tree build races between test workers), or its Python path.  Native
against native and plain against plain must be bit-equal; native against
plain, equal counts and IoU sums within 1e-12.
"""
import dataclasses
import os
import subprocess

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.evalutils import dvpq as jdvpq
from polyphonicformer_tpu.evalutils import runner as jrunner
from polyphonicformer_tpu.evalutils import stq as jstq
from polyphonicformer_tpu.evalutils import vpq as jvpq
from polyphonicformer_tpu.infer.panoptic import fuse_panoptic as jax_fuse
from polyphonicformer_tpu.ops import native as jax_native
from polyphonicformer_tpu.ops.resize import resize_bilinear as jax_resize
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.evalutils import dvpq, runner, stq, vpq
from polyphonicformer_torch.infer.panoptic import fuse_panoptic
from polyphonicformer_torch.ops.resize import resize_bilinear_matmul

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIV = 10000


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    so = tmp_path_factory.mktemp("jax_native") / "libpolynative.so"
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-o",
                    str(so), "native/lsap.cpp", "native/vpq_core.cpp"], cwd=REPO, check=True)
    return str(so)


@pytest.fixture
def jax_on_native(jax_native_lib, monkeypatch):
    monkeypatch.setattr(jax_native, "_LIB_PATH", jax_native_lib)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.available()


@pytest.fixture
def jax_on_python(monkeypatch):
    monkeypatch.setattr(jax_native, "_load", lambda: None)


def random_panoptic(rng, shape, void_frac=0.05):
    cat = rng.randint(0, 19, shape)
    inst = np.where(cat < 8, rng.randint(0, 5, shape) + 1, 0)
    pan = cat * DIV + inst
    pan[rng.rand(*shape) < void_frac] = 255 * DIV
    return pan.astype(np.int64)


def pair(rng, base_hw=(16, 24), scale=8, flip=0.2):
    """Block-structured GT and a prediction that differs on ``flip`` of the
    blocks and never holds the void class."""
    base = random_panoptic(rng, base_hw)
    gt = np.kron(base, np.ones((scale, scale), np.int64))
    pb = base.copy()
    mask = rng.rand(*base_hw) < flip
    pb[mask] = random_panoptic(rng, base_hw, void_frac=0.0)[mask]
    void = pb == 255 * DIV
    pb[void] = random_panoptic(rng, base_hw, void_frac=0.0)[void]
    return np.kron(pb, np.ones((scale, scale), np.int64)), gt


def _bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(4))
def test_vpq_eval_matches_jax(seed, jax_native_lib, monkeypatch):
    rng = np.random.RandomState(seed)
    pred, gt = pair(rng, flip=0.1 + 0.1 * seed)
    native_res = vpq.vpq_eval(pred, gt)
    plain_res = vpq.vpq_eval_plain(pred, gt)
    with monkeypatch.context() as m:
        m.setattr(jax_native, "_load", lambda: None)
        _bit_equal(plain_res, jvpq.vpq_eval(pred, gt))
    monkeypatch.setattr(jax_native, "_LIB_PATH", jax_native_lib)
    monkeypatch.setattr(jax_native, "_lib", None)
    _bit_equal(native_res, jvpq.vpq_eval(pred, gt))
    for a, b in zip(native_res[1:], plain_res[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(native_res[0], plain_res[0], rtol=1e-12, atol=0)
    assert native_res[1].sum() > 0 and native_res[3].sum() > 0


def _write_dumps(root, save, rng, encoding):
    """Seq 0 with 4 frames, seq 3 with 3: GT depth on the uint16 grid, the
    predicted depth with relative errors on both sides of every lambda."""
    for seq_id, img_id in [(0, i) for i in range(4)] + [(3, i) for i in range(3)]:
        pred, gt = pair(rng, (10, 12), scale=5, flip=0.25)
        gt_depth = np.round((rng.rand(50, 60) * 60 + 1) * 256).astype(np.float32) / 256
        gt_depth[rng.rand(50, 60) < 0.15] = 0.0
        rel = np.array([0.0, 0.05, 0.2, 0.4, 0.7], np.float32)[rng.randint(0, 5, (50, 60))]
        pred_depth = np.clip(gt_depth * (1 + rel), 0.01, None).astype(np.float32)
        if encoding == "u16":
            enc = lambda d: np.clip(np.round(d * 256.0), 0, 65535).astype(np.uint16)  # noqa: E731
            pred_depth, gt_depth = enc(pred_depth), enc(gt_depth)
        save(root, "gt", seq_id, img_id, gt, gt_depth)
        save(root, "pred", seq_id, img_id, pred, pred_depth)


@pytest.mark.parametrize("encoding", ["f32", "u16"])
def test_evaluate_dvpq_matches_jax(encoding, tmp_path, jax_on_native):
    """Dumps written by JAX's save_frame aggregate to JAX's numbers bit for
    bit; the port's own save_frame writes the same arrays."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _write_dumps(jdir, jdvpq.save_frame, np.random.RandomState(5), encoding)
    _write_dumps(pdir, dvpq.save_frame, np.random.RandomState(5), encoding)
    for kind in ("gt", "pred"):
        names = [os.path.basename(p) for p in jdvpq.list_frames(jdir, kind)]
        assert names == [os.path.basename(p) for p in dvpq.list_frames(pdir, kind)]
        for name in names:
            a, b = np.load(os.path.join(pdir, kind, name)), np.load(os.path.join(jdir, kind, name))
            for key in ("panseg", "depth"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(dvpq.load_depth_dump(a), jdvpq.load_depth_dump(b))
    want = jdvpq.evaluate_dvpq(jdir, nproc=2)
    got = dvpq.evaluate_dvpq(jdir, nproc=2)
    assert got == want
    assert want["average"]["pq"] > 0 and len(want) == 17
    assert dvpq.WINDOWS == jdvpq.WINDOWS and dvpq.DEPTH_THRS == jdvpq.DEPTH_THRS


def test_stq_matches_jax():
    rng = np.random.RandomState(2)
    acc, jacc = stq.STQAccumulator(), jstq.STQAccumulator()
    for seq in range(2):
        for _ in range(3):
            pred, gt = pair(rng, (6, 8), scale=4, flip=0.3)
            _bit_equal(stq.stq_element(pred, gt), jstq.stq_element(pred, gt))
            acc.update(pred, gt, seq_id=seq)
            jacc.update(pred, gt, seq_id=seq)
    assert acc.result() == jacc.result()
    assert acc.result()["STQ"] > 0


def test_frame_stats_and_metrics_match_jax(jax_on_native):
    rng = np.random.RandomState(3)
    vs, ds, jvs, jds = [], [], [], []
    for _ in range(3):
        pred, gt = pair(rng)
        gd = (rng.rand(*gt.shape) * 60 + 1).astype(np.float32)
        gd[rng.rand(*gt.shape) < 0.1] = 0
        pd = (gd * (1 + 0.3 * rng.randn(*gt.shape))).clip(0.5, 80).astype(np.float32)
        v, d = runner.frame_stats(pred, gt, pd, gd)
        jv, jd = jrunner.frame_stats(pred, gt, pd, gd)
        _bit_equal((v, d), (jv, jd))
        vs.append(v), ds.append(d), jvs.append(jv), jds.append(jd)
    got = runner.metrics_from_stats(np.stack(vs), np.stack(ds))
    assert got == jrunner.metrics_from_stats(np.stack(jvs), np.stack(jds))
    assert got["pq@inf"] > 0


def test_depth_metrics_and_threshold_match_jax():
    rng = np.random.RandomState(4)
    pred, gt = pair(rng)
    gd = (rng.rand(*gt.shape) * 60 + 1).astype(np.float32)
    gd[rng.rand(*gt.shape) < 0.1] = 0
    pd = (gd * (1 + 0.3 * rng.randn(*gt.shape))).clip(0.5, 80).astype(np.float32)
    assert vpq.compute_depth_errors(pd, gd) == jvpq.compute_depth_errors(pd, gd)
    for thr in (0.0, 0.5, 0.25, 0.1):
        np.testing.assert_array_equal(vpq.apply_depth_threshold(pred, pd, gd, thr),
                                      jvpq.apply_depth_threshold(pred, pd, gd, thr))
    results = [vpq.vpq_eval(*pair(rng)) for _ in range(3)]
    got, want = vpq.aggregate_pq(results), jvpq.aggregate_pq(results)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# (stride-4 logits, output size): factors 3.125 and 2.54 x 2.325
GENERAL = {"50x100": ((16, 32), (50, 100)), "61x93": ((24, 40), (61, 93))}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(GENERAL))
def test_general_fusion_matches_jax(case, dtype):
    """Non-integer factors take the general branch on both sides: maps on
    >= 99.9% of pixels (measured: all), depth where they agree within
    rtol 1e-4 + atol 2e-3 (f32) and one bf16 ulp (bf16), keep and seg ids
    equal (the bounds of tests/test_torch_slice.py)."""
    (hs, ws), (h, w) = GENERAL[case]
    cfg = dataclasses.replace(get_preset("debug_tiny_video").model, max_per_img=100)
    pcfg = model_preset("debug_tiny_video", max_per_img=100)
    q = pcfg.num_queries
    rng = np.random.RandomState(hs)
    cls = (1 / (1 + np.exp(-2 * rng.randn(q, 19)))).astype(np.float32)
    # each stride-4 block owned by one query, so segments are kept
    owner = np.kron(rng.randint(0, q, (hs // 4 + 1, ws // 4 + 1)), np.ones((4, 4), int))
    owner = owner[:hs, :ws]
    ml = (np.where(owner[None] == np.arange(q)[:, None, None], 4.0, -4.0)
          + 0.5 * rng.randn(q, hs, ws)).astype(np.float32)
    dl = rng.randn(q, hs, ws).astype(np.float32)
    di = rng.randn(hs, ws).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jax_fuse(cfg, jnp.asarray(cls), jnp.asarray(ml), jnp.asarray(dl), jnp.asarray(di),
                    (h, w), fusion_dtype=jdt)
    got = fuse_panoptic(pcfg, torch.from_numpy(cls), torch.from_numpy(ml), torch.from_numpy(dl),
                        torch.from_numpy(di), (h, w), fusion_dtype=tdt)
    same = np.ones((h, w), bool)
    for field in ("semantic", "panoptic"):
        a, b = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert a.shape == b.shape == (h, w)
        assert (a == b).mean() >= 0.999, field
        same &= a == b
    rtol = 1e-4 if dtype == "f32" else 2.0 ** -7
    a, b = np.asarray(want.depth)[same], got.depth.numpy()[same]
    assert (np.abs(a - b) <= 2e-3 + rtol * np.abs(a)).all()
    np.testing.assert_array_equal(np.asarray(want.keep), got.keep.numpy())
    np.testing.assert_array_equal(np.asarray(want.seg_ids), got.seg_ids.numpy())
    assert int(got.keep[:100].sum()) > 0, "no thing kept"


def test_low_precision_resize_matches_jax():
    """resize_bilinear_matmul(precise=False) on bf16 against JAX's
    resize_bilinear(precise=False): within one bf16 ulp."""
    rng = np.random.RandomState(0)
    x = rng.randn(5, 16, 32).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x, jnp.bfloat16), (50, 100), precise=False)
                      .astype(jnp.float32))
    got = resize_bilinear_matmul(torch.from_numpy(x).bfloat16(), (50, 100),
                                 precise=False).float().numpy()
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()


def test_magma_table_matches_cv2():
    from polyphonicformer_torch.tools.demo import MAGMA_RGB, colorize_depth

    bgr = cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_MAGMA)
    np.testing.assert_array_equal(MAGMA_RGB, bgr.reshape(256, 3)[:, ::-1])
    depth = np.random.RandomState(0).rand(7, 9).astype(np.float32) * 100
    d8 = (255 * (1 - np.clip(depth / 80.0, 0, 1))).astype(np.uint8)
    np.testing.assert_array_equal(colorize_depth(depth),
                                  cv2.applyColorMap(d8, cv2.COLORMAP_MAGMA)[:, :, ::-1])

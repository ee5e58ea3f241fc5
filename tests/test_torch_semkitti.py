"""The SemKITTI-DVPS mode of the port against the JAX package's, on the CPU:
the ``video_r50_semkitti_1x`` preset, the nearest GT downsample of
``frame_to_sample`` (``ModelConfig.semantic_kitti``), the train loader over
a SemKITTI-layout split, ``data/label_shift.py`` and the dataset scanner.

The split is ``data/synthetic_split.py::write_semkitti_split`` (the port's
PNG encoder; the layout of the JAX ``tests/test_semkitti_e2e.py``): 94x310
frames, a quarter of SemKITTI-DVPS's 376x1241, 18-22 things a sequence.

Tolerance: none.  Every GT field is bit-equal.  The one expected
difference is fault F2: where a uint8 image is smaller than the crop, JAX
pads the raw image with 0 before the normalisation and the port pads with
0 after it, so on that border the port holds 0 and JAX ``-mean / std``;
everywhere else the port's normalised image equals JAX's uint8 image
normalised.
"""
import copy
import dataclasses
import random

import numpy as np
import pytest
import torch

from polyphonicformer_tpu.configs import get_preset as jax_preset
from polyphonicformer_tpu.data import label_shift as jax_label_shift
from polyphonicformer_tpu.data.cityscapes_dvps import CityscapesDVPSDataset as JaxDataset
from polyphonicformer_tpu.data.loader import TrainLoader as JaxTrainLoader
from polyphonicformer_tpu.data.pipeline import frame_to_sample as jax_frame_to_sample
from polyphonicformer_torch.configs import model_preset, preset
from polyphonicformer_torch.data import label_shift
from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
from polyphonicformer_torch.data.loader import GT_FIELDS, TrainLoader
from polyphonicformer_torch.data.pipeline import frame_to_sample, normalize_image
from polyphonicformer_torch.data.synthetic_split import write_semkitti_split

H, W = 94, 310  # SemKITTI-DVPS's 376x1241 / 4
CROP = (96, 320)  # the preset's 384x1248 / 4, on the size divisor


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs test files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("semkitti"))
    write_semkitti_split(root, "train", num_seqs=2, frames_per_seq=4, h=H, w=W)
    return root


def _datasets(root, **kw):
    kw = dict(split="train", with_depth=True, **kw)
    return CityscapesDVPSDataset(root, **kw), JaxDataset(root, **kw)


def test_preset_is_semantic_kitti():
    """Pinned field for field by test_torch_configs.py; here its meaning."""
    cfg = preset("video_r50_semkitti_1x")
    assert cfg.model.semantic_kitti and cfg.model.with_track
    assert cfg.data.img_size == (384, 1248) and cfg.data.ratio_range == (1.0, 2.0)
    assert cfg.data.data_root == "data/semkitti-dvps"
    assert not preset("video_r50_1x").model.semantic_kitti


def test_scanner_reads_the_semkitti_layout_as_jax(root):
    ds, jds = _datasets(root, ref_sample_mode="img")
    assert ds.images == jds.images and len(ds.images) == 8
    assert ds.images[0]["ann"].endswith("_gtFine_class.png")
    assert ds.images[0]["depth"].endswith("_depth_718.8560180664062.png")
    for info in ds.images[::3]:
        got, want = ds.load_frame(info), jds.load_frame(info)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
        assert (got["labels"] < 8).sum() >= 18  # SemKITTI's density of things


@pytest.mark.parametrize("semantic_kitti", [True, False])
def test_frame_to_sample_matches_jax(root, semantic_kitti):
    """94x310 frames padded to 96x312: the nearest GT downsample (binary
    masks) with ``semantic_kitti``, the bilinear one without."""
    ds, _ = _datasets(root, ref_sample_mode="img")
    cfg = model_preset("debug_tiny_video", semantic_kitti=semantic_kitti, max_things=16)
    jcfg = dataclasses.replace(jax_preset("debug_tiny_video").model,
                               semantic_kitti=semantic_kitti, max_things=16)
    for info in ds.images[:4]:
        frame = ds.load_frame(info)
        got = frame_to_sample(frame, cfg, (96, 312))
        want = jax_frame_to_sample(frame, jcfg, (96, 312))
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["image"], want["image"][:H, :W])  # F2
        for k in GT_FIELDS:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        soft = got["thing_masks"][(got["thing_masks"] > 0) & (got["thing_masks"] < 1)]
        assert (soft.size == 0) == semantic_kitti


def _f2_border(got_img, want_u8, dc):
    """The port's normalised image against JAX's uint8 one: equal to its
    normalisation except on a bottom and right border where the port is 0
    and JAX's raw pixels are 0.  Returns the image's true (h, w)."""
    want = normalize_image(want_u8, dc.mean, dc.std)
    diff = (got_img != want).any(-1)
    ph, pw = diff.shape
    h = ph - int(np.argmin(diff.all(1)[::-1])) if not diff.all() else 0
    w = pw - int(np.argmin(diff.all(0)[::-1])) if not diff.all() else 0
    border = np.ones_like(diff)
    border[:h, :w] = False
    np.testing.assert_array_equal(diff, border)
    assert not got_img[border].any() and not want_u8[border].any()
    return h, w


@pytest.mark.parametrize("ratio_range", [(1.0, 2.0), (1.0, 1.0)])
def test_train_loader_matches_jax(root, ratio_range):
    """The first 3 batches of 2 clips of ``video_r50_semkitti_1x``'s data at
    a quarter of its size (crop 96x320, ratio 1.0-2.0) on the debug video
    model (``max_things`` 8, fewer than a frame's things: the overflow keeps
    the largest), one worker each.  At ratio 1.0 every image is shorter than
    the crop: F2 on every sample."""
    cfg, jcfg = preset("video_r50_semkitti_1x"), jax_preset("video_r50_semkitti_1x")
    over = dict(img_size=CROP, ratio_range=ratio_range, batch_size=2)
    dc, jdc = (dataclasses.replace(c.data, **over) for c in (cfg, jcfg))
    mc = model_preset("debug_tiny_video", semantic_kitti=True)
    jmc = dataclasses.replace(jax_preset("debug_tiny_video").model, semantic_kitti=True)
    kw = dict(ref_sample_mode=dc.ref_sample_mode, ref_seq_index=dc.ref_seq_index)
    ds, jds = _datasets(root, **kw)
    loaders = (TrainLoader(ds, dc, mc, seed=5, num_workers=1, device="cpu"),
               JaxTrainLoader(jds, jdc, jmc, seed=5, num_workers=1))
    batches = []
    for loader in loaders:
        it = iter(loader)
        try:
            batches.append([next(it) for _ in range(3)])
        finally:
            loader.stop()
    short = 0
    for got, want in zip(*batches):
        for img, gt in (("image", "gt"), ("ref_image", "ref_gt")):
            g, w = getattr(got, img).numpy(), np.asarray(getattr(want, img))
            assert w.dtype == np.uint8 and g.shape == w.shape
            if g.dtype == np.uint8:
                np.testing.assert_array_equal(g, w, err_msg=img)
            else:
                sizes = [_f2_border(g[i], w[i], dc) for i in range(len(g))]
                short += sum(hw != CROP for hw in sizes)
            for f in GT_FIELDS:
                np.testing.assert_array_equal(getattr(getattr(got, gt), f).numpy(),
                                              np.asarray(getattr(getattr(want, gt), f)),
                                              err_msg=f"{gt}.{f}")
            masks = getattr(got, gt).thing_masks.numpy()
            assert set(np.unique(masks)) <= {0.0, 1.0}  # the nearest downsample
    if ratio_range == (1.0, 1.0):
        assert short == 12


def test_label_shift_matches_jax():
    rng = np.random.RandomState(0)
    sem = rng.choice([0, 1, 8, 10, 11, 13, 18, 255], size=(40, 60))
    inst = np.where(sem >= 11, rng.randint(1, 4, size=sem.shape), 0)
    sem[:3] = 255
    for ours, theirs, args in (
            (label_shift.sem2ins_masks_cityscapes, jax_label_shift.sem2ins_masks_cityscapes,
             (sem, inst)),
            (label_shift.sem2ins_masks, jax_label_shift.sem2ins_masks,
             (sem, inst, 2, (13, 11), 255)),
            (label_shift.sem2ins_masks_cityscapes, jax_label_shift.sem2ins_masks_cityscapes,
             (np.full((4, 5), 255), np.zeros((4, 5), np.int64)))):
        got, want = ours(*args), theirs(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    masks, labels, _ = label_shift.sem2ins_masks_cityscapes(sem, inst)
    assert masks.sum(0).max() == 1 and (labels < 8).any() and (labels >= 8).any()


def test_clip_rejection_draws_match(root):
    """Random(seed) after 6 clips of the SemKITTI pipeline is in the same
    state on both sides (rejections included): the draws are JAX's."""
    from polyphonicformer_tpu.data.pipeline import TrainPipeline as JaxPipeline
    from polyphonicformer_torch.data.pipeline import TrainPipeline

    ds, _ = _datasets(root, ref_sample_mode="img")
    frames = [ds.load_frame(info) for info in ds.images[:4]]
    dc = dataclasses.replace(preset("video_r50_semkitti_1x").data, img_size=(32, 64))
    jdc = dataclasses.replace(jax_preset("video_r50_semkitti_1x").data, img_size=(32, 64))
    mc = model_preset("debug_tiny_video", semantic_kitti=True)
    jmc = dataclasses.replace(jax_preset("debug_tiny_video").model, semantic_kitti=True)
    port, jax = TrainPipeline(dc, mc), JaxPipeline(jdc, jmc)
    rp, rj = random.Random(3), random.Random(3)
    outcomes = []
    for i in range(6):
        clip = [frames[i % 3], frames[i % 3 + 1]]
        got, want = port(copy.deepcopy(clip), rp), jax(copy.deepcopy(clip), rj)
        assert (got is None) == (want is None) and rp.getstate() == rj.getstate()
        outcomes.append(got is None)
        for g, w in zip(got or [], want or []):
            for k in GT_FIELDS:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert not all(outcomes)

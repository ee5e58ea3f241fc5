"""The port's eval data side against the JAX package's on the same files:
the Cityscapes-DVPS dataset scan and frame decode (cv2 on the JAX side,
``data/png.py`` on the port's) on the JAX tests' synthetic train, val and
SemKITTI layouts; ``make_test_input``; and ``MPEvalLoader``'s order,
images and GT dumps.  Everything must be equal, field for field and bit for
bit.
"""
import os

import numpy as np
import pytest
import torch

from polyphonicformer_tpu.configs import get_preset as jax_get_preset
from polyphonicformer_tpu.data import cityscapes_dvps as jds
from polyphonicformer_tpu.data import mp_loader as jmp
from polyphonicformer_tpu.data import pipeline as jpipe
from polyphonicformer_torch.configs import get_preset
from polyphonicformer_torch.data import cityscapes_dvps as pds
from polyphonicformer_torch.data import mp_loader as pmp
from polyphonicformer_torch.data import pipeline as ppipe
from test_dataset_and_cli import write_synthetic_dataset
from test_semkitti_e2e import write_semkitti_dataset

FRAME_KEYS = ("img", "pan", "depth", "masks", "labels", "inst_ids", "seq_id", "img_id")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    cs = str(tmp_path_factory.mktemp("cityscapes"))
    write_synthetic_dataset(cs, split="train", num_seqs=2, frames_per_seq=4)
    write_synthetic_dataset(cs, split="val", num_seqs=2, frames_per_seq=3)
    sk = str(tmp_path_factory.mktemp("semkitti"))
    write_semkitti_dataset(sk, split="val", num_seqs=2, frames_per_seq=2)
    return {"train": cs, "val": cs, "semkitti": sk}


def _assert_equal(a, b, what):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


CASES = {
    "train_random": ("train", "train", dict(ref_sample_mode="random", ref_seq_index=(-1, 1))),
    "train_sequence": ("train", "train", dict(ref_sample_mode="sequence",
                                              ref_seq_index=(-1, 1))),
    "val_img": ("val", "val", dict(ref_sample_mode="img")),
    "val_test": ("val", "val", dict(ref_sample_mode="test", ref_seq_len_test=2)),
    "semkitti": ("semkitti", "val", dict(ref_sample_mode="img")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_matches_jax(roots, case):
    """Scan (images, samples, pairs) and every frame's decode."""
    layout, split, kw = CASES[case]
    want = jds.CityscapesDVPSDataset(roots[layout], split=split, **kw)
    got = pds.CityscapesDVPSDataset(roots[layout], split=split, **kw)
    assert got.images == want.images
    assert got.samples == want.samples
    for idx in range(len(got)):
        import random

        assert got.get_pair(idx, random.Random(idx)) == want.get_pair(idx, random.Random(idx))
    for info in got.images:
        for segments in (True, False):
            a = got.load_frame(info, segments=segments)
            b = want.load_frame(info, segments=segments)
            assert sorted(a) == sorted(b)
            for key in FRAME_KEYS:
                if key in b:
                    _assert_equal(a[key], b[key], f"{case} {info['img']} {key}")


def test_constants_and_to_coco_match_jax():
    for name in ("CLASSES", "THING_CLASSES", "STUFF_CLASSES", "NO_OBJ", "NO_OBJ_HB",
                 "DIVISOR_PAN", "INSTANCE_DIVISOR", "TRAINID_TO_COCO"):
        assert getattr(pds, name) == getattr(jds, name), name
    rng = np.random.RandomState(0)
    pan = rng.randint(0, 19, (20, 30)) * 1000 + rng.randint(0, 7, (20, 30))
    pan[:3] = 32 * 1000
    for divisor in (1000, 10000):
        _assert_equal(pds.to_coco(pan, divisor), jds.to_coco(pan, divisor), str(divisor))
    masks, labels, inst = pds.decode_segments(pds.to_coco(pan, 10000))
    for a, b in zip((masks, labels, inst), jds.decode_segments(jds.to_coco(pan, 10000))):
        _assert_equal(a, b, "decode_segments")


@pytest.mark.parametrize("hw", [(128, 256), (50, 100), (97, 33)])
def test_make_test_input_matches_jax(hw):
    """Normalise, then pad with 0 to the divisor; odd sizes included."""
    rng = np.random.RandomState(hw[0])
    frame = dict(img=rng.randint(0, 256, hw + (3,)).astype(np.uint8), seq_id=3, img_id=7)
    got = ppipe.make_test_input(frame, get_preset("video_r50_1x").data)
    want = jpipe.make_test_input(frame, jax_get_preset("video_r50_1x").data)
    assert sorted(got) == sorted(want)
    for key in want:
        _assert_equal(got[key], want[key], key)


def test_mp_eval_loader_matches_jax(roots, tmp_path):
    """Two spawn workers each side over the val split: the same frames in
    the same order, bit-equal images, and bit-equal GT dumps."""
    root = roots["val"]
    want_ds = jds.CityscapesDVPSDataset(root, split="val", ref_sample_mode="img")
    got_ds = pds.CityscapesDVPSDataset(root, split="val", ref_sample_mode="img")
    frames = list(reversed(got_ds.images))  # an order other than the scan's
    dc, jdc = get_preset("debug_tiny_video").data, jax_get_preset("debug_tiny_video").data
    padded = (128, 256)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with jmp.MPEvalLoader(want_ds, frames, jdc, padded, num_workers=2, gt_dir=jdir) as loader:
        want = list(loader)
    with pmp.MPEvalLoader(got_ds, frames, dc, padded, num_workers=2, gt_dir=pdir,
                          device="cpu") as loader:
        got = list(loader)
    assert [info for info, _ in got] == [info for info, _ in want] == frames
    for (_, image), (_, ref) in zip(got, want):
        assert image.dtype == torch.float32 and image.device.type == "cpu"
        np.testing.assert_array_equal(image.numpy(), ref)
    names = sorted(os.listdir(os.path.join(jdir, "gt")))
    assert names == sorted(os.listdir(os.path.join(pdir, "gt"))) and len(names) == len(frames)
    for name in names:
        a = np.load(os.path.join(pdir, "gt", name))
        b = np.load(os.path.join(jdir, "gt", name))
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            _assert_equal(a[key], b[key], f"{name} {key}")

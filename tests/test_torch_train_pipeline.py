"""The port's train pipeline (``polyphonicformer_torch/data/pipeline.py``:
``TrainPipeline``, cv2's resizes emulated in ``data/resize.py``) against the
JAX package's (``polyphonicformer_tpu/data/pipeline.py``, real cv2) on the
same decoded frames and the same ``random.Random`` seed.

Tolerance: none.  Every output field is bit-equal, a clip is rejected
(``None``) on the same draws, and both leave the generator in the same
state, for 1- and 2-frame clips, crops that are and are not divisor-aligned,
and ratios that cut and do not cut the image.  The one expected difference
is fault F2: where the image is smaller than the crop, JAX ships the uint8
crop padded with 0 (normalised to ``-mean / std`` on the device) while the
port ships the crop at its true size and ``BatchSender`` pads it with 0
after the normalisation, as the reference pads after Normalize.
"""
import copy
import dataclasses
import random

import numpy as np
import pytest

from polyphonicformer_tpu.configs import get_preset as jax_preset
from polyphonicformer_tpu.data.pipeline import TrainPipeline as JaxPipeline
from polyphonicformer_torch.configs import preset
from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
from polyphonicformer_torch.data.loader import BatchSender, flat_sample
from polyphonicformer_torch.data.pipeline import TrainPipeline, normalize_image
from polyphonicformer_torch.data.synthetic_split import write_dvps_split

H, W = 128, 256


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("split"))
    write_dvps_split(root, "train", num_seqs=2, frames_per_seq=3, h=H, w=W)
    ds = CityscapesDVPSDataset(root, split="train", ref_seq_index=(-1, 1))
    return [ds.load_frame(info) for info in ds.images]


def _pipelines(name, **data):
    cfg, jcfg = preset(name), jax_preset(name)
    dc = dataclasses.replace(cfg.data, **data)
    jdc = dataclasses.replace(jcfg.data, **data)
    return TrainPipeline(dc, cfg.model), JaxPipeline(jdc, jcfg.model), dc


def _run_both(port, jax, clips, seed):
    """Each pipeline over the clips from its own Random(seed); returns the
    pairs of outputs."""
    rp, rj = random.Random(seed), random.Random(seed)
    pairs = []
    for clip in clips:
        pairs.append((port(copy.deepcopy(clip), rp), jax(copy.deepcopy(clip), rj)))
        assert rp.getstate() == rj.getstate()
    return pairs


def _clips(frames, two):
    if not two:
        return [[f] for f in frames]
    return [[frames[i], frames[i + 1]] for i in (0, 1, 3, 4)] * 2


CONFIGS = [
    # (preset, data overrides): full crops, cutting crops with rejections,
    # a crop size off the divisor (normalised on the host on both sides)
    ("debug_tiny", {}),
    ("debug_tiny", {"img_size": (64, 128), "ratio_range": (1.0, 2.0)}),
    ("debug_tiny", {"img_size": (60, 100), "ratio_range": (1.0, 2.0), "flip_ratio": 1.0}),
    ("debug_tiny_video", {}),
    ("debug_tiny_video", {"img_size": (64, 128), "ratio_range": (1.0, 2.0)}),
    ("debug_tiny_video", {"img_size": (64, 128), "ratio_range": (1.0, 2.0),
                          "check_id_match": 1}),
]


@pytest.mark.parametrize("name,data", CONFIGS)
def test_pipeline_matches_jax(frames, name, data):
    port, jax, _ = _pipelines(name, **data)
    pairs = _run_both(port, jax, _clips(frames, name.endswith("video")), seed=7)
    rejected = 0
    for got, want in pairs:
        assert (got is None) == (want is None)
        if got is None:
            rejected += 1
            continue
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if data.get("check_id_match") == 1:  # no id is below 1: every clip is rejected
        assert rejected == len(pairs)
    else:
        assert rejected < len(pairs)


def test_rejections_happen(frames):
    """Crops of 64x128 out of up to 256x512 miss every thing now and then:
    the rejection path is exercised (and matched above)."""
    port, jax, _ = _pipelines("debug_tiny_video", img_size=(32, 64), ratio_range=(1.0, 2.0))
    pairs = _run_both(port, jax, _clips(frames, True) * 3, seed=3)
    outcomes = [got is None for got, _ in pairs]
    assert any(outcomes) and not all(outcomes)
    assert outcomes == [want is None for _, want in pairs]


@pytest.mark.parametrize("name", ["debug_tiny", "debug_tiny_video"])
def test_short_image_pads_after_normalise(frames, name):
    """F2: a 96x200 image and a 128x256 crop."""
    port, jax, dc = _pipelines(name, ratio_range=(1.0, 1.0), flip_ratio=0.0)
    small = []
    for f in frames:
        f = dict(f, img=f["img"][:96, :200], masks=f["masks"][:, :96, :200],
                 depth=f["depth"][:96, :200])
        keep = f["masks"].any(axis=(1, 2))
        small.append(dict(f, masks=f["masks"][keep], labels=f["labels"][keep],
                          inst_ids=f["inst_ids"][keep]))
    (got, want), = _run_both(port, jax, _clips(small, name.endswith("video"))[:1], seed=0)
    for g, w in zip(got, want):
        assert g["image"].shape == (96, 200, 3) and w["image"].shape == (H, W, 3)
        np.testing.assert_array_equal(w["image"][:96, :200], g["image"])
        assert not w["image"][96:].any() and not w["image"][:, 200:].any()
        for k in w:
            if k != "image":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    batch = BatchSender(dc, len(got) == 2, "cpu")([flat_sample(got)])
    images = [batch.image] + ([batch.ref_image] if len(got) == 2 else [])
    for img, w in zip(images, want):
        img = img[0].numpy()
        assert img.dtype == np.float32
        np.testing.assert_array_equal(img[:96, :200],
                                      normalize_image(w["image"][:96, :200], dc.mean, dc.std))
        assert not img[96:].any() and not img[:, 200:].any()

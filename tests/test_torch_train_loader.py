"""The port's train loaders (``polyphonicformer_torch/data/loader.py::
TrainLoader``, the thread backend, and ``data/mp_loader.py::
MPTrainLoader``, the spawn-worker backend) against the JAX package's
``TrainLoader`` on the same ``write_dvps_split(split="train")`` split.

Tolerance: none.  With one worker each (one ``random.Random(seed * 100003
+ wid)`` stream), the first 3 batches of batch size 2 are equal field by
field: the raw uint8 image and every GT field, key and ref frame, for
``debug_tiny`` and ``debug_tiny_video``.  A dead worker makes
``MPTrainLoader`` raise ``RuntimeError`` within its poll interval instead
of waiting (it looks every second); the 2-frame split is one the loader accepts (instance ids
shared across frames).
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from polyphonicformer_tpu.configs import get_preset as jax_preset
from polyphonicformer_tpu.data.cityscapes_dvps import CityscapesDVPSDataset as JaxDataset
from polyphonicformer_tpu.data.loader import TrainLoader as JaxTrainLoader
from polyphonicformer_torch.configs import preset
from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
from polyphonicformer_torch.data.loader import GT_FIELDS, TrainLoader
from polyphonicformer_torch.data.mp_loader import MPTrainLoader
from polyphonicformer_torch.data.synthetic_split import write_dvps_split

BATCHES, B = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs test files on parallel workers,
    where a CPU torch step with a thread per core slows several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("split"))
    write_dvps_split(root, "train", num_seqs=2, frames_per_seq=3, h=128, w=256)
    return root


def _datasets(root, dc):
    kw = dict(split="train", ref_sample_mode=dc.ref_sample_mode,
              ref_seq_index=dc.ref_seq_index, with_depth=True)
    return CityscapesDVPSDataset(root, **kw), JaxDataset(root, **kw)


def _take(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        loader.stop()


def _assert_batch_equal(got, want, two_frame):
    frames = [("image", "gt")] + ([("ref_image", "ref_gt")] if two_frame else [])
    for img, gt in frames:
        g, w = getattr(got, img).numpy(), np.asarray(getattr(want, img))
        assert g.dtype == w.dtype == np.uint8, img
        np.testing.assert_array_equal(g, w, err_msg=img)
        for f in GT_FIELDS:
            np.testing.assert_array_equal(getattr(getattr(got, gt), f).numpy(),
                                          np.asarray(getattr(getattr(want, gt), f)),
                                          err_msg=f"{gt}.{f}")
    if not two_frame:
        assert got.ref_image is None and got.ref_gt is None


@pytest.mark.parametrize("name", ["debug_tiny", "debug_tiny_video"])
@pytest.mark.parametrize("backend", ["thread", "process"])
def test_loader_matches_jax(root, name, backend):
    cfg, jcfg = preset(name), jax_preset(name)
    dc = dataclasses.replace(cfg.data, batch_size=B)
    jdc = dataclasses.replace(jcfg.data, batch_size=B)
    ds, jds = _datasets(root, dc)
    want = _take(JaxTrainLoader(jds, jdc, jcfg.model, seed=5, num_workers=1), BATCHES)
    cls = TrainLoader if backend == "thread" else MPTrainLoader
    got = _take(cls(ds, dc, cfg.model, seed=5, num_workers=1, device="cpu"), BATCHES)
    two_frame = name.endswith("video")
    for g, w in zip(got, want):
        _assert_batch_equal(g, w, two_frame)
    if two_frame:  # the split's clips share thing ids across frames
        for g in got:
            ids = g.gt.thing_inst_ids[g.gt.thing_valid]
            assert np.isin(ids.numpy(), g.ref_gt.thing_inst_ids.numpy()).any()


def test_dead_worker_raises(root):
    cfg = preset("debug_tiny_video")
    ds, _ = _datasets(root, cfg.data)
    loader = MPTrainLoader(ds, cfg.data, cfg.model, seed=0, num_workers=2, device="cpu").start()
    try:
        it = iter(loader)
        next(it)  # the workers run
        victim = loader._procs[1]
        victim.kill()
        victim.join(timeout=10)
        assert not victim.is_alive()
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="workers died"):
            for _ in range(loader.slots + 1):  # the ring's ready samples, then the check
                next(it)
        assert time.perf_counter() - t0 < 5.0
    finally:
        loader.stop()

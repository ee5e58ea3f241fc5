"""The training CLI's data path and the CLI itself on the card.

Marked ``cuda``: without a card every test skips.  On the card:

    python -m pytest tests/test_torch_train_cuda.py -m cuda

- ``BatchSender`` (pinned staging, ``non_blocking`` copies) gives on the
  card the batch it gives on the CPU, over more batches than it has staging
  sets: bit for bit, except a short image, normalised on the device and
  padded with 0, within one f32 spacing (the card divides by a scalar as a
  multiply by its reciprocal; the train step normalises a full uint8 image
  on the card the same way).
- ``MPTrainLoader(device="cuda")`` yields the batches of
  ``MPTrainLoader(device="cpu")``, bit for bit.
- ``tools/train.py`` on the card (``debug_tiny_video``, process loader)
  runs 3 steps with finite metrics and each train kernel launched as a
  train step launches it, then resumes at step 3.
"""
import copy
import json
import random

import numpy as np
import pytest
import torch

from polyphonicformer_torch.configs import preset
from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
from polyphonicformer_torch.data.loader import GT_FIELDS, BatchSender, flat_sample
from polyphonicformer_torch.data.mp_loader import MPTrainLoader
from polyphonicformer_torch.data.pipeline import TrainPipeline
from polyphonicformer_torch.data.synthetic_split import write_dvps_split

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def root(tmp_path):
    write_dvps_split(str(tmp_path), "train", num_seqs=2, frames_per_seq=3, h=128, w=256)
    return str(tmp_path)


def _fields(batch):
    out = {"image": batch.image, "ref_image": batch.ref_image}
    out.update({f: getattr(batch.gt, f) for f in GT_FIELDS})
    out.update({"ref_" + f: getattr(batch.ref_gt, f) for f in GT_FIELDS})
    return {k: v.cpu() for k, v in out.items()}


def _assert_same(a, b):
    fa, fb = _fields(a), _fields(b)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        if k.endswith("image") and fa[k].dtype == torch.float32:
            spacing = torch.finfo(torch.float32).eps * torch.maximum(fa[k].abs(), fb[k].abs())
            assert bool(((fa[k] - fb[k]).abs() <= spacing).all()), k
        else:
            assert torch.equal(fa[k], fb[k]), k


def test_batch_sender_card_equals_cpu(dev, root):
    cfg = preset("debug_tiny_video")
    ds = CityscapesDVPSDataset(root, ref_seq_index=(-1, 1))
    pipe = TrainPipeline(cfg.data, cfg.model)
    rng = random.Random(0)
    samples = []
    while len(samples) < 8:
        t = rng.randrange(2)  # frames t, t + 1 of the first sequence
        out = pipe([ds.load_frame(ds.images[t]), ds.load_frame(ds.images[t + 1])], rng)
        if out is not None:
            samples.append(flat_sample(out))
    short = dict(samples[0], image=samples[0]["image"][:100, :200])  # normalised on the card
    card = BatchSender(cfg.data, True, dev)
    cpu = BatchSender(cfg.data, True, "cpu")
    for i in range(0, 8, 2):  # 4 batches through the 3 staging sets
        batch = samples[i:i + 2] if i else [short, samples[1]]
        got = card(copy.deepcopy(batch))
        want = cpu(batch)
        _assert_same(got, want)
        assert got.image.dtype == (torch.float32 if i == 0 else torch.uint8)


def test_mp_loader_card_equals_cpu(dev, root):
    cfg = preset("debug_tiny_video")
    ds = CityscapesDVPSDataset(root, ref_seq_index=(-1, 1))
    got, want = [], []
    for device, out in ((dev, got), ("cpu", want)):
        loader = MPTrainLoader(ds, cfg.data, cfg.model, seed=1, num_workers=1, device=device)
        it = iter(loader)
        try:
            out.extend(next(it) for _ in range(3))
        finally:
            loader.stop()
    for g, w in zip(got, want):
        assert g.image.is_cuda
        _assert_same(g, w)


def test_train_cli_on_card(dev, root, tmp_path):
    from polyphonicformer_torch.ops.cuda import lsa, mask_loss, upsample2
    from polyphonicformer_torch.tools import train

    kernels = (upsample2.KERNEL_BWD, lsa.KERNEL, mask_loss.KERNEL, mask_loss.KERNEL_BWD)
    args = ["--preset", "debug_tiny_video", "--data-root", root, "--work-dir",
            str(tmp_path / "run"), "--eval-every-epochs", "0"]
    before = [k.launches for k in kernels]
    out = train.main(args + ["--max-steps", "3"])
    assert [k.launches - b for k, b in zip(kernels, before)] == [12, 3, 6, 6]
    with open(out["metrics_path"]) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert all(np.isfinite(v) for r in lines for v in r.values())
    again = train.main(args + ["--max-steps", "4", "--resume"])
    assert (again["start_step"], again["end_step"]) == (3, 4)

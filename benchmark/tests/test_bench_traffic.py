"""The traffic generators: the frozen copy of ``synthetic_batch`` gives
bit-equal arrays to the port's for the same seed, and a seed gives the same
frames twice (and another seed others)."""
import pytest
import torch

from benchmark.reference import config as ref_config
from benchmark.traffic import load, moving_blocks, synthetic_batch

from .tiny import HERE


@pytest.mark.parametrize("seed, two_frame, max_instances", [
    (0, True, 24), (2 ** 31 + 5, True, None), (7, False, 6)])
def test_synthetic_batch_is_the_ports(seed, two_frame, max_instances):
    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch as port_batch

    cfg = model_preset("video_r50_1x")
    mine = synthetic_batch.synthetic_batch(cfg, 2, (64, 128), two_frame, seed % 2 ** 32,
                                           max_instances, "cpu")
    port = port_batch(cfg, 2, (64, 128), two_frame, seed % 2 ** 32, max_instances, "cpu")
    assert torch.equal(mine[0], port.image)
    for f in synthetic_batch.FIELDS:
        assert torch.equal(mine[1][f], getattr(port.gt, f)), f
    if two_frame:
        assert torch.equal(mine[2], port.ref_image)
        for f in synthetic_batch.FIELDS:
            assert torch.equal(mine[3][f], getattr(port.ref_gt, f)), f


def test_pool_batches_differ_and_repeat():
    exp = ref_config.load(HERE / "configs" / "video_r50_1x.json")
    mix = load("train_video_b2")
    a = synthetic_batch.pool(mix, exp.model, 2, (64, 128), 2 ** 33 + 1, "cpu")
    b = synthetic_batch.pool(mix, exp.model, 2, (64, 128), 2 ** 33 + 1, "cpu")
    assert len(a) == mix["pool"]
    assert all(torch.equal(x[0], y[0]) for x, y in zip(a, b))
    assert not torch.equal(a[0][0], a[1][0])


def test_frames_repeat_for_a_seed():
    mix = load("serve_4streams")
    a = moving_blocks.pool(mix, (128, 256), 2 ** 32 + 3, torch.device("cpu"))
    b = moving_blocks.pool(mix, (128, 256), 2 ** 32 + 3, torch.device("cpu"))
    c = moving_blocks.pool(mix, (128, 256), 5, torch.device("cpu"))
    assert a.shape == (mix["cycle_frames"], mix["streams"], 128, 256, 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])  # the blocks move
    assert not torch.equal(a[0, 0], a[0, 1])  # streams differ

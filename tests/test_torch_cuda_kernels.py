"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes (the serving shapes are in chip_smoke.py).

Marked ``cuda``: without a card every test skips.  On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda
"""
import pytest
import torch

from polyphonicformer_torch.ops.cuda import map_render, mask_pool, phase_fusion, upsample2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nchw", [False, True])
def test_mask_pool(dev, dtype, nchw):
    """rtol 1e-5 of sum |feat| over each mask; the split sum is
    deterministic, so two launches give the same bits."""
    g = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((2, 37, 19, 45), generator=g, device=dev).to(dtype)
    if nchw:
        feats = torch.randn((2, 70, 19, 45), generator=g, device=dev).to(dtype).permute(0, 2, 3, 1)
    else:
        feats = torch.randn((2, 19, 45, 70), generator=g, device=dev).to(dtype)
    before = mask_pool.KERNEL.launches
    got = mask_pool.masked_pool(logits, feats)
    again = mask_pool.masked_pool(logits, feats)
    assert mask_pool.KERNEL.launches == before + 2
    want = mask_pool.mask_pool_plain(logits, feats)
    hard = (torch.sigmoid(logits.float()) > 0.5).float()
    bound = 1e-5 * torch.einsum("bnhw,bhwc->bnc", hard, feats.float().abs()) + 1e-6
    assert ((got - want).abs() <= bound).all()
    assert torch.equal(got, again)


@pytest.mark.parametrize("fy,fx", [(2, 2), (4, 4), (3, 2), (1, 4)])
def test_upsample_bit_equal(dev, fy, fx):
    x = torch.randn((3, 13, 29), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    assert torch.equal(upsample2.upsample_int(x, fy, fx), upsample2.upsample_int_plain(x, fy, fx))


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("n_full", [None, 10])
def test_phase_fusion(dev, f, n_full):
    """pix, marginals and areas exact; dep rtol 1e-5, atol 1e-4.  Widths
    not a multiple of the block exercise the ragged edge."""
    g = torch.Generator(device=dev).manual_seed(2)
    kk, hs, ws = 27, 11, 150
    probs = torch.sigmoid(torch.randn((kk, hs, ws), generator=g, device=dev) * 3)
    scores = torch.rand((kk,), generator=g, device=dev)
    depth = torch.rand((kk, hs, ws), generator=g, device=dev) * 70 + 1
    got = phase_fusion.phase_fusion(probs, scores, depth, f, f, n_full=n_full)
    want = phase_fusion.phase_fusion_plain(probs, scores, depth, f, f, n_full=n_full)
    for i in (0, 2, 3, 4):
        assert torch.equal(got[i], want[i]), i
    assert ((got[1] - want[1]).abs() <= 1e-4 + 1e-5 * want[1].abs()).all()


def test_map_render(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    k, h, w = 21, 33, 70
    args = (torch.randint(-1, 30, (h, w), generator=g, device=dev, dtype=torch.int32),
            torch.rand((h, w), generator=g, device=dev), torch.rand((h, w), generator=g, device=dev),
            torch.randint(0, 19, (k,), generator=g, device=dev, dtype=torch.int32),
            torch.randint(0, k, (k,), generator=g, device=dev, dtype=torch.int32),
            torch.rand((k,), generator=g, device=dev) > 0.4,
            torch.randint(0, 1000, (k,), generator=g, device=dev, dtype=torch.int32), 19)
    for a, b in zip(map_render.render_maps(*args), map_render.render_maps_plain(*args)):
        assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        upsample2.upsample_int(torch.zeros((1, 4, 4), device=dev, dtype=torch.float16), 2)
    with pytest.raises(ValueError):
        upsample2.upsample_int(torch.zeros((1, 4, 8), device=dev)[:, :, ::2], 2)
    with pytest.raises(NotImplementedError):
        z = torch.zeros((8, 4, 4), device=dev)
        phase_fusion.phase_fusion(z, torch.zeros(8, device=dev), z, 3, 3)


def test_video_frame_step_never_syncs(dev):
    """After a warm-up frame (which uploads the cached constants), a bf16
    frame through the serving path reads nothing back to the host."""
    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.infer.pipeline import video_frame_step
    from polyphonicformer_torch.infer.tracker import init_tracker_state
    from polyphonicformer_torch.models import build_model

    cfg = model_preset("debug_tiny_video", max_per_img=100)
    g = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, dev, generator=g).to(torch.bfloat16)
    frames = torch.randn((2, 1, 64, 128, 3), generator=g, device=dev)
    state = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev)
    kw = dict(compute_dtype=torch.bfloat16, fusion_dtype=torch.bfloat16)
    _, state = video_frame_step(model, cfg, frames[0], state, 1, (64, 128), **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, state = video_frame_step(model, cfg, frames[1], state, 2, (64, 128), **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.semantic.shape == (64, 128)

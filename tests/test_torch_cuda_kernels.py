"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes (the serving shapes are in chip_smoke.py).

Marked ``cuda``: without a card every test skips.  On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda
"""
import pytest
import torch

from polyphonicformer_torch.ops.cuda import (lsa, map_render, mask_loss, mask_pool,
                                             phase_fusion, relpos_attn, tracker, upsample2,
                                             window_attn)
import tracker_cases

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


def _check_mask_pool(logits, feats):
    """rtol 1e-5 of sum |feat| over each mask, and equal bits twice."""
    got = mask_pool.masked_pool(logits, feats)
    again = mask_pool.masked_pool(logits, feats)
    want = mask_pool.mask_pool_plain(logits, feats)
    hard = (torch.sigmoid(logits.float()) > 0.5).float()
    bound = 1e-5 * torch.einsum("bnhw,bhwc->bnc", hard, feats.float().abs()) + 1e-6
    assert ((got - want).abs() <= bound).all()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(1, 100), (1, 111), (2, 111)])
def test_mask_pool_main_shapes(dev, dtype, b, n):
    """The serving and training shapes: 1024x2048 / 8 masks over 256 NCHW
    channels (the 16-byte vector path, split over HW across the SMs)."""
    g = torch.Generator(device=dev).manual_seed(8)
    logits = torch.randn((b, n, 128, 256), generator=g, device=dev).to(dtype)
    feats = torch.randn((b, 256, 128, 256), generator=g, device=dev).to(dtype)
    before = mask_pool.KERNEL.launches
    _check_mask_pool(logits, feats.permute(0, 2, 3, 1))
    assert mask_pool.KERNEL.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_pool_unaligned(dev, dtype):
    """Storage that starts one element off a 16-byte boundary takes the
    kernel's predicated scalar path."""
    g = torch.Generator(device=dev).manual_seed(9)
    lg = torch.randn((1 + 111 * 64 * 128,), generator=g, device=dev).to(dtype)
    ft = torch.randn((1 + 256 * 64 * 128,), generator=g, device=dev).to(dtype)
    logits = lg[1:].view(1, 111, 64, 128)
    feats = ft[1:].view(1, 256, 64, 128).permute(0, 2, 3, 1)
    assert logits.data_ptr() % 16 and feats.data_ptr() % 16
    _check_mask_pool(logits, feats)


@pytest.mark.parametrize("shape,f", [((111, 128, 256), 2), ((1, 256, 512), 4)])
def test_upsample_main_shapes_bit_equal(dev, shape, f):
    x = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(10), device=dev)
    before = upsample2.KERNEL.launches
    assert torch.equal(upsample2.upsample_int(x, f), upsample2.upsample_int_plain(x, f, f))
    assert upsample2.KERNEL.launches == before + 1


@pytest.mark.parametrize("fy,fx", [(2, 2), (4, 4), (3, 2), (1, 4)])
def test_upsample_bit_equal(dev, fy, fx):
    x = torch.randn((3, 13, 29), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    assert torch.equal(upsample2.upsample_int(x, fy, fx), upsample2.upsample_int_plain(x, fy, fx))


# (K, hs, ws): widths off the 8-column chunk (plain fills) and off the
# 32-column tile; hs one more than a tile of stride rows at f = 4 (4) and
# f = 2 (8); 16-byte fills with ragged tiles
PF_SHAPES = [(27, 11, 150), (27, 5, 33), (19, 9, 40), (70, 17, 64)]


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("n_full", [None, 10, 8, 64])
@pytest.mark.parametrize("kk,hs,ws", PF_SHAPES)
def test_phase_fusion(dev, f, n_full, kk, hs, ws):
    """pix, marginals and areas exact; dep rtol 1e-5, atol 1e-4; two
    candidates tie exactly (the first must win).  Widths and heights not a
    multiple of the tile exercise the ragged edges."""
    g = torch.Generator(device=dev).manual_seed(2)
    probs = torch.sigmoid(torch.randn((kk, hs, ws), generator=g, device=dev) * 3)
    scores = torch.rand((kk,), generator=g, device=dev)
    depth = torch.rand((kk, hs, ws), generator=g, device=dev) * 70 + 1
    probs[3], scores[3] = probs[1], scores[1]
    before = phase_fusion.KERNEL.launches
    got = phase_fusion.phase_fusion(probs, scores, depth, f, f, n_full=n_full)
    assert phase_fusion.KERNEL.launches == before + 1
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


# (n, h, w) of the source: ragged everything; one row past whole blocks of
# source rows and one column past a block's 128 (scalar path); whole blocks
# (float4 path); float4 with ragged bands and strips
BWD_SHAPES = [(3, 13, 29), (2, 33, 129), (2, 32, 128), (1, 65, 132)]


@pytest.mark.parametrize("fy,fx", [(2, 2), (4, 4), (3, 2), (1, 4)])
@pytest.mark.parametrize("n,h,w", BWD_SHAPES)
def test_upsample_bwd_bit_equal(dev, fy, fx, n, h, w):
    """K2b against its plain version, and through autograd."""
    g = torch.Generator(device=dev).manual_seed(4)
    grad = torch.randn((n, h * fy, w * fx), generator=g, device=dev)
    before = upsample2.KERNEL_BWD.launches
    got = upsample2._upsample_int_bwd_cuda(grad, fy, fx)
    assert torch.equal(got, upsample2.upsample_int_bwd_plain(grad, fy, fx))
    x = torch.randn((n, h, w), generator=g, device=dev, requires_grad=True)
    upsample2.upsample_int(x, fy, fx).backward(grad)
    assert torch.equal(x.grad, got)
    assert upsample2.KERNEL_BWD.launches == before + 2


def test_upsample_bwd_unaligned(dev):
    """A gradient that starts one element off a 16-byte boundary takes the
    kernel's scalar loads; bit-equal all the same."""
    g = torch.Generator(device=dev).manual_seed(5)
    flat = torch.randn((1 + 2 * 64 * 256,), generator=g, device=dev)
    grad = flat[1:].view(2, 64, 256)
    assert grad.data_ptr() % 16
    assert torch.equal(upsample2._upsample_int_bwd_cuda(grad, 2, 2),
                       upsample2.upsample_int_bwd_plain(grad, 2, 2))


@pytest.mark.parametrize("n", [444, 19])
def test_upsample_bwd_main_shapes_bit_equal(dev, n):
    """The train step's gradients: (444, 256, 512) stacked masks and (19,
    256, 512) semantic logits."""
    grad = torch.randn((n, 256, 512), generator=torch.Generator(device=dev).manual_seed(6),
                       device=dev)
    assert torch.equal(upsample2._upsample_int_bwd_cuda(grad, 2, 2),
                       upsample2.upsample_int_bwd_plain(grad, 2, 2))


@pytest.mark.parametrize("g_rows,p_cols", [(64, 100), (12, 20), (40, 40), (7, 130), (1, 1),
                                           (32, 32), (33, 33), (64, 128), (20, 300),
                                           (16, 1024)])
def test_lsa_equals_plain(dev, g_rows, p_cols):
    """K5: the same assignments as the plain solver, with ties, clamped
    non-finite costs and invalid rows in the middle; the shapes run every
    CPL instance (1, 2, 4, 8, 16 and 32 columns a lane)."""
    from polyphonicformer_torch.ops.hungarian import match_gt_to_preds_batched

    gen = torch.Generator(device=dev).manual_seed(5)
    costs = torch.randn((6, g_rows, p_cols), generator=gen, device=dev) * 3
    costs[:, :, ::7] = costs[:, :, ::7].round()
    costs[0] = costs[0].round()
    costs[4, min(2, g_rows - 1), 0] = float("nan")
    valid = torch.rand((6, g_rows), generator=gen, device=dev) > 0.4
    valid[1] = False
    valid[2] = True
    valid[3, ::2] = False
    got = match_gt_to_preds_batched(costs, valid)
    want = match_gt_to_preds_batched(costs.cpu(), valid.cpu())
    assert torch.equal(got.cpu(), want)
    assert torch.equal(match_gt_to_preds_batched(costs, valid), got)  # deterministic


@pytest.mark.parametrize("g_rows,p_cols", [(64, 100), (24, 40), (33, 70), (16, 1024)])
def test_lsa_transposed_raw_costs_and_signed_zeros(dev, g_rows, p_cols):
    """K5 on raw costs as the assignment hands them, a transposed view of
    (N, P, M), with -0.0 tied against +0.0, +-inf and NaN; launched once
    (the preparation happens in the kernel), equal to the plain solver."""
    from polyphonicformer_torch.ops.hungarian import match_gt_to_preds_batched

    gen = torch.Generator(device=dev).manual_seed(8)
    costs = (torch.randn((6, p_cols, g_rows), generator=gen, device=dev) * 3).round()
    costs[:, ::2] = torch.where(costs[:, ::2] == 0, -0.0, costs[:, ::2])
    costs[:, 1::3] = torch.where(costs[:, 1::3] == 0, 0.0, costs[:, 1::3])
    costs[2] = torch.where(costs[2] < 1, -0.0, 0.0)
    costs[4, 0, 0], costs[4, 1, -1], costs[4, -1, 1] = float("nan"), float("inf"), -float("inf")
    view = costs.transpose(1, 2)
    valid = torch.rand((6, g_rows), generator=gen, device=dev) > 0.3
    valid[3, ::3] = False
    before = lsa.KERNEL.launches
    got = match_gt_to_preds_batched(view, valid)
    assert lsa.KERNEL.launches == before + 1
    assert torch.equal(got.cpu(), lsa.solve_lsa_plain(view.cpu(), valid.cpu()))
    assert torch.equal(lsa.solve_lsa(view.contiguous(), valid), got)


def test_lsa_train_step_problems(dev):
    """K5 on the problems one full-width image_r50_2x train step hands it
    (recorded at the solver's entry), equal to the plain solver, twice."""
    from polyphonicformer_torch.tools import kernel_probe

    for costs, valid in kernel_probe._train_step_lsa_problems(dev):
        got = lsa.solve_lsa(costs, valid)
        assert torch.equal(got.cpu(), lsa.solve_lsa_plain(costs.cpu(), valid.cpu()))
        assert torch.equal(lsa.solve_lsa(costs, valid), got)


@pytest.mark.parametrize("shape,offset", [
    ((2, 7, 16, 128), 0), ((3, 111, 37, 45), 0), ((1, 100, 64, 128), 0),
    ((1, 100, 256, 512), 0),  # the rpn head's call in the train step
    ((2, 9, 13, 7), 0),       # H*W not a multiple of 4 (as 37 x 45)
    ((1, 7, 16, 128), 1),     # rows not 16-byte aligned: the scalar path
])
def test_mask_loss_equals_plain(dev, shape, offset):
    """K6 / K6b: stats and dice within rtol 1e-5 of the plain version, the
    forward's lse bit-equal to the plain version's (``_rank_terms``), dm
    within rtol 1e-5 + atol 1e-7 of the plain gradient given that lse; any
    H and W; deterministic."""
    n, q, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    m = torch.randn(shape, generator=gen, device=dev) * 3
    if offset:
        m = torch.cat([torch.zeros(offset, device=dev), m.reshape(-1)])[offset:].view(shape)
        assert not mask_loss.vector_path(h * w, m)
    t = (torch.rand(shape, generator=gen, device=dev) < 0.3).float()
    pos = (torch.rand((n, q), generator=gen, device=dev) < 0.5).float()
    valid = (torch.rand((n, h, w), generator=gen, device=dev) < 0.9).float()
    lbl = torch.randint(-1, q + 2, (n, h, w), generator=gen, device=dev, dtype=torch.int32)
    lbl[torch.rand((n, h, w), generator=gen, device=dev) < 0.2] = 255
    stats, dice, lse = mask_loss._stats_cuda(m, t, pos, valid, lbl)
    ws, wd, wl = mask_loss.mask_loss_stats_plain(m, t, pos, valid, lbl)
    torch.testing.assert_close(stats, ws, rtol=1e-5, atol=1e-7 * h * w)
    torch.testing.assert_close(dice, wd, rtol=1e-5, atol=1e-7 * h * w)
    assert torch.equal(lse, wl) and torch.equal(lse, mask_loss._rank_terms(m, lbl)[0])
    again = mask_loss._stats_cuda(m, t, pos, valid, lbl)
    assert all(torch.equal(a, b) for a, b in zip(again, (stats, dice, lse)))
    gs = torch.randn((n, 2), generator=gen, device=dev)
    gd = torch.randn((n, 3, q), generator=gen, device=dev)
    dm = mask_loss._grad_cuda(m, t, pos, valid, lbl, gs, gd, lse)
    torch.testing.assert_close(dm, mask_loss.mask_loss_grad_plain(m, t, pos, valid, lbl, gs, gd, wl),
                               rtol=1e-5, atol=1e-7)


def test_mask_pool_backward(dev):
    """K1's backward on the card equals the CPU's (hard^T @ g)."""
    g = torch.Generator(device=dev).manual_seed(7)
    logits = torch.randn((2, 9, 8, 16), generator=g, device=dev)
    feats = torch.randn((2, 12, 8, 16), generator=g, device=dev, requires_grad=True)
    grad = torch.randn((2, 9, 12), generator=g, device=dev)
    mask_pool.masked_pool(logits, feats.permute(0, 2, 3, 1)).backward(grad)
    fc = feats.detach().cpu().requires_grad_()
    mask_pool.masked_pool(logits.cpu(), fc.permute(0, 2, 3, 1)).backward(grad.cpu())
    torch.testing.assert_close(feats.grad.cpu(), fc.grad, rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        upsample2.upsample_int(torch.zeros((1, 4, 4), device=dev, dtype=torch.float16), 2)
    with pytest.raises(ValueError):
        upsample2.upsample_int(torch.zeros((1, 4, 8), device=dev)[:, :, ::2], 2)
    with pytest.raises(NotImplementedError):
        z = torch.zeros((8, 4, 4), device=dev)
        phase_fusion.phase_fusion(z, torch.zeros(8, device=dev), z, 3, 3)
    with pytest.raises(ValueError):  # more rows than columns
        lsa.solve_lsa(torch.zeros((1, 5, 4), device=dev),
                      torch.ones((1, 5), dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):  # more columns than the largest instance
        lsa.solve_lsa(torch.zeros((1, 2, 1025), device=dev),
                      torch.ones((1, 2), dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):
        z = torch.zeros((1, 3, 4, 4), device=dev)
        mask_loss.mask_loss_stats(z, z, torch.zeros((1, 2), device=dev),
                                  torch.zeros((1, 4, 4), device=dev),
                                  torch.zeros((1, 4, 4), dtype=torch.int32, device=dev))


def test_video_frame_step_never_syncs(dev):
    """After a warm-up frame (which uploads the cached constants), a bf16
    frame through the serving path reads nothing back to the host and
    launches K9 once."""
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
    launches = tracker.KERNEL.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, state = video_frame_step(model, cfg, frames[1], state, 2, (64, 128), **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.semantic.shape == (64, 128)
    assert tracker.KERNEL.launches == launches + 1


def test_train_step_never_syncs(dev):
    """After a warm-up step, one debug_tiny train step on the card (K1,
    K2, K2b, K5, K6, K6b, AdamW and the non-finite guard) reads nothing
    back to the host, and each new kernel is launched."""
    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import PolyphonicFormer
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    cfg = preset("debug_tiny")
    with torch.device("meta"):
        model = PolyphonicFormer(cfg.model)
    state, opt = create_train_state(model, cfg, torch.Generator(device=dev).manual_seed(0),
                                    device=dev)
    step = make_train_step(state.model, cfg, opt)
    batch = synthetic_batch(cfg.model, 1, (64, 128), seed=0, device=dev)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    kernels = (upsample2.KERNEL_BWD, lsa.KERNEL, mask_loss.KERNEL, mask_loss.KERNEL_BWD)
    before = [k.launches for k in kernels]
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 1, 2, 2]
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert bool(torch.isfinite(metrics["total_loss"]))


def test_video_train_step_never_syncs(dev):
    """After a warm-up step, one debug_tiny_video 2-frame train step on the
    card (the key frame's K1, K2, K2b, K5, K6, K6b, the ref frame's
    features, the marginal GT boxes, the track head and losses, AdamW and
    the guard) reads nothing back to the host, and launches each kernel as
    often as an image step does."""
    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import PolyphonicFormer
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    cfg = preset("debug_tiny_video")
    with torch.device("meta"):
        model = PolyphonicFormer(cfg.model)
    state, opt = create_train_state(model, cfg, torch.Generator(device=dev).manual_seed(0),
                                    device=dev)
    step = make_train_step(state.model, cfg, opt, video=True)
    batch = synthetic_batch(cfg.model, 1, (64, 128), two_frame=True, seed=0, device=dev)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    kernels = (mask_pool.KERNEL, upsample2.KERNEL, upsample2.KERNEL_BWD, lsa.KERNEL,
               mask_loss.KERNEL, mask_loss.KERNEL_BWD)
    before = [k.launches for k in kernels]
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [k.launches - b for k, b in zip(kernels, before)] == [7, 4, 4, 1, 2, 2]
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert bool(torch.isfinite(metrics["total_loss"]))
    assert float(metrics["loss_track"]) > 0 and float(metrics["loss_track_aux"]) > 0


@pytest.mark.parametrize("hw", [(256, 512), (128, 256)])
def test_marginal_gt_boxes_equal_materialised_on_card(dev, hw):
    """The GT track boxes from the stride-4 support marginals equal, bit for
    bit, the MAD boxes of the materialised binarised x4 upsample (K2) over
    the same masks; the marginal counts equal the CPU's."""
    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.ops.roi_align import masks_to_boxes_mad, upsampled_support_marginals
    from polyphonicformer_torch.train.video_losses import gt_track_boxes, gt_track_masks

    cfg = model_preset("video_r50_1x")
    gt = synthetic_batch(cfg, 2, hw, seed=3, max_instances=24, device=dev).gt
    got = gt_track_boxes(gt, hw)
    full = gt_track_masks(gt, hw)
    assert torch.equal(got, masks_to_boxes_mad(full.flatten(0, 1)).reshape(got.shape))
    assert int(gt.thing_valid.sum()) >= 24
    cpu = upsampled_support_marginals(gt.thing_masks.flatten(0, 1).cpu(), hw)
    for a, b in zip(upsampled_support_marginals(gt.thing_masks.flatten(0, 1), hw), cpu):
        assert torch.equal(a.cpu(), b)


def _attn_close(got, want):
    """f32: sums in another order (1e-5).  bf16: within one bf16 spacing
    (ulp) of the output everywhere, as one flipped output rounding; K7's
    rounding of P leaves no more room (without it, K7's outputs move by up
    to hundreds of ulps)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    assert got.dtype == want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    assert ((got - want).abs() <= torch.ldexp(torch.ones_like(got), e - 8)).all()


# K7: (windows, mask types, heads, ws, hd): two images of 35 windows, ws 8 /
# hd 64 being the largest window and head the kernels take; then Swin-L stages
# 2 and 3 of a 1024x2048 frame
K7_SHAPES = [(70, 35, 3, 7, 32), (70, 35, 3, 8, 64), (190, 190, 24, 7, 32), (50, 50, 48, 7, 32)]
# K8: (images, Hp, Wp, heads, ws, hd): two 14x63 images (18 windows each),
# two 16x64 images at ws 8 / hd 64; then Swin-L stages 0 and 1
K8_SHAPES = [(2, 14, 63, 3, 7, 32), (2, 16, 64, 3, 8, 64), (1, 259, 518, 6, 7, 32),
             (1, 133, 259, 12, 7, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nw,ntypes,heads,ws,hd", K7_SHAPES)
def test_window_attn_math(dev, dtype, masked, nw, ntypes, heads, ws, hd):
    """K7 against its plain version, a random mask of ``ntypes`` window
    types; the small shapes need over 48 KB of shared memory at ws 8."""
    g = torch.Generator(device=dev).manual_seed(8)
    l = ws * ws
    qkv = torch.randn((nw, l, 3 * heads * hd), generator=g, device=dev).to(dtype)
    bias = torch.randn((heads, l, l), generator=g, device=dev) * 0.5
    mask = ((torch.rand((ntypes, l, l), generator=g, device=dev) < 0.3) * -100.0
            if masked else None)
    before = window_attn.KERNEL_MATH.launches
    got = window_attn.window_attn_math(qkv, bias, mask, heads)
    assert window_attn.KERNEL_MATH.launches == before + 1
    want = window_attn.window_attn_math_plain(qkv, bias, mask, heads)
    _attn_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,hp,wp,heads,ws,hd", K8_SHAPES)
def test_window_attention(dev, dtype, masked, b, hp, wp, heads, ws, hd):
    """K8 against its plain version, the shift mask of the images' windows."""
    from polyphonicformer_torch.models.swin import _shift_attn_mask

    g = torch.Generator(device=dev).manual_seed(9)
    l = ws * ws
    qkv = torch.randn((b, hp, wp, 3 * heads * hd), generator=g, device=dev).to(dtype)
    bias = torch.randn((heads, l, l), generator=g, device=dev) * 0.5
    mask = torch.from_numpy(_shift_attn_mask(hp, wp, ws, ws // 2)).to(dev) if masked else None
    before = window_attn.KERNEL_IMAGE.launches
    got = window_attn.window_attention(qkv, bias, mask, heads, ws)
    assert window_attn.KERNEL_IMAGE.launches == before + 1
    want = window_attn.window_attention_plain(qkv, bias, mask, heads, ws)
    _attn_close(got, want)


# bf16 (window, head dim) under 33 tokens or off 32 and 64: head slots padded
# to 16 channels; head dim 12 takes the kernel's 2-byte loads
ODD_SHAPES = [(4, 16), (5, 8), (3, 12), (6, 40), (4, 24)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ws,hd", ODD_SHAPES)
def test_window_attn_bf16_odd_shapes(dev, masked, ws, hd):
    """K8 on two images of 3x4 windows, K7 on their windows, and K8 on a qkv
    that is not 16-byte aligned, each against its plain version."""
    from polyphonicformer_torch.models.swin import _shift_attn_mask, window_partition

    g = torch.Generator(device=dev).manual_seed(10)
    heads, l, hp, wp = 2, ws * ws, 3 * ws, 4 * ws
    qkv = torch.randn((2, hp, wp, 3 * heads * hd), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((heads, l, l), generator=g, device=dev) * 0.5
    mask = torch.from_numpy(_shift_attn_mask(hp, wp, ws, ws // 2)).to(dev) if masked else None
    _attn_close(window_attn.window_attention(qkv, bias, mask, heads, ws),
                window_attn.window_attention_plain(qkv, bias, mask, heads, ws))
    win = window_partition(qkv, ws).contiguous()
    _attn_close(window_attn.window_attn_math(win, bias, mask, heads),
                window_attn.window_attn_math_plain(win, bias, mask, heads))
    shifted = torch.empty(qkv.numel() + 1, dtype=qkv.dtype, device=dev)[1:].view(qkv.shape)
    shifted.copy_(qkv)
    _attn_close(window_attn.window_attention(shifted, bias, mask, heads, ws),
                window_attn.window_attention_plain(qkv, bias, mask, heads, ws))


def test_window_attn_wrappers_refuse(dev):
    bias = torch.zeros((2, 49, 49), device=dev)
    with pytest.raises(TypeError):  # float16
        window_attn.window_attn_math(torch.zeros((4, 49, 96), device=dev, dtype=torch.float16),
                                     bias, None, 2)
    with pytest.raises(ValueError):  # 81 tokens a window
        window_attn.window_attention(torch.zeros((1, 9, 9, 96), device=dev),
                                     torch.zeros((2, 81, 81), device=dev), None, 2, 9)
    with pytest.raises(ValueError):  # head dim 80
        window_attn.window_attn_math(torch.zeros((4, 49, 480), device=dev), bias, None, 2)
    with pytest.raises(ValueError):  # not contiguous
        window_attn.window_attn_math(torch.zeros((4, 49, 192), device=dev)[..., ::2], bias,
                                     None, 2)
    with pytest.raises(ValueError):  # 3 window types for 4 windows
        window_attn.window_attn_math(torch.zeros((4, 49, 96), device=dev), bias,
                                     torch.zeros((3, 49, 49), device=dev), 2)
    with pytest.raises(ValueError):  # 14x21 is 6 windows, not 4
        window_attn.window_attention(torch.zeros((1, 14, 21, 96), device=dev), bias,
                                     torch.zeros((4, 49, 49), device=dev), 2, 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("entry", ["k7", "k8"])
def test_window_attn_grads_match_plain(dev, dtype, masked, entry):
    """On the card the output of K7/K8 carries a grad_fn when qkv requires
    grad, and the qkv and bias gradients (the plain version's VJP) lie
    within 1e-5 x max |plain| of autograd through the plain version on the
    same inputs and cotangent: two images of 3x4 windows of 49 tokens, 3
    heads of 32."""
    from polyphonicformer_torch.models.swin import _shift_attn_mask, window_partition

    g = torch.Generator(device=dev).manual_seed(11)
    heads, ws, hp, wp = 3, 7, 21, 28
    qkv = torch.randn((2, hp, wp, 3 * heads * 32), generator=g, device=dev).to(dtype)
    bias = torch.randn((heads, 49, 49), generator=g, device=dev) * 0.5
    mask = torch.from_numpy(_shift_attn_mask(hp, wp, ws, 3)).to(dev) if masked else None
    if entry == "k7":
        qkv = window_partition(qkv, ws).contiguous()
        run, plain, extra = window_attn.window_attn_math, window_attn.window_attn_math_plain, ()
        kernel = window_attn.KERNEL_MATH
    else:
        run, plain, extra = window_attn.window_attention, window_attn.window_attention_plain, (ws,)
        kernel = window_attn.KERNEL_IMAGE
    grads, cot = [], None
    for fn in (run, plain):
        q, b = qkv.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        before = kernel.launches
        y = fn(q, b, mask, heads, *extra)
        if fn is run:
            assert y.grad_fn is not None and kernel.launches == before + 1
        if cot is None:
            cot = torch.randn(y.shape, generator=g, device=dev).to(dtype)
        y.backward(cot)
        grads.append((q.grad.float(), b.grad))
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_swin_train_step_grads_match_f64_reference(dev):
    """A debug_tiny train step with the swin_tiny backbone on the card
    through K7 and K8 against the same step in f64 on the CPU and with the
    plain versions on the card (``chip_smoke.check_swin_train_reference``,
    which raises on a mismatch): assignments, losses, grad_norm and every
    parameter's gradient, K7 and K8 launched."""
    import chip_smoke

    info = chip_smoke.check_swin_train_reference(dev)
    worst = info["max_grad_err_of_max_f64"]
    assert max(worst["kernels_vs_f64"], worst["kernels_vs_plain"]) <= chip_smoke.SWIN_GRAD_RTOL


def test_swin_frame_never_syncs(dev):
    """After a warm-up frame (which uploads the shift masks and the bias
    index), a bf16 swin_tiny frame reads nothing back to the host and
    launches K8 10 times (stages 0-2, at most 12 heads) and K7 twice."""
    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.infer.pipeline import video_frame_step
    from polyphonicformer_torch.infer.tracker import init_tracker_state
    from polyphonicformer_torch.models import build_model

    cfg = model_preset("debug_tiny_video", backbone="swin_tiny", max_per_img=100)
    g = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, dev, generator=g).to(torch.bfloat16)
    frames = torch.randn((2, 1, 64, 128, 3), generator=g, device=dev)
    state = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev)
    kw = dict(compute_dtype=torch.bfloat16, fusion_dtype=torch.bfloat16)
    _, state = video_frame_step(model, cfg, frames[0], state, 1, (64, 128), **kw)
    torch.cuda.synchronize()
    before = (window_attn.KERNEL_IMAGE.launches, window_attn.KERNEL_MATH.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, state = video_frame_step(model, cfg, frames[1], state, 2, (64, 128), **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.semantic.shape == (64, 128)
    assert (window_attn.KERNEL_IMAGE.launches - before[0],
            window_attn.KERNEL_MATH.launches - before[1]) == (10, 2)


def test_batched_video_step_never_syncs(dev):
    """The batched step over 2 clips (bf16, debug widths): after a warm-up
    step, one step reads nothing back to the host, launches K3 and K4
    once per clip and K9 once for both; its per-clip maps equal two one-clip
    frame steps."""
    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.infer.pipeline import (batched_video_step,
                                                       init_batched_tracker_states,
                                                       video_frame_step)
    from polyphonicformer_torch.infer.tracker import init_tracker_state
    from polyphonicformer_torch.models import build_model

    cfg = model_preset("debug_tiny_video", max_per_img=100)
    g = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, dev, generator=g).to(torch.bfloat16)
    frames = torch.randn((2, 2, 64, 128, 3), generator=g, device=dev)
    kw = dict(compute_dtype=torch.bfloat16, fusion_dtype=torch.bfloat16)
    states = init_batched_tracker_states(cfg, 2, dev)
    _, states = batched_video_step(model, cfg, frames[0], states, [1, 1], (64, 128), **kw)
    torch.cuda.synchronize()
    before = (phase_fusion.KERNEL.launches, map_render.KERNEL.launches, tracker.KERNEL.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, states = batched_video_step(model, cfg, frames[1], states, [2, 2], (64, 128), **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (phase_fusion.KERNEL.launches - before[0], map_render.KERNEL.launches - before[1],
            tracker.KERNEL.launches - before[2]) == (2, 2, 1)
    assert out.semantic.shape == (2, 64, 128) and states.ids.shape[0] == 2
    for b in range(2):
        state = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev)
        for t in range(2):
            fo, state = video_frame_step(model, cfg, frames[t, b:b + 1], state, t + 1,
                                         (64, 128), **kw)
        agree = (fo.semantic == out.semantic[b]).float().mean()
        assert agree >= 0.999, float(agree)  # a batch of 2 may sum in another order


def _tracker_fields(step):
    """(state, ids, order, kept) as (name, tensor) pairs."""
    return [*tracker_cases.state_fields(step[0]).items(),
            *zip(("ids", "order", "kept"), step[1:])]


@pytest.mark.parametrize("b", [1, 4])
def test_tracker_step_kernel_matches_plain(dev, b):
    """K9 against the plain version (the op's CPU route) over 100 seeded
    8-frame sequences at the serving sizes (D 64, T 128, BD 64, E 256) and
    B = b, 200 in all (``tests/tracker_cases.py``: each match metric,
    with_cats on and off, 0, 4, 64 or any number of valid rows a frame, tied
    scores and scores at the thresholds, duplicate boxes, duplicate
    embeddings whose tie the lowest column must win, a full table of 128
    tracklets with overflow, expiry).  ids, order, kept and every state
    field equal (``torch.equal``), each side carrying its own state; the
    input state bit-unchanged; one launch a call."""
    for seed in range(100 * (b > 1), 100 * (b > 1) + 100):
        cfg, frames = tracker_cases.sequence(seed, b)
        card = tracker_cases.fresh_states(cfg, b, 256, dev)
        plain = tracker_cases.fresh_states(cfg, b, 256)
        for f, x in enumerate(frames):
            before = card.map(torch.clone)
            launches = tracker.KERNEL.launches
            got = tracker.tracker_step_batched(cfg, card, *(t.to(dev) for t in x))
            assert tracker.KERNEL.launches == launches + 1
            want = tracker.tracker_step_batched(cfg, plain, *x)
            for (name, g), (_, w) in zip(_tracker_fields(got), _tracker_fields(want)):
                assert g.dtype == w.dtype and g.shape == w.shape, (seed, f, name)
                assert torch.equal(g.cpu(), w), (seed, f, name, int((g.cpu() != w).sum()))
            for name, t in tracker_cases.state_fields(card).items():
                assert torch.equal(t, getattr(before, name)), (seed, f, "input changed", name)
            card, plain = got[0], want[0]


def test_tracker_step_kernel_refuses(dev):
    """A host tensor among card tensors, a non-contiguous one, and rows
    not 16-byte aligned."""
    cfg, frames = tracker_cases.sequence(9, 2, frames=1)
    state = tracker_cases.fresh_states(cfg, 2, 256, dev)
    boxes, labels, emb, valid, fids = (t.to(dev) for t in frames[0])
    with pytest.raises(ValueError):
        tracker.tracker_step_batched(cfg, state, boxes, labels, emb, valid, fids.cpu())
    with pytest.raises(ValueError):
        wide = torch.zeros((2, 64, 512), device=dev)[:, :, ::2]
        tracker.tracker_step_batched(cfg, state, boxes, labels, wide, valid, fids)
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.zeros(emb.numel() + 1, device=dev)[1:].view(emb.shape)
        tracker.tracker_step_batched(cfg, state, boxes, labels, shifted, valid, fids)


def _relpos_inputs(dev, b, hp, wp, ws, heads):
    g = torch.Generator(device=dev).manual_seed(10)
    kh, kw = (ws, ws) if ws else (hp, wp)
    qkv = torch.randn((b, hp, wp, 3 * 64 * heads), generator=g, device=dev).bfloat16()
    rh = (torch.randn((2 * kh - 1, 64), generator=g, device=dev) * 0.3).bfloat16()
    rw = (torch.randn((2 * kw - 1, 64), generator=g, device=dev) * 0.3).bfloat16()
    return qkv, rh, rw


@pytest.mark.parametrize("b,hp,wp,ws,heads", [
    (1, 6, 9, 3, 2), (2, 28, 42, 14, 3), (1, 70, 140, 14, 1),  # windows, the last of ViT-L
    (1, 4, 8, 0, 2), (2, 5, 13, 0, 1),  # global, rows not whole tiles
    (1, 8, 64, 0, 2), (2, 16, 128, 0, 1)])  # global by column halves
def test_relpos_attention(dev, b, hp, wp, ws, heads):
    """K10 against its plain version: relative L2 within 1e-2 (P and the
    output rounded to bf16 give ~3e-3), and the term dropped far outside."""
    qkv, rh, rw = _relpos_inputs(dev, b, hp, wp, ws, heads)
    before = relpos_attn.KERNEL.launches
    got = relpos_attn.relpos_attention(qkv, rh, rw, heads, ws)
    assert relpos_attn.KERNEL.launches == before + 1
    want = relpos_attn.relpos_attention_plain(qkv, rh, rw, heads, ws)
    gap = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert torch.isfinite(got.float()).all() and gap < 1e-2
    dropped = relpos_attn.relpos_attention_plain(qkv, rh * 0, rw * 0, heads, ws)
    assert ((got.float() - dropped.float()).norm() / dropped.float().norm()).item() > 0.1


def test_relpos_attention_refuses(dev):
    qkv, rh, rw = _relpos_inputs(dev, 1, 6, 9, 3, 2)
    with pytest.raises(TypeError):
        relpos_attn.relpos_attention(qkv.float(), rh.float(), rw.float(), 2, 3)
    with pytest.raises(ValueError, match="head dim"):
        relpos_attn.relpos_attention(qkv, rh[:, :32].contiguous(), rw[:, :32].contiguous(), 4, 3)
    leaf = qkv.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        relpos_attn.relpos_attention(leaf, rh, rw, 2, 3).sum().backward()

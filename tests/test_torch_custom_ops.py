"""Every kernel entry of the port as a ``torch.library`` custom op in the
``poly::`` namespace: ``torch.library.opcheck`` at small shapes (schema,
fake tensors, AOT dispatch with static and dynamic shapes), each op's CPU
result bit-equal to its plain version, and the fake outputs' shapes and
dtypes equal to the real ones.  On a card (marked ``cuda``, skipped
without one), ``opcheck`` again with the inputs on the card, through the
kernels:

    python -m pytest tests/test_torch_custom_ops.py -m cuda
"""
import numpy as np
import pytest
import torch

from polyphonicformer_torch.ops.cuda import (lsa, map_render, mask_loss, mask_pool,
                                             phase_fusion, tracker, upsample2, window_attn)
import tracker_cases

torch.set_num_threads(2)


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _mask_loss_inputs(rng):
    n, q, h, w = 2, 5, 6, 10
    m = _t(rng, n, q, h, w, scale=3.0)
    t = torch.from_numpy((rng.rand(n, q, h, w) < 0.3).astype(np.float32))
    pos = torch.from_numpy((rng.rand(n, q) < 0.5).astype(np.float32))
    valid = torch.from_numpy((rng.rand(n, h, w) < 0.9).astype(np.float32))
    lbl = torch.from_numpy(rng.randint(0, q, (n, h, w)).astype(np.int32))
    lbl[0, 0, :3] = 255
    return m, t, pos, valid, lbl


def _window_inputs(rng, image: bool, masked: bool, dtype):
    heads, hd, ws = 2, 8, 3
    l = ws * ws
    bias = _t(rng, heads, l, l)
    if image:
        qkv = _t(rng, 2, 6, 9, 3 * heads * hd).to(dtype)
        nmask = (6 // ws) * (9 // ws)
        extra = (ws,)
    else:
        qkv = _t(rng, 8, l, 3 * heads * hd).to(dtype)
        nmask = 4
        extra = ()
    mask = torch.from_numpy(np.where(rng.rand(nmask, l, l) < 0.3, -100.0, 0.0)
                            .astype(np.float32)) if masked else None
    return (qkv, bias, mask, heads, *extra)


def _tracker_args(seed: int):
    """The op's arguments for the second frame of a small tracker case (2
    clips, D 8, T 16, BD 16, E 8), from the state the first frame left."""
    cfg, frames = tracker_cases.sequence(seed, 2, frames=2, d=8, t=16, bd=16, e=8)
    state = tracker_cases.fresh_states(cfg, 2, 8)
    state = tracker.tracker_step_batched(cfg, state, *frames[0])[0]
    return (*tracker_cases.state_fields(state).values(), *frames[1],
            [float(getattr(cfg, n)) for n in tracker.THRESHOLDS], cfg.memo_tracklet_frames,
            cfg.with_cats, cfg.match_metric)


def _cases():
    """(id, op, args, plain) for every op."""
    rng = np.random.RandomState(0)
    logits = _t(rng, 2, 7, 6, 10)
    feats = _t(rng, 2, 16, 6, 10).permute(0, 2, 3, 1)  # an NHWC view, as the modules pass
    probs = torch.sigmoid(_t(rng, 13, 5, 7, scale=3.0))
    scores = torch.rand(13, generator=torch.Generator().manual_seed(0))
    depth = torch.sigmoid(_t(rng, 13, 5, 7))
    pix = torch.from_numpy(rng.randint(-1, 12, (20, 28)).astype(np.int32))
    k = 11
    tables = (torch.from_numpy(rng.randint(0, 19, k).astype(np.int32)),
              torch.from_numpy(rng.randint(0, 9000, k).astype(np.int64)),
              torch.from_numpy(rng.rand(k) < 0.7),
              torch.from_numpy(rng.randint(0, 30, k).astype(np.int32)))
    costs = _t(rng, 3, 9, 6).transpose(1, 2)  # (3, 6, 9), a transposed view
    valid = torch.from_numpy(rng.rand(3, 6) < 0.7)
    ml = _mask_loss_inputs(rng)
    lse = mask_loss.mask_loss_stats_plain(*ml)[2]
    grads = (_t(rng, 2, 2), _t(rng, 2, 3, 5))
    cases = [
        ("mask_pool", mask_pool.mask_pool_op, (logits, feats, 0.5),
         lambda a: mask_pool.mask_pool_plain(*a)),
        ("mask_pool_bf16", mask_pool.mask_pool_op,
         (logits.to(torch.bfloat16), feats.to(torch.bfloat16), 0.5),
         lambda a: mask_pool.mask_pool_plain(*a)),
        ("upsample_int", upsample2.upsample_int_op, (_t(rng, 3, 4, 6), 2, 4),
         lambda a: upsample2.upsample_int_plain(*a)),
        ("upsample_int_bwd", upsample2.upsample_int_bwd_op, (_t(rng, 3, 8, 24), 2, 4),
         lambda a: upsample2.upsample_int_bwd_plain(*a)),
        ("phase_fusion", phase_fusion.phase_fusion_op, (probs, scores, depth, 4, 4, None),
         lambda a: phase_fusion.phase_fusion_plain(*a)),
        ("phase_fusion_nfull", phase_fusion.phase_fusion_op,
         (probs.to(torch.bfloat16), scores, depth, 2, 2, 3),
         lambda a: phase_fusion.phase_fusion_plain(*a)),
        ("render_maps", map_render.render_maps_op,
         (pix, _t(rng, 20, 28), _t(rng, 20, 28), *tables, 19),
         lambda a: map_render.render_maps_plain(*a)),
        ("solve_lsa", lsa.solve_lsa_op, (costs, valid), lambda a: lsa.solve_lsa_plain(*a)),
        ("mask_loss_stats", mask_loss.mask_loss_stats_op, ml,
         lambda a: mask_loss.mask_loss_stats_plain(*a)),
        ("mask_loss_grad", mask_loss.mask_loss_grad_op, (*ml, *grads, lse),
         lambda a: mask_loss.mask_loss_grad_plain(*a)),
        ("tracker_step", tracker.tracker_step_op, _tracker_args(21),
         lambda a: tracker.tracker_step_plain(*a)),
        ("tracker_step_cosine", tracker.tracker_step_op, _tracker_args(20),
         lambda a: tracker.tracker_step_plain(*a)),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for masked in (False, True):
            tag = f"{str(dtype)[6:]}{'_mask' if masked else ''}"
            cases.append((f"window_attn_math_{tag}", window_attn.window_attn_math_op,
                          _window_inputs(rng, False, masked, dtype),
                          lambda a: window_attn.window_attn_math_plain(*a)))
            cases.append((f"window_attention_{tag}", window_attn.window_attention_op,
                          _window_inputs(rng, True, masked, dtype),
                          lambda a: window_attn.window_attention_plain(*a)))
    return cases


CASES = {c[0]: c[1:] for c in _cases()}
OPS = ("mask_pool", "upsample_int", "upsample_int_bwd", "phase_fusion", "render_maps",
       "solve_lsa", "mask_loss_stats", "mask_loss_grad", "window_attn_math",
       "window_attention", "tracker_step")


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def test_every_kernel_is_a_poly_op():
    """The eleven ops of the kernel table, each with a CPU, a CUDA and a fake
    registration."""
    for name in OPS:
        op = getattr(torch.ops.poly, name).default
        for key in ("CPU", "CUDA"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key), (name, key)
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "Meta"), name
    assert {op.name() for op, _, _ in CASES.values()} == {f"poly::{n}" for n in OPS}


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck(case):
    op, args, _ = CASES[case]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_equals_plain(case):
    """Bit-equal, dtypes and shapes included; phase_fusion's counts buffer
    holds the plain row marginals, column marginals and areas in turn."""
    op, args, plain = CASES[case]
    got, want = _leaves(op(*args)), _leaves(plain(args))
    if case.startswith("phase_fusion"):
        want = want[:2] + [torch.cat([w.flatten() for w in want[2:]])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_shapes(case):
    """The fake implementation's outputs have the real ones' shapes and
    dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, _ = CASES[case]
    real = _leaves(op(*args))
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
        fake = _leaves(op(*fake_args))
    assert [(f.shape, f.dtype) for f in fake] == [(r.shape, r.dtype) for r in real]


def test_phase_fusion_views():
    """``phase_fusion`` returns the plain version's five results, the last
    three as views of the op's counts buffer."""
    _, args, _ = CASES["phase_fusion_nfull"]
    got = phase_fusion.phase_fusion(*args)
    want = phase_fusion.phase_fusion_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].untyped_storage().data_ptr() == got[4].untyped_storage().data_ptr()



@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    op, args, _ = CASES[case]
    torch.library.opcheck(op, [a.cuda() if torch.is_tensor(a) else a for a in args])

"""K6/K6b's autograd Function on the CPU: the forward saves the per-pixel
logsumexp, and the backward through it equals the plain gradient that
recomputes it, bit for bit."""
import numpy as np
import pytest
import torch

from polyphonicformer_torch.ops.cuda import mask_loss


def _inputs(shape, seed):
    n, q, h, w = shape
    rng = np.random.RandomState(seed)
    m = torch.from_numpy((rng.randn(n, q, h, w) * 3).astype(np.float32))
    t = torch.from_numpy(((rng.rand(n, q, h, w) < 0.3) * rng.rand(n, q, h, w)).astype(np.float32))
    pos = torch.from_numpy((rng.rand(n, q) < 0.5).astype(np.float32))
    valid = torch.from_numpy((rng.rand(n, h, w) < 0.9).astype(np.float32))
    lbl = rng.randint(-1, q + 2, (n, h, w))
    lbl[rng.rand(n, h, w) < 0.2] = 255
    gs = torch.from_numpy(rng.randn(n, 2).astype(np.float32))
    gd = torch.from_numpy(rng.randn(n, 3, q).astype(np.float32))
    return m, t, pos, valid, torch.from_numpy(lbl.astype(np.int32)), gs, gd


@pytest.mark.parametrize("shape", [(2, 7, 16, 128), (3, 11, 37, 45), (1, 100, 8, 16)])
def test_backward_through_saved_lse_equals_recompute(shape):
    """The Function's gradient (through the forward's saved lse) is
    bit-equal to ``mask_loss_grad_plain`` recomputing the logsumexp, and to
    the plain gradient given the forward's lse."""
    m, t, pos, valid, lbl, gs, gd = _inputs(shape, 3)
    mt = m.clone().requires_grad_()
    stats, dice = mask_loss.mask_loss_stats(mt, t, pos, valid, lbl)
    torch.autograd.backward([stats, dice], [gs, gd])
    recomputed = mask_loss.mask_loss_grad_plain(m, t, pos, valid, lbl, gs, gd)
    assert torch.equal(mt.grad, recomputed)
    _, _, lse = mask_loss.mask_loss_stats_plain(m, t, pos, valid, lbl)
    assert torch.equal(mt.grad, mask_loss.mask_loss_grad_plain(m, t, pos, valid, lbl, gs, gd, lse))


@pytest.mark.parametrize("shape", [(2, 7, 16, 128), (1, 100, 8, 16)])
def test_plain_forward_lse_is_the_rank_logsumexp(shape):
    """The plain forward's lse is ``_rank_terms``' online logsumexp, bit for
    bit, and within float rounding of ``torch.logsumexp``; the Function
    returns the same stats and dice as the plain forward."""
    m, t, pos, valid, lbl, _, _ = _inputs(shape, 4)
    stats, dice, lse = mask_loss.mask_loss_stats_plain(m, t, pos, valid, lbl)
    assert torch.equal(lse, mask_loss._rank_terms(m, lbl)[0])
    torch.testing.assert_close(lse, torch.logsumexp(m.double(), dim=1).float(),
                               rtol=1e-6, atol=1e-6)
    got = mask_loss.mask_loss_stats(m, t, pos, valid, lbl)
    assert torch.equal(got[0], stats) and torch.equal(got[1], dice)


def test_backward_without_cotangent_of_dice():
    """Only the stats reach the loss: the missing dice cotangent counts as
    zeros, as the plain gradient with a zero gdice."""
    m, t, pos, valid, lbl, gs, gd = _inputs((2, 5, 8, 12), 5)
    mt = m.clone().requires_grad_()
    stats, _ = mask_loss.mask_loss_stats(mt, t, pos, valid, lbl)
    (stats * gs).sum().backward()
    want = mask_loss.mask_loss_grad_plain(m, t, pos, valid, lbl, gs, torch.zeros_like(gd))
    assert torch.equal(mt.grad, want)

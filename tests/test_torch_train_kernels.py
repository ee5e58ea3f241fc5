"""The plain versions of the training slice's kernels against the JAX
package's functions on the CPU: K2b (upsample backward), K5 (assignment),
K6 / K6b (fused mask-loss reductions and their gradient) and the K1
backward.  The Pallas kernels run in interpret mode, as
``tests/test_pallas_ops.py`` runs them; inputs are made with numpy from a
seed and handed to both sides."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.ops.hungarian import match_gt_to_preds_batched as jax_match
from polyphonicformer_tpu.ops.pallas.lsa import solve_lsa_pallas
from polyphonicformer_tpu.ops.pallas.mask_loss import fused_mask_loss_stats
from polyphonicformer_tpu.ops.pallas.mask_pool import masked_pool as jax_masked_pool
from polyphonicformer_tpu.ops.pallas.upsample2 import upsample_int_pallas
from polyphonicformer_torch.ops.cuda import lsa, mask_loss, mask_pool, upsample2
from polyphonicformer_torch.ops.hungarian import match_gt_to_preds_batched


@pytest.mark.parametrize("f", [2, 4])
def test_upsample_bwd_plain_matches_jax_vjp(f):
    """K2b: the transposed stencil against ``jax.vjp`` of the interpreted
    Pallas kernel (its ``_call_bwd``); max abs 1e-6.  Also the autograd
    path: the gradient of ``upsample_int`` on a CPU tensor."""
    rng = np.random.RandomState(f)
    x = rng.randn(3, 8, 16).astype(np.float32)
    g = rng.randn(3, 8 * f, 16 * f).astype(np.float32)
    _, vjp = jax.vjp(lambda v: upsample_int_pallas(v, f, True), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = upsample2.upsample_int_bwd_plain(torch.from_numpy(g), f, f).numpy()
    assert got.shape == want.shape == (3, 8, 16)
    assert np.abs(got - want).max() <= 1e-6
    xt = torch.from_numpy(x).requires_grad_()
    upsample2.upsample_int(xt, f).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), got)


def _lsa_problems(seed, n, g, p):
    """Costs with exact ties, signed zeros and valid rows that are not all
    at the front."""
    rng = np.random.RandomState(seed)
    costs = (rng.randn(n, g, p) * 3).astype(np.float32)
    costs[:, :, ::7] = np.round(costs[:, :, ::7])  # repeated values: ties
    costs[0, :, :] = np.round(costs[0])  # a problem of small integers
    costs[5, :, ::2] = -0.0  # -0.0 tied with +0.0
    costs[5, :, 1::4] = 0.0
    valid = rng.rand(n, g) > 0.4
    valid[1] = False
    valid[2] = True
    valid[3, ::2] = False  # invalid rows in the middle
    costs[4, 2] = np.nan  # non-finite costs are clamped
    costs[4, 5, 3] = np.inf
    return costs, valid


def test_lsa_plain_matches_pallas_and_lax():
    """K5: the same assignments, element for element, as the interpreted
    Pallas kernel and the lax solver, on problems with ties, non-finite
    costs and invalid rows in the middle."""
    costs, valid = _lsa_problems(0, 6, 12, 20)
    want_pallas = np.asarray(solve_lsa_pallas(jnp.asarray(costs), jnp.asarray(valid),
                                              interpret=True))
    want_lax = np.asarray(jax_match(jnp.asarray(costs), jnp.asarray(valid)))
    got = match_gt_to_preds_batched(torch.from_numpy(costs), torch.from_numpy(valid)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_lax)
    assert (got[~valid] == -1).all() and (got[2] >= 0).all()


def test_lsa_plain_matches_pallas_and_lax_transposed():
    """K5 on the layout the assignment hands it: a transposed view of
    (N, P, M) costs, the same assignments as the Pallas kernel and the lax
    solver on the contiguous (N, M, P) costs."""
    costs, valid = _lsa_problems(1, 6, 12, 20)
    view = torch.from_numpy(np.ascontiguousarray(costs.transpose(0, 2, 1))).transpose(1, 2)
    assert view.stride(1) == 1
    np.testing.assert_array_equal(view.numpy(), costs)
    got = match_gt_to_preds_batched(view, torch.from_numpy(valid)).numpy()
    want_pallas = np.asarray(solve_lsa_pallas(jnp.asarray(costs), jnp.asarray(valid),
                                              interpret=True))
    want_lax = np.asarray(jax_match(jnp.asarray(costs), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_lax)


def test_lsa_plain_is_optimal():
    """Against scipy's optimum on the valid rows of larger problems."""
    from scipy.optimize import linear_sum_assignment

    rng = np.random.RandomState(5)
    costs = rng.randn(3, 30, 60).astype(np.float32)
    valid = rng.rand(3, 30) > 0.3
    got = lsa.solve_lsa_plain(torch.from_numpy(costs), torch.from_numpy(valid)).numpy()
    for c, v, cols in zip(costs, valid, got):
        rows, ref = linear_sum_assignment(c[v])
        assert len(set(cols[v].tolist())) == v.sum()
        np.testing.assert_allclose(c[v][np.arange(v.sum()), cols[v]].sum(),
                                   c[v][rows, ref].sum(), rtol=1e-5)


def _mask_loss_inputs(seed=0, n=2, q=7, h=16, w=128):
    rng = np.random.RandomState(seed)
    m = (rng.randn(n, q, h, w) * 3).astype(np.float32)
    t = (rng.rand(n, q, h, w) < 0.3).astype(np.float32) * rng.rand(n, q, h, w).astype(np.float32)
    pos = (rng.rand(n, q) < 0.5).astype(np.float32)
    v = (rng.rand(n, h, w) < 0.9).astype(np.float32)
    lbl = rng.randint(-1, q + 2, (n, h, w))
    lbl[rng.rand(n, h, w) < 0.2] = 255
    return m, t, pos, v, lbl.astype(np.int32)


def test_mask_loss_plain_matches_pallas():
    """K6 and K6b: stats and dice against the interpreted Pallas forward,
    and dm against ``jax.vjp`` of it with random cotangents; rtol 1e-5,
    atol 1e-7 (f32 sums in another order)."""
    arrays = _mask_loss_inputs()
    m, t, pos, v, lbl = (jnp.asarray(a) for a in arrays)
    (stats, dice), vjp = jax.vjp(lambda mm: fused_mask_loss_stats(mm, t, pos, v, lbl, True), m)
    rng = np.random.RandomState(9)
    gs = rng.randn(2, 2).astype(np.float32)
    gd = rng.randn(2, 3, 7).astype(np.float32)
    gs128 = np.zeros((2, 128), np.float32)
    gs128[:, :2] = gs
    (dm_want,) = vjp((jnp.asarray(gs128), jnp.asarray(gd)))

    tm = [torch.from_numpy(a) for a in arrays]
    mt = tm[0].clone().requires_grad_()
    got_stats, got_dice = mask_loss.mask_loss_stats(mt, *tm[1:])
    np.testing.assert_allclose(got_stats.detach().numpy(), np.asarray(stats)[:, :2],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_dice.detach().numpy(), np.asarray(dice),
                               rtol=1e-5, atol=1e-7)
    torch.autograd.backward([got_stats, got_dice], [torch.from_numpy(gs), torch.from_numpy(gd)])
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(dm_want), rtol=1e-5, atol=1e-7)
    direct = mask_loss.mask_loss_grad_plain(*tm, torch.from_numpy(gs), torch.from_numpy(gd))
    np.testing.assert_array_equal(direct.numpy(), mt.grad.numpy())


def test_mask_pool_backward_matches_jax_vjp():
    """K1 backward: zero to the logits, hard^T @ g to the features; rtol 1e-6."""
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 9, 8, 16).astype(np.float32)
    feats = rng.randn(2, 8, 16, 12).astype(np.float32)
    g = rng.randn(2, 9, 12).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_masked_pool(a, b), jnp.asarray(logits), jnp.asarray(feats))
    dl_want, df_want = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    lt = torch.from_numpy(logits).requires_grad_()
    ft = torch.from_numpy(feats).permute(0, 3, 1, 2).contiguous().requires_grad_()
    mask_pool.masked_pool(lt, ft.permute(0, 2, 3, 1)).backward(torch.from_numpy(g))
    assert not dl_want.any() and (lt.grad is None or not lt.grad.any())
    np.testing.assert_allclose(ft.grad.permute(0, 2, 3, 1).numpy(), df_want, rtol=1e-6,
                               atol=1e-6)

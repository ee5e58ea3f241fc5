"""The plain PyTorch versions of the port's four kernels against the JAX
package's functions, run as the JAX tests run them on the CPU (the reference
einsum for mask_pool, interpret mode for the Pallas kernels).  Inputs are
made with numpy from a seed and handed to both sides."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from polyphonicformer_tpu.ops.pallas.map_render import render_maps as jax_render_maps
from polyphonicformer_tpu.ops.pallas.mask_pool import masked_pool as jax_masked_pool
from polyphonicformer_tpu.ops.pallas.phase_fusion import phase_fusion as jax_phase_fusion
from polyphonicformer_tpu.ops.pallas.upsample2 import upsample_int_pallas
from polyphonicformer_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from polyphonicformer_torch.ops.cuda import map_render, mask_pool, phase_fusion, upsample2


def test_mask_pool_plain_matches_jax():
    """(B, N, h, w) logits x (B, h, w, C) feats at the tiny model's widths;
    the port is handed the NHWC view of an NCHW tensor, as its modules do.
    Tolerance: rtol 1e-5 of sum_hw |feat| over each mask (f32 sums in
    another order)."""
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 31, 16, 32).astype(np.float32)
    logits[0, 0, 0, :4] = [1e-9, -1e-9, 0.0, 3e-8]  # sigmoid rounds to 0.5
    feats = rng.randn(2, 16, 32, 64).astype(np.float32)
    want = np.asarray(jax_masked_pool(jnp.asarray(logits), jnp.asarray(feats)))
    feats_nchw = torch.from_numpy(feats).permute(0, 3, 1, 2).contiguous()
    got = mask_pool.masked_pool(torch.from_numpy(logits),
                                feats_nchw.permute(0, 2, 3, 1)).numpy()
    hard = (1.0 / (1.0 + np.exp(-logits.astype(np.float64)))) > 0.5
    bound = 1e-5 * np.einsum("bnhw,bhwc->bnc", hard, np.abs(feats)) + 1e-6
    assert got.shape == want.shape == (2, 31, 64) and got.dtype == np.float32
    assert (np.abs(got - want) <= bound).all()


def test_upsample_plain_matches_jax():
    """x2: bit-equal to the Pallas kernel in interpret mode.  x4: bit-equal
    to the XLA phase path (ops/resize.py), which the Pallas kernel claims
    to equal; the interpreted Pallas kernel itself differs from both by
    one ulp in places (XLA contracts some of its multiply-adds), so against
    it the JAX package's own tolerance holds (tests/test_pallas_ops.py)."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 16, 32).astype(np.float32)
    got2 = upsample2.upsample_int(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(
        got2, np.asarray(upsample_int_pallas(jnp.asarray(x), 2, True)))
    got4 = upsample2.upsample_int(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(
        got4, np.asarray(jax_resize_bilinear(jnp.asarray(x), (64, 128))))
    np.testing.assert_allclose(
        got4, np.asarray(upsample_int_pallas(jnp.asarray(x), 4, True)),
        rtol=1e-6, atol=5e-7)


@pytest.mark.parametrize("n_full", [None, 10])
def test_phase_fusion_plain_matches_jax(n_full):
    """31 candidates (20 things + 11 stuff) at stride 4, x4 to 64x128.
    pix, marginals and areas exact; dep rtol 1e-5, atol 1e-4."""
    rng = np.random.RandomState(2)
    kk, hs, ws = 31, 16, 32
    logits = rng.randn(kk, hs, ws).astype(np.float32) * 3
    probs = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    scores = rng.rand(kk).astype(np.float32)
    depth = (rng.rand(kk, hs, ws) * 70 + 1).astype(np.float32)
    want = jax_phase_fusion(jnp.asarray(probs), jnp.asarray(scores),
                            jnp.asarray(depth), 4, 4, interpret=True,
                            n_full=n_full)
    got = phase_fusion.phase_fusion(torch.from_numpy(probs), torch.from_numpy(scores),
                                    torch.from_numpy(depth), 4, 4, n_full=n_full)
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    if n_full is not None:
        assert (got[0] == 16).any(), "no folded row won; the fold is untested"
    for i, name in ((0, "pix"), (2, "row_marg"), (3, "col_marg"), (4, "oarea")):
        assert got[i].shape == want[i].shape, name
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-4)


def test_map_render_plain_matches_jax():
    """21 table rows; pix covers [0, 30), so winners in the padding and
    beyond (the fusion's sentinel) render void.  Exact."""
    rng = np.random.RandomState(3)
    kk, h, w, num_classes = 21, 32, 64, 19
    pix = rng.randint(0, 30, (h, w)).astype(np.int32)
    dep = (rng.rand(h, w) * 70).astype(np.float32)
    db = (rng.rand(h, w) * 70).astype(np.float32)
    labels = rng.randint(0, num_classes, (kk,)).astype(np.int32)
    seg = rng.randint(0, kk + 1, (kk,)).astype(np.int32)
    keep = rng.rand(kk) > 0.4
    track = (rng.randint(0, 1 << 20, (kk,)) * keep).astype(np.int32)
    args = (pix, dep, db, labels, seg, keep, track)
    want = jax_render_maps(*map(jnp.asarray, args), num_classes, interpret=True)
    got = map_render.render_maps(*map(torch.from_numpy, args), num_classes)
    for g, wnt, name in zip(got, want, ("semantic", "panoptic", "depth", "track")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), err_msg=name)

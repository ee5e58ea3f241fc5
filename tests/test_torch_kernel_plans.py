"""What the port's K1, K2, K3, K5 and K6 wrappers hand their CUDA kernels,
checked on the CPU: K2's phase weights and K3's phase taps against the JAX
package's, K3's launch plan, K1's launch plan,
K1's threshold band, a numpy mirror of K1's exact three-way bf16 split
of f32 features (pooling with it against JAX ``masked_pool``), K6's launch
plan and vector path, numpy mirrors of K6's log1p polynomial and its
warp reduction, K5's launch plan and a numpy mirror of its warp-wide
argmin.  No card, no compile."""
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from polyphonicformer_tpu.ops.pallas.mask_pool import masked_pool as jax_masked_pool
from polyphonicformer_tpu.ops.pallas.phase_fusion import _phase_taps
from polyphonicformer_tpu.ops.resize import _phase_weights
from polyphonicformer_torch.ops.cuda import _lib, lsa, mask_loss, mask_pool, phase_fusion, upsample2

H100_SMS = 132


@pytest.mark.parametrize("factor", range(1, 9))
def test_phase_weights_bit_equal_to_jax(factor):
    """The table of ``phase_weights`` and the host arrays the K2 launch
    passes (``_phase_args``) equal JAX ``_phase_weights`` bit for bit."""
    weights, base = _phase_weights(factor)
    table = upsample2.phase_weights(factor)
    assert [b for b, _, _ in table] == base.tolist()
    got = np.array([[w0, w1] for _, w0, w1 in table], dtype=np.float32)
    assert got.tobytes() == weights.tobytes()
    bases, pairs = upsample2._phase_args(factor)
    assert list(bases) == base.tolist()
    assert np.array(list(pairs), dtype=np.float32).tobytes() == weights.reshape(-1).tobytes()


@pytest.mark.parametrize("factor", [2, 4])
def test_phase_taps_bit_equal_to_jax(factor):
    """``phase_taps`` and the kernel's compile-time taps
    (``csrc/phase_fusion.cu::Taps``: lam = f32((p + 0.5) / F - 0.5 + 1 for
    the first half of the phases), w0 = 1 - lam in f32) equal JAX
    ``_phase_taps`` bit for bit, and the base offset is -1 for the first
    half of the phases, 0 for the rest (the kernel's constant)."""
    want = _phase_taps(factor)
    assert phase_fusion.phase_taps(factor) == want
    assert [b for b, _, _ in want] == [-1] * (factor // 2) + [0] * (factor // 2)
    lam = [np.float32((p + 0.5) / factor - 0.5 + (p < factor // 2)) for p in range(factor)]
    kernel = np.array([[np.float32(1) - x, x] for x in lam], dtype=np.float32)
    assert kernel.tobytes() == np.array([[w0, w1] for _, w0, w1 in want],
                                        dtype=np.float32).tobytes()


@pytest.mark.parametrize("kp,nf,hs,ws,f", [
    (112, 64, 256, 512, 4),   # R50 and Swin-L serving, one clip or each of a batch
    (112, 112, 256, 512, 4),  # the same, no rows folded
    (112, 64, 256, 512, 2),   # factor 2
    (32, 8, 5, 33, 4),        # the card test's shapes: one past a tile
    (24, 16, 9, 40, 2),
    (72, 64, 17, 64, 4),
    (8, 8, 1, 1, 4),          # one stride-4 pixel
])
def test_phase_fusion_launch_plan(kp, nf, hs, ws, f):
    """The grid covers every stride-4 pixel with no empty tile, a block is
    (32, 16) threads (8 stride-4 rows), and shared memory (the ring,
    scores, counts) stays within a block's 227 KB; at the serving shape two
    blocks fit an SM."""
    plan = phase_fusion.launch_plan(kp, nf, hs, ws, f)
    gx, gy = plan.grid
    assert gx * phase_fusion.TILE_W >= ws > (gx - 1) * phase_fusion.TILE_W
    assert gy * phase_fusion.TILE_H >= hs > (gy - 1) * phase_fusion.TILE_H and gy <= 65535
    assert plan.threads == (32, 16) and phase_fusion.TILE_H == 8
    ring = phase_fusion.STAGES * phase_fusion.CK * (8 + 2) * (32 + 2 * phase_fusion.HALO) * 2
    assert plan.smem == ring + 4 * kp + 4 * nf * (8 * f + 32 * f + 16)
    assert plan.smem <= phase_fusion.MAX_SMEM
    assert 2 <= phase_fusion.STAGES <= 8 and ring % 16 == 0
    if (hs, ws) == (256, 512) and nf == 64:
        assert 2 * plan.smem <= 228 * 1024


@pytest.mark.parametrize("b,n,hw,c", [
    (1, 111, 128 * 256, 256),  # each stage, serving and training
    (1, 100, 128 * 256, 256),  # the rpn head
    (2, 111, 128 * 256, 256),  # the batched Swin-L step over 2 clips
    (2, 37, 19 * 45, 70),      # the card test's ragged shape
    (1, 300, 100, 513),        # several row tiles and channel slices
    (3, 5, 7, 3),              # less than one stage of HW
    (1, 1, 64 * 1000 + 1, 1),  # one position past a whole stage
])
def test_mask_pool_launch_plan(b, n, hw, c):
    """The splits cover HW exactly in whole stages; the grid lies inside
    CUDA's limits, and with more than one split holds no more blocks than
    the card has SMs (one block fills an SM)."""
    plan = mask_pool.launch_plan(b, n, hw, c, H100_SMS)
    assert plan.chunk % mask_pool.DEPTH == 0 and plan.chunk > 0
    assert (plan.splits - 1) * plan.chunk < hw <= plan.splits * plan.chunk
    gx, gy, gz = plan.grid
    assert gx * mask_pool.CHANNELS >= c > (gx - 1) * mask_pool.CHANNELS
    assert gz == b * plan.row_tiles and plan.row_tiles * mask_pool.ROWS >= n
    assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    if plan.splits > 1:
        assert gx * gy * gz <= H100_SMS
    if hw >= 128 * 256:  # the main path fills at least half the SMs
        assert gx * gy * gz >= H100_SMS // 2


def test_mask_pool_launch_plan_main_shape():
    """At (1, 111, 128x256, 256): 2 channel slices x 64 chunks of 512."""
    plan = mask_pool.launch_plan(1, 111, 128 * 256, 256, H100_SMS)
    assert (plan.grid, plan.chunk) == ((2, 64, 1), 512)


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 with round-to-nearest-even, kept in f32 (the kernel's
    __float2bfloat16_rn for finite values)."""
    u = x.astype(np.float32).view(np.uint32)
    u = (u + (((u >> 16) & 1) + np.uint32(0x7FFF))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _split3(x: np.ndarray):
    """The kernel's split of f32 features: hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid), each difference an exact f32 subtraction."""
    hi = _bf16(x)
    r1 = (x - hi).astype(np.float32)
    mid = _bf16(r1)
    lo = _bf16((r1 - mid).astype(np.float32))
    return hi, mid, lo


def _values(seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    mags = 10.0 ** rng.uniform(-30, 30, size=20000)
    x = (mags * rng.choice([-1.0, 1.0], size=mags.shape)).astype(np.float32)
    x[:8] = [0.0, -0.0, 1e-30, -1e-30, 1e30, -1e30, 1.0, -3.0]
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_split_reconstructs_f32(seed):
    """hi + mid + lo == x exactly (summed in f64 and in f32 in the
    kernel's order), for both signs, zeros and magnitudes 1e-30 to 1e30;
    each part is a bf16 value, and the rounding mirror agrees with
    torch's bf16 conversion."""
    x = _values(seed)
    hi, mid, lo = _split3(x)
    for part in (hi, mid, lo):
        assert (_bf16(part) == part).all()
    assert (hi.astype(np.float64) + mid + lo == x.astype(np.float64)).all()
    assert (((hi + mid).astype(np.float32) + lo).astype(np.float32) == x).all()
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert (_bf16(x) == want).all()


@pytest.mark.parametrize("seed,shape", [(0, (1, 23, 8, 16, 24)), (1, (2, 31, 16, 32, 64))])
def test_split_pool_matches_jax(seed, shape):
    """Pooling f32 features as the kernel does (a 0/1 mask times each of
    the three bf16 parts, summed into f32) against JAX ``masked_pool``
    (its reference einsum on the CPU), within rtol 1e-5 of sum |feat| over
    each mask.  Feature magnitudes span 1e-3 to 1e3."""
    b, n, h, w, c = shape
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, n, h, w).astype(np.float32)
    logits[0, 0, 0, :4] = [1e-9, -1e-9, 0.0, 3e-8]  # the f32 sigmoid rounds to 0.5
    feats = (rng.randn(b, h, w, c) * 10.0 ** rng.uniform(-3, 3, (b, h, w, c))).astype(np.float32)
    want = np.asarray(jax_masked_pool(jnp.asarray(logits), jnp.asarray(feats)))
    sig = (np.float32(1.0) / (np.float32(1.0) + np.exp(-logits))).astype(np.float32)
    hard = (sig > np.float32(0.5)).astype(np.float32).reshape(b, n, h * w)
    got = np.zeros((b, n, c), dtype=np.float32)
    for part in _split3(feats.reshape(b, h * w, c)):
        got = (got + np.matmul(hard, part)).astype(np.float32)
    bound = 1e-5 * np.einsum("bnk,bkc->bnc", hard, np.abs(feats.reshape(b, h * w, c))) + 1e-6
    assert (np.abs(got - want) <= bound).all()
    assert (hard[0, 0, :4] == [0, 0, 0, 0]).all()


@pytest.mark.parametrize("thr", [0.5, 0.3, 0.9, 0.05])
def test_threshold_band_decides_as_the_sigmoid(thr):
    """Outside K1's band (lo, hi) the compare x >= hi gives the same bit as
    the f32 ``1 / (1 + exp(-x)) > thr``, for x crowded around the band's
    edges and spread over [-100, 100]; the ends are bf16 values, and
    logit(thr) lies inside the band."""
    lo, hi = mask_pool.threshold_band(thr)
    assert torch.tensor([lo, hi]).to(torch.bfloat16).double().tolist() == [lo, hi]
    mid = np.log(thr / (1.0 - thr))
    assert lo < mid < hi
    assert hi - lo < 4e-5 / (thr * (1 - thr)) + 2.0 ** -6 * max(1.0, abs(mid))
    rng = np.random.RandomState(0)
    x = np.concatenate([
        lo + rng.uniform(-1e-4, 1e-4, 20000), hi + rng.uniform(-1e-4, 1e-4, 20000),
        rng.uniform(-100, 100, 20000)]).astype(np.float32)
    x = np.concatenate([x, np.nextafter(np.float32([lo, hi]), np.float32([-np.inf, np.inf]))])
    with np.errstate(over="ignore"):
        exact = np.float32(1.0) / (np.float32(1.0) + np.exp(-x)) > np.float32(thr)
    outside = (x <= lo) | (x >= hi)
    assert outside.sum() > 30000
    assert (exact[outside] == (x[outside] >= hi)).all()


def test_threshold_band_none_near_the_ends():
    for thr in (0.0, 1.0, 5e-6, 1 - 5e-6):
        assert mask_pool.threshold_band(thr) == (-np.inf, np.inf)


def _mask_loss_constants() -> dict:
    """The ``constexpr int`` constants of ``csrc/mask_loss.cu``."""
    src = (_lib.CSRC / "mask_loss.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_mask_loss_constants_match_the_source():
    c = _mask_loss_constants()
    assert (mask_loss.THREADS, mask_loss.PPT, mask_loss.ROWS_PER_GROUP) == (
        c["THREADS"], c["PPT"], c["ROWS_PER_GROUP"])
    assert c["GROUP"] % c["DEPTH"] == 0 and 32 % c["GROUP"] == 0


@pytest.mark.parametrize("n,q,hw", [
    (3, 111, 256 * 512),  # the three refinement stages of the train step
    (1, 100, 256 * 512),  # the rpn head
    (3, 111, 37 * 45),    # the card test's ragged shape
    (2, 7, 16 * 128),
    (1, 5, 64 * 300),     # two groups, the second short
    (1, 1, 1),
    (2, 3, 1024 * 2048),  # 2048 blocks, 128 groups
])
def test_mask_loss_launch_plan(n, q, hw):
    """Blocks cover the pixels in tiles of THREADS x PPT, groups cover the
    blocks, and the scratch holds a partial row a block, a row a group and
    the tickets; at the train step's shapes the forward runs in one wave of
    FWD_BLOCKS_PER_SM blocks an SM."""
    plan = mask_loss.launch_plan(n, q, hw)
    tile = mask_loss.THREADS * mask_loss.PPT
    assert (plan.blocks - 1) * tile < hw <= plan.blocks * tile
    rpg = mask_loss.ROWS_PER_GROUP
    assert (plan.groups - 1) * rpg < plan.blocks <= plan.groups * rpg
    assert plan.scratch_floats == n * (plan.blocks + plan.groups) * (2 + 3 * q) + n * (plan.groups + 1)
    if hw == 256 * 512:
        assert n * plan.blocks <= _mask_loss_constants()["FWD_BLOCKS_PER_SM"] * H100_SMS


def test_mask_loss_vector_path():
    """float4 loads only where H*W is a multiple of 4 and every row starts
    on 16 bytes."""
    x = torch.zeros(64 * 16 + 4)
    assert mask_loss.vector_path(64, x[:64], x[4:68])
    assert not mask_loss.vector_path(63, x[:63])
    assert not mask_loss.vector_path(64, x[:64], x[1:65])


def test_log1p_polynomial_as_close_as_log1pf():
    """``log1p_01`` (Horner with fused multiply-adds, then times e) lies
    within 2e-7 relative of log1p over e in [0, 1], as f32 ``log1p`` does."""
    src = (_lib.CSRC / "mask_loss.cu").read_text()
    body = src[src.index("float log1p_01(float e)"):]
    body = body[:body.index("return p * e;")]
    coeffs = [float(c) for c in re.findall(r"(-?\d+\.\d*)f", body)]
    assert len(coeffs) == 9 and coeffs[-1] == 1.0
    e = np.concatenate([np.linspace(0, 1, 400001), np.geomspace(1e-30, 1, 20001)]).astype(np.float32)
    p = np.full(e.shape, np.float32(coeffs[0]))
    for c in coeffs[1:]:  # an f32 fma: the f64 product of f32 values is exact
        p = (p.astype(np.float64) * e + np.float32(c)).astype(np.float32)
    got = (p * e).astype(np.float32).astype(np.float64)
    want = np.log1p(e.astype(np.float64))
    rel = np.abs(got - want) / np.where(want > 0, want, 1.0)
    assert rel.max() <= 2e-7
    assert got[0] == 0.0 and np.all(got >= 0)


def _reduce_scatter(v: np.ndarray) -> np.ndarray:
    """``reduce_scatter<N>`` of csrc/mask_loss.cu on a (32 lanes, N) array."""
    lanes = np.arange(32)
    n = v.shape[1]
    v = v.copy()
    half, off = n // 2, 16
    while half >= 1:
        hi = (lanes & off) != 0
        for i in range(half):
            send = np.where(hi, v[:, i], v[:, i + half])
            keep = np.where(hi, v[:, i + half], v[:, i])
            v[:, i] = keep + send[lanes ^ off]
        half, off = half // 2, off // 2
    s = v[:, 0].copy()
    off = 16 // n
    while off >= 1:
        s = s + s[lanes ^ off]
        off //= 2
    return s


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_warp_reduce_scatter_gives_each_lane_one_total(n):
    """After the transposed shuffle reduction lane L holds the warp's total
    of value L // (32 / n), in every one of those 32 / n lanes."""
    v = np.random.RandomState(n).randint(-1000, 1000, (32, n)).astype(np.float64)
    got = _reduce_scatter(v)
    assert np.array_equal(got, v.sum(axis=0)[np.arange(32) // (32 // n)])


def test_lsa_plain_counts_dijkstra_steps():
    """The plain solver counts each problem's Dijkstra steps (K5's serial
    chain): one a valid row where every row's best column is free, more
    where rows compete for a column; invalid rows take none."""
    diag = torch.full((1, 4, 6), 5.0)
    diag[0, torch.arange(4), torch.arange(4)] = 0.0
    steps = []
    lsa.solve_lsa_plain(diag, torch.tensor([[True, True, False, True]]), steps)
    assert steps == [3]
    clash = torch.tensor([[[0.0, 1.0, 9.0], [0.0, 2.0, 9.0]]])
    steps = []
    got = lsa.solve_lsa_plain(clash, torch.tensor([[True, True]]), steps)
    assert got.tolist() == [[1, 0]] and steps[0] > 2


def test_mask_loss_variants_edit_the_source():
    """``tools/mask_loss_variants.py``: every edit finds its text once in
    csrc/mask_loss.cu, and every variant but the design differs from it."""
    from polyphonicformer_torch.tools import mask_loss_variants

    srcs = mask_loss_variants.sources()
    design = (_lib.CSRC / "mask_loss.cu").read_text()
    assert srcs["design"] == design
    assert all(s != design for name, s in srcs.items() if name != "design")
    assert len(set(srcs.values())) == len(srcs)


@pytest.mark.parametrize("g,p,cpl,smem", [
    (1, 1, 1, 140),
    (20, 20, 1, 1892),
    (32, 32, 1, 4484),
    (33, 33, 2, 4752),
    (64, 100, 4, 26488),   # the train step's problems
    (64, 130, 8, 34560),
    (16, 1024, 32, 65732),
])
def test_lsa_launch_plan(g, p, cpl, smem):
    """K5: the least template instance with 32 * cpl >= p columns, one warp
    a problem, and shared memory for the costs at the odd row stride p | 1
    with the 32 * cpl - p words the slots past p read, u, col4row and the
    valid bitmask, within a block's 227 KB."""
    plan = lsa.launch_plan(g, p)
    assert plan == lsa.Plan(cpl, 32, smem)
    assert 32 * cpl >= p and (cpl == 1 or 16 * cpl < p)
    assert smem == 4 * (g * (p | 1) + 32 * cpl - p + 2 * g + -(-g // 32)) <= 232448


def test_lsa_plan_matches_the_source():
    """The instances ``poly_lsa`` dispatches and its shared memory formula
    are those of ``launch_plan``."""
    src = (_lib.CSRC / "lsa.cu").read_text()
    cases = re.findall(r"case (\d+): return launch<(\d+)>", src)
    assert all(a == b for a, b in cases)
    assert [int(a) for a, _ in cases] == list(lsa.CPL_INSTANCES)
    assert "return 4 * (G * row_stride(P) + row_pad(P, CPL) + 2 * G + (G + 31) / 32);" in src
    assert "return P | 1;" in src and "return 32 * CPL - P;" in src


def _ordered(x: np.float32) -> int:
    """The key's high word: the order-preserving bits of x + 0.0 (-0.0
    folds onto +0.0 in round-to-nearest)."""
    b = int(np.array([np.float32(x) + np.float32(0.0)], dtype=np.float32).view(np.uint32)[0])
    return (~b & 0xFFFFFFFF) if b & 0x80000000 else b | 0x80000000


def _warp_argmin(vals: np.ndarray, remaining: np.ndarray, rows: np.ndarray) -> dict:
    """csrc/lsa.cu's argmin of one Dijkstra step over (P,) f32 values:
    column j in lane j % 32, slot j // 32; each lane takes the least
    ordered value of its remaining slots (all ones for none) and the low
    word of the first slot that holds it (column << 11 | its row + 1).
    The kernel reduces with two ``__reduce_min_sync`` (the value, then the
    low word among the lanes that hold it); five xor rounds over the packed
    64-bit key (value << 32 | low word) give the same.  Returns the
    (column, row) each lane ends with, for both."""
    p = vals.shape[0]
    cpl = lsa.launch_plan(1, p).cpl
    highs, lows = [], []
    for lane in range(32):
        ords = [_ordered(vals[j]) if j < p and remaining[j] else 0xFFFFFFFF
                for j in range(lane, 32 * cpl, 32)]
        highs.append(min(ords))
        j = ords.index(highs[-1]) * 32 + lane
        lows.append(j << 11 | (int(rows[j]) + 1 if j < p else 0))
    mm = min(highs)
    lw = min(lo if hi == mm else 0xFFFFFFFF for hi, lo in zip(highs, lows))
    keys = [hi << 32 | lo for hi, lo in zip(highs, lows)]
    for off in (16, 8, 4, 2, 1):
        keys = [min(k, keys[lane ^ off]) for lane, k in enumerate(keys)]
    return {"redux": [(lw >> 11, (lw & 0x7FF) - 1)] * 32,
            "butterfly": [((k & 0xFFFFFFFF) >> 11, (k & 0x7FF) - 1) for k in keys]}


def _argmin_case(case: str, p: int, rng) -> tuple:
    if case == "exact_ties":
        vals = rng.randint(0, 3, p).astype(np.float32)
        rem = rng.rand(p) < 0.7
    elif case == "signed_zero":  # +0.0 before -0.0: raw bits would pick the -0.0
        vals = rng.choice(np.float32([0.0, -0.0, 1.0, 2.5]), p).astype(np.float32)
        vals[p // 3] = 0.0
        vals[p // 3 + 1:] = np.where(vals[p // 3 + 1:] == 0, np.float32(-0.0), vals[p // 3 + 1:])
        vals[: p // 3] = np.abs(vals[: p // 3]) + 1
        vals[-1] = -0.0
        rem = rng.rand(p) < 0.8
        rem[[p // 3, -1]] = True
    elif case == "one_remaining":
        vals = (rng.randn(p) * 3).astype(np.float32)
        rem = np.zeros(p, dtype=bool)
        rem[rng.randint(p)] = True
    else:  # every column masked but the last
        vals = (rng.randn(p) * 3).astype(np.float32)
        vals[-1] = 1e20
        rem = np.zeros(p, dtype=bool)
        rem[-1] = True
    rem[rng.randint(p)] |= not rem.any()
    return vals, rem


@pytest.mark.parametrize("p", [20, 100, 1024])
@pytest.mark.parametrize("case", ["exact_ties", "signed_zero", "one_remaining", "last_only"])
def test_lsa_warp_argmin_picks_the_first_minimum(case, p):
    """K5's warp-wide argmin (two ``__reduce_min_sync``) and the packed-key
    xor butterfly leave in every lane the column ``torch.argmin`` picks on
    the plain solver's masked values (the first index of the minimum, -0.0
    equal to +0.0), with that column's row: exact ties, signed zeros, one
    remaining column, every column masked but the last."""
    rng = np.random.RandomState(p)
    for _ in range(20):
        vals, rem = _argmin_case(case, p, rng)
        rows = rng.randint(-1, min(p, 1024), p)  # the row of each column, -1 free
        want = int(torch.argmin(torch.where(torch.from_numpy(rem), torch.from_numpy(vals),
                                            1e30)))
        got = _warp_argmin(vals, rem, rows)
        assert got["redux"] == got["butterfly"] == [(want, rows[want])] * 32
        if case == "signed_zero":
            assert want == p // 3 and not np.signbit(vals[want])


def test_lsa_variants_edit_the_source():
    """``tools/lsa_variants.py``: every edit finds its text once in
    csrc/lsa.cu, and every variant but the design differs from it and
    from the others."""
    from polyphonicformer_torch.tools import lsa_variants

    srcs = lsa_variants.sources()
    design = (_lib.CSRC / "lsa.cu").read_text()
    assert srcs["design"] == design
    assert all(s != design for name, s in srcs.items() if name != "design")
    assert len(set(srcs.values())) == len(srcs)

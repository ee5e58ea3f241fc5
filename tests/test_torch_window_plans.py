"""What the port's bf16 window-attention kernels (K7, K8) rest on, checked on
the CPU with no card and no compile: K8's exact three-way bf16 split of f32
P (a numpy mirror of the kernel's ``split3``, with the subnormal
probabilities of masked rows), P V taken with the split against the JAX
kernel, the recheck's two conditions (numpy models of a tensor-core kernel
against the plain version's order), and the launch plan at the Swin-L,
swin_tiny and card-test shapes."""
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from polyphonicformer_tpu.ops.pallas.window_attn import window_attention_pallas as jax_k8
from polyphonicformer_torch.models.swin import _shift_attn_mask
from polyphonicformer_torch.ops.cuda import _lib
from polyphonicformer_torch.ops.cuda import window_attn as wa

MAX_SMEM = 232_448


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 with round-to-nearest-even, kept in f32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + (((u >> 16) & 1) + np.uint32(0x7FFF))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _split3(p: np.ndarray):
    """The kernel's ``split3``: hi = bf16(p), mid = bf16(p - hi), lo =
    bf16(p - hi - mid), each difference an f32 op."""
    hi = _bf16(p)
    r1 = (p - hi).astype(np.float32)
    mid = _bf16(r1)
    lo = _bf16((r1 - mid).astype(np.float32))
    return hi, mid, lo


def _ulps(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """x moved by k f32 ulps (k small, x nonzero)."""
    return (x.astype(np.float32).view(np.int32) + k.astype(np.int32)).view(np.float32)


def _probabilities(seed: int, rows: int = 4000, l: int = 49) -> np.ndarray:
    """f32 softmax rows of seeded scores, a third of them under a -100 mask
    on a random half of their columns (exp(-100) ~ 3.7e-44, subnormal)."""
    rng = np.random.RandomState(seed)
    s = (rng.randn(rows, l) * rng.uniform(0.5, 8, (rows, 1))).astype(np.float32)
    masked = (rng.rand(rows, 1) < 1 / 3) & (rng.rand(rows, l) < 0.5)
    s = np.where(masked, s - np.float32(100), s).astype(np.float32)
    e = np.exp((s - s.max(-1, keepdims=True)).astype(np.float32)).astype(np.float32)
    return (e / e.sum(-1, keepdims=True, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("seed,rounded", [(0, False), (1, False), (2, True)])
def test_p_split_bit_equal_and_exact(seed, rounded):
    """K8's f32 P (and K7's P rounded to bf16): the three parts are bf16
    values and sum to p bit for bit wherever p is normal; a subnormal p
    (the masked rows) loses less than bf16's least subnormal, 2^-133.  K7's
    rounded P is its own hi part."""
    p = _probabilities(seed)
    if rounded:
        p = _bf16(p)
    hi, mid, lo = _split3(p)
    for part in (hi, mid, lo):
        assert not (part.view(np.uint32) & 0xFFFF).any()
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    normal = p >= np.float32(2.0 ** -126)
    assert np.array_equal(total[normal], p[normal].astype(np.float64))
    assert (np.abs(total - p.astype(np.float64)) < 2.0 ** -133).all()
    if rounded:
        assert np.array_equal(hi, p) and not mid.any() and not lo.any()
    else:
        assert (~normal & (p > 0)).sum() > 1000  # subnormal probabilities occur


@pytest.mark.parametrize("masked", [False, True])
def test_split_pv_matches_jax(masked):
    """K8's P V from the three bf16 parts of f32 P (numpy: P from the plain
    version's f32 scores and softmax, the part products exact, summed in
    f64) against JAX ``window_attention_pallas`` in interpret mode, two
    14x63 images, heads of 32.  Tolerance: one bf16 ulp of the output,
    as the plain version's K8 test against JAX, at every output the kernel
    keeps; the kernel recomputes an output with |o| <= TAU sum p |v| (near
    0 by cancellation) in the plain version's order instead (here 1 of
    169,344 outputs lies beyond, at |o| ~ 2^-18 sum p |v|)."""
    heads, hd, ws, l = 3, 32, 7, 49
    rng = np.random.RandomState(5)
    qkv = _bf16(rng.randn(2, 14, 63, 3 * heads * hd))
    bias = (rng.randn(heads, l, l) * 0.5).astype(np.float32)
    mask = _shift_attn_mask(14, 63, ws, 3) if masked else None
    want = np.asarray(jnp.asarray(jax_k8(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias),
                                         None if mask is None else jnp.asarray(mask), heads, ws,
                                         True), jnp.float32))
    x = torch.from_numpy(qkv).reshape(2, 2, ws, 9, ws, -1).permute(0, 1, 3, 2, 4, 5)
    q, k, v = wa._split_heads(x.reshape(-1, l, 3 * heads * hd), heads)
    s = torch.einsum("wqhd,wkhd->whqk", q, k) * wa._scale(hd) + torch.from_numpy(bias)[None]
    if mask is not None:
        s = (s.reshape(2, 18, heads, l, l) + torch.from_numpy(mask)[None, :, None]).reshape(s.shape)
    p = torch.softmax(s, dim=-1).numpy()
    vv = v.numpy().astype(np.float64)
    parts = _split3(p)
    o = sum(np.einsum("whqk,wkhd->wqhd", part.astype(np.float64), vv) for part in parts)
    a = np.einsum("whqk,wkhd->wqhd", parts[0].astype(np.float64), np.abs(vv))

    def image(z):
        z = z.reshape(2, 2, 9, ws, ws, -1).transpose(0, 1, 3, 2, 4, 5)
        return z.reshape(2, 14, 63, heads * hd)

    got = image(_bf16(o.astype(np.float32)))
    rechecked = image(np.abs(o) <= _recheck_constants()["TAU"] * a)
    err = np.abs(got - want)
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    assert (rechecked | (err <= np.ldexp(1.0, e - 8))).all()
    assert rechecked.mean() < 1e-3
    assert (err == 0).mean() > 0.99


def _recheck_constants() -> dict:
    """TAU, P_NEAR, P_NEAR_M, P_NEAR_X as csrc/window_attn.cu states them."""
    src = (_lib.CSRC / "window_attn.cu").read_text()
    out = {}
    for name in ("TAU", "P_NEAR", "P_NEAR_M", "P_NEAR_X"):
        m = re.search(rf"constexpr (?:float|int) {name} = ([^;]+);", src)
        out[name] = float.fromhex(m.group(1)[:-1]) if "0x" in m.group(1) else float(
            m.group(1).rstrip("f"))
    return out


def _torch_order_softmax(s: np.ndarray) -> np.ndarray:
    """The plain version's f32 softmax (PyTorch's)."""
    return torch.softmax(torch.from_numpy(s), dim=-1).numpy()


def _kernel_softmax(s: np.ndarray):
    """The bf16 kernel's softmax of rows of at most 64 (numpy f32): columns
    8j + 2q, 8j + 2q + 1 in quad lane q, each lane's sum in tile order, the
    lanes summed (0 + 1) + (2 + 3), p = e times the rounded reciprocal.
    Returns (p, e, row max)."""
    rows, l = s.shape
    m = s.max(-1, keepdims=True)
    e = np.exp((s - m).astype(np.float32)).astype(np.float32)
    ep = np.zeros((rows, 64), np.float32)
    ep[:, :l] = e
    lane = np.zeros((rows, 4), np.float32)
    for j in range(8):
        for q in range(4):
            pair = (ep[:, 8 * j + 2 * q] + ep[:, 8 * j + 2 * q + 1]).astype(np.float32)
            lane[:, q] = (lane[:, q] + pair).astype(np.float32)
    total = ((lane[:, 0] + lane[:, 1]).astype(np.float32)
             + (lane[:, 2] + lane[:, 3]).astype(np.float32)).astype(np.float32)
    inv = (1.0 / total.astype(np.float64)).astype(np.float32)[:, None]
    return (e * inv).astype(np.float32), e, m


def _near_midpoint(p, e, m, c) -> np.ndarray:
    """The kernel's ``near_midpoint``, elementwise."""
    ex = ((e.view(np.uint32) >> 23) & 0xFF).astype(np.int64) - 127
    base = c["P_NEAR"] + np.minimum(c["P_NEAR_M"] * np.abs(m), 32768.0).astype(np.int64)
    d = base + (np.float32(c["P_NEAR_X"] * 0.6931472) * (1 - ex).astype(np.float32)).astype(
        np.int64)
    return np.abs((p.view(np.uint32) & 0xFFFF).astype(np.int64) - 0x8000) <= d


@pytest.mark.parametrize("seed,spread,most", [(0, 1.0, 0.05), (1, 3.0, 0.1), (2, 6.0, 0.15)])
def test_recheck_catches_k7_rounding_flips(seed, spread, most):
    """K7's P rounds to bf16, so a p of the kernel an f32 ulp or two from
    the plain version's can round the other way.  Model: scores 0-2 ulps
    apart (the tensor cores' sums), the kernel's softmax against PyTorch's.
    Every row where some bf16 p differs is one the kernel's midpoint test
    marks; the margin grows with the scores' magnitude, and so does the
    share of rows marked (3.6%, 7.3% and 12.5% at score spreads 1, 3, 6)."""
    c = _recheck_constants()
    rng = np.random.RandomState(seed)
    s = (rng.randn(40000, 49) * spread).astype(np.float32)
    s_k = _ulps(s, rng.randint(-2, 3, s.shape))
    want = _bf16(_torch_order_softmax(s))
    p, e, m = _kernel_softmax(s_k)
    flipped = (_bf16(p) != want).any(-1)
    marked = _near_midpoint(p, e, m, c).any(-1)
    assert flipped.sum() > 20
    assert not (flipped & ~marked).any()
    assert marked.mean() < most


@pytest.mark.parametrize("seed", [0, 1])
def test_recheck_catches_k8_cancellation(seed):
    """An output near 0 by cancellation moves its bf16 rounding by many ulps
    with any f32 difference in its sum.  Model: the plain version's
    sequential f32 FMAs over the keys against the kernel's (p a few ulps
    apart, its split parts, sums of 16 products rounded to f32 and
    accumulated in f32).  Every output beyond one bf16 ulp of the plain
    version's has |o| <= TAU sum p |v|, and the test marks under 5% of the
    rows (of 32 outputs)."""
    c = _recheck_constants()
    rng = np.random.RandomState(seed)
    rows, l, hd = 20000, 49, 32
    p = _torch_order_softmax((rng.randn(rows, l) * 1.2).astype(np.float32))
    v = _bf16(rng.randn(l, hd).astype(np.float32) * rng.uniform(0.2, 2, (1, hd)).astype(np.float32))
    plain = np.zeros((rows, hd), np.float32)
    for j in range(l):
        plain = (plain.astype(np.float64) + p[:, j:j + 1].astype(np.float64) * v[j]).astype(
            np.float32)
    p_k = _ulps(p, rng.randint(-2, 3, p.shape))
    hi, mid, lo = _split3(p_k)
    kernel = np.zeros((rows, hd), np.float32)
    for j0 in range(0, l, 16):
        part = sum(x[:, j0:j0 + 16].astype(np.float64) @ v[j0:j0 + 16].astype(np.float64)
                   for x in (lo, mid, hi))
        kernel = (kernel + part.astype(np.float32)).astype(np.float32)
    a = (hi.astype(np.float64) @ np.abs(v).astype(np.float64)).astype(np.float32)
    got, want = _bf16(kernel), _bf16(plain)
    _, ex = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    beyond = np.abs(got - want) > np.ldexp(1.0, ex - 8)
    marked = np.abs(kernel) <= np.float32(c["TAU"]) * a
    assert beyond.sum() > 0
    assert not (beyond & ~marked).any()
    assert marked.any(-1).mean() < 0.05


# (windows, heads, head dim, tokens, masked): Swin-L stages 0-3 of a 1024x2048
# frame and of the batched step over 2 clips, swin_tiny at 64x128 (stages 0-3),
# the card tests' shapes (ws 8 / hd 64 and the odd windows and head dims),
# ragged counts
PLAN_SHAPES = [
    (2738, 6, 32, 49, True), (703, 12, 32, 49, True), (190, 24, 32, 49, True),
    (50, 48, 32, 49, False), (2 * 2738, 6, 32, 49, True), (2 * 190, 24, 32, 49, True),
    (18, 3, 32, 49, True), (6, 6, 32, 49, True), (2, 12, 32, 49, False), (1, 24, 32, 49, True),
    (70, 3, 64, 64, True), (8, 3, 64, 64, False), (37, 9, 32, 49, True), (1, 1, 32, 36, False),
    (24, 2, 16, 16, True), (24, 2, 8, 25, True), (24, 2, 12, 9, False), (24, 2, 40, 36, True),
    (24, 2, 24, 16, True),
]


@pytest.mark.parametrize("nwin,heads,hd,l,masked", PLAN_SHAPES)
def test_window_launch_plan(nwin, heads, hd, l, masked):
    """Heads per block divide the heads and fill at most 64 channels and 8
    warps (a warp per head and 16-row strip); a row of the tiles is the
    group's 16-padded slots and 16 bytes more, an odd number of 16-byte
    chunks; shared memory fits a block (the Swin shapes fit 3 blocks on an
    SM); the grid lies inside CUDA's limits; and the blocks cover every
    (window, head) exactly once."""
    plan = wa.launch_plan(nwin, heads, hd, l, masked)
    g, hd16, strips = plan.group, -(-hd // 16) * 16, -(-l // 16)
    assert heads % g == 0 and plan.warps == g * strips
    assert g == 1 or (g * hd16 <= wa.GROUP_CHANNELS and plan.warps <= wa.MAX_WARPS)
    assert plan.warps <= wa.MAX_WARPS
    assert plan.pitch == g * hd16 + 8 and (plan.pitch * 2 // 16) % 2 == 1
    assert plan.smem == (3 * 64 * plan.pitch * 2 + 4 * g * l * l + (4 * l * l if masked else 0)
                         + 256 * plan.warps)
    assert plan.smem <= MAX_SMEM
    if hd == 32 and l == 49:
        assert 3 * (plan.smem + 1024) <= 228 * 1024
    gx, gy = plan.grid
    assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535
    covered = np.zeros((nwin, heads), np.int64)
    for by in range(gy):
        covered[:, by * g:(by + 1) * g] += 1
    assert (covered == 1).all()


def test_window_launch_plan_main_shape():
    """Swin-L stage 0: 2 heads of 32 a block, 8 warps, 144-byte rows, 3
    groups, 58,508 bytes of shared memory."""
    plan = wa.launch_plan(2738, 6, 32, 49, True)
    assert (plan.group, plan.warps, plan.pitch, plan.grid) == (2, 8, 72, (2738, 3))
    assert plan.smem == 58_508

// Swin window attention, K7 and K8: per window and head,
//   softmax(Q K^T * scale + bias[h] (+ mask[window type])) V
// over a window of L = ws * ws <= 64 tokens with head dim hd <= 64.
//
// Replaces two TPU kernels that share this math:
//   K7 polyphonicformer_tpu/ops/pallas/win_attn_math.py::_fwd_call, on windows
//      already partitioned: qkv (nw, L, 3C), window w takes mask[w % ntypes];
//      the f32 probabilities are rounded to qkv's dtype before P V;
//   K8 polyphonicformer_tpu/ops/pallas/window_attn.py::_window_attention_fwd, on
//      the padded (and rolled) image itself: qkv (B, Hp, Wp, 3C), row t of window
//      (b, wy, wx) is pixel (b, wy * ws + t / ws, wx * ws + t % ws), read and
//      written in place (no partition copy); the probabilities stay f32.
// Both take Q K^T in f32 from bf16 (or f32) operands, multiply by scale, add the
// f32 bias and then the f32 mask (rounded adds, in that order), take an f32
// softmax and accumulate P V in f32; the output is rounded once to qkv's dtype.
//
// Bound on the H100: bytes.  At Swin-L stage 0 (1024x2048 frame, bf16) K8
// moves 155 MB of qkv, 52 MB of output and 26 MB of mask, ~69 us at 3.35 TB/s,
// against 5 GFLOP (~5 us on the tensor cores).
//
// bf16 (the serving dtype): window_attn_mma_kernel, FlashAttention-2's layout
// on mma.sync.m16n8k16 (bf16 in, f32 accumulate).  cuobjdump -sass of the
// built library shows HMMA in every bf16 instantiation: K8 40, 80, 120, 160 and
// K7 24, 48, 72, 96 at head dims 16, 32, 48, 64 (chip_smoke.py phase 2 checks
// them).  Both products run there; the CUDA cores take dot products only in
// the recheck below.
// - Blocks: one per window and group of heads (the wrapper's launch plan:
//   at most 64 channels and 8 warps, 2 heads at Swin's head dim 32), a warp
//   per (head, 16-row query strip).  The group's channels of every row of Q,
//   K and V are loaded once into shared memory by 16-byte cp.async (bf16, as
//   they lie in qkv), rows padded by 16 bytes so the 8 rows of an ldmatrix
//   fall in distinct banks; rows past L, and columns past hd within a head's
//   16-padded slot, are zero (a stale NaN times a zero probability is NaN).
//   The group's bias tiles (the same for every window, L2-resident) and the
//   window's mask tile are read once per block into shared memory by 4-byte
//   cp.async, with the Q, K and V loads.
// - Q K^T: ldmatrix A fragments of the warp's Q strip, ldmatrix B fragments of
//   K, 8 key tiles of 8 accumulated in registers.  * scale, + bias, + mask as
//   rounded f32 ops; key columns past L get -inf before the row max.  Key
//   tiles wholly past L, and the second 8 rows of a strip past L, skip the
//   softmax (p = 0).
// - Softmax in registers: a row lies in a quad, its max and sum take two quad
//   shuffles; expf, and e times the rounded reciprocal of the sum.
// - P V: P never leaves registers.  K7 rounds P to bf16, which is exactly one
//   A fragment.  K8 keeps P in f32: p = hi + mid + lo, three bf16 parts taken
//   by round-to-nearest (hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi -
//   mid)), exact for every normal p, so each product with a bf16 v is exact
//   and P V is three mma per tile.  ldmatrix.trans loads the V fragments.
//   Probabilities below bf16's least subnormal (exp(-100) ~ 3.7e-44 under the
//   shift mask) round to 0: together they move an output by at most 64 x
//   2^-133 x max |v|.
// - The recheck.  The outputs are held to the f32 plain versions at one bf16
//   ulp.  Sums in another order than theirs (cuBLAS's sequential FMAs,
//   torch's warp softmax) move an f32 output by a few 2^-24 x a, a = sum_j
//   p_j |v_j|, and K7's P by a few f32 ulps, growing with the scores'
//   magnitude.  That stays within one bf16 ulp except where the output is
//   near 0 by cancellation (|o| a tiny share of a), or where a p of K7 lies
//   that near a bf16 rounding midpoint (one flip moves an output by up to
//   2^-8 p |v|): 90-260 outputs a Swin-L stage shape
//   (tools/window_attn_margins.py).  So each warp also takes a (one more mma
//   a tile on |V|, V with its sign bits cleared; K8 with P's hi part) and
//   marks a row where some output has |o| <= TAU a, or (K7) some p lies
//   within P_NEAR + P_NEAR_M |m| + P_NEAR_X |x| f32 ulps of a midpoint.  A
//   marked row is recomputed on the CUDA cores in the plain version's order
//   (recheck_row: sequential FMAs over hd and over the keys, the warp softmax
//   of the f32 kernel below), so its outputs are the plain version's.  The
//   margins are at least 2x what the Swin-L shapes need (nothing lands
//   beyond one ulp at half of them); they mark ~2% of K8's rows and ~5% of
//   K7's there, ~20% and ~30% of the kernels' time.
// - Stores: each warp writes its bf16 outputs into its own part of the Q
//   tile; the block then writes whole 16-byte chunks of each output row.
// - Any head dim up to 64 (a head's slot padded to 16 channels) and any window
//   up to 64 tokens; hd or C not a multiple of 8, or qkv not 16-byte
//   aligned, take 2-byte loads and stores instead of cp.async.
// - What bounds it (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phase 3):
//   not memory: 15-22% of the byte bound.  The CUDA-core work on each score
//   (scale, bias, mask, exp, reciprocal, K8's split, the recheck's tests),
//   the recheck itself, 64 x 64 tiles for 49 x 49 windows, and 3 blocks of
//   8 warps an SM (80 registers a thread) that do not overlap a block's loads
//   with its own compute.
// The launch plan (heads per block, row pitch, shared-memory bytes) is
// ops/cuda/window_attn.py::launch_plan, passed in by the wrapper and checked
// here.
//
// f32 (the swin_tiny f32 check only): window_attn_f32_kernel, the first
// version kept: a block per (window, head) stages Q, K and V as f32 in shared
// memory, forms the scores and P V with sequential f32 FMAs on the CUDA cores
// (the order of the plain version's f32 matmuls) and runs the softmax a warp
// per row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_L = 64;      // tokens of a window: 8 key tiles, 4 query strips
constexpr int KEY_TILES = 8;   // key tiles of 8 in Q K^T
constexpr int MAX_WARPS = 8;   // warps of a bf16 block
constexpr float TAU = 0x1p-12f;  // recheck a row with |o| <= TAU sum p |v|
// K7: recheck a row with a p within P_NEAR + P_NEAR_M |m| + P_NEAR_X |x| f32 ulps
// of a bf16 rounding midpoint (m: the row max, x = s - m <= 0, e = exp(x))
constexpr int P_NEAR = 8;
constexpr float P_NEAR_M = 4.f;
constexpr float P_NEAR_X = 2.f;

// Windows: token t of window w -> its row of qkv (3C wide) and of out (C wide).
template <bool IMAGE>
struct WindowRows {
  long long w, img_row0;
  int wx0, L, Wp, ws;
  __device__ WindowRows(long long w_, int L_, int Hp, int Wp_, int ws_)
      : w(w_), img_row0(0), wx0(0), L(L_), Wp(Wp_), ws(ws_) {
    if constexpr (IMAGE) {
      const int nH = Hp / ws, nW = Wp / ws;
      const long long per_image = (long long)nH * nW;
      const long long b = w / per_image;
      const int r = (int)(w - b * per_image);
      img_row0 = b * Hp + (long long)(r / nW) * ws;
      wx0 = (r % nW) * ws;
    }
  }
  __device__ long long operator()(int t) const {
    if constexpr (IMAGE) {
      return (img_row0 + t / ws) * (long long)Wp + wx0 + t % ws;
    } else {
      return w * L + t;
    }
  }
};

// The softmax of one row of at most 64 scores, a warp: lane holds columns lane
// (a) and lane + 32 (b), -inf where absent; returns their probabilities.  The
// order of torch.softmax's warp kernel on such rows: the max, expf(x - max), the
// lane's pair summed, then the butterfly 16..1, and e / sum.
__device__ __forceinline__ float2 warp_softmax(float a, float b) {
  float m = fmaxf(a, b);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float ea = expf(a - m), eb = expf(b - m);
  float sum = ea + eb;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return make_float2(__fdiv_rn(ea, sum), __fdiv_rn(eb, sum));
}

// ------------------------------------------------------------------ bf16
struct Args {
  const __nv_bfloat16* qkv;
  const float* bias;
  const float* mask;  // null: no mask
  __nv_bfloat16* out;
  int L, C, hd, group, pitch, smem;  // pitch: elements of a shared row
  float scale;
  int ntypes, Hp, Wp, ws;
  int vec;  // 16-byte loads and stores (hd and C multiples of 8, aligned)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
// d += a b, a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two f32 -> one bf16x2 word, each rounded to nearest (lo in the low half)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }

// p within `base` + P_NEAR_X |x| f32 ulps of a bf16 rounding midpoint, |x| < (1 -
// log2 e) ln 2 from e's exponent
__device__ __forceinline__ bool near_midpoint(float p, float e, int base) {
  const int ex = (int)((__float_as_uint(e) >> 23) & 0xFFu) - 127;
  const int d = base + (int)(P_NEAR_X * 0.6931472f * (float)(1 - ex));
  return abs((int)(__float_as_uint(p) & 0xFFFFu) - 0x8000) <= d;
}

// K8's split of an f32 p into three bf16 parts, hi + mid + lo == p for normal p:
// the parts of the pair (x, y) as the words of three A fragments
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float rx = __fsub_rn(x, __low2float(h)), ry = __fsub_rn(y, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  lo = pack(__fsub_rn(rx, __low2float(m)), __fsub_rn(ry, __high2float(m)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
}

// Row i of head slot g in the plain version's arithmetic, by one warp: the
// scores by sequential FMAs over the head dim, the warp softmax, P V by
// sequential FMAs over the keys; the bf16 outputs go to row i of the Q tile.
template <bool IMAGE>
__device__ void recheck_row(const Args& a, __nv_bfloat16* sq, const __nv_bfloat16* sk,
                            const __nv_bfloat16* sv, const float* sm, float* sp,
                            const float* bh, int i, int lane) {
  const int L = a.L, hd = a.hd, pitch = a.pitch;
  const __nv_bfloat16* qi = sq + i * pitch;
  float s[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = lane + 32 * half;
    s[half] = -CUDART_INF_F;
    if (j < L) {
      const __nv_bfloat16* kj = sk + j * pitch;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(bf(qi[d]), bf(kj[d]), acc);
      float x = __fadd_rn(__fmul_rn(acc, a.scale), bh[i * L + j]);
      if (sm != nullptr) x = __fadd_rn(x, sm[i * L + j]);
      s[half] = x;
    }
  }
  float2 p = warp_softmax(s[0], s[1]);
  if constexpr (!IMAGE) {  // K7 rounds P to bf16
    p.x = bf(__float2bfloat16_rn(p.x));
    p.y = bf(__float2bfloat16_rn(p.y));
  }
  sp[lane] = p.x;
  sp[lane + 32] = p.y;
  __syncwarp();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int d = lane + 32 * half;
    if (d < hd) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(sp[j], bf(sv[j * pitch + d]), acc);
      sq[i * pitch + d] = __float2bfloat16_rn(acc);
    }
  }
  __syncwarp();
}

// IMAGE = false: K7 (partitioned windows, P rounded to bf16); true: K8 (image
// layout, P kept in f32).  HD: the head dim rounded up to 16.
template <int HD, bool IMAGE>
__global__ void __launch_bounds__(MAX_WARPS * 32, HD <= 32 ? 3 : 1)
    window_attn_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, hd = a.hd, G = a.group, pitch = a.pitch;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + MAX_L * pitch;
  __nv_bfloat16* sv = sk + MAX_L * pitch;
  float* sb = reinterpret_cast<float*>(sv + MAX_L * pitch);  // the group's bias tiles
  float* sm = sb + G * L * L;                                 // the window's mask tile
  float* sp = sm + (a.mask != nullptr ? L * L : 0);           // 64 floats a warp

  const long long w = blockIdx.x;
  const int h0 = blockIdx.y * G;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const WindowRows<IMAGE> rows(w, L, a.Hp, a.Wp, a.ws);
  const long long C3 = 3LL * a.C;

  // zero rows L..63 (16-byte stores: a row is a whole number of 16-byte chunks)
  // and the columns hd..HD of each head slot
  {
    const int per_plane = (MAX_L - L) * pitch / 8;
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
    for (int e = tid; e < 3 * per_plane; e += nthreads) {
      const int pl = e / per_plane;
      reinterpret_cast<uint4*>(sq + pl * MAX_L * pitch + L * pitch)[e - pl * per_plane] = zero4;
    }
  }
  if (hd < HD) {
    const int pad = HD - hd;
    for (int e = tid; e < 3 * L * G * pad; e += nthreads) {
      const int pl = e / (L * G * pad), r = e % (L * G * pad);
      const int t = r / (G * pad), gc = r % (G * pad);
      sq[pl * MAX_L * pitch + t * pitch + (gc / pad) * HD + hd + gc % pad] =
          __float2bfloat16_rn(0.f);
    }
  }
  // the group's channels of Q, K and V: a thread keeps one 16-byte chunk of a
  // row and steps over the tokens
  if (a.vec) {
    const int chunks = hd / 8, per_row = G * chunks, step = nthreads / per_row;
    const int gc = tid % per_row, g = gc / chunks, c = gc % chunks;
    const long long src0 = (long long)(h0 + g) * hd + 8 * c;
    __nv_bfloat16* dst0 = sq + g * HD + 8 * c;
    for (int t = tid / per_row; t < L && tid < step * per_row; t += step) {
      const __nv_bfloat16* src = a.qkv + rows(t) * C3 + src0;
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
        cp_async16(dst0 + pl * MAX_L * pitch + t * pitch, src + (long long)pl * a.C);
    }
  } else {
    for (int e = tid; e < L * G * hd; e += nthreads) {
      const int t = e / (G * hd), gd = e % (G * hd), g = gd / hd, d = gd % hd;
      const __nv_bfloat16* src = a.qkv + rows(t) * C3 + (long long)(h0 + g) * hd + d;
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
        sq[pl * MAX_L * pitch + t * pitch + g * HD + d] = src[(long long)pl * a.C];
    }
  }
  // the group's bias tiles (contiguous heads) and the window's mask tile
  const float* bg = a.bias + (long long)h0 * L * L;
  for (int e = tid; e < G * L * L; e += nthreads) cp_async4(sb + e, bg + e);
  if (a.mask != nullptr) {
    const float* mw = a.mask + (w % a.ntypes) * L * L;
    for (int e = tid; e < L * L; e += nthreads) cp_async4(sm + e, mw + e);
  }
  cp_async_wait_all();
  __syncthreads();

  const int strips = (L + 15) / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int g = warp / strips, s16 = 16 * (warp % strips);
  const int col = g * HD;
  const float* bh = sb + g * L * L;
  const float* smw = a.mask != nullptr ? sm : nullptr;
  const int i0 = s16 + lane / 4, i1 = i0 + 8;  // this lane's two rows
  const int c0 = 2 * (lane % 4);              // and its first column in a tile
  const bool has1 = s16 + 8 < L;              // rows i1 lie in the window

  // S = Q K^T
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qa[kk], sq + (s16 + lane % 16) * pitch + col + 16 * kk + 8 * (lane / 16));
  float sc[KEY_TILES][4];
#pragma unroll
  for (int j = 0; j < KEY_TILES; j += 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = sc[j + 1][e] = 0.f;
    if (8 * j < L) {
      const int m = lane / 8;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, sk + (8 * j + 8 * (m / 2) + lane % 8) * pitch + col + 16 * kk + 8 * (m % 2));
        mma(sc[j], qa[kk], kb[0], kb[1]);
        mma(sc[j + 1], qa[kk], kb[2], kb[3]);
      }
    }
  }
  // * scale, + bias, + mask; -inf past L.  Rows past L take 0 (never stored);
  // key tiles past L, and the rows i1 past L, are skipped (p = 0)
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < KEY_TILES; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * j >= L || (e >= 2 && !has1)) {
        sc[j][e] = 0.f;
        continue;
      }
      const int i = e < 2 ? i0 : i1, c = 8 * j + c0 + (e & 1);
      float x = -CUDART_INF_F;
      if (c < L) {
        x = 0.f;
        if (i < L) {
          x = __fadd_rn(__fmul_rn(sc[j][e], a.scale), bh[i * L + c]);
          if (smw != nullptr) x = __fadd_rn(x, smw[i * L + c]);
        }
      }
      sc[j][e] = x;
    }
    if (8 * j >= L) continue;
    mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
    mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
  }
  // softmax: a row lies in a quad
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < KEY_TILES; ++j) {
    if (8 * j >= L) continue;
    sc[j][0] = expf(sc[j][0] - mx0);
    sc[j][1] = expf(sc[j][1] - mx0);
    sum0 += sc[j][0] + sc[j][1];
    if (has1) {
      sc[j][2] = expf(sc[j][2] - mx1);
      sc[j][3] = expf(sc[j][3] - mx1);
      sum1 += sc[j][2] + sc[j][3];
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  // p = e / sum as e times a rounded reciprocal: within 2 ulps of the quotient,
  // which the recheck's margins take in
  const float inv0 = __frcp_rn(sum0), inv1 = has1 ? __frcp_rn(sum1) : 0.f;
  const int base0 = P_NEAR + (int)fminf(P_NEAR_M * fabsf(mx0), 32768.f);
  const int base1 = P_NEAR + (int)fminf(P_NEAR_M * fabsf(mx1), 32768.f);
  bool near0 = false, near1 = false;
#pragma unroll
  for (int j = 0; j < KEY_TILES; ++j) {
    if (8 * j >= L) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __fmul_rn(sc[j][e], e < 2 ? inv0 : inv1);
      if constexpr (!IMAGE) {
        if (e < 2) near0 |= near_midpoint(p, sc[j][e], base0);
        else near1 |= near_midpoint(p, sc[j][e], base1);
      }
      sc[j][e] = p;
    }
  }

  // O = P V and A = P |V|, by key steps of 16
  float o[HD / 8][4], av[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = av[n][e] = 0.f;
#pragma unroll
  for (int t = 0; t < MAX_L / 16; ++t) {
    if (16 * t >= L) break;
    // the A fragment of keys 16t..16t+15: key tiles 2t and 2t + 1
    uint32_t pa[4], pm[4], pl[4];
    if constexpr (IMAGE) {
      split3(sc[2 * t][0], sc[2 * t][1], pa[0], pm[0], pl[0]);
      split3(sc[2 * t][2], sc[2 * t][3], pa[1], pm[1], pl[1]);
      split3(sc[2 * t + 1][0], sc[2 * t + 1][1], pa[2], pm[2], pl[2]);
      split3(sc[2 * t + 1][2], sc[2 * t + 1][3], pa[3], pm[3], pl[3]);
    } else {
      pa[0] = pack(sc[2 * t][0], sc[2 * t][1]);
      pa[1] = pack(sc[2 * t][2], sc[2 * t][3]);
      pa[2] = pack(sc[2 * t + 1][0], sc[2 * t + 1][1]);
      pa[3] = pack(sc[2 * t + 1][2], sc[2 * t + 1][3]);
    }
    const int m = lane / 8;
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t vb[4];
      ldsm_x4_t(vb, sv + (16 * t + 8 * (m % 2) + lane % 8) * pitch + col + 8 * (n + m / 2));
      if constexpr (IMAGE) {
        mma(o[n], pl, vb[0], vb[1]);
        mma(o[n + 1], pl, vb[2], vb[3]);
        mma(o[n], pm, vb[0], vb[1]);
        mma(o[n + 1], pm, vb[2], vb[3]);
      }
      mma(o[n], pa, vb[0], vb[1]);
      mma(o[n + 1], pa, vb[2], vb[3]);
      mma(av[n], pa, vb[0] & 0x7FFF7FFFu, vb[1] & 0x7FFF7FFFu);
      mma(av[n + 1], pa, vb[2] & 0x7FFF7FFFu, vb[3] & 0x7FFF7FFFu);
    }
  }

  // rows to recheck: an output near 0 against sum p |v|, or (K7) a p near a
  // rounding midpoint
  bool bad0 = near0, bad1 = near1;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    bad0 |= (fabsf(o[n][0]) <= TAU * av[n][0] && av[n][0] > 0.f) |
            (fabsf(o[n][1]) <= TAU * av[n][1] && av[n][1] > 0.f);
    bad1 |= (fabsf(o[n][2]) <= TAU * av[n][2] && av[n][2] > 0.f) |
            (fabsf(o[n][3]) <= TAU * av[n][3] && av[n][3] > 0.f);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    bad0 |= __shfl_xor_sync(0xffffffffu, bad0, off);
    bad1 |= __shfl_xor_sync(0xffffffffu, bad1, off);
  }
  bad0 &= i0 < L;
  bad1 &= i1 < L;
  // the fast outputs of the rows kept, into this warp's part of the Q tile
  __syncwarp();
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = col + 8 * n + c0;
    if (!bad0 && i0 < L)
      *reinterpret_cast<uint32_t*>(sq + i0 * pitch + c) = pack(o[n][0], o[n][1]);
    if (!bad1 && i1 < L)
      *reinterpret_cast<uint32_t*>(sq + i1 * pitch + c) = pack(o[n][2], o[n][3]);
  }
  // bit r: row s16 + r of the strip is rechecked
  uint32_t marked = (__ballot_sync(0xffffffffu, bad0) & 0x11111111u) |
                    ((__ballot_sync(0xffffffffu, bad1) & 0x11111111u) << 1);
  __syncwarp();
  while (marked) {
    const int b = __ffs(marked) - 1;
    marked &= marked - 1;
    const int r = (b / 4) + 8 * (b % 4);  // lane 4k -> row k; the shifted bits -> row k + 8
    recheck_row<IMAGE>(a, sq + col, sk + col, sv + col, smw, sp + 64 * warp, bh, s16 + r,
                       lane);
  }
  __syncthreads();

  // the outputs, rows 0..L-1 of the Q tile
  if (a.vec) {
    const int chunks = hd / 8, per_row = G * chunks, step = nthreads / per_row;
    const int gc = tid % per_row, gg = gc / chunks, c = gc % chunks;
    const long long dst0 = (long long)(h0 + gg) * hd + 8 * c;
    for (int t = tid / per_row; t < L && tid < step * per_row; t += step)
      *reinterpret_cast<uint4*>(a.out + rows(t) * a.C + dst0) =
          *reinterpret_cast<const uint4*>(sq + t * pitch + gg * HD + 8 * c);
  } else {
    for (int e = tid; e < L * G * hd; e += nthreads) {
      const int t = e / (G * hd), gd = e % (G * hd), gg = gd / hd, d = gd % hd;
      a.out[rows(t) * a.C + (long long)(h0 + gg) * hd + d] = sq[t * pitch + gg * HD + d];
    }
  }
}

// shared-memory bytes of a block: Q, K and V tiles of MAX_L rows, the group's
// bias tiles, the mask tile, 64 floats a warp (ops/cuda/window_attn.py::
// launch_plan computes the same)
int mma_smem(int L, int group, int pitch, bool masked, int warps) {
  return 3 * MAX_L * pitch * 2 + 4 * group * L * L + (masked ? 4 * L * L : 0) + 4 * 64 * warps;
}

template <int HD, bool IMAGE>
int launch_mma_hd(const Args& a, long long nwin, int heads, cudaStream_t stream) {
  auto kern = window_attn_mma_kernel<HD, IMAGE>;
  if (a.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int warps = a.group * ((a.L + 15) / 16);
  const dim3 grid((unsigned)nwin, (unsigned)(heads / a.group));
  kern<<<grid, warps * 32, a.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool IMAGE>
int launch_mma(const Args& a, long long nwin, int heads, cudaStream_t stream) {
  const int hd16 = (a.hd + 15) / 16 * 16;
  const int warps = a.group * ((a.L + 15) / 16);
  if (a.group <= 0 || heads % a.group || a.L < 1 || a.L > MAX_L || a.hd < 1 || hd16 > 64 ||
      warps > MAX_WARPS || a.pitch != a.group * hd16 + 8 ||
      a.smem != mma_smem(a.L, a.group, a.pitch, a.mask != nullptr, warps))
    return (int)cudaErrorInvalidValue;
  switch (hd16) {
    case 16: return launch_mma_hd<16, IMAGE>(a, nwin, heads, stream);
    case 32: return launch_mma_hd<32, IMAGE>(a, nwin, heads, stream);
    case 48: return launch_mma_hd<48, IMAGE>(a, nwin, heads, stream);
    default: return launch_mma_hd<64, IMAGE>(a, nwin, heads, stream);
  }
}

// ------------------------------------------------------------------ f32
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <bool IMAGE>
__global__ void __launch_bounds__(THREADS) window_attn_f32_kernel(
    const float* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ mask, float* __restrict__ out, int L, int C, int hd,
    float scale, int ntypes, int Hp, int Wp, int ws) {
  extern __shared__ float smem_f[];
  const int hs = hd + 1;
  float* sq = smem_f;
  float* sk = sq + L * hs;
  float* sv = sk + L * hs;
  float* sp = sv + L * hs;  // L x L scores, then probabilities

  const long long w = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const WindowRows<IMAGE> row(w, L, Hp, Wp, ws);

  for (int e = tid; e < L * hd; e += THREADS) {
    const int t = e / hd, d = e - t * hd;
    const float* src = qkv + row(t) * (3LL * C) + (long long)h * hd + d;
    sq[t * hs + d] = src[0];
    sk[t * hs + d] = src[C];
    sv[t * hs + d] = src[2 * C];
  }
  __syncthreads();

  const float* bh = bias + (long long)h * L * L;
  const float* mw = mask == nullptr ? nullptr : mask + (w % ntypes) * L * L;
  for (int e = tid; e < L * L; e += THREADS) {
    const int i = e / L, j = e - i * L;
    const float* qi = sq + i * hs;
    const float* kj = sk + j * hs;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qi[d], kj[d], acc);
    float s = __fadd_rn(__fmul_rn(acc, scale), bh[e]);
    if (mw != nullptr) s = __fadd_rn(s, mw[e]);
    sp[e] = s;
  }
  __syncthreads();

  // softmax, a warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < L; i += WARPS) {
    float* pr = sp + i * L;
    const bool has_a = lane < L, has_b = lane + 32 < L;
    const float2 p = warp_softmax(has_a ? pr[lane] : -CUDART_INF_F,
                                  has_b ? pr[lane + 32] : -CUDART_INF_F);
    if (has_a) pr[lane] = p.x;
    if (has_b) pr[lane + 32] = p.y;
  }
  __syncthreads();

  for (int e = tid; e < L * hd; e += THREADS) {
    const int i = e / hd, d = e - i * hd;
    const float* pi = sp + i * L;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(pi[j], sv[j * hs + d], acc);
    out[row(i) * C + (long long)h * hd + d] = acc;
  }
}

template <bool IMAGE>
int launch_f32(const void* qkv, const void* bias, const void* mask, void* out, long long nwin,
               int heads, int L, int C, float scale, int ntypes, int Hp, int Wp, int ws,
               cudaStream_t stream) {
  const int hd = C / heads;
  const size_t smem = (size_t)(3 * L * (hd + 1) + L * L) * sizeof(float);
  auto kern = window_attn_f32_kernel<IMAGE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)nwin, (unsigned)heads);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(out), L, C, hd, scale, ntypes, Hp,
      Wp, ws);
  return (int)cudaGetLastError();
}

}  // namespace

// K7.  qkv (nw, L, 3C) contiguous, bf16 (qkv_bf16 = 1) or f32; bias (heads, L, L)
// f32; mask (ntypes, L, L) f32 or null, nw a multiple of ntypes; out (nw, L, C) in
// qkv's dtype.  bf16 only: group (heads per block), pitch (elements), smem (bytes)
// and vec (16-byte loads) from the wrapper's launch plan.
extern "C" int poly_window_attn_math(const void* qkv, int qkv_bf16, const void* bias,
                                     const void* mask, void* out, long long nw, int L,
                                     int C, int heads, int ntypes, float scale, int group,
                                     int pitch, int smem, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qkv_bf16) {
    const Args a{static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
                 static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out),
                 L, C, C / heads, group, pitch, smem, scale, ntypes, 0, 0, 0, vec};
    return launch_mma<false>(a, nw, heads, st);
  }
  return launch_f32<false>(qkv, bias, mask, out, nw, heads, L, C, scale, ntypes, 0, 0, 0, st);
}

// K8.  qkv (B, Hp, Wp, 3C) contiguous with Hp and Wp multiples of ws; bias
// (heads, ws*ws, ws*ws) f32; mask (Hp/ws * Wp/ws, ws*ws, ws*ws) f32 or null, the
// same for every image; out (B, Hp, Wp, C) in qkv's dtype.  group, pitch, smem,
// vec as for K7.
extern "C" int poly_window_attention(const void* qkv, int qkv_bf16, const void* bias,
                                     const void* mask, void* out, int B, int Hp, int Wp,
                                     int C, int heads, int ws, float scale, int group,
                                     int pitch, int smem, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_image = (Hp / ws) * (Wp / ws);
  const long long nwin = (long long)B * per_image;
  if (qkv_bf16) {
    const Args a{static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
                 static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out),
                 ws * ws, C, C / heads, group, pitch, smem, scale, per_image, Hp, Wp, ws,
                 vec};
    return launch_mma<true>(a, nwin, heads, st);
  }
  return launch_f32<true>(qkv, bias, mask, out, nwin, heads, ws * ws, C, scale, per_image,
                          Hp, Wp, ws, st);
}

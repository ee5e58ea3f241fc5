// ViTDet attention with the decomposed relative-position term, K10: per window
// (or the whole image) and head,
//   softmax((q * scale) k^T + rel_h + rel_w) v,
//   rel_h[i, kr] = q_i . R_h[hq_i - kr + kh - 1],  rel_w[i, kc] = q_i . R_w[wq_i - kc + kw - 1],
// with the unscaled q, token t at (t / kw, t % kw) of its window or image
// (detectron2 modeling/backbone/utils.py::add_decomposed_rel_pos).
//
// Replaces no TPU kernel: the JAX package has no ViT.  Added for ViTDet ViT-L
// (models/vit.py): 20 window blocks of 14 x 14 = 196 tokens and 4 global blocks
// over the 64 x 128 grid of a 1024 x 2048 frame (8,192 tokens), a bias that
// depends on the query.  K7/K8 take 64 tokens and a (heads, L, L) table; a
// materialised bias of a global block would be 2 GiB a frame in bf16.
//
// Two modes of one op (ops/cuda/relpos_attn.py): qkv (B, Hp, Wp, 3C) bf16;
// ws > 0: the ws x ws windows of the padded image, row t of window (b, wy, wx)
// read and written in place at pixel (b, wy ws + t / ws, wx ws + t % ws), kh =
// kw = ws (relpos_attn_window_kernel); ws = 0: the whole image, kh = Hp, kw = Wp
// (relpos_attn_global_kernel).  R_h (2 kh - 1, 64), R_w (2 kw - 1, 64) bf16.
//
// Numerics: Q K^T and P V on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
// accumulate); rel_h and rel_w as products of the bf16 q and the bf16 tables on
// the tensor cores, f32; each score acc * scale + rel_h + rel_w in f32 (in base 2:
// every term times log2 e), an online softmax in f32 (exp2f, a running max and
// sum a row), the unnormalised probabilities rounded to bf16 before P V, the sum
// kept in f32, the output divided by it once and rounded once to bf16.  No L x L
// score or bias tensor is written to device memory.
//
// Bound on the H100 at ViTDet-L's shapes, B = 4 (989 bf16 TFLOP/s, 3.35 TB/s):
// global: 4 B heads L^2 hd = 1.10 TFLOP (1.11 ms) against 268 MB (80 us), bound
// by operations; window: 321 MB of qkv and output (96 us) against 31.5 GFLOP
// (32 us), bound by bytes.
//
// Design (FlashAttention-2's layout, as K7/K8 lay out their fragments):
// - A block is 64 queries of one window (or image) and head, 4 warps of 16
//   query rows; 3 blocks an SM in global mode, 4 in window mode.  (On an H100
//   80GB HBM3 at 700 W, a design of 128 queries, 32 rows a warp and one block an
//   SM ran slower: 7.42 ms global, 0.848 ms window, against 6.20 and 0.566 for
//   a first design of this layout with both rel tables in shared memory.)
// - Key tiles of 64 tokens, double-buffered by 16-byte cp.async (zero-filled
//   past L); Q K^T in registers, then + rel_h + rel_w in f32; columns past L get
//   -inf.  P stays in registers: the bf16 A fragment of P V is the score tile.
// - The rel terms are products of Q with the table rows its block reaches,
//   staged in the K/V buffers and multiplied on the tensor cores; each product
//   q_i . R[rho] goes to the (query, key row) or (query, key column) it serves.
//   * Global blocks where kw is a multiple of 64 (1024 x 2048: 64 x 128 tokens):
//     a block's queries lie in one image row and a key tile in one key row.
//     rel_h is a 64 x kh f32 table in shared memory, one value a row and tile.
//     Tiles run column half by column half; at the start of each half the block
//     stages the 127 R_w rows the half needs, scatters the products into a
//     64 x 64 table in the K/V buffers and each lane takes its 2 rows x 16
//     columns of rel_w into registers for the half's kh tiles.
//   * Windows (and other global shapes): f32 tables rel_h (64 x kh) and rel_w
//     (64 x kw) in shared memory, read per score.  The blocks of a window and
//     its heads run next to each other, so its pixels' rows come from DRAM
//     once and its K and V from L2 for the other query blocks; warps whose 16
//     rows lie past L, and key steps past L, are skipped (196 = 3 x 64 + 4).
// - Outputs are divided by the row sums, rounded, staged in the Q tile and
//   written as 16-byte chunks.
//
// Measured (H100 80GB HBM3, 700 W, B = 4): 6.57 ms global, 17% of its bound;
// 0.59 ms window, 16% of its bound.  Not bound by the card's rates: the work a
// tile asks of each warp (64 mma, 32 ldmatrix of K and V, the softmax's exp2 and
// adds) runs nearly in sequence, and 12 warps an SM (3 blocks of 4) do not
// hide it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // queries of a block: 4 warps of 16 rows
constexpr int BK = 64;              // keys of a tile
constexpr int HD = 64;              // head dim
constexpr int PITCH = HD + 8;       // bf16 elements of a shared row; 8 ldmatrix rows hit 8 banks
constexpr int THREADS = 128;
constexpr int KV_ROWS = 4 * BK;     // K0, V0, K1, V1; staged table rows before and between tiles
constexpr int HALF_ROWS = 2 * BK;   // R_w rows a column half stages (127 used)
constexpr int TP = BK + 8;          // pitch (floats) of a half's rel_w table: 8 mod 32
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* rh;
  const __nv_bfloat16* rw;
  __nv_bfloat16* out;
  int Hp, Wp, C, ws, heads;  // ws 0: global
  int kh, kw, L;             // key rows, key columns, tokens of a window (image)
  int qblocks;               // query blocks of a window (image)
  int ph, pw;                // row pitches (floats) of the shared rel_h and rel_w tables
  int rowtile;               // global, kw a multiple of BK: column halves, rel_w in registers
  float scale_log2;          // scale * log2 e
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, or 16 zero bytes where !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two f32 -> one bf16x2 word, each rounded to nearest (lo in the low half)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s0, s1 (the warp's 16 rows x columns 8 j .. 8 j + 15) = Q B^T over the head
// dim, B the rows 8 j .. 8 j + 15 of a shared tile
__device__ __forceinline__ void qk_pair(float (&s0)[4], float (&s1)[4],
                                        const uint32_t (&qa)[HD / 16][4],
                                        const __nv_bfloat16* b, int j, int lane) {
  const int m = lane >> 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) s0[e] = s1[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t kb[4];
    ldsm_x4(kb, b + (8 * j + 8 * (m >> 1) + (lane & 7)) * PITCH + 16 * kk + 8 * (m & 1));
    mma(s0, qa[kk], kb[0], kb[1]);
    mma(s1, qa[kk], kb[2], kb[3]);
  }
}

template <bool WINDOW, bool ROWTILE>
__device__ __forceinline__ void relpos_body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);  // BQ x PITCH
  __nv_bfloat16* skv = sq + BQ * PITCH;                         // KV_ROWS x PITCH
  float* srh = reinterpret_cast<float*>(skv + KV_ROWS * PITCH);  // BQ x ph
  float* srw = srh + BQ * a.ph;                                  // BQ x pw (not ROWTILE)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kh = a.kh, kw = a.kw, L = a.L;
  int qb, head;
  long long base;  // pixel of token 0
  if constexpr (WINDOW) {  // the query blocks of a window, then its heads, then the windows
    int x = blockIdx.x;
    qb = x % a.qblocks;
    x /= a.qblocks;
    head = x % a.heads;
    const int wdx = x / a.heads;
    const int nW = a.Wp / a.ws, per_image = (a.Hp / a.ws) * nW;
    const int b = wdx / per_image, r = wdx - b * per_image;
    base = ((long long)b * a.Hp + (long long)(r / nW) * a.ws) * a.Wp + (long long)(r % nW) * a.ws;
  } else {
    qb = blockIdx.x;
    head = blockIdx.y;
    base = (long long)blockIdx.z * a.Hp * a.Wp;
  }
  const long long C3 = 3LL * a.C;
  const __nv_bfloat16* src = a.qkv + (long long)head * HD;
  auto pixel = [&](int t) -> long long {
    if constexpr (WINDOW) {
      const int y = t / kw;
      return base + (long long)y * a.Wp + (t - y * kw);
    } else {
      return base + t;
    }
  };
  const int ntiles = (L + BK - 1) / BK;
  auto tile_t0 = [&](int tau) -> int {
    if constexpr (ROWTILE) {  // column half by column half
      const int half = tau / kh;
      return (tau - half * kh) * kw + half * BK;
    } else {
      return tau * BK;
    }
  };
  auto load_kv = [&](int tau, int buf) {
    const int t0 = tile_t0(tau);
    __nv_bfloat16* dk = skv + buf * 2 * BK * PITCH;
    __nv_bfloat16* dv = dk + BK * PITCH;
    for (int e = tid; e < BK * (HD / 8); e += THREADS) {
      const int r = e >> 3, c = e & 7, t = t0 + r;
      const bool ok = t < L;
      const __nv_bfloat16* s = src + (ok ? pixel(t) * C3 : 0) + 8 * c;
      cp_async16(dk + r * PITCH + 8 * c, s + a.C, ok);
      cp_async16(dv + r * PITCH + 8 * c, s + 2 * a.C, ok);
    }
    cp_async_commit();
  };
  const int q0 = qb * BQ;

  // Q rows q0 .. q0 + 63 (zero past L), and the table rows the block's queries
  // reach: R_h rows h0 .. h1 + kh - 1, R_w rows w0 .. w1 + kw - 1 (ROWTILE: R_h
  // alone, the queries in one row; each half stages its R_w rows later)
  for (int e = tid; e < BQ * (HD / 8); e += THREADS) {
    const int r = e >> 3, c = e & 7, t = q0 + r;
    const bool ok = t < L;
    cp_async16(sq + r * PITCH + 8 * c, src + (ok ? pixel(t) * C3 : 0) + 8 * c, ok);
  }
  const int qlast = min(q0 + BQ, L) - 1;
  const int h0 = q0 / kw, h1 = qlast / kw;
  const int w0 = h0 == h1 ? q0 - h0 * kw : 0, w1 = h0 == h1 ? qlast - h1 * kw : kw - 1;
  const int nh = (h1 - h0 + kh + 7) & ~7, nw = ROWTILE ? 0 : (w1 - w0 + kw + 7) & ~7;
  for (int e = tid; e < (nh + nw) * (HD / 8); e += THREADS) {
    const int r = e >> 3, c = e & 7;
    const bool is_h = r < nh;
    const int rho = is_h ? h0 + r : w0 + (r - nh);
    const bool ok = rho < (is_h ? 2 * kh - 1 : 2 * kw - 1);
    const __nv_bfloat16* tab = is_h ? a.rh : a.rw;
    cp_async16(skv + r * PITCH + 8 * c, tab + (ok ? (long long)rho * HD : 0) + 8 * c, ok);
  }
  cp_async_commit();
  for (int e = tid; e < BQ * (ROWTILE ? a.ph : a.ph + a.pw); e += THREADS) srh[e] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int s16 = 16 * warp;
  const bool active = q0 + s16 < L;  // the warp has rows in the window (image)
  const int i0 = s16 + (lane >> 2), i1 = i0 + 8;  // this lane's two rows
  const int c0 = 2 * (lane & 3);                  // and its first column of an 8-column tile
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qa[kk], sq + (s16 + (lane & 15)) * PITCH + 16 * kk + 8 * (lane >> 4));

  // rel_h (and rel_w): q_i . R[rho] for every staged rho, each to the key row or
  // column it serves (r = hq + kh - 1 - rho, r = wq + kw - 1 - rho)
  if (active) {
    const int t0q = q0 + i0, t1q = q0 + i1;
    const int hq0 = t0q / kw, wq0 = t0q - hq0 * kw, hq1 = t1q / kw, wq1 = t1q - hq1 * kw;
    const bool v0 = t0q < L, v1 = t1q < L;
    for (int j = 0; j < (nh + nw) / 8; j += 2) {
      float g[2][4];
      qk_pair(g[0], g[1], qa, skv, j, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          const int rl = 8 * (j + u) + c0 + (e & 1), i = top ? i0 : i1;
          if (!(top ? v0 : v1) || rl >= nh + nw) continue;  // a pair's second tile may lie past
          if (rl < nh) {
            const int r = (top ? hq0 : hq1) + kh - 1 - (h0 + rl);
            if (r >= 0 && r < kh) srh[i * a.ph + r] = g[u][e] * LOG2E;
          } else {
            const int r = (top ? wq0 : wq1) + kw - 1 - (w0 + rl - nh);
            if (r >= 0 && r < kw) srw[i * a.pw + r] = g[u][e] * LOG2E;
          }
        }
    }
  }
  __syncthreads();  // the staged rows are read; the K/V buffers take them over

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float rwr[8][4];  // ROWTILE: this lane's rel_w in the current column half
  const float* rh0 = srh + i0 * a.ph;
  const float* rh1 = srh + i1 * a.ph;
  const float* rw0 = srw + i0 * a.pw;
  const float* rw1 = srw + i1 * a.pw;
  const int m = lane >> 3;

  if constexpr (!ROWTILE) load_kv(0, 0);
  for (int tau = 0; tau < ntiles; ++tau) {
    int half = 0, kr = 0;
    if constexpr (ROWTILE) {
      half = tau / kh;
      kr = tau - half * kh;
      if (kr == 0) {
        // the half's rel_w: stage R_w rows rho0 .. rho0 + 126, where rho0 =
        // w0 - 64 half + kw - 64; q_i . R_w[rho0 + rl] serves column 64 half + c,
        // c = i - rl + 63, into a BQ x TP table after the staged rows
        if (tau > 0) __syncthreads();  // every warp is done with the last tile
        const int rho0 = w0 - half * BK + kw - BK;
        for (int e = tid; e < HALF_ROWS * (HD / 8); e += THREADS) {
          const int r = e >> 3, c = e & 7, rho = rho0 + r;
          const bool ok = rho >= 0 && rho < 2 * kw - 1;
          cp_async16(skv + r * PITCH + 8 * c, a.rw + (ok ? (long long)rho * HD : 0) + 8 * c, ok);
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        float* st = reinterpret_cast<float*>(skv + HALF_ROWS * PITCH);
#pragma unroll 1
        for (int j = 0; j < HALF_ROWS / 8; j += 2) {
          float g[2][4];
          qk_pair(g[0], g[1], qa, skv, j, lane);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? i0 : i1;
              const int c = i - (8 * (j + u) + c0 + (e & 1)) + BK - 1;
              if (c >= 0 && c < BK) st[i * TP + c] = g[u][e] * LOG2E;
            }
        }
        __syncthreads();
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rwr[n][e] = st[(e < 2 ? i0 : i1) * TP + 8 * n + c0 + (e & 1)];
        __syncthreads();  // the table is read; the K/V buffers take it over
        load_kv(tau, tau & 1);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // tile tau is in; every warp is done with tile tau - 1
    if (tau + 1 < ntiles && !(ROWTILE && kr + 1 == kh)) load_kv(tau + 1, (tau + 1) & 1);
    if (!active) continue;
    const __nv_bfloat16* sk = skv + (tau & 1) * 2 * BK * PITCH;
    const __nv_bfloat16* sv = sk + BK * PITCH;
    const int t0 = tile_t0(tau);
    const int nvalid = min(BK, L - t0);  // keys of the tile in the window (image)

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      if (8 * j < nvalid) {
        qk_pair(sc[j], sc[j + 1], qa, sk, j, lane);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = sc[j + 1][e] = 0.f;
      }
    }

    if constexpr (ROWTILE) {
      const float b0 = rh0[kr], b1 = rh1[kr];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = fmaf(sc[n][e], a.scale_log2, rwr[n][e]) + (e < 2 ? b0 : b1);
    } else {
      // (key row, key column) of this lane's first column, then steps of 8
      int kr0 = (t0 + c0) / kw;
      int kc = t0 + c0 - kr0 * kw;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        int kr1 = kr0, kc1 = kc + 1;
        if (kc1 == kw) {
          kc1 = 0;
          ++kr1;
        }
        const int j = t0 + 8 * n + c0;
        const bool ok0 = j < L, ok1 = j + 1 < L;
        const int ka = min(kr0, kh - 1), kb = min(kr1, kh - 1);
        sc[n][0] = ok0 ? fmaf(sc[n][0], a.scale_log2, rh0[ka]) + rw0[kc] : -CUDART_INF_F;
        sc[n][1] = ok1 ? fmaf(sc[n][1], a.scale_log2, rh0[kb]) + rw0[kc1] : -CUDART_INF_F;
        sc[n][2] = ok0 ? fmaf(sc[n][2], a.scale_log2, rh1[ka]) + rw1[kc] : -CUDART_INF_F;
        sc[n][3] = ok1 ? fmaf(sc[n][3], a.scale_log2, rh1[kb]) + rw1[kc1] : -CUDART_INF_F;
        kc += 8;
        while (kc >= kw) {
          kc -= kw;
          ++kr0;
        }
      }
    }

    // online softmax: a row lies in a quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[n][0] = exp2f(sc[n][0] - mx0);
      sc[n][1] = exp2f(sc[n][1] - mx0);
      sc[n][2] = exp2f(sc[n][2] - mx1);
      sc[n][3] = exp2f(sc[n][3] - mx1);
      s0 += sc[n][0] + sc[n][1];
      s1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * corr0 + s0;
    l1 = l1 * corr1 + s1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }
    // O += P V, P rounded to bf16: the score tile is the A fragment
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      if (16 * t >= nvalid) break;
      const uint32_t pa[4] = {pack(sc[2 * t][0], sc[2 * t][1]), pack(sc[2 * t][2], sc[2 * t][3]),
                              pack(sc[2 * t + 1][0], sc[2 * t + 1][1]),
                              pack(sc[2 * t + 1][2], sc[2 * t + 1][3])};
#pragma unroll
      for (int n = 0; n < HD / 8; n += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, sv + (16 * t + 8 * (m & 1) + (lane & 7)) * PITCH + 8 * (n + (m >> 1)));
        mma(o[n], pa, vb[0], vb[1]);
        mma(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

  if (active) {  // the warp's rows of the Q tile take its outputs (only this warp read them)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(sq + i0 * PITCH + 8 * n + c0) =
          pack(o[n][0] * inv0, o[n][1] * inv0);
      *reinterpret_cast<uint32_t*>(sq + i1 * PITCH + 8 * n + c0) =
          pack(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
  __syncthreads();
  for (int e = tid; e < BQ * (HD / 8); e += THREADS) {
    const int r = e >> 3, c = e & 7, t = q0 + r;
    if (t < L)
      *reinterpret_cast<uint4*>(a.out + pixel(t) * a.C + (long long)head * HD + 8 * c) =
          *reinterpret_cast<const uint4*>(sq + r * PITCH + 8 * c);
  }
}

// blocks an SM the register budget keeps room for: 4 (window), 3 (global); 2 or 3
// window blocks and 2 global blocks measured no faster on an H100 80GB HBM3 at 700 W
__global__ void __launch_bounds__(THREADS, 4) relpos_attn_window_kernel(const Args a) {
  relpos_body<true, false>(a);
}

__global__ void __launch_bounds__(THREADS, 3) relpos_attn_global_kernel(const Args a) {
  if (a.rowtile)
    relpos_body<false, true>(a);
  else
    relpos_body<false, false>(a);
}

// table rows the block of queries q0 .. stages first (ops/cuda/relpos_attn.py::staged_rows)
int staged_rows(int q0, int L, int kh, int kw, bool rowtile) {
  const int q1 = (q0 + BQ < L ? q0 + BQ : L) - 1;
  const int h0 = q0 / kw, h1 = q1 / kw;
  const int w0 = h0 == h1 ? q0 % kw : 0, w1 = h0 == h1 ? q1 % kw : kw - 1;
  return ((h1 - h0 + kh + 7) & ~7) + (rowtile ? 0 : ((w1 - w0 + kw + 7) & ~7));
}

}  // namespace

// K10.  qkv (B, Hp, Wp, 3C) bf16 contiguous, 16-byte aligned, C = heads x 64;
// rh (2 kh - 1, 64), rw (2 kw - 1, 64) bf16 contiguous, 16-byte aligned; out
// (B, Hp, Wp, C) bf16.  ws > 0: windows of ws x ws (Hp, Wp multiples of ws), kh =
// kw = ws; ws = 0: global, kh = Hp, kw = Wp.  scale: the head dim's -1/2 power.
extern "C" int poly_relpos_attention(const void* qkv, const void* rh, const void* rw, void* out,
                                     int B, int Hp, int Wp, int C, int heads, int ws,
                                     float scale, void* stream) {
  if (B < 1 || Hp < 1 || Wp < 1 || heads < 1 || C != heads * HD || ws < 0 ||
      (ws > 0 && (Hp % ws || Wp % ws)))
    return (int)cudaErrorInvalidValue;
  const int kh = ws ? ws : Hp, kw = ws ? ws : Wp, L = kh * kw;
  const bool rowtile = ws == 0 && kw % BK == 0;
  const int qblocks = (L + BQ - 1) / BQ;
  for (int qb = 0; qb < qblocks; ++qb)
    if (staged_rows(qb * BQ, L, kh, kw, rowtile) > KV_ROWS) return (int)cudaErrorInvalidValue;
  const int ph = kh | 1, pw = rowtile ? 0 : (kw | 1);  // odd: 8 rows of a column in distinct banks
  const Args a{static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(rh),
               static_cast<const __nv_bfloat16*>(rw), static_cast<__nv_bfloat16*>(out),
               Hp, Wp, C, ws, heads, kh, kw, L, qblocks, ph, pw, (int)rowtile, scale * LOG2E};
  const size_t smem = (size_t)(BQ + KV_ROWS) * PITCH * 2 + 4 * (size_t)BQ * (ph + pw);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kern)(const Args) = ws ? relpos_attn_window_kernel : relpos_attn_global_kernel;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (ws) {
    const long long blocks = (long long)B * (Hp / ws) * (Wp / ws) * heads * qblocks;
    kern<<<dim3((unsigned)blocks), THREADS, smem, st>>>(a);
  } else {
    kern<<<dim3((unsigned)qblocks, (unsigned)heads, (unsigned)B), THREADS, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

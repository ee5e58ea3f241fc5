// Hard-mask pooling: out[b, n, c] = sum_hw [sigmoid(m[b, n, hw]) > thr] * f[b, hw, c].
//
// Replaces polyphonicformer_tpu/ops/pallas/mask_pool.py::_masked_pool_tpu.
//
// Bound.  At the main shape (N = 111 queries, C = 256 channels, HW = 32768
// at 1024x2048 / 8) the function is a skinny product, 1.86 GFLOP against
// 24 MB of bf16 operands: device memory bounds it (7.2 us at 3.35 TB/s),
// as long as the products run on the tensor cores.
//
// Design.
// - Tensor cores through wgmma.m64n128k16 (bf16 in, f32 accumulate), both
//   operands in shared memory in wgmma's K-major layouts: 128-byte rows
//   with the 128-byte swizzle for the 64-deep stages of bf16 operands, 8 x
//   16-byte core matrices for the 32-deep stages of f32 ones.  The block's
//   two warpgroups each own 64 rows of a 128-row x 128-channel output tile
//   (64 f32 accumulators a thread).  wgmma rather than mma.sync: it reads
//   both operands from shared memory (no ldmatrix, no fragments held in
//   registers) and runs asynchronously, so the threads convert the next
//   stage while the products of this one are in flight.
// - A is the thresholded mask, staged once per channel slice as bf16 0/1.
//   The threshold is the plain version's, in f32: 1 / (1 + expf(-x)) > thr
//   (not x > 0: for tiny positive x the f32 sigmoid rounds to exactly 0.5).
//   That expression costs some 30 instructions, so the host also passes a
//   band [lo, hi] around logit(thr), both ends bf16 values, outside which
//   the true sigmoid lies at least 1e-5 from thr
//   (ops/cuda/mask_pool.py::threshold_band): there the f32 expression, good
//   to well under 1e-6, cannot fall on the other side, so x >= hi decides
//   the same bit.  bf16 logits are compared two at a time (__hge2 yields the
//   bf16 1.0 / 0.0 words of A directly; measured faster than f32 compares
//   of the widened values), and the expression is evaluated, out of line,
//   only for the chunks of a thread that hold a logit inside the band.
// - B is the feature tile stored channel-major with HW contiguous, the
//   K-major operand of wgmma and the NCHW layout of the main path, so it
//   needs no transpose.  f32 features are split exactly into three bf16
//   parts while staged (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
//   mid), whose sum is x for normal f32) and run as three products into the
//   same accumulators.  A product of 0/1 with a bf16 value is exact, so only the
//   order of the f32 additions differs from the plain version.
// - One block covers every row of the mask (up to 128; more rows take more
//   row tiles) over a 128-channel slice and one HW chunk, so each feature
//   element is read once and each mask element once per channel slice.
//   Both slices of a chunk are neighbouring blocks, so the second read of
//   the mask hits L2.
// - Loads: a ring of 4 stages of raw tiles in shared memory, filled by
//   16-byte cp.async three stages ahead of the tensor cores, a warp
//   reading whole 128-byte lines of 4 rows.  Each thread
//   converts the chunks it copied itself (raw mask -> A, raw f32 features
//   -> three B tiles; raw bf16 features are the B tile) into one of two
//   buffers, the next stage's while this stage's products are in flight,
//   so a stage needs one barrier.  Operands that cannot take 16-byte
//   copies (HW not a multiple of 8, rows not 16-byte aligned, NHWC
//   features) are read by a predicated scalar path in the same kernel.
// - The HW reduction is split over about one block per SM.  The splits
//   write their partial tiles to a (S, B, N, C) scratch that stays in L2,
//   and a second kernel, mask_pool_sum_splits, sums them in a fixed order
//   (8 groups of splits, each in split order, then the 8 sums in order), so
//   two runs give the same bits.  A grid-wide barrier in a cooperative
//   launch, summing in the same launch, measured no faster on the H100 and
//   needs every block resident and a spin-wait; a sum through clusters of 8
//   blocks and distributed shared memory measured slower.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 128;      // mask rows per block
constexpr int CT = 128;      // channels per block
constexpr int THREADS = 256;

struct Params {
  const void* logits;  // (B, N, HW) contiguous
  const void* feats;   // (B, HW, C) with strides (fsb, fshw, fsc)
  long long fsb, fshw, fsc;
  float* partial;      // (S, B, N, C), unused when splits == 1
  float* out;          // (B, N, C)
  int B, N, HW, C;
  float thr, lo, hi;   // threshold, and the band where it is evaluated
  int splits, chunk, ntiles;
  int vec_m, vec_f;    // 16-byte copies allowed for the mask / the features
};

// Tile geometry of one type pair: the stage depth KT keeps every raw row at
// 128 bytes (64 bf16 or 32 f32 positions).  Operand tiles are in core
// matrices: element (r, k) at byte core_off(r, k).
template <typename TM_, typename TF>
struct Geo {
  using TM = TM_;
  static constexpr bool BF16_FEATS = sizeof(TF) == 2;
  static constexpr int KT = (sizeof(TM) == 2 && sizeof(TF) == 2) ? 64 : 32;
  static constexpr int NSTAGE = 4;  // raw stages in the ring (6 measured no faster)
  static constexpr int NP = BF16_FEATS ? 1 : 3;  // bf16 parts of a feature
  static constexpr int TILE = MT * KT;           // bf16 per operand tile (MT == CT)
  static constexpr int RAW_M = MT * KT * (int)sizeof(TM);  // bytes of a raw mask stage
  // bytes of a stage's features: the padded B tile itself for bf16, raw f32 rows otherwise
  static constexpr int RAW_F = BF16_FEATS ? TILE * 2 : CT * KT * 4;
  static constexpr int SLOT = RAW_M + RAW_F;
  // the ring, then two buffers of the A tile and (f32 features) the three B tiles
  static constexpr int CONV = (1 + (BF16_FEATS ? 0 : NP)) * TILE;  // bf16 per buffer
  static constexpr int SMEM = NSTAGE * SLOT + 2 * CONV * 2 + 1024;  // + alignment
  static constexpr int EM = 16 / (int)sizeof(TM), EF = 16 / (int)sizeof(TF);  // per copy
  static constexpr int M_CHUNKS = MT * KT / EM / THREADS;  // copies per thread and stage
  static constexpr int F_CHUNKS = CT * KT / EF / THREADS;
  // bf16 operand rows of 128 bytes (KT = 64) take wgmma's 128-byte swizzle:
  // row r's 16-byte chunk c sits at r * 128 + (c ^ r % 8) * 16, so the 8
  // chunks of a row written together land in 8 distinct bank groups.
  // Shorter rows use the no-swizzle layout of 8 x 16-byte core matrices.
  static constexpr bool SW128 = KT == 64;
  static constexpr int SBO = SW128 ? 1024 : KT * 16;  // bytes to the next 8 rows

  __device__ static int core_off(int r, int k) {
    if (SW128) return r * 128 + (((k / 8) ^ (r % 8)) * 16) + (k % 8) * 2;
    return (r / 8) * SBO + (k / 8) * 128 + (r % 8) * 16 + (k % 8) * 2;
  }
  // 16-byte chunk e of a raw tile with e16 elements per chunk: row (or
  // channel) r and first position k.  Neighbouring threads walk a row, so
  // a warp reads whole 128-byte lines (8 rows of 64 bytes a warp loaded
  // much slower).
  __device__ static void chunk(int e, int e16, int& r, int& k) {
    const int per_row = KT / e16;
    r = e / per_row;
    k = (e % per_row) * e16;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ unsigned short bf16_bits(__nv_bfloat16 v) {
  return *reinterpret_cast<unsigned short*>(&v);
}

__device__ __forceinline__ uint32_t pack2(unsigned short a, unsigned short b) {
  return a | (uint32_t)b << 16;
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bf2_of(uint32_t w) {
  return *reinterpret_cast<__nv_bfloat162*>(&w);
}

// [sigmoid(x) > thr] as the plain version computes it, in f32 (1 / y is the
// correctly rounded reciprocal, as the IEEE division 1.0f / y is, without
// the division's call into a slow path), the band deciding where it can
__device__ __forceinline__ bool keep(float x, float thr, float lo, float hi) {
  return x >= hi || (x > lo && __frcp_rn(1.0f + expf(-x)) > thr);
}

// x -> (hi, mid, lo) bf16 with hi + mid + lo == x for normal f32 x
__device__ __forceinline__ void split3(float x, unsigned short& hi, unsigned short& mid,
                                       unsigned short& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(h));
  const __nv_bfloat16 m = __float2bfloat16_rn(r1);
  const float r2 = __fsub_rn(r1, __bfloat162float(m));
  hi = bf16_bits(h);
  mid = bf16_bits(m);
  lo = bf16_bits(__float2bfloat16_rn(r2));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// shared-memory matrix descriptor of a K-major operand: no swizzle (8 x
// 16-byte core matrices, 128 bytes to the next one along K) or the 128-byte
// swizzle (128-byte rows, the tile 1024-byte aligned); sbo bytes to the
// next 8 rows
__device__ __forceinline__ uint64_t gmma_desc(const void* p, bool sw128, int sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | (uint64_t)((sw128 ? 16 : 128) >> 4) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)(sw128 ? 1 : 0) << 62;
}

// d += A (64 x 16, K-major) * B (16 x 128, K-major), both from shared memory
__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared memory written by this thread (stores, cp.async) -> visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across the async products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int j = 0; j < 64; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

// The rare chunks (bit q of redo: this thread's chunk q) holding a logit
// inside the band: their A values by the exact expression.  Out of line,
// so that the compiler cannot predicate it into the common path.
template <typename G>
__device__ __noinline__ void redo_chunks(const unsigned char* raw, unsigned char* sa, unsigned redo,
                                         float thr, float lo, float hi) {
  using TM = typename G::TM;
  for (int q = 0; q < G::M_CHUNKS; ++q) {
    if (!((redo >> q) & 1u)) continue;
    const int e = threadIdx.x + q * THREADS;
    int r, k;
    G::chunk(e, G::EM, r, k);
    const TM* x = reinterpret_cast<const TM*>(raw + e * 16);
    unsigned short* dst = reinterpret_cast<unsigned short*>(sa + G::core_off(r, k));
    for (int j = 0; j < G::EM; ++j) {
      const float v = to_f32(x[j]);
      dst[j] = keep(v, thr, lo, hi) ? 0x3F80u : 0u;
    }
  }
}

// One block's view of its tile: where its operands are and how its stages
// are fetched and converted.
template <typename TM, typename TF>
struct Block {
  using G = Geo<TM, TF>;
  static constexpr int KT = G::KT, TILE = G::TILE;

  const Params& p;
  unsigned char* smem;
  const TM* mb;  // this image's mask rows, from row n0
  const TF* fb;  // this image's features, from channel c0
  int nrows, ncols, k_begin, k_end;

  __device__ unsigned char* slot(int i) const { return smem + (i % G::NSTAGE) * G::SLOT; }
  // A tile of stage i (two buffers, by parity)
  __device__ __nv_bfloat16* a_tile(int i) const {
    return reinterpret_cast<__nv_bfloat16*>(smem + G::NSTAGE * G::SLOT) + (i % 2) * G::CONV;
  }
  // B tile of part pi at stage i: the stage's own slot for bf16 features,
  // else after the A tile of the same buffer
  __device__ __nv_bfloat16* b_tile(int i, int pi) const {
    if (G::BF16_FEATS) return reinterpret_cast<__nv_bfloat16*>(slot(i) + G::RAW_M);
    return a_tile(i) + (1 + pi) * TILE;
  }
  // chunk q of this thread in a raw tile with e16 elements per 16 bytes
  __device__ void chunk(int q, int e16, int& e, int& r, int& k) const {
    e = threadIdx.x + q * THREADS;
    G::chunk(e, e16, r, k);
  }

  // issue the 16-byte copies of stage i (the vector operands only)
  __device__ __forceinline__ void issue(int i) const {
    const int k0 = k_begin + i * KT;
    if (p.vec_m) {
#pragma unroll
      for (int q = 0; q < G::M_CHUNKS; ++q) {
        int e, r, k;
        chunk(q, G::EM, e, r, k);
        const bool ok = r < nrows && k0 + k < k_end;
        cp_async16(slot(i) + e * 16, ok ? mb + (long long)r * p.HW + k0 + k : mb, ok ? 16 : 0);
      }
    }
    if (p.vec_f) {
#pragma unroll
      for (int q = 0; q < G::F_CHUNKS; ++q) {
        int e, c, k;
        chunk(q, G::EF, e, c, k);
        const bool ok = c < ncols && k0 + k < k_end;
        // bf16: straight into the B tile; f32: raw, at this thread's bytes
        unsigned char* dst = slot(i) + G::RAW_M + (G::BF16_FEATS ? G::core_off(c, k) : e * 16);
        cp_async16(dst, ok ? fb + (long long)c * p.fsc + k0 + k : fb, ok ? 16 : 0);
      }
    }
  }

  // the raw mask chunks of stage i -> A, by the band alone; returns a bit
  // per chunk of this thread's with an element inside it (to be redone)
  __device__ __forceinline__ unsigned threshold_banded(int i, int k0) const {
    __nv_bfloat16* sa = a_tile(i);
    unsigned inside = 0;
#pragma unroll
    for (int q = 0; q < G::M_CHUNKS; ++q) {
      int e, r, k;
      chunk(q, G::EM, e, r, k);
      const bool ok = r < nrows && k0 + k < k_end;
      const uint4 raw = *reinterpret_cast<const uint4*>(slot(i) + e * 16);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t a[G::EM / 2];
      if constexpr (G::EM == 8) {  // bf16 logits, two at a time (exact: lo, hi are bf16)
        const __nv_bfloat162 hi2 = __float2bfloat162_rn(p.hi), lo2 = __float2bfloat162_rn(p.lo);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 v = bf2_of(w[j]);
          a[j] = ok ? bits_of(__hge2(v, hi2)) : 0u;
          const bool in = ok && (bits_of(__hgt2(v, lo2)) & bits_of(__hlt2(v, hi2))) != 0;
          inside |= (unsigned)in << q;
        }
      } else {  // f32 logits
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x0 = __uint_as_float(w[2 * j]), x1 = __uint_as_float(w[2 * j + 1]);
          a[j] = ok ? ((x0 >= p.hi) ? 0x3F80u : 0u) | ((x1 >= p.hi) ? 0x3F800000u : 0u) : 0u;
          const bool in = ok && ((x0 > p.lo && x0 < p.hi) || (x1 > p.lo && x1 < p.hi));
          inside |= (unsigned)in << q;
        }
      }
      unsigned char* dst = reinterpret_cast<unsigned char*>(sa) + G::core_off(r, k);
      if constexpr (G::EM == 8)
        *reinterpret_cast<uint4*>(dst) = make_uint4(a[0], a[1], a[2], a[3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(a[0], a[1]);
    }
    return inside;
  }

  // stage i's raw tiles (or, on the scalar path, global memory) -> its A
  // tile and, for f32 features, its three B tiles.  Each thread converts
  // the very chunks it copied, so only its own cp.async wait is needed.
  // Called by every thread of the block.
  __device__ __forceinline__ void convert(int i) const {
    const int k0 = k_begin + i * KT;
    __nv_bfloat16* sa = a_tile(i);
    if (p.vec_m) {
      const unsigned inside = threshold_banded(i, k0);
      if (inside) redo_chunks<G>(slot(i), reinterpret_cast<unsigned char*>(sa), inside, p.thr,
                                 p.lo, p.hi);
    } else {
      for (int e = threadIdx.x; e < MT * KT; e += THREADS) {
        const int r = e / KT, k = e % KT;
        bool on = false;
        if (r < nrows && k0 + k < k_end)
          on = keep(to_f32(mb[(long long)r * p.HW + k0 + k]), p.thr, p.lo, p.hi);
        *reinterpret_cast<unsigned short*>(reinterpret_cast<unsigned char*>(sa) +
                                           G::core_off(r, k)) = on ? 0x3F80u : 0u;
      }
    }

    if (p.vec_f) {
      if constexpr (!G::BF16_FEATS) {  // raw f32 rows -> three bf16 parts
#pragma unroll
        for (int q = 0; q < G::F_CHUNKS; ++q) {
          int e, c, k;
          chunk(q, 4, e, c, k);
          const float4 x = *reinterpret_cast<const float4*>(slot(i) + G::RAW_M + e * 16);
          unsigned short h[4], m[4], l[4];
          split3(x.x, h[0], m[0], l[0]);
          split3(x.y, h[1], m[1], l[1]);
          split3(x.z, h[2], m[2], l[2]);
          split3(x.w, h[3], m[3], l[3]);
          __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(
              reinterpret_cast<unsigned char*>(b_tile(i, 0)) + G::core_off(c, k));
          *reinterpret_cast<uint2*>(b) = make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
          *reinterpret_cast<uint2*>(b + TILE) = make_uint2(pack2(m[0], m[1]), pack2(m[2], m[3]));
          *reinterpret_cast<uint2*>(b + 2 * TILE) =
              make_uint2(pack2(l[0], l[1]), pack2(l[2], l[3]));
        }
      }
    } else {
      unsigned char* sb = reinterpret_cast<unsigned char*>(b_tile(i, 0));
      for (int e = threadIdx.x; e < CT * KT; e += THREADS) {
        int c, k;  // walk the contiguous axis with neighbouring threads
        if (p.fsc == 1) { c = e % CT; k = e / CT; } else { k = e % KT; c = e / KT; }
        float x = 0.f;
        if (c < ncols && k0 + k < k_end) x = to_f32(fb[(long long)(k0 + k) * p.fshw + c * p.fsc]);
        unsigned short* s = reinterpret_cast<unsigned short*>(sb + G::core_off(c, k));
        if constexpr (G::BF16_FEATS) {
          s[0] = bf16_bits(__float2bfloat16_rn(x));  // exact: x came from bf16
        } else {
          split3(x, s[0], s[TILE], s[2 * TILE]);
        }
      }
    }
  }
};

// The second pass: out = sum over the S partial planes, in a fixed order.
// A block takes 32 outputs (float4 or float) and 8 groups of splits; each
// group sums its splits in order, then the 8 sums are added in order.
constexpr int SUM_X = 32, SUM_G = 8;

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename V>
__global__ void __launch_bounds__(SUM_X * SUM_G) mask_pool_sum_splits(
    const V* __restrict__ partial, V* __restrict__ out, long long count, int splits) {
  __shared__ V red[SUM_G][SUM_X];
  const long long o = (long long)blockIdx.x * SUM_X + threadIdx.x;
  const int g = threadIdx.y;
  const int q0 = g * splits / SUM_G, q1 = (g + 1) * splits / SUM_G;
  V sum = V{};
  if (o < count) {
#pragma unroll 4
    for (int q = q0; q < q1; ++q) sum = sum + __ldcg(partial + q * count + o);
  }
  red[g][threadIdx.x] = sum;
  __syncthreads();
  if (g == 0 && o < count) {
#pragma unroll
    for (int gg = 1; gg < SUM_G; ++gg) sum = sum + red[gg][threadIdx.x];
    out[o] = sum;
  }
}

template <typename TM, typename TF>
__global__ void __launch_bounds__(THREADS, 1) mask_pool_mma(const Params p) {
  using G = Geo<TM, TF>;
  constexpr int KT = G::KT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment (SMEM has room for it)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int c0 = blockIdx.x * CT;
  const int b = blockIdx.z / p.ntiles;
  const int n0 = (blockIdx.z % p.ntiles) * MT;
  const int k_begin = blockIdx.y * p.chunk;
  const int k_end = min(p.HW, k_begin + p.chunk);  // the last splits may be empty
  const Block<TM, TF> blk{p, smem,
                          static_cast<const TM*>(p.logits) + ((long long)b * p.N + n0) * p.HW,
                          static_cast<const TF*>(p.feats) + b * p.fsb + c0 * p.fsc,
                          min(MT, p.N - n0), min(CT, p.C - c0), k_begin, k_end};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;                 // warpgroup: rows wg * 64 .. wg * 64 + 63

  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;

  const int stages = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;
#pragma unroll
  for (int i = 0; i < G::NSTAGE - 1; ++i) {
    if (i < stages) blk.issue(i);
    cp_async_commit();
  }
  cp_async_wait<G::NSTAGE - 2>();  // this thread's copies of stage 0 landed
  if (stages > 0) blk.convert(0);
  fence_async_smem();
  for (int i = 0; i < stages; ++i) {
    // stage i converted, its copies landed and are visible to wgmma
    // everywhere; stage i-1's products are done, so its slot and its A
    // buffer are free
    __syncthreads();
    if (i + G::NSTAGE - 1 < stages) blk.issue(i + G::NSTAGE - 1);  // into stage i-1's slot
    cp_async_commit();

    {
      fence_acc(acc);
      wgmma_fence();
      const unsigned char* sa = reinterpret_cast<const unsigned char*>(blk.a_tile(i)) + wg * 8 * G::SBO;
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        // along K: 32 bytes within a swizzled row, or two core matrices
        const int dk = G::SW128 ? kk * 2 : kk / 8 * 128;
#pragma unroll
        for (int pi = 0; pi < G::NP; ++pi) {
          const unsigned char* sb = reinterpret_cast<const unsigned char*>(blk.b_tile(i, pi));
          wgmma_64x128x16(acc, gmma_desc(sa + dk, G::SW128, G::SBO),
                          gmma_desc(sb + dk, G::SW128, G::SBO));
        }
      }
      wgmma_commit();
    }
    // the next stage's conversion runs while the products are in flight
    if (i + 1 < stages) {
      cp_async_wait<G::NSTAGE - 2>();
      blk.convert(i + 1);
      fence_async_smem();
    }
    wgmma_wait_all();
    fence_acc(acc);
  }
  cp_async_wait<0>();

  // accumulators -> the output (one split) or this split's partial tile:
  // warp w of the warpgroup holds rows 16 w .. 16 w + 15 of its 64; in
  // each 8-channel block j, a thread holds two rows and two channels
  const long long plane = (long long)p.B * p.N * p.C;
  float* dst = p.splits == 1 ? p.out : p.partial + blockIdx.y * plane;
  const bool pairs = p.C % 2 == 0;  // (c, c+1) pairs are 8-byte aligned
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + (warp % 4) * 16 + lane / 4 + h * 8;
      const int c = j * 8 + (lane % 4) * 2;
      if (r >= blk.nrows || c >= blk.ncols) continue;
      float* o = dst + ((long long)b * p.N + n0 + r) * p.C + c0 + c;
      if (pairs && c + 1 < blk.ncols) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        o[0] = acc[4 * j + 2 * h];
        if (c + 1 < blk.ncols) o[1] = acc[4 * j + 2 * h + 1];
      }
    }
}

template <typename TM, typename TF>
int launch(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = Geo<TM, TF>::SMEM;
  static_assert(smem <= 232448, "shared memory of one block");
  auto kernel = mask_pool_mma<TM, TF>;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  kernel<<<grid, THREADS, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long plane = (long long)p.B * p.N * p.C;
  const dim3 block(SUM_X, SUM_G);
  if (plane % 4 == 0) {
    const long long n4 = plane / 4;
    mask_pool_sum_splits<float4><<<(unsigned)((n4 + SUM_X - 1) / SUM_X), block, 0, stream>>>(
        reinterpret_cast<const float4*>(p.partial), reinterpret_cast<float4*>(p.out), n4, p.splits);
  } else {
    mask_pool_sum_splits<float><<<(unsigned)((plane + SUM_X - 1) / SUM_X), block, 0, stream>>>(
        p.partial, p.out, plane, p.splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// logits_bf16 / feats_bf16: 1 for bfloat16, 0 for float32.  The launch plan
// (ops/cuda/mask_pool.py::launch_plan): grid (ceil(C / 128), splits,
// B * ntiles), chunk a multiple of 64 with splits * chunk >= HW; splits > 1
// needs a (splits, B, N, C) f32 scratch.  lo, hi:
// ops/cuda/mask_pool.py::threshold_band(thr).
extern "C" int poly_mask_pool(const void* logits, int logits_bf16, const void* feats,
                              int feats_bf16, long long fsb, long long fshw, long long fsc,
                              void* partial, void* out, int B, int N, int HW, int C,
                              float thr, float lo, float hi, int splits, int chunk,
                              int ntiles, int vec_m, int vec_f, void* stream) {
  Params p{logits, feats, fsb, fshw, fsc, static_cast<float*>(partial), static_cast<float*>(out),
           B, N, HW, C, thr, lo, hi, splits, chunk, ntiles, vec_m, vec_f};
  const dim3 grid((C + CT - 1) / CT, splits, B * ntiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (logits_bf16 && feats_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(p, grid, st);
  if (logits_bf16) return launch<__nv_bfloat16, float>(p, grid, st);
  if (feats_bf16) return launch<float, __nv_bfloat16>(p, grid, st);
  return launch<float, float>(p, grid, st);
}

// Panoptic fusion in phase space: for every (py, px) phase of the exact
// fy x fx bilinear upsample of the stride-4 candidate maps, the argmax of
// score * prob, the winner's depth, and per candidate the row and column
// marginals of the argmax regions and the area where prob >= 0.5.
//
// Replaces polyphonicformer_tpu/ops/pallas/phase_fusion.py::phase_fusion
// (its _kernel, lines 56-123).  What bounds it on the H100 is the exact
// merge, not the bytes: for every output pixel and candidate row the two
// separately rounded lerps (__fmul_rn / __fadd_rn, which nvcc must not
// contract into FMAs), the multiply by the score, the compare and select of
// the argmax (a compare for a folded row) and, for full rows, the >= 0.5
// area compare.  As written here that is 8.75 f32-pipe instructions per
// pixel and full row and 6.75 per folded row (the horizontal lerps share
// their products: 2.5; the vertical lerps 2.25; the score 1; the argmax 2,
// or 1; the area 1), 1.85 G at the serving shape (111 candidates of 256 x
// 512, 64 full rows, 1024 x 2048 out): 55 us at one instruction per lane
// and clock on 132 SMs, where the bytes (76 MB) take 23 us.  So the design
// keeps the arithmetic pipes fed and the other instructions few:
// - one thread per stride-4 pixel and half of its fy row phases (those that
//   read the same two source rows): it holds the argmax state of fy / 2 x fx
//   output pixels, reads its 2 x 3 neighbours once for them, and writes
//   each row's fx pixels as one int4 / float4 (int2 / float2 at fx = 2);
// - a block takes a tile of TW x TH stride-4 pixels, (32, 16) threads.  The
//   candidates stream through shared memory in a ring of slots of CK
//   candidates, each the tile with a one-pixel halo (the image's edge
//   columns replicated into it, so no thread clamps), filled by 16-byte
//   cp.async, each thread's chunk and offsets fixed for the whole loop; the
//   next slots' loads are in flight while the current slot computes.  The
//   slot loop is unrolled over its CK candidates, and a slot holds full or
//   folded rows only (NF and KP are multiples of CK), so the branch is per
//   slot.  Candidates past K (the padding to KP) are read as zeros: the
//   caller's maps are not copied.  Widths that are not a multiple of 8, or
//   pointers that are not 16-byte aligned, fill the same ring with plain
//   loads;
// - the row and column marginals accumulate as integer counts in shared
//   memory (rows warp-aggregated with __match_any_sync, columns one shared
//   atomic per pixel), the area as one warp sum per four candidates, their
//   counts packed a byte each; at the end one global atomicAdd goes out per
//   nonzero (candidate, row), (candidate, column) and area of the block
//   (the one-thread-per-pixel kernel before it sent one per pixel for the
//   columns).  The grid and the shared memory bytes come from the host
//   (ops/cuda/phase_fusion.py::launch_plan); two blocks fit an SM, at most
//   64 registers a thread.
// The contract is the plain version's, bit for bit: the lerps rows first,
// then columns, in the same order; strict > over the candidates in index
// order, so among ties the first wins; rows at or beyond NF fold into one
// max whose win writes the sentinel NF (here: a folded row beating the
// full rows' best, the same test); the marginals and areas are integer
// counts below 2^24 in f32, exact whatever the order of the atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;      // stride-4 pixels of a tile along x (one warp)
constexpr int HALO = 8;     // bf16 columns loaded on each side (16 bytes)
constexpr int SW = TW + 2 * HALO;  // bf16 columns of a shared tile row
constexpr int CK = 8;       // candidates a ring slot holds (KP and NF are multiples of 8)
constexpr int TH = 8;       // stride-4 rows of a tile; a block is (TW, 2 * TH) threads
constexpr int STAGES = 4;   // ring slots: STAGES - 1 slots' loads in flight

// Per phase p of factor F the lerp weights (w0, w1), as ops/cuda/
// phase_fusion.py::phase_taps computes them (lam = src - base rounded to f32,
// then 1 - lam in f32; the base offset is -1 for the first F/2 phases and 0
// for the others).  At F = 2 and 4 they are exact binary fractions, and as
// compile-time constants a product shared by two phases is computed once.
template <int F>
struct Taps {
  float w0[F], w1[F];
  constexpr Taps() : w0(), w1() {
    for (int p = 0; p < F; ++p) {
      const float lam = (float)((p + 0.5) / F - 0.5 + (p < F / 2 ? 1 : 0));
      w1[p] = lam;
      w0[p] = 1.0f - lam;
    }
  }
};

struct FusionArgs {
  const __nv_bfloat16* probs;  // (KK, HS, WS); rows [KK, KP) read as zeros
  const __nv_bfloat16* depth;  // (KK, HS, WS)
  const float* scores;         // (KK,)
  int KK, KP, NF, KF, HS, WS;
  int* pix;     // (HS*FY, WS*FX)
  float* dep;   // (HS*FY, WS*FX)
  float* rowm;  // (KF, HS*FY), zeroed
  float* colm;  // (KF, WS*FX), zeroed
  float* oarea; // (KF,), zeroed
  int vec;
};

__device__ __forceinline__ float lerp(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The ring's loads: slot for candidates [k0, k0 + CK) of the tile whose
// first stride-4 pixel is (y0, x0), TH + 2 rows y0 - 1 .. y0 + TH (clamped
// to the image), columns x0 - HALO .. x0 + TW + HALO.  Shared row r, column
// j holds image row clamp(y0 - 1 + r), column x0 - HALO + j, with the
// image's edge columns replicated into the columns just outside it (x = -1
// and x = WS), so a thread reads its three neighbours without clamping.
// Candidates at or beyond KK (the padding to a multiple of CK) are rows of
// zeros.  In the 16-byte path each thread owns one chunk of a slot, the
// same in every slot, whose offsets are worked out once.
struct Filler {
  static constexpr int ROWS = TH + 2, CHUNKS = SW / 8;
  static_assert(CK * ROWS * CHUNKS <= TW * 2 * TH, "one 16-byte chunk a thread");
  int src = -1;  // the chunk's element offset from candidate k0's plane, or -1
  int dst = 0;   // its shared element offset | its candidate in the slot << 16

  __device__ Filler(int tid, int y0, int x0, const FusionArgs& a) {
    if (!a.vec || tid >= CK * ROWS * CHUNKS) return;
    const int q = tid % CHUNKS, r = (tid / CHUNKS) % ROWS, kk = tid / (CHUNKS * ROWS);
    const int x = x0 - HALO + q * 8;
    const int y = min(max(y0 - 1 + r, 0), a.HS - 1);
    if (x < 0 || x >= a.WS) return;
    src = kk * a.HS * a.WS + y * a.WS + x;
    dst = ((kk * ROWS + r) * SW + q * 8) | kk << 16;
  }

  __device__ __forceinline__ void operator()(__nv_bfloat16* slot, int k0, int tid, int y0,
                                             int x0, const FusionArgs& a) const {
    const int nthreads = blockDim.x * blockDim.y;
    const __nv_bfloat16* pk = a.probs + k0 * ((long long)a.HS * a.WS);
    const int plane = a.HS * a.WS;
    if (a.vec) {
      if (src >= 0) {
        __nv_bfloat16* d = slot + (dst & 0xffff);
        if (k0 + (dst >> 16) < a.KK)
          cp_async16(d, pk + src);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
      const int right = a.WS - x0 + HALO;  // shared column of x = WS
      if (x0 != 0 && right >= SW) return;  // uniform: a tile inside the image
      for (int i = tid; i < CK * ROWS * 2; i += nthreads) {
        const int side = i & 1, r = (i >> 1) % ROWS, kk = (i >> 1) / ROWS;
        if (side == 0 ? x0 != 0 : right >= SW) continue;
        const int y = min(max(y0 - 1 + r, 0), a.HS - 1);
        slot[(kk * ROWS + r) * SW + (side == 0 ? HALO - 1 : right)] =
            k0 + kk < a.KK ? pk[kk * plane + y * a.WS + (side == 0 ? 0 : a.WS - 1)]
                           : __nv_bfloat16{};
      }
    } else {
      for (int i = tid; i < CK * ROWS * (TW + 2); i += nthreads) {
        const int j = i % (TW + 2), r = (i / (TW + 2)) % ROWS, kk = i / ((TW + 2) * ROWS);
        const int x = min(max(x0 - 1 + j, 0), a.WS - 1);
        const int y = min(max(y0 - 1 + r, 0), a.HS - 1);
        slot[(kk * ROWS + r) * SW + HALO - 1 + j] =
            k0 + kk < a.KK ? pk[kk * plane + y * a.WS + x] : __nv_bfloat16{};
      }
    }
  }
};

template <int F>
__global__ void __launch_bounds__(TW * 2 * TH, 2) phase_fusion_kernel(const FusionArgs a) {
  // A thread: one stride-4 pixel (xs, ys) and the PY = F / 2 output row
  // phases that read the same two source rows (the first half of the phases
  // rows ys - 1 and ys, the second half ys and ys + 1).
  constexpr int FY = F, FX = F, PY = F / 2, ROWS = TH + 2, WARPS = TW * 2 * TH / 32;
  constexpr int SLOT = CK * ROWS * SW;  // bf16 elements of a ring slot
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* sc = reinterpret_cast<float*>(ring + STAGES * SLOT);  // [KP]
  int* row_acc = reinterpret_cast<int*>(sc + a.KP);              // [TH * FY][NF]
  int* col_acc = row_acc + TH * FY * a.NF;                       // [NF][TW * FX]
  int* area_acc = col_acc + a.NF * TW * FX;                      // [WARPS][NF]

  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lx = threadIdx.x, ly = threadIdx.y >> 1, half = threadIdx.y & 1;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int xs = x0 + lx, ys = y0 + ly;
  const bool ok = xs < a.WS && ys < a.HS;
  const int nck = a.KP / CK;

  // start the ring before zeroing the counts
  const Filler fill(tid, y0, x0, a);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nck) fill(ring + s * SLOT, s * CK, tid, y0, x0, a);
    cp_async_commit();
  }
  int cur = 0, spare = STAGES - 1;  // ring slots of the slot computed next, and of its refill
  for (int i = tid; i < a.KP; i += nthreads) sc[i] = i < a.KK ? a.scores[i] : 0.f;
  for (int i = tid; i < (TH * FY + TW * FX + WARPS) * a.NF; i += nthreads) row_acc[i] = 0;

  // this thread's taps: shared rows ly + half and the next, columns
  // c1 - 1 .. c1 + 1; row phases half * PY + i
  constexpr Taps<F> T{};
  const int c1 = lx + HALO;
  float wy0[PY], wy1[PY];
#pragma unroll
  for (int i = 0; i < PY; ++i) {
    wy0[i] = half ? T.w0[PY + i] : T.w0[i];
    wy1[i] = half ? T.w1[PY + i] : T.w1[i];
  }

  // per pixel the running argmax of the full rows, and a bit that a folded
  // row beat it (the folded rows come last, so their max beats the full
  // rows' best exactly when one of them does)
  float best[PY][FX];
  int arg[PY][FX];
  unsigned lost[PY] = {};
#pragma unroll
  for (int i = 0; i < PY; ++i)
#pragma unroll
    for (int px = 0; px < FX; ++px) {
      best[i][px] = -INFINITY;
      arg[i][px] = 0;
    }

  for (int c = 0; c < nck; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {  // refill the slot computed in the previous iteration
      const int next = c + STAGES - 1;
      if (next < nck) fill(ring + spare * SLOT, next * CK, tid, y0, x0, a);
      cp_async_commit();
    }
    const __nv_bfloat16* m = ring + cur * SLOT + (ly + half) * SW + c1;
    spare = cur;
    cur = cur + 1 == STAGES ? 0 : cur + 1;
    const int k0 = c * CK;
    if (k0 < a.NF) {  // a slot of full rows (NF and KP are multiples of CK)
      // per row phase and candidate the count of v >= 0.5 among this
      // thread's FX pixels, one byte each (a warp's sum is at most 128)
      unsigned long long packed[PY] = {};
#pragma unroll
      for (int kk = 0; kk < CK; ++kk) {
        const __nv_bfloat16* mk = m + kk * ROWS * SW;
        float t0[3], t1[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          t0[j] = __bfloat162float(mk[j - 1]);
          t1[j] = __bfloat162float(mk[SW + j - 1]);
        }
        const float s = sc[k0 + kk];
#pragma unroll
        for (int i = 0; i < PY; ++i) {
          float vy[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) vy[j] = lerp(wy0[i], t0[j], wy1[i], t1[j]);
          unsigned cnt = 0;
#pragma unroll
          for (int px = 0; px < FX; ++px) {
            const int b = px < FX / 2 ? 0 : 1;
            const float v = lerp(T.w0[px], vy[b], T.w1[px], vy[b + 1]);
            const float p = __fmul_rn(s, v);
            if (p > best[i][px]) { best[i][px] = p; arg[i][px] = k0 + kk; }
            cnt += v >= 0.5f;
          }
          packed[i] += (unsigned long long)cnt << (8 * kk);
        }
      }
#pragma unroll
      for (int i = 0; i < PY; ++i)
#pragma unroll
        for (int q = 0; q < CK / 4; ++q) {
          const unsigned tot =
              __reduce_add_sync(0xffffffffu, ok ? (unsigned)(packed[i] >> (32 * q)) : 0u);
          if (lane < 4) area_acc[warp * a.NF + k0 + 4 * q + lane] += (tot >> (8 * lane)) & 0xff;
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < CK; ++kk) {
        const __nv_bfloat16* mk = m + kk * ROWS * SW;
        float t0[3], t1[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          t0[j] = __bfloat162float(mk[j - 1]);
          t1[j] = __bfloat162float(mk[SW + j - 1]);
        }
        const float s = sc[k0 + kk];
#pragma unroll
        for (int i = 0; i < PY; ++i) {
          float vy[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) vy[j] = lerp(wy0[i], t0[j], wy1[i], t1[j]);
#pragma unroll
          for (int px = 0; px < FX; ++px) {
            const int b = px < FX / 2 ? 0 : 1;
            const float v = lerp(T.w0[px], vy[b], T.w1[px], vy[b + 1]);
            lost[i] |= (unsigned)(__fmul_rn(s, v) > best[i][px]) << px;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // winners, depth, stores and marginals
  const int H = a.HS * FY, W = a.WS * FX;
  const int xc = min(xs, a.WS - 1);
  const int r0 = min(max(ys + half - 1, 0), a.HS - 1);
  const int r1 = min(ys + half, a.HS - 1);
  const long long plane = (long long)a.HS * a.WS;
#pragma unroll
  for (int i = 0; i < PY; ++i) {
    const int py = half * PY + i;
    int win[FX];
    float d[FX];
#pragma unroll
    for (int px = 0; px < FX; ++px) {
      int k = arg[i][px];
      if (lost[i] >> px & 1) k = a.NF;  // a folded row wins: sentinel
      win[px] = k;
      d[px] = 0.f;
      if (ok && k < a.NF && k < a.KK) {  // a zero row's depth is 0
        const __nv_bfloat16* dk = a.depth + k * plane;
        const int ca = px < FX / 2 ? max(xc - 1, 0) : xc;
        const int cb = px < FX / 2 ? xc : min(xc + 1, a.WS - 1);
        const float ta = lerp(wy0[i], __bfloat162float(dk[r0 * a.WS + ca]), wy1[i],
                              __bfloat162float(dk[r1 * a.WS + ca]));
        const float tb = lerp(wy0[i], __bfloat162float(dk[r0 * a.WS + cb]), wy1[i],
                              __bfloat162float(dk[r1 * a.WS + cb]));
        d[px] = lerp(T.w0[px], ta, T.w1[px], tb);
      }
    }
    if (ok) {
      const long long o = (long long)(ys * FY + py) * W + xs * FX;
      if (FX == 4) {
        *reinterpret_cast<int4*>(a.pix + o) = make_int4(win[0], win[1], win[2], win[3]);
        *reinterpret_cast<float4*>(a.dep + o) = make_float4(d[0], d[1], d[2], d[3]);
      } else {
        *reinterpret_cast<int2*>(a.pix + o) = make_int2(win[0], win[1]);
        *reinterpret_cast<float2*>(a.dep + o) = make_float2(d[0], d[1]);
      }
    }
#pragma unroll
    for (int px = 0; px < FX; ++px) {
      const int k = win[px];
      const bool counted = ok && k < a.KF;
      // row marginal: lanes (one output row, consecutive columns) that
      // share a winner add once
      const unsigned peers = __match_any_sync(0xffffffffu, counted ? k : -1);
      if (counted && lane == __ffs(peers) - 1)
        atomicAdd(&row_acc[(ly * FY + py) * a.NF + k], __popc(peers));
      if (counted) atomicAdd(&col_acc[k * (TW * FX) + lx * FX + px], 1);
    }
  }
  __syncthreads();
  for (int i = tid; i < TH * FY * a.NF; i += nthreads) {
    const int r = y0 * FY + i / a.NF, k = i % a.NF;
    if (k < a.KF && r < H && row_acc[i]) atomicAdd(&a.rowm[(long long)k * H + r], (float)row_acc[i]);
  }
  for (int i = tid; i < a.NF * TW * FX; i += nthreads) {
    const int k = i / (TW * FX), col = x0 * FX + i % (TW * FX);
    if (k < a.KF && col < W && col_acc[i]) atomicAdd(&a.colm[(long long)k * W + col], (float)col_acc[i]);
  }
  for (int k = tid; k < a.KF; k += nthreads) {
    int tot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) tot += area_acc[w * a.NF + k];
    if (tot) atomicAdd(&a.oarea[k], (float)tot);
  }
}

}  // namespace

// probs/depth: (KK, HS, WS) bf16 contiguous, read as KP rows (KP the
// multiple of 8 at or above KK; the rows beyond KK are zeros, scores 0);
// scores (KK,) f32.  Rows [0, NF) are full rows; rows [NF, KP) fold into one max channel
// whose wins write the sentinel NF.  Marginals and areas cover rows [0, KF).
// fy == fx in {2, 4}.  The launch
// (ops/cuda/phase_fusion.py::launch_plan): grid (gx, gy) tiles of TW x TH
// stride-4 pixels, `smem` bytes of dynamic shared memory; vec:
// 16-byte cp.async fills (WS a multiple of 8, probs 16-byte aligned).
extern "C" int poly_phase_fusion(const void* probs, const void* depth, const void* scores,
                                 int KK, int KP, int NF, int KF, int HS, int WS, int fy, int fx,
                                 void* pix, void* dep,
                                 void* rowm, void* colm, void* oarea, int gx, int gy, int smem,
                                 int vec, void* stream) {
  if (fy != fx || (fy != 2 && fy != 4) || KP % CK || NF % CK || KK > KP || KP - KK >= CK ||
      (long long)HS * WS * CK >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  FusionArgs a{static_cast<const __nv_bfloat16*>(probs), static_cast<const __nv_bfloat16*>(depth),
               static_cast<const float*>(scores), KK, KP, NF, KF, HS, WS,
               static_cast<int*>(pix), static_cast<float*>(dep), static_cast<float*>(rowm),
               static_cast<float*>(colm), static_cast<float*>(oarea), vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy), block(TW, 2 * TH);
  cudaError_t err;
  if (fy == 4) {
    err = cudaFuncSetAttribute(phase_fusion_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    phase_fusion_kernel<4><<<grid, block, smem, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(phase_fusion_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    phase_fusion_kernel<2><<<grid, block, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

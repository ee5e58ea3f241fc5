// Panoptic fusion in phase space: for every (py, px) phase of the exact
// fy x fx bilinear upsample of the stride-4 candidate maps, the argmax of
// score * prob, the winner's depth, and per candidate the row and column
// marginals of the argmax regions and the area where prob >= 0.5.
//
// Replaces polyphonicformer_tpu/ops/pallas/phase_fusion.py::phase_fusion
// (its _kernel, lines 56-123).  On the H100 the work is arithmetic on data
// that sits in L1/L2: the bf16 stacks are ~29 MB each at 111 x 256 x 512,
// while every stride-4 pixel evaluates K candidates x 16 phases.  One thread
// per stride-4 pixel walks the candidates once (k outer), loads the 3x3
// bf16 neighbourhood of candidate k and updates the running argmax of all
// fy*fx phases held in registers; the winner's depth is lerped once per
// phase at the end.  The lerp runs rows first, then columns, with separately
// rounded __fmul_rn / __fadd_rn, as the Pallas kernel and the plain version
// do, so argmax and depth agree bit for bit.  The marginals are integer
// counts: rows gather in shared memory (warp-aggregated with
// __match_any_sync) and columns go straight to device memory, one atomicAdd
// per pixel (about 2M per frame, the first thing to batch when this kernel
// is tuned).  Both land in the f32 outputs as integer values below 2^24,
// which makes the sums exact and independent of order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// phase_fusion.py::_phase_taps: lam rounded to f32 first, then 1 - lam in f32.
__device__ __forceinline__ void phase(int p, int f, int& base, float& w0, float& w1) {
  const double src = (p + 0.5) / f - 0.5;
  const double fl = floor(src);
  const float lam = (float)(src - fl);
  base = (int)fl;
  w0 = __fsub_rn(1.0f, lam);
  w1 = lam;
}

__device__ __forceinline__ float lerp(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

template <int FY, int FX>
__global__ void phase_fusion_kernel(
    const __nv_bfloat16* __restrict__ probs,  // (KP, HS, WS)
    const __nv_bfloat16* __restrict__ depth,  // (KP, HS, WS)
    const float* __restrict__ scores,         // (KP,)
    int KP, int NF, int KF, int HS, int WS,
    int* __restrict__ pix, float* __restrict__ dep,  // (HS*FY, WS*FX)
    float* __restrict__ rowm,   // (KF, HS*FY), zeroed
    float* __restrict__ colm,   // (KF, WS*FX), zeroed
    float* __restrict__ oarea)  // (KF,), zeroed
{
  constexpr int P = FY * FX;
  extern __shared__ int smem[];
  int* row_acc = smem;          // [FY][NF]
  int* area_acc = smem + FY * NF;  // [NF]
  for (int i = threadIdx.x; i < (FY + 1) * NF; i += blockDim.x) smem[i] = 0;
  __syncthreads();

  int by[FY], bx[FX];
  float wy0[FY], wy1[FY], wx0[FX], wx1[FX];
#pragma unroll
  for (int p = 0; p < FY; ++p) phase(p, FY, by[p], wy0[p], wy1[p]);
#pragma unroll
  for (int p = 0; p < FX; ++p) phase(p, FX, bx[p], wx0[p], wx1[p]);

  const int lane = threadIdx.x & 31;
  const int xs = blockIdx.x * blockDim.x + threadIdx.x;
  const int ys = blockIdx.y;
  const bool ok = xs < WS;
  const int xc = min(xs, WS - 1);
  const int cols[3] = {max(xc - 1, 0), xc, min(xc + 1, WS - 1)};
  const int rows[3] = {max(ys - 1, 0), ys, min(ys + 1, HS - 1)};
  const long long plane = (long long)HS * WS;
  const int H = HS * FY, W = WS * FX;

  float best[P], fold[P];
  int arg[P];
#pragma unroll
  for (int i = 0; i < P; ++i) { best[i] = -INFINITY; fold[i] = -INFINITY; arg[i] = 0; }

  for (int k = 0; k < KP; ++k) {
    const __nv_bfloat16* m = probs + k * plane;
    float nb[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) nb[r][c] = __bfloat162float(m[rows[r] * WS + cols[c]]);
    const float s = scores[k];
    const bool full = k < NF;
    int cnt = 0;
#pragma unroll
    for (int py = 0; py < FY; ++py) {
      float vy[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) vy[c] = lerp(wy0[py], nb[by[py] + 1][c], wy1[py], nb[by[py] + 2][c]);
#pragma unroll
      for (int px = 0; px < FX; ++px) {
        const int i = py * FX + px;
        const float v = lerp(wx0[px], vy[bx[px] + 1], wx1[px], vy[bx[px] + 2]);
        const float p = __fmul_rn(s, v);
        if (full) {
          if (p > best[i]) { best[i] = p; arg[i] = k; }
          cnt += v >= 0.5f;
        } else if (p > fold[i]) {
          fold[i] = p;
        }
      }
    }
    if (full) {  // k is uniform across the warp
      const int tot = __reduce_add_sync(0xffffffffu, ok ? cnt : 0);
      if (lane == 0 && tot) atomicAdd(&area_acc[k], tot);
    }
  }

#pragma unroll
  for (int py = 0; py < FY; ++py) {
#pragma unroll
    for (int px = 0; px < FX; ++px) {
      const int i = py * FX + px;
      int k = arg[i];
      if (NF < KP && fold[i] > best[i]) k = NF;  // a pruned row wins: sentinel
      float d = 0.f;
      if (k < NF) {
        const __nv_bfloat16* dk = depth + k * plane;
        const int r0 = rows[by[py] + 1], r1 = rows[by[py] + 2];
        const int ca = cols[bx[px] + 1], cb = cols[bx[px] + 2];
        const float ta = lerp(wy0[py], __bfloat162float(dk[r0 * WS + ca]), wy1[py],
                              __bfloat162float(dk[r1 * WS + ca]));
        const float tb = lerp(wy0[py], __bfloat162float(dk[r0 * WS + cb]), wy1[py],
                              __bfloat162float(dk[r1 * WS + cb]));
        d = lerp(wx0[px], ta, wx1[px], tb);
      }
      const int row = ys * FY + py, col = xs * FX + px;
      const bool counted = ok && k < KF;
      if (ok) {
        pix[(long long)row * W + col] = k;
        dep[(long long)row * W + col] = d;
      }
      // row marginal: lanes that share a winner add once
      const unsigned peers = __match_any_sync(0xffffffffu, counted ? k : -1);
      if (counted && lane == __ffs(peers) - 1) atomicAdd(&row_acc[py * NF + k], __popc(peers));
      // column marginal: this thread owns the column's FY pixels
      if (counted) atomicAdd(&colm[(long long)k * W + col], 1.0f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < FY * NF; i += blockDim.x) {
    const int py = i / NF, k = i % NF;
    if (k < KF && row_acc[i]) atomicAdd(&rowm[(long long)k * H + ys * FY + py], (float)row_acc[i]);
  }
  for (int k = threadIdx.x; k < KF; k += blockDim.x)
    if (area_acc[k]) atomicAdd(&oarea[k], (float)area_acc[k]);
}

template <int FY, int FX>
int launch(const void* probs, const void* depth, const void* scores, int KP, int NF, int KF,
           int HS, int WS, void* pix, void* dep, void* rowm, void* colm, void* oarea,
           int threads, cudaStream_t st) {
  dim3 grid((WS + threads - 1) / threads, HS);
  const size_t shm = (size_t)(FY + 1) * NF * sizeof(int);
  phase_fusion_kernel<FY, FX><<<grid, threads, shm, st>>>(
      static_cast<const __nv_bfloat16*>(probs), static_cast<const __nv_bfloat16*>(depth),
      static_cast<const float*>(scores), KP, NF, KF, HS, WS, static_cast<int*>(pix),
      static_cast<float*>(dep), static_cast<float*>(rowm), static_cast<float*>(colm),
      static_cast<float*>(oarea));
  return (int)cudaGetLastError();
}

}  // namespace

// probs/depth: (KP, HS, WS) bf16 contiguous, KP a multiple of 8; scores (KP,)
// f32.  Rows [0, NF) are full rows; rows [NF, KP) fold into one max channel
// whose wins write the sentinel NF.  Marginals and areas cover rows [0, KF).
// fy == fx in {2, 4}; threads is a multiple of 32.
extern "C" int poly_phase_fusion(const void* probs, const void* depth, const void* scores,
                                 int KP, int NF, int KF, int HS, int WS, int fy, int fx,
                                 void* pix, void* dep, void* rowm, void* colm, void* oarea,
                                 int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fy == 4 && fx == 4)
    return launch<4, 4>(probs, depth, scores, KP, NF, KF, HS, WS, pix, dep, rowm, colm, oarea, threads, st);
  if (fy == 2 && fx == 2)
    return launch<2, 2>(probs, depth, scores, KP, NF, KF, HS, WS, pix, dep, rowm, colm, oarea, threads, st);
  return (int)cudaErrorInvalidValue;
}

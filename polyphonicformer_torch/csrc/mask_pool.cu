// Hard-mask pooling: out[b, n, c] = sum_hw [sigmoid(m[b, n, hw]) > thr] * f[b, hw, c].
//
// Replaces polyphonicformer_tpu/ops/pallas/mask_pool.py::_masked_pool_tpu.
// On the H100 this is a skinny GEMM (M = N <= 111 queries, N' = C = 256,
// reduction over HW = 32768 at 1024x2048): about 100 output tiles, far too
// few to fill 132 SMs, so the reduction is split over HW across blocks.
// Each split writes its partial (N, C) tile into a (S, B, N, C) scratch and
// a second pass sums the S partials in a fixed order, so two runs give the
// same bits (no float atomics).  The threshold runs while the mask tile is
// staged in shared memory, in f32, as 1 / (1 + exp(-x)) > thr (not x > 0:
// for tiny positive x the f32 sigmoid rounds to exactly 0.5).  The product
// is plain f32 FMA in registers; tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TN = 32;   // query rows per block
constexpr int TC = 64;   // channels per block
constexpr int TK = 32;   // hw positions per shared-memory stage
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TM, typename TF>
__global__ void __launch_bounds__(THREADS) mask_pool_partial(
    const TM* __restrict__ logits,  // (B, N, HW) contiguous
    const TF* __restrict__ feats,   // (B, HW, C) with strides (fsb, fshw, fsc)
    long long fsb, long long fshw, long long fsc,
    float* __restrict__ partial,    // (S, B, N, C)
    int B, int N, int HW, int C, float thr, int splits, int chunk) {
  __shared__ float sa[TK][TN + 1];
  __shared__ float sb[TK][TC];

  const int c0 = blockIdx.x * TC;
  const int n0 = blockIdx.y * TN;
  const int b = blockIdx.z / splits;
  const int s = blockIdx.z % splits;
  const int k_begin = s * chunk;
  const int k_end = min(HW, k_begin + chunk);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: c = tx + 16 * j
  const int ty = tid / 16;  // row pair: n = 2 * ty + i

  const TM* mb = logits + (long long)b * N * HW;
  const TF* fb = feats + (long long)b * fsb;
  float acc[2][4] = {};

  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    // mask tile, thresholded in f32 on the way into shared memory
    for (int e = tid; e < TN * TK; e += THREADS) {
      const int n = e / TK, k = e % TK;
      float v = 0.f;
      if (n0 + n < N && k0 + k < k_end) {
        const float x = to_f32(mb[(long long)(n0 + n) * HW + k0 + k]);
        v = (1.0f / (1.0f + expf(-x)) > thr) ? 1.f : 0.f;
      }
      sa[k][n] = v;
    }
    // feature tile; walk the contiguous axis with neighbouring threads
    for (int e = tid; e < TK * TC; e += THREADS) {
      int k, c;
      if (fsc == 1) { k = e / TC; c = e % TC; } else { k = e % TK; c = e / TK; }
      float v = 0.f;
      if (c0 + c < C && k0 + k < k_end) v = to_f32(fb[(k0 + k) * fshw + (c0 + c) * fsc]);
      sb[k][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      const float a0 = sa[k][2 * ty], a1 = sa[k][2 * ty + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f = sb[k][tx + 16 * j];
        acc[0][j] += a0 * f;
        acc[1][j] += a1 * f;
      }
    }
    __syncthreads();
  }

  float* out = partial + ((long long)s * B + b) * N * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + 2 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (n < N && c < C) out[(long long)n * C + c] = acc[i][j];
    }
  }
}

__global__ void sum_splits(const float* __restrict__ partial, float* __restrict__ out,
                           long long count, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[p * count + i];
  out[i] = s;
}

template <typename TM, typename TF>
void launch(const void* logits, const void* feats, long long fsb, long long fshw,
            long long fsc, float* partial, int B, int N, int HW, int C, float thr,
            int splits, int chunk, cudaStream_t stream) {
  dim3 grid((C + TC - 1) / TC, (N + TN - 1) / TN, B * splits);
  mask_pool_partial<TM, TF><<<grid, THREADS, 0, stream>>>(
      static_cast<const TM*>(logits), static_cast<const TF*>(feats), fsb, fshw, fsc,
      partial, B, N, HW, C, thr, splits, chunk);
}

}  // namespace

// logits_bf16 / feats_bf16: 1 for bfloat16, 0 for float32.  chunk is a
// multiple of 32 and splits * chunk >= HW.
extern "C" int poly_mask_pool(const void* logits, int logits_bf16, const void* feats,
                              int feats_bf16, long long fsb, long long fshw, long long fsc,
                              void* partial, void* out, int B, int N, int HW, int C,
                              float thr, int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (logits_bf16 && feats_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(logits, feats, fsb, fshw, fsc, part, B, N, HW, C, thr, splits, chunk, st);
  else if (logits_bf16)
    launch<__nv_bfloat16, float>(logits, feats, fsb, fshw, fsc, part, B, N, HW, C, thr, splits, chunk, st);
  else if (feats_bf16)
    launch<float, __nv_bfloat16>(logits, feats, fsb, fshw, fsc, part, B, N, HW, C, thr, splits, chunk, st);
  else
    launch<float, float>(logits, feats, fsb, fshw, fsc, part, B, N, HW, C, thr, splits, chunk, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long count = (long long)B * N * C;
  sum_splits<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(part, static_cast<float*>(out),
                                                               count, splits);
  return (int)cudaGetLastError();
}

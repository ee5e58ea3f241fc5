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
// Both take Q K^T in f32 from the compute dtype (products of bf16 values are
// exact in f32), multiply by scale, add the f32 bias and then the f32 mask
// (rounded adds, in that order), take an f32 softmax and accumulate P V in f32;
// the output is rounded once to the compute dtype.
//
// Bound on the H100: bytes.  At Swin-L stage 0 (1024x2048 frame, bf16) K8
// moves 155 MB of qkv, 52 MB of output and 26 MB of mask, ~69 us at 3.35 TB/s,
// against 5 GFLOP (~5 us on the tensor cores).  This first version is a plain
// one: a block per (window, head) stages Q, K and V for its window as f32 in
// shared memory (rows padded to hd + 1 words, so neighbouring tokens fall in
// neighbouring banks), forms the L x L scores with f32 FMAs on the CUDA cores,
// runs the softmax a warp per row with shuffles, and forms P V the same way.
// Tensor cores (mma / wgmma) and wider loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// IMAGE = false: K7 (partitioned windows); IMAGE = true: K8 (image layout).
template <typename T, bool IMAGE>
__global__ void __launch_bounds__(THREADS) window_attn_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ mask, T* __restrict__ out, int L, int C, int hd,
    float scale, int ntypes, int Hp, int Wp, int ws) {
  extern __shared__ float smem[];
  const int hs = hd + 1;
  float* sq = smem;
  float* sk = sq + L * hs;
  float* sv = sk + L * hs;
  float* sp = sv + L * hs;  // L x L scores, then probabilities

  const long long w = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;

  // token t of this window -> its row of qkv (3C wide) and of out (C wide)
  long long img_row0 = 0;
  int wx0 = 0;
  if constexpr (IMAGE) {
    const int nH = Hp / ws, nW = Wp / ws;
    const long long per_image = (long long)nH * nW;
    const long long b = w / per_image;
    const int r = (int)(w - b * per_image);
    img_row0 = b * Hp + (long long)(r / nW) * ws;
    wx0 = (r % nW) * ws;
  }
  auto row = [=](int t) -> long long {
    if constexpr (IMAGE) {
      return (img_row0 + t / ws) * (long long)Wp + wx0 + t % ws;
    } else {
      return w * L + t;
    }
  };

  for (int e = tid; e < L * hd; e += THREADS) {
    const int t = e / hd, d = e - t * hd;
    const T* src = qkv + row(t) * (3LL * C) + (long long)h * hd + d;
    sq[t * hs + d] = to_f32(src[0]);
    sk[t * hs + d] = to_f32(src[C]);
    sv[t * hs + d] = to_f32(src[2 * C]);
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

  // softmax, a warp per row; L <= 64, so each lane holds columns lane, lane + 32
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < L; i += WARPS) {
    float* pr = sp + i * L;
    const bool has_a = lane < L, has_b = lane + 32 < L;
    const float a = has_a ? pr[lane] : -CUDART_INF_F;
    const float b = has_b ? pr[lane + 32] : -CUDART_INF_F;
    float m = fmaxf(a, b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float ea = has_a ? expf(a - m) : 0.f;
    const float eb = has_b ? expf(b - m) : 0.f;
    float sum = ea + eb;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float pa = ea / sum, pb = eb / sum;
    if constexpr (!IMAGE) {  // K7 rounds P to the compute dtype before P V
      pa = to_f32(from_f32<T>(pa));
      pb = to_f32(from_f32<T>(pb));
    }
    if (has_a) pr[lane] = pa;
    if (has_b) pr[lane + 32] = pb;
  }
  __syncthreads();

  for (int e = tid; e < L * hd; e += THREADS) {
    const int i = e / hd, d = e - i * hd;
    const float* pi = sp + i * L;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(pi[j], sv[j * hs + d], acc);
    out[row(i) * C + (long long)h * hd + d] = from_f32<T>(acc);
  }
}

template <typename T, bool IMAGE>
int launch(const void* qkv, const void* bias, const void* mask, void* out, long long nwin,
           int heads, int L, int C, float scale, int ntypes, int Hp, int Wp, int ws,
           cudaStream_t stream) {
  const int hd = C / heads;
  const size_t smem = (size_t)(3 * L * (hd + 1) + L * L) * sizeof(float);
  auto kern = window_attn_kernel<T, IMAGE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)nwin, (unsigned)heads);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out), L, C, hd, scale, ntypes, Hp,
      Wp, ws);
  return (int)cudaGetLastError();
}

}  // namespace

// K7.  qkv (nw, L, 3C) contiguous, bf16 (qkv_bf16 = 1) or f32; bias (heads, L, L)
// f32; mask (ntypes, L, L) f32 or null, nw a multiple of ntypes; out (nw, L, C) in
// qkv's dtype.
extern "C" int poly_window_attn_math(const void* qkv, int qkv_bf16, const void* bias,
                                     const void* mask, void* out, long long nw, int L,
                                     int C, int heads, int ntypes, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qkv_bf16)
    return launch<__nv_bfloat16, false>(qkv, bias, mask, out, nw, heads, L, C, scale,
                                        ntypes, 0, 0, 0, st);
  return launch<float, false>(qkv, bias, mask, out, nw, heads, L, C, scale, ntypes, 0, 0,
                              0, st);
}

// K8.  qkv (B, Hp, Wp, 3C) contiguous with Hp and Wp multiples of ws; bias
// (heads, ws*ws, ws*ws) f32; mask (Hp/ws * Wp/ws, ws*ws, ws*ws) f32 or null, the
// same for every image; out (B, Hp, Wp, C) in qkv's dtype.
extern "C" int poly_window_attention(const void* qkv, int qkv_bf16, const void* bias,
                                     const void* mask, void* out, int B, int Hp, int Wp,
                                     int C, int heads, int ws, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_image = (Hp / ws) * (Wp / ws);
  const long long nwin = (long long)B * per_image;
  if (qkv_bf16)
    return launch<__nv_bfloat16, true>(qkv, bias, mask, out, nwin, heads, ws * ws, C, scale,
                                       per_image, Hp, Wp, ws, st);
  return launch<float, true>(qkv, bias, mask, out, nwin, heads, ws * ws, C, scale,
                             per_image, Hp, Wp, ws, st);
}

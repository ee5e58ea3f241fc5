// Exact integer-factor bilinear upsample (align_corners=False, edge
// replication), f32, forward only.
//
// Replaces polyphonicformer_tpu/ops/pallas/upsample2.py::_call_fwd
// (upsample_int_pallas / upsample2_pallas).  On the H100 it is bound by
// device memory: each output element reads four inputs that sit in L1/L2 and
// writes one f32, about 145 MB per frame on the serving path.  One thread per
// output element: the row pass and then the column pass of
// polyphonicformer_tpu/ops/resize.py::_upsample_int_factor_1d, evaluated for
// the element's two source columns.  Every multiply and add is a separately
// rounded __fmul_rn / __fadd_rn, so nvcc cannot contract them into FMAs and
// the result is bit-equal to the plain version.
#include <cuda_runtime.h>

namespace {

// Phase p of factor f, as resize.py::_phase_weights computes it: the lerp
// weight in float64, rounded to f32 last.
__device__ __forceinline__ void phase(int p, int f, int& base, float& w0, float& w1) {
  const double src = (p + 0.5) / f - 0.5;
  const double fl = floor(src);
  const double lam = src - fl;
  base = (int)fl;
  w0 = (float)(1.0 - lam);
  w1 = (float)lam;
}

__device__ __forceinline__ float lerp(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

__global__ void upsample_int_fwd(const float* __restrict__ x, float* __restrict__ y,
                                 long long total, int h, int w, int fy, int fx) {
  const int ho = h * fy, wo = w * fx;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int ox = (int)(i % wo);
    const int oy = (int)((i / wo) % ho);
    const long long n = i / ((long long)wo * ho);
    int by, bx;
    float wy0, wy1, wx0, wx1;
    phase(oy % fy, fy, by, wy0, wy1);
    phase(ox % fx, fx, bx, wx0, wx1);
    const int iy = oy / fy, ix = ox / fx;
    const int r0 = min(max(iy + by, 0), h - 1), r1 = min(max(iy + by + 1, 0), h - 1);
    const int c0 = min(max(ix + bx, 0), w - 1), c1 = min(max(ix + bx + 1, 0), w - 1);
    const float* p = x + n * h * w;
    const float t0 = lerp(wy0, p[r0 * w + c0], wy1, p[r1 * w + c0]);
    const float t1 = lerp(wy0, p[r0 * w + c1], wy1, p[r1 * w + c1]);
    y[i] = lerp(wx0, t0, wx1, t1);
  }
}

}  // namespace

// x: (n, h, w) f32 contiguous -> y: (n, h*fy, w*fx) f32 contiguous.
extern "C" int poly_upsample_int(const void* x, void* y, long long n, int h, int w,
                                 int fy, int fx, void* stream) {
  const long long total = n * h * fy * (long long)w * fx;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 132LL * 64 ? want : 132LL * 64);
  upsample_int_fwd<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), total, h, w, fy, fx);
  return (int)cudaGetLastError();
}

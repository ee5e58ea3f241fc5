// Exact integer-factor bilinear upsample (align_corners=False, edge
// replication), f32, forward and backward.
//
// The forward replaces polyphonicformer_tpu/ops/pallas/upsample2.py::_call_fwd
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

// The backward replaces upsample2.py::_call_bwd: the transposed stencil of
// _down_axis, columns first and then rows, as the JAX kernel applies it.
// Bound by device memory: it reads the (n, fy*h, fx*w) gradient once and
// writes (n, h, w).  One thread per source pixel; it gathers the <= 2f taps
// per axis that reach it in the order of _down_axis, with the clamp terms
// at the first and last row and column (a tap beyond the edge reads 0, as
// the JAX halo of zeros does).  Each value of the column pass is recomputed
// by the up to three source rows that need it, from L1/L2.  The same
// __fmul_rn / __fadd_rn discipline makes it bit-equal to the plain version.

// Transposed stencil along one axis at source index j of n: g(k) reads
// the gradient at upsampled index k of this axis.
template <typename G>
__device__ __forceinline__ float down_axis(const G& g, int j, int n, int f) {
  float dx = 0.f;
  for (int p = 0; p < f; ++p) {
    int base;
    float w0, w1;
    phase(p, f, base, w0, w1);
    const float gp = g(j * f + p);
    if (base == -1) {  // out_p[i] = w0 x[i-1] + w1 x[i]; clamp at i = 0
      const float hi = j + 1 < n ? g((j + 1) * f + p) : 0.f;
      dx = __fadd_rn(__fadd_rn(dx, __fmul_rn(w1, gp)), __fmul_rn(w0, hi));
      dx = __fadd_rn(dx, j == 0 ? __fmul_rn(w0, gp) : 0.f);
    } else {  // out_p[i] = w0 x[i] + w1 x[i+1]; clamp at i = n-1
      const float lo = j > 0 ? g((j - 1) * f + p) : 0.f;
      dx = __fadd_rn(__fadd_rn(dx, __fmul_rn(w0, gp)), __fmul_rn(w1, lo));
      dx = __fadd_rn(dx, j == n - 1 ? __fmul_rn(w1, gp) : 0.f);
    }
  }
  return dx;
}

__global__ void upsample_int_bwd(const float* __restrict__ g, float* __restrict__ dx,
                                 long long total, int h, int w, int fy, int fx) {
  const int wo = w * fx;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int ix = (int)(i % w);
    const int iy = (int)((i / w) % h);
    const long long n = i / ((long long)w * h);
    const float* gn = g + n * h * fy * (long long)wo;
    // column pass of upsampled row r at source column ix
    const auto col = [&](int r) {
      const float* row = gn + (long long)r * wo;
      return down_axis([&](int k) { return row[k]; }, ix, w, fx);
    };
    dx[i] = down_axis(col, iy, h, fy);
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

// g: (n, h*fy, w*fx) f32 contiguous -> dx: (n, h, w) f32 contiguous.
extern "C" int poly_upsample_int_bwd(const void* g, void* dx, long long n, int h, int w,
                                     int fy, int fx, void* stream) {
  const long long total = n * h * (long long)w;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 132LL * 64 ? want : 132LL * 64);
  upsample_int_bwd<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(dx), total, h, w, fy, fx);
  return (int)cudaGetLastError();
}

// Exact integer-factor bilinear upsample (align_corners=False, edge
// replication), f32, forward and backward.
//
// The forward replaces polyphonicformer_tpu/ops/pallas/upsample2.py::_call_fwd
// (upsample_int_pallas / upsample2_pallas).  It is bound by device memory:
// it reads the (n, h, w) input once and writes the (n, fy*h, fx*w) output
// once, 72.7 MB at the serving x2 of (111, 128, 256), 21.7 us at 3.35 TB/s.
// So the design spends few instructions per byte:
// - the phase weights come from the host (ops/cuda/upsample2.py::
//   phase_weights, bit-equal to ops/resize.py::_phase_weights) as kernel
//   arguments, not recomputed per element in float64;
// - a 2-D grid gives 32-bit index math: blockIdx.z the image, blockIdx.y a
//   band of input rows, blockIdx.x a strip of columns;
// - each thread takes 4 source columns of one source row: it reads them
//   from the three source rows its output rows need with float4 loads (and
//   the one-column halo on each side with scalar loads that hit L1), does
//   the row pass of polyphonicformer_tpu/ops/resize.py::
//   _upsample_int_factor_1d for each of its fy output rows, then the column
//   pass, and writes fy rows of 4*fx values as float4 stores;
// - the factors of the serving and training paths (2 and 4) are template
//   specialisations; other factors in 1..8 take a loop.  Shapes whose width
//   is not a multiple of 4, or whose pointers are not 16-byte aligned, take
//   scalar loads and stores in the same kernel.
// Every multiply and add is a separately rounded __fmul_rn / __fadd_rn in
// the order of the plain version, so nvcc cannot contract them into FMAs
// and the result is bit-equal to it.
#include <cuda_runtime.h>

namespace {

// Phase p of factor f, as resize.py::_phase_weights computes it: the lerp
// weight in float64, rounded to f32 last.  (The backward's weights.)
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

constexpr int MAXF = 8;
constexpr int COLS = 4;          // source columns per thread
constexpr int TX = 32, TY = 8;   // threads per block: column groups x source rows

// Per phase of each axis: base offset (-1 or 0) and the two lerp weights.
struct Phases {
  int by[MAXF], bx[MAXF];
  float wy0[MAXF], wy1[MAXF], wx0[MAXF], wx1[MAXF];
};

struct UpArgs {
  const float* x;
  float* y;
  int h, w, fy, fx, vec;
  Phases ph;
};

// Row r (clamped) of image xn at source columns c-1 .. c+COLS (clamped):
// v[0] is the left halo, v[1..COLS] the thread's columns, v[COLS+1] the right.
__device__ __forceinline__ void load_row(float (&v)[COLS + 2], const float* xn, int r,
                                         int c, const UpArgs& a) {
  r = min(max(r, 0), a.h - 1);
  const float* row = xn + (long long)r * a.w;
  if (a.vec) {  // c + COLS <= w and 16-byte aligned rows
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + c));
    v[1] = q.x; v[2] = q.y; v[3] = q.z; v[4] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < COLS; ++i) v[1 + i] = __ldg(row + min(c + i, a.w - 1));
  }
  v[0] = __ldg(row + max(c - 1, 0));
  v[COLS + 1] = __ldg(row + min(c + COLS, a.w - 1));
}

template <int FY, int FX>
__global__ void __launch_bounds__(TX * TY) upsample_int_fwd(const UpArgs a) {
  const int fy = FY ? FY : a.fy, fx = FX ? FX : a.fx;
  const int c = (blockIdx.x * TX + threadIdx.x) * COLS;  // first source column
  const int iy = blockIdx.y * TY + threadIdx.y;          // source row
  if (c >= a.w || iy >= a.h) return;
  const int ncols = min(COLS, a.w - c);
  const float* xn = a.x + (long long)blockIdx.z * a.h * a.w;
  const int wo = a.w * fx;
  float* yn = a.y + (long long)blockIdx.z * a.h * fy * wo;

  // the three source rows any output row of this source row reads
  float up[COLS + 2], mid[COLS + 2], dn[COLS + 2];
  load_row(up, xn, iy - 1, c, a);
  load_row(mid, xn, iy, c, a);
  load_row(dn, xn, iy + 1, c, a);

#pragma unroll
  for (int py = 0; py < (FY ? FY : MAXF); ++py) {
    if (!FY && py >= fy) break;
    // row pass: taps (iy-1, iy) for base -1, (iy, iy+1) for base 0
    const bool lo = a.ph.by[py] == -1;
    const float wy0 = a.ph.wy0[py], wy1 = a.ph.wy1[py];
    float t[COLS + 2];
#pragma unroll
    for (int i = 0; i < COLS + 2; ++i)
      t[i] = lo ? lerp(wy0, up[i], wy1, mid[i]) : lerp(wy0, mid[i], wy1, dn[i]);
    float* yrow = yn + (long long)(iy * fy + py) * wo + c * fx;
    if (FX && a.vec) {
      // column pass into 4 * FX values, stored as float4
      float o[COLS * (FX ? FX : 1)];
#pragma unroll
      for (int i = 0; i < COLS; ++i)
#pragma unroll
        for (int px = 0; px < (FX ? FX : 1); ++px) {
          const float w0 = a.ph.wx0[px], w1 = a.ph.wx1[px];
          o[i * FX + px] = a.ph.bx[px] == -1 ? lerp(w0, t[i], w1, t[i + 1])
                                             : lerp(w0, t[i + 1], w1, t[i + 2]);
        }
#pragma unroll
      for (int q = 0; q < FX; ++q)
        reinterpret_cast<float4*>(yrow)[q] =
            make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    } else {
      for (int i = 0; i < ncols; ++i)
        for (int px = 0; px < fx; ++px) {
          const float w0 = a.ph.wx0[px], w1 = a.ph.wx1[px];
          yrow[i * fx + px] = a.ph.bx[px] == -1 ? lerp(w0, t[i], w1, t[i + 1])
                                                : lerp(w0, t[i + 1], w1, t[i + 2]);
        }
    }
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

// x: (n, h, w) f32 contiguous -> y: (n, h*fy, w*fx) f32 contiguous.  base_y,
// w_y: per row phase, the base offset and the weights (w0, w1); base_x, w_x
// the same per column phase (host arrays, ops/cuda/upsample2.py).
extern "C" int poly_upsample_int(const void* x, void* y, long long n, int h, int w, int fy,
                                 int fx, const int* base_y, const float* w_y, const int* base_x,
                                 const float* w_x, int vec, void* stream) {
  if (fy < 1 || fy > MAXF || fx < 1 || fx > MAXF || n > 65535) return (int)cudaErrorInvalidValue;
  UpArgs a{static_cast<const float*>(x), static_cast<float*>(y), h, w, fy, fx, vec, {}};
  for (int p = 0; p < fy; ++p) {
    a.ph.by[p] = base_y[p];
    a.ph.wy0[p] = w_y[2 * p];
    a.ph.wy1[p] = w_y[2 * p + 1];
  }
  for (int p = 0; p < fx; ++p) {
    a.ph.bx[p] = base_x[p];
    a.ph.wx0[p] = w_x[2 * p];
    a.ph.wx1[p] = w_x[2 * p + 1];
  }
  const dim3 block(TX, TY);
  const dim3 grid((w + TX * COLS - 1) / (TX * COLS), (h + TY - 1) / TY, (unsigned)n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fy == 2 && fx == 2)
    upsample_int_fwd<2, 2><<<grid, block, 0, st>>>(a);
  else if (fy == 4 && fx == 4)
    upsample_int_fwd<4, 4><<<grid, block, 0, st>>>(a);
  else
    upsample_int_fwd<0, 0><<<grid, block, 0, st>>>(a);
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

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
// weight in float64, rounded to f32 last.  (The generic backward's weights.)
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
// writes (n, h, w), 291 MB at the training shape (444, 256, 512) -> (444,
// 128, 256), 86.9 us at 3.35 TB/s.  The forward's layout, transposed:
// - a 3-D grid with 32-bit index math: blockIdx.z the image, blockIdx.y a
//   band of BAND * BTY source rows, blockIdx.x a strip of TX * COLS source
//   columns;
// - each thread takes COLS = 4 source columns over BAND = 2 source rows.
//   (Longer bands repeat fewer column passes but leave fewer loads in
//   flight: at the training shape bands of 8 rows were slower.)  It
//   walks down the gradient rows its band needs, (BAND + 2) * f of them
//   (one source row of halo above and below), loading each once: 4f
//   values with float4 loads and the one-phase halo on each side with
//   scalar loads that hit L1;
// - it does the column pass of each gradient row once, as soon as the row
//   is loaded, and keeps the result in registers for the three source rows
//   that read it (the loop is unrolled, so the rows live in registers);
// - the row pass of each source row then reads only registers, and the 4
//   results go out as one float4 store;
// - the phase weights come from the host (the forward's table), factors 2
//   and 4 are template specialisations, and a phase's base offset (-1 for
//   the first f/2 phases, 0 for the rest) is a constant.  Widths that are
//   not a multiple of 4, or pointers that are not 16-byte aligned, take
//   scalar loads and stores in the same kernel; other factors in 1..8 take
//   the generic kernel below.
// Every tap is added in _down_axis's order with __fmul_rn / __fadd_rn,
// including the adds of 0 beyond the edge and of the clamp terms, so the
// result is bit-equal to the plain version: a column-pass value is the
// same number whether it is computed once or three times.

constexpr int BAND = 2;  // source rows per thread
constexpr int BTY = 4;   // threads per block along the rows

struct DownArgs {
  const float* g;
  float* dx;
  int h, w, vec;
  Phases ph;
};

// One source index j of n along an axis of factor F: the transposed stencil
// over the F phases of j and of its neighbours.  at(q, p) reads the
// gradient at phase p of source index j + q, q in {-1, 0, 1}.
template <int F, typename At>
__device__ __forceinline__ float down_taps(const At& at, int j, int n, const float (&w0)[MAXF],
                                           const float (&w1)[MAXF]) {
  float dx = 0.f;
#pragma unroll
  for (int p = 0; p < F; ++p) {
    const float gp = at(0, p);
    if (p < F / 2) {  // base -1: out_p[i] = w0 x[i-1] + w1 x[i]; clamp at i = 0
      const float hi = j + 1 < n ? at(1, p) : 0.f;
      dx = __fadd_rn(__fadd_rn(dx, __fmul_rn(w1[p], gp)), __fmul_rn(w0[p], hi));
      dx = __fadd_rn(dx, j == 0 ? __fmul_rn(w0[p], gp) : 0.f);
    } else {  // base 0: out_p[i] = w0 x[i] + w1 x[i+1]; clamp at i = n-1
      const float lo = j > 0 ? at(-1, p) : 0.f;
      dx = __fadd_rn(__fadd_rn(dx, __fmul_rn(w0[p], gp)), __fmul_rn(w1[p], lo));
      dx = __fadd_rn(dx, j == n - 1 ? __fmul_rn(w1[p], gp) : 0.f);
    }
  }
  return dx;
}

// The column pass of gradient row r (clamped) at source columns c .. c+3.
template <int F>
__device__ __forceinline__ void col_pass(float (&out)[COLS], const float* gn, int r,
                                         int rows, int c, const DownArgs& a) {
  const int wo = a.w * F;
  const float* row = gn + min(max(r, 0), rows - 1) * wo;
  // seg[(i + 1) * F + p]: phase p of source column c + i, i in -1 .. COLS
  float seg[(COLS + 2) * F];
  if (a.vec) {  // c + COLS <= w and 16-byte aligned rows
#pragma unroll
    for (int q = 0; q < F; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + c * F) + q);
      seg[F + 4 * q] = v.x; seg[F + 4 * q + 1] = v.y;
      seg[F + 4 * q + 2] = v.z; seg[F + 4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < COLS * F; ++k) {
      const int col = c * F + k;
      seg[F + k] = col < wo ? __ldg(row + col) : 0.f;
    }
  }
  // halo: the base-0 phases of column c-1, the base -1 phases of c+COLS
#pragma unroll
  for (int p = F / 2; p < F; ++p) seg[p] = c > 0 ? __ldg(row + (c - 1) * F + p) : 0.f;
#pragma unroll
  for (int p = 0; p < F / 2; ++p) {
    const int col = (c + COLS) * F + p;
    seg[(COLS + 1) * F + p] = col < wo ? __ldg(row + col) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < COLS; ++i)
    out[i] = down_taps<F>([&](int q, int p) { return seg[(i + 1 + q) * F + p]; }, c + i, a.w,
                          a.ph.wx0, a.ph.wx1);
}

template <int F>
__global__ void __launch_bounds__(TX * BTY) upsample_int_bwd_band(const DownArgs a) {
  const int c = (blockIdx.x * TX + threadIdx.x) * COLS;              // first source column
  const int r0 = (blockIdx.y * BTY + threadIdx.y) * BAND;            // first source row
  if (c >= a.w || r0 >= a.h) return;
  const int rows = a.h * F;
  const float* gn = a.g + (long long)blockIdx.z * rows * (a.w * F);
  float* dn = a.dx + (long long)blockIdx.z * a.h * a.w;
  const int ncols = min(COLS, a.w - c);
  // cp[k]: the column pass of gradient row (r0 - 1) * F + k
  float cp[(BAND + 2) * F][COLS];
#pragma unroll
  for (int k = 0; k < 2 * F; ++k) col_pass<F>(cp[k], gn, (r0 - 1) * F + k, rows, c, a);
#pragma unroll
  for (int b = 0; b < BAND; ++b) {
    const int j = r0 + b;
    if (j >= a.h) break;
#pragma unroll
    for (int k = 0; k < F; ++k)
      col_pass<F>(cp[(b + 2) * F + k], gn, (j + 1) * F + k, rows, c, a);
    float o[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i)
      o[i] = down_taps<F>([&](int q, int p) { return cp[(b + 1 + q) * F + p][i]; }, j, a.h,
                          a.ph.wy0, a.ph.wy1);
    float* out = dn + j * a.w + c;
    if (a.vec) {
      *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int i = 0; i < COLS; ++i)
        if (i < ncols) out[i] = o[i];
    }
  }
}

// The generic kernel, other factors in 1..8: one thread per source pixel,
// gathering the <= 2f taps per axis that reach it in the order of
// _down_axis with the weights recomputed per tap (phase()); each value of
// the column pass is recomputed by the up to three source rows that need it.

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

// The per-phase table of the host arrays (ops/cuda/upsample2.py::_phase_args).
void fill_phases(Phases& ph, int fy, int fx, const int* base_y, const float* w_y,
                 const int* base_x, const float* w_x) {
  for (int p = 0; p < fy; ++p) {
    ph.by[p] = base_y[p];
    ph.wy0[p] = w_y[2 * p];
    ph.wy1[p] = w_y[2 * p + 1];
  }
  for (int p = 0; p < fx; ++p) {
    ph.bx[p] = base_x[p];
    ph.wx0[p] = w_x[2 * p];
    ph.wx1[p] = w_x[2 * p + 1];
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
  fill_phases(a.ph, fy, fx, base_y, w_y, base_x, w_x);
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

// g: (n, h*fy, w*fx) f32 contiguous -> dx: (n, h, w) f32 contiguous; the
// phase tables as for poly_upsample_int; vec: w a multiple of 4 and both
// pointers 16-byte aligned.
extern "C" int poly_upsample_int_bwd(const void* g, void* dx, long long n, int h, int w,
                                     int fy, int fx, const int* base_y, const float* w_y,
                                     const int* base_x, const float* w_x, int vec,
                                     void* stream) {
  if (fy < 1 || fy > MAXF || fx < 1 || fx > MAXF || n > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fy == fx && (fy == 2 || fy == 4)) {
    DownArgs a{static_cast<const float*>(g), static_cast<float*>(dx), h, w, vec, {}};
    fill_phases(a.ph, fy, fx, base_y, w_y, base_x, w_x);
    const dim3 block(TX, BTY);
    const dim3 grid((w + TX * COLS - 1) / (TX * COLS), (h + BAND * BTY - 1) / (BAND * BTY),
                    (unsigned)n);
    if (fy == 2)
      upsample_int_bwd_band<2><<<grid, block, 0, st>>>(a);
    else
      upsample_int_bwd_band<4><<<grid, block, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  const long long total = n * h * (long long)w;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 132LL * 64 ? want : 132LL * 64);
  upsample_int_bwd<<<blocks, threads, 0, st>>>(static_cast<const float*>(g),
                                               static_cast<float*>(dx), total, h, w, fy, fx);
  return (int)cudaGetLastError();
}

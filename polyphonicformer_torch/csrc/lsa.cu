// Exact rectangular linear-sum assignment (Jonker-Volgenant shortest
// augmenting paths), one problem per warp.
//
// Replaces polyphonicformer_tpu/ops/pallas/lsa.py::solve_lsa_pallas
// (_lsa_kernel and the preparation in front of it).  costs (N, G, P) f32
// with G <= P, read through their strides (the assignment hands in a
// transposed view), valid (N, G) u8, read through its strides ->
// col4row (N, G) i32, -1 for invalid rows.
//
// On the H100 the work is a serial chain: one Dijkstra per valid row, each a
// chain of steps over the columns, and nothing else.  So the bound is
// latency, not bytes or operations (the bytes, G*P*4 per problem, and the
// flops are negligible): the longest problem's Dijkstra steps times one
// warp-wide argmin (tools/kernel_probe.py k5).  The design keeps every step
// inside one warp, in registers, with no barrier and no serial merge:
//   * Column j belongs to lane j % 32, slot j / 32.  A lane keeps its CPL =
//     ceil(P / 32) columns' v, shortest path cost (spc), predecessor row,
//     assigned row (row4col) and "remaining" flag (a bitmask) in registers;
//     spc, path and the flags are reset in registers for each row.  CPL is
//     a template parameter (ops/cuda/lsa.py::launch_plan).
//   * One step: row i and the path length min_val are uniform across the
//     warp.  Each lane relaxes its remaining columns from shared memory (32
//     consecutive words a slot: no bank conflict; the slots past P read a
//     pad and are ignored, so no slot branches), takes the least key of
//     its slots, and two __reduce_min_sync leave the warp's least key in
//     every lane: first the order-preserving bits of the value (-0.0 folded
//     onto +0.0), then, among the lanes that hold it, the low word column
//     << 11 | row4col[column] + 1, so ties go to the lowest column, as
//     lsa.py:56-58 breaks them, and the next row arrives with the column
//     (no read of row4col).  Two reductions took 0.086 us a step where five
//     __shfl_xor_sync rounds over the packed 64-bit key took 0.145 us.
//   * Per row: the rows scanned besides the root are the rows of the
//     popped columns other than the sink, so the dual update of u goes by
//     column (u[row4col[j]] += min_val - spc[j]: no scanned set, no gather),
//     beside that of v.  The warp then walks the augmenting path in step:
//     the owner of column j hands its predecessor row over with one
//     __shfl_sync and takes it as its row4col.  No barrier but __syncwarp.
//   * The raw costs of the valid rows arrive by 4-byte cp.async, all in
//     flight at once, with the lanes along the input's unit-stride
//     dimension (for the transposed view, a lane a row).  Invalid rows are
//     never reached by a Dijkstra (a scanned row is the root or a matched
//     row), so they are not loaded.  The preparation of solve_lsa_pallas
//     (lsa.py:143-144: NaN -> 1e8, +-inf -> +-1e8) is applied to each cost
//     as a step reads it: two min/max and a select (a separate pass over
//     the rows after the copy cost more at the train step's problems).
//     The valid rows come from one ballot of `valid` into a bitmask.
//   * The cost matrix sits in shared memory with an odd row stride, so both
//     the row reads and the column-wise copies of a transposed input are
//     free of bank conflicts.
// Rows run in order 0..G-1, which is what the Pallas kernel computes (it
// runs invalid rows and discards their updates).  All arithmetic is the
// same chain of separately rounded f32 adds as ops/hungarian.py::solve_lsa
// (the __f*_rn intrinsics keep nvcc from fusing them).
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr float INF = 1e30f;
constexpr float FLT_MAX_F = 3.402823466e38f;
constexpr unsigned FULL = 0xffffffffu;

// The row stride of the cost matrix in shared memory (odd).
__host__ __device__ inline int row_stride(int P) { return P | 1; }

// Words past the last cost row that a lane's slots beyond P read (and
// ignore), so that every slot reads shared memory without a branch.
__host__ __device__ inline int row_pad(int P, int CPL) { return 32 * CPL - P; }

// Shared memory of one problem (ops/cuda/lsa.py::launch_plan): the costs
// and their pad, u (G), col4row (G) and the valid bitmask (ceil(G / 32)
// words).
__host__ __device__ inline int smem_bytes(int G, int P, int CPL) {
  return 4 * (G * row_stride(P) + row_pad(P, CPL) + 2 * G + (G + 31) / 32);
}

// The order-preserving bits of x, -0.0 folded onto +0.0 (x + 0.0 in
// round-to-nearest): a < b as floats iff ordered(a) < ordered(b).
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.f));
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// nan_to_num(x, nan=1e8, posinf=1e8, neginf=-1e8): fminf takes the number
// when one side is NaN
__device__ __forceinline__ float prepare(float x) {
  return fabsf(x) <= FLT_MAX_F ? x : fmaxf(fminf(x, 1e8f), -1e8f);
}

__device__ __forceinline__ bool is_valid(const unsigned* vbits, int g) {
  return (vbits[g >> 5] >> (g & 31)) & 1u;
}

// A 4-byte asynchronous copy from global to shared memory if `on`.
__device__ __forceinline__ void copy4(bool on, float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n @p cp.async.ca.shared.global [%1], [%2], 4;\n}\n"
      ::"r"((int)on), "r"(d), "l"(src) : "memory");
}

// The raw costs of the valid rows into shared memory (row stride PS) by
// 4-byte asynchronous copies, the lanes along the input's unit-stride
// dimension, every copy in flight at once.
template <int CPL>
__device__ __forceinline__ void load_costs(float* cost, int PS, const float* __restrict__ c,
                                           long long sg, long long sp, int G, int P,
                                           const unsigned* vbits, int lane) {
  const int NW = (G + 31) / 32;
  if (sg == 1 && sp != 1) {  // a transposed view: a lane a row
    for (int w = 0; w < NW; ++w) {
      if (!vbits[w]) continue;  // no valid row among these 32
      const int g = w * 32 + lane;
      const bool on = is_valid(vbits, g);
      const float* src = c + g;
      float* dst = cost + g * PS;
#pragma unroll 4
      for (int p = 0; p < P; ++p) copy4(on, dst + p, src + p * sp);
    }
  } else {  // a lane a column
    for (int w = 0; w < NW; ++w) {
      for (unsigned bits = vbits[w]; bits; bits &= bits - 1) {
        const int g = w * 32 + __ffs(bits) - 1;
#pragma unroll
        for (int s = 0; s < CPL; ++s) {
          const int p = s * 32 + lane;
          copy4(p < P, cost + g * PS + p, c + g * sg + p * sp);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int CPL>
__global__ void __launch_bounds__(32) lsa_kernel(const float* __restrict__ costs, long long sn,
                                                 long long sg, long long sp,
                                                 const unsigned char* __restrict__ valid,
                                                 long long svn, long long svg,
                                                 int* __restrict__ out, int G, int P) {
  extern __shared__ float smem[];
  const int PS = row_stride(P);
  const int NW = (G + 31) / 32;
  float* cost = smem;                      // (G, PS) and the pad
  float* u = cost + G * PS + row_pad(P, CPL);  // (G)
  int* col4row = (int*)(u + G);            // (G)
  unsigned* vbits = (unsigned*)(col4row + G);  // (NW)

  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  for (int w = 0; w < NW; ++w) {
    const int e = w * 32 + lane;
    const unsigned b = __ballot_sync(FULL, e < G && valid[n * svn + e * svg]);
    if (lane == 0) vbits[w] = b;
  }
  for (int e = lane; e < G; e += 32) {
    u[e] = 0.f;
    col4row[e] = -1;
  }
  // the lane's columns j = s * 32 + lane: v, and the key's low word for
  // each, j << 11 | (the row assigned to j) + 1
  unsigned live = 0;  // slots that hold a column
  float v[CPL];
  unsigned jrow[CPL];
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    if (s * 32 + lane < P) live |= 1u << s;
    v[s] = 0.f;
    jrow[s] = static_cast<unsigned>(s * 32 + lane) << 11;
  }
  __syncwarp();
  load_costs<CPL>(cost, PS, costs + n * sn, sg, sp, G, P, vbits, lane);
  __syncwarp();

  for (int w = 0; w < NW; ++w) {
    for (unsigned bits = vbits[w]; bits; bits &= bits - 1) {
      const int cur = w * 32 + __ffs(bits) - 1;
      float spc[CPL];
      int path[CPL];
#pragma unroll
      for (int s = 0; s < CPL; ++s) {
        spc[s] = INF;
        path[s] = -1;
      }
      unsigned rem = live;
      int i = cur, sink;
      float min_val = 0.f;

      // Dijkstra from row `cur` until an unassigned column is reached
      while (true) {
        const float ui = u[i];
        const float* row = cost + i * PS + lane;
        float r[CPL];
        unsigned ord[CPL];  // ordered(spc) of the remaining columns, all ones for the others
#pragma unroll
        for (int s = 0; s < CPL; ++s) {
          r[s] = __fsub_rn(__fsub_rn(__fadd_rn(min_val, prepare(row[s * 32])), ui), v[s]);
        }
#pragma unroll
        for (int s = 0; s < CPL; ++s) {
          const bool better = (rem & (1u << s)) && r[s] < spc[s];
          spc[s] = better ? r[s] : spc[s];
          path[s] = better ? i : path[s];
          ord[s] = rem & (1u << s) ? ordered(spc[s]) : ~0u;
        }
        // the lane's least value and the low word of its first column
        unsigned m = ord[0];
#pragma unroll
        for (int s = 1; s < CPL; ++s) m = min(m, ord[s]);
        unsigned low = 0;
#pragma unroll
        for (int s = CPL - 1; s >= 0; --s) low = ord[s] == m ? jrow[s] : low;
        const unsigned mm = __reduce_min_sync(FULL, m);
        const unsigned lw = __reduce_min_sync(FULL, m == mm ? low : ~0u);
        const int j = static_cast<int>(lw >> 11);
        const int next = static_cast<int>(lw & 0x7ffu) - 1;
        min_val = from_ordered(mm);
        const unsigned popped_now = lane == (j & 31) ? 1u << (j >> 5) : 0u;
        rem &= ~popped_now;
        if (next < 0) {
          sink = j;
          break;
        }
        i = next;
      }

      // dual updates over the popped columns (the rows scanned besides cur
      // are their rows)
      const unsigned popped = live & ~rem;
#pragma unroll
      for (int s = 0; s < CPL; ++s) {
        if ((popped >> s) & 1u) {
          const float d = __fsub_rn(min_val, spc[s]);
          v[s] = __fsub_rn(v[s], d);
          const int e = static_cast<int>(jrow[s] & 0x7ffu) - 1;
          if (e >= 0) u[e] = __fadd_rn(u[e], d);
        }
      }
      if (lane == 0) u[cur] = __fadd_rn(u[cur], min_val);
      // the augmentation along the path, all lanes in step: the owner of
      // column j gives its predecessor row r and takes r as its row
      int j = sink;
      while (true) {
        const unsigned slot = 1u << (j >> 5);
        int pj = -1;
#pragma unroll
        for (int s = 0; s < CPL; ++s) pj = (slot >> s) & 1u ? path[s] : pj;
        const int r = __shfl_sync(FULL, pj, j & 31);
        const unsigned mine = lane == (j & 31) ? slot : 0u;
#pragma unroll
        for (int s = 0; s < CPL; ++s) {
          jrow[s] = (mine >> s) & 1u ? (jrow[s] & ~0x7ffu) | static_cast<unsigned>(r + 1) : jrow[s];
        }
        const int nj = col4row[r];
        __syncwarp();
        if (lane == 0) col4row[r] = j;
        if (r == cur) break;
        j = nj;
      }
      __syncwarp();
    }
  }
  for (int e = lane; e < G; e += 32) {
    out[(long long)n * G + e] = is_valid(vbits, e) ? col4row[e] : -1;
  }
}

// The dynamic shared memory each instance and device may use so far
// (cudaFuncSetAttribute once per instance and size, not once per launch).
constexpr int MAX_DEVICES = 64;
std::atomic<int> smem_set[6][MAX_DEVICES];

template <int CPL>
int launch(int slot, const float* costs, long long sn, long long sg, long long sp,
           const unsigned char* valid, long long svn, long long svg, int* out, int n, int G,
           int P, cudaStream_t stream) {
  const int smem = smem_bytes(G, P, CPL);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (smem_set[slot][dev].load() < smem) {
      err = cudaFuncSetAttribute(lsa_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      int seen = smem_set[slot][dev].load();
      while (seen < smem && !smem_set[slot][dev].compare_exchange_weak(seen, smem)) {
      }
    }
  }
  lsa_kernel<CPL><<<n, 32, smem, stream>>>(costs, sn, sg, sp, valid, svn, svg, out, G, P);
  return (int)cudaGetLastError();
}

}  // namespace

// costs (n, G, P) f32 and valid (n, G) u8 with the given element strides,
// out (n, G) i32 contiguous; cpl = ops/cuda/lsa.py::launch_plan(G, P).cpl.
extern "C" int poly_lsa(const void* costs, long long sn, long long sg, long long sp,
                        const void* valid, long long svn, long long svg, void* out, int n,
                        int G, int P, int cpl, void* stream) {
  const float* c = static_cast<const float*>(costs);
  const unsigned char* vd = static_cast<const unsigned char*>(valid);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > P || P > 32 * cpl) return (int)cudaErrorInvalidValue;
  switch (cpl) {
    case 1: return launch<1>(0, c, sn, sg, sp, vd, svn, svg, o, n, G, P, st);
    case 2: return launch<2>(1, c, sn, sg, sp, vd, svn, svg, o, n, G, P, st);
    case 4: return launch<4>(2, c, sn, sg, sp, vd, svn, svg, o, n, G, P, st);
    case 8: return launch<8>(3, c, sn, sg, sp, vd, svn, svg, o, n, G, P, st);
    case 16: return launch<16>(4, c, sn, sg, sp, vd, svn, svg, o, n, G, P, st);
    case 32: return launch<32>(5, c, sn, sg, sp, vd, svn, svg, o, n, G, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

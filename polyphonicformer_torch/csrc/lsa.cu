// Exact rectangular linear-sum assignment (Jonker-Volgenant shortest
// augmenting paths), one problem per thread block.
//
// Replaces polyphonicformer_tpu/ops/pallas/lsa.py::solve_lsa_pallas
// (_lsa_kernel).  costs (N, G, P) f32 with G <= P, valid (N, G) u8 ->
// col4row (N, G) i32, -1 for invalid rows.  The caller has already set the
// costs of invalid rows to 0 and clamped non-finite costs (+-1e8).
//
// On the H100 the work is a serial chain: one Dijkstra per valid row, each
// a chain of steps over the columns, and nothing else.  So the bound is
// latency, not bytes or operations (the bytes, G*P*4 per problem, and the
// flops are negligible).  The design keeps the whole problem state in
// shared memory and gives each column one thread: a step relaxes every
// remaining column in parallel and takes the minimum and its first
// (lowest) column index with warp shuffles and one pass over the warps'
// results, as lsa.py:56-58 breaks ties.  Rows run in order 0..G-1 and
// invalid rows are skipped, which is what the Pallas kernel computes (it
// runs them and discards their updates).  No column padding is needed:
// threads beyond P take no part.  All arithmetic is the same sequence of
// separately rounded f32 adds as ops/hungarian.py::solve_lsa.
#include <cuda_runtime.h>

namespace {

constexpr float INF = 1e30f;

struct ArgMin {
  float v;
  int j;
};

__device__ __forceinline__ ArgMin better(ArgMin a, ArgMin b) {
  return (b.v < a.v || (b.v == a.v && b.j < a.j)) ? b : a;
}

__device__ __forceinline__ ArgMin warp_argmin(ArgMin a) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMin o;
    o.v = __shfl_down_sync(0xffffffffu, a.v, off);
    o.j = __shfl_down_sync(0xffffffffu, a.j, off);
    a = better(a, o);
  }
  return a;
}

__global__ void lsa_kernel(const float* __restrict__ costs, const unsigned char* __restrict__ valid,
                           int* __restrict__ out, int G, int P) {
  extern __shared__ float smem[];
  float* cost = smem;              // (G, P)
  float* u = cost + G * P;         // (G)
  float* v = u + G;                // (P)
  float* spc = v + P;              // (P) shortest path costs
  int* path = (int*)(spc + P);     // (P) predecessor row per column
  int* row4col = path + P;         // (P)
  int* col4row = row4col + P;      // (G)
  int* remaining = col4row + G;    // (P) 1 while the column is unscanned
  int* scanned = remaining + P;    // (G) rows reached by this Dijkstra
  __shared__ ArgMin warp_best[32];
  __shared__ int s_i, s_sink;
  __shared__ float s_min;

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int nwarps = (blockDim.x + 31) / 32;
  const float* c = costs + (long long)n * G * P;
  for (int e = t; e < G * P; e += blockDim.x) cost[e] = c[e];
  for (int e = t; e < P; e += blockDim.x) {
    v[e] = 0.f;
    row4col[e] = -1;
  }
  for (int e = t; e < G; e += blockDim.x) {
    u[e] = 0.f;
    col4row[e] = -1;
  }
  __syncthreads();

  for (int cur = 0; cur < G; ++cur) {
    if (!valid[(long long)n * G + cur]) continue;  // uniform over the block
    for (int e = t; e < P; e += blockDim.x) {
      remaining[e] = 1;
      spc[e] = INF;
      path[e] = -1;
    }
    for (int e = t; e < G; e += blockDim.x) scanned[e] = 0;
    if (t == 0) {
      s_i = cur;
      s_sink = -1;
      s_min = 0.f;
    }
    __syncthreads();

    // Dijkstra from row `cur` until an unassigned column is reached
    while (true) {
      const int i = s_i;
      const float min_val = s_min;
      if (t == 0) scanned[i] = 1;
      ArgMin a = {INF, t};
      if (t < P && remaining[t]) {
        const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, cost[i * P + t]), u[i]), v[t]);
        if (r < spc[t]) {
          spc[t] = r;
          path[t] = i;
        }
        a.v = spc[t];
      }
      a = warp_argmin(a);
      if ((t & 31) == 0) warp_best[t >> 5] = a;
      __syncthreads();
      if (t == 0) {
        ArgMin b = warp_best[0];
        for (int wi = 1; wi < nwarps; ++wi) b = better(b, warp_best[wi]);
        s_min = b.v;
        remaining[b.j] = 0;
        if (row4col[b.j] < 0) {
          s_sink = b.j;
        } else {
          s_i = row4col[b.j];
        }
      }
      __syncthreads();
      if (s_sink >= 0) break;
    }

    // dual updates, then the augmentation along the path (serial)
    const float min_val = s_min;
    for (int e = t; e < G; e += blockDim.x) {
      if (e == cur) {
        u[e] = __fadd_rn(u[e], min_val);
      } else if (scanned[e]) {
        u[e] = __fadd_rn(u[e], __fsub_rn(min_val, spc[col4row[e]]));
      }
    }
    for (int e = t; e < P; e += blockDim.x) {
      if (!remaining[e]) v[e] = __fsub_rn(v[e], __fsub_rn(min_val, spc[e]));
    }
    __syncthreads();
    if (t == 0) {
      int j = s_sink;
      while (true) {
        const int i = path[j];
        row4col[j] = i;
        const int next = col4row[i];
        col4row[i] = j;
        j = next;
        if (i == cur) break;
      }
    }
    __syncthreads();
  }
  for (int e = t; e < G; e += blockDim.x) {
    out[(long long)n * G + e] = valid[(long long)n * G + e] ? col4row[e] : -1;
  }
}

// Shared memory of one problem (ops/cuda/lsa.py::smem_bytes).
int smem_bytes(int G, int P) { return (G * P + G + 2 * P) * 4 + (3 * P + 2 * G) * 4; }

}  // namespace

// costs (n, G, P) f32, valid (n, G) u8, out (n, G) i32, all contiguous.
extern "C" int poly_lsa(const void* costs, const void* valid, void* out, int n, int G, int P,
                        void* stream) {
  const int threads = ((P + 31) / 32) * 32;
  const int smem = smem_bytes(G, P);
  cudaError_t err = cudaFuncSetAttribute(lsa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  lsa_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(costs), static_cast<const unsigned char*>(valid),
      static_cast<int*>(out), G, P);
  return (int)cudaGetLastError();
}

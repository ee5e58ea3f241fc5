// Render the semantic, panoptic, depth and track maps from the fusion's
// per-pixel winning candidate by table lookup.
//
// Replaces polyphonicformer_tpu/ops/pallas/map_render.py::render_maps.  The
// TPU kernel packed keep/seg/label into one f32 code and contracted one-hot
// masks because the TPU has no fast per-pixel gather; the H100 has one, so
// the (K,) tables sit in shared memory and each thread looks up its pixel's
// integers directly.  The kernel is bound by device memory: 12 bytes read
// and 16 written per pixel, ~58 MB at 1024x2048.  A pixel whose winner lies
// outside [0, K) (the fusion's sentinel) renders void: semantic =
// num_classes, panoptic = 0, depth = depth_basic, track = 0.  Track ids are
// looked up regardless of keep: the caller gates them.
#include <cuda_runtime.h>

namespace {

__global__ void map_render_kernel(const int* __restrict__ pix, const float* __restrict__ depth_sel,
                                  const float* __restrict__ depth_basic,
                                  const int* __restrict__ labels, const int* __restrict__ seg_ids,
                                  const int* __restrict__ keep, const int* __restrict__ track,
                                  int K, int num_classes, long long total, int* __restrict__ sem,
                                  int* __restrict__ pan, float* __restrict__ dep,
                                  int* __restrict__ trk) {
  extern __shared__ int tab[];  // [4][K]: labels, seg_ids, keep, track
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    tab[i] = labels[i];
    tab[K + i] = seg_ids[i];
    tab[2 * K + i] = keep[i];
    tab[3 * K + i] = track[i];
  }
  __syncthreads();
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = pix[i];
    const bool in = k >= 0 && k < K;
    const bool kept = in && tab[2 * K + k] != 0;
    sem[i] = kept ? tab[k] : num_classes;
    pan[i] = kept ? tab[K + k] : 0;
    dep[i] = kept ? depth_sel[i] : depth_basic[i];
    trk[i] = in ? tab[3 * K + k] : 0;
  }
}

}  // namespace

// pix, depth_sel, depth_basic, sem, pan, dep, trk: (total,) contiguous;
// labels, seg_ids, keep, track: (K,) int32.
extern "C" int poly_map_render(const void* pix, const void* depth_sel, const void* depth_basic,
                               const void* labels, const void* seg_ids, const void* keep,
                               const void* track, int K, int num_classes, long long total,
                               void* sem, void* pan, void* dep, void* trk, void* stream) {
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 132LL * 16 ? want : 132LL * 16);
  map_render_kernel<<<blocks, threads, 4 * K * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pix), static_cast<const float*>(depth_sel),
      static_cast<const float*>(depth_basic), static_cast<const int*>(labels),
      static_cast<const int*>(seg_ids), static_cast<const int*>(keep),
      static_cast<const int*>(track), K, num_classes, total, static_cast<int*>(sem),
      static_cast<int*>(pan), static_cast<float*>(dep), static_cast<int*>(trk));
  return (int)cudaGetLastError();
}

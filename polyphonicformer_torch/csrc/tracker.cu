// One step of the quasi-dense embedding tracker for every clip of a serving
// step (K9): one thread block a clip.
//
// Replaces no Pallas kernel.  The JAX package leaves the tracker
// (polyphonicformer_tpu/infer/tracker.py::tracker_step) to XLA inside jit,
// where it is one fused program.  Run eagerly, its plain PyTorch version
// (infer/tracker.py::tracker_step) is ~1,650 launches of tiny ops a clip: a
// Python loop over the D detections of ~17 device ops each, then ~20
// scatters.  This kernel is the whole step of all B clips in one launch, so
// the host issues one call where it issued thousands.
//
// What bounds it on the H100: latency, not bytes or operations.  A clip
// touches ~0.4 MB (its state in and out, its detections: under 0.2 us at
// 3.35 TB/s), and its (D, T+BD) score products are ~3 MFLOP.  The greedy
// assignment is a serial chain: one argmax over the T+BD memo columns per
// valid detection, in score order, each depending on the columns the ones
// before it took; around it, each phase's loads wait on device memory.  The
// design keeps the chain short and inside one warp and keeps many loads in
// flight:
//   * The detections, the (D, D) IoU flags, the valid rows' embeddings and
//     the (D, T+BD) score matrix live in shared memory (~190 KB at D 64,
//     T 128, BD 64, E 256; ops/cuda/tracker.py::smem_bytes mirrors carve()).
//   * The stable descending sort is a rank by counting: the rank of i is
//     the number of j with key_j > key_i, or with equal keys and j < i.
//     Invalid rows carry -inf and sort last, in index order.  IoU is taken
//     only between valid rows (a warp a row), the only pairs whose flags
//     the plain version reads.
//   * Scores are computed for valid rows and valid memo columns only.  The
//     valid rows' embeddings, then the memo rows in chunks of 32, arrive in
//     shared memory by cp.async, 16 bytes a copy (the wrapper takes only E a
//     multiple of 4 and 16-byte aligned rows), the next chunk in flight while
//     the last is multiplied; each
//     thread accumulates up to 8 rows of one column (a warp shares its row:
//     broadcast reads).  Every other entry is 0, as the plain version masks
//     it.
//   * One greedy step is one warp argmax over all T+BD <= 256 columns (a
//     column a lane, 8 slots, the taken columns a bit mask in each
//     lane's registers): two __reduce_*_sync, first over the order-
//     preserving bits of the value (-0.0 folded onto +0.0), then the lowest
//     column among the lanes that hold it, as torch.argmax breaks ties; the
//     value comes back from the bits and the column's track id from its
//     lane by one shuffle, so no shared load waits in the chain.  Only the
//     valid rows take a step.
//   * Prefix counts (new ids, free slots first, new tracklets) and the
//     search of a row's slot are ballots in a warp.  The state's updates are
//     per slot: each slot takes the new tracklet placed in it, else the EMA
//     of its matched detection, else its old values, then expiry.  The
//     embedding rows go out as float4, 4 rows a warp with all their loads in
//     flight before the first store.
// Exact arithmetic: every float of the state (embeds EMA, boxes,
// velocities, backdrops) and the IoU tests are computed element by element
// with __f*_rn intrinsics (no FMA contraction), in the plain version's
// order and with its Python-float constants cast to f32, so they are bit-
// equal to it.  Only the scores (dot products, norms, softmax sums) round
// differently from cuBLAS and PyTorch's softmax; a decision can differ only
// where a score lies within rounding of a threshold or of a tie.  The
// output state is written out of place: the input state is never touched.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CW = 32;  // memo rows a staged chunk: a column a lane
constexpr int RPT = 8;  // detection rows a thread accumulates at once
constexpr int RW = 4;   // embedding rows a warp writes at once
constexpr int UPL = 2;  // float4s a lane loads of each such row
constexpr int SLOTS = 8;  // greedy columns a lane: T + BD <= 32 * SLOTS
constexpr unsigned FULL = 0xffffffffu;
constexpr int BISOFTMAX = 0, COSINE = 2;  // match metrics; 1 is softmax

struct Args {
  // input state, every field with a leading clip axis
  const int* ids;
  const float* embeds;
  const float* bboxes;
  const int* labels;
  const int* last_frame;
  const float* velocities;
  const int* acc_frames;
  const int* num_tracklets;
  const float* bd_embeds;
  const float* bd_bboxes;
  const int* bd_labels;
  const unsigned char* bd_valid;
  // detections
  const float* det_bboxes;
  const int* det_labels;
  const float* det_embeds;
  const unsigned char* det_valid;
  const int* frame_ids;
  // output state, then ids, order and kept
  int* o_ids;
  float* o_embeds;
  float* o_bboxes;
  int* o_labels;
  int* o_last_frame;
  float* o_velocities;
  int* o_acc_frames;
  int* o_num_tracklets;
  float* o_bd_embeds;
  float* o_bd_bboxes;
  int* o_bd_labels;
  unsigned char* o_bd_valid;
  int* o_det_ids;
  long long* o_order;
  unsigned char* o_kept;
  int D, T, BD, E, memo_frames, metric, with_cats;
  float init_thr, obj_thr, match_thr, keep_w, new_w, conf_thr, bd_iou_thr, class_iou_thr;
};

struct Smem {
  float *det, *memo, *S, *rmax, *rsum, *cmax, *csum, *box, *key;
  int *order, *label, *sid, *vrow, *slot, *upd, *neu, *tid, *fo, *vcol, *mlabel, *misc;
  unsigned char *valid0, *valid, *bdkeep, *flags, *mvalid;
};

// The shared memory of one clip, each array 16-byte aligned; with s null
// it only counts the bytes.  ops/cuda/tracker.py::smem_bytes mirrors it.
__host__ __device__ inline size_t carve(unsigned char* base, int D, int T, int BD, int E,
                                        Smem* s) {
  const int M = T + BD;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = s ? base + off : nullptr;
    off += (bytes + 15) & ~static_cast<size_t>(15);
    return p;
  };
  auto f = [&](size_t n) { return reinterpret_cast<float*>(take(4 * n)); };
  auto i = [&](size_t n) { return reinterpret_cast<int*>(take(4 * n)); };
  Smem t;
  t.det = f((size_t)D * E);
  t.memo = f((size_t)2 * CW * (E + 4));  // two chunks: one multiplied, one arriving
  t.S = f((size_t)D * M);
  t.rmax = f(D);
  t.rsum = f(D);
  t.cmax = f(M);
  t.csum = f(M);
  t.box = f(5 * D);
  t.key = f(D);
  t.order = i(D);
  t.label = i(D);
  t.sid = i(D);
  t.vrow = i(D);
  t.slot = i(D);
  t.upd = i(T);
  t.neu = i(T);
  t.tid = i(T);
  t.fo = i(T);
  t.vcol = i(M);
  t.mlabel = i(M);
  t.misc = i(2);  // the valid rows' and columns' counts
  t.valid0 = take(D);
  t.valid = take(D);
  t.bdkeep = take(D);
  t.flags = take((size_t)D * D);
  t.mvalid = take(M);
  if (s) *s = t;
  return off;
}

// The order-preserving bits of x, -0.0 folded onto +0.0: a < b as floats
// iff ordered(a) < ordered(b) (NaN excepted); unordered() inverts it.
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// An asynchronous copy of 16 bytes from device to shared memory; a block's
// copies stay in flight until it waits for their group.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// torch.clamp(x, min=0.0)
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

// infer/tracker.py::bbox_iou of rows a and b, operation by operation
__device__ float iou(const float* a, const float* b) {
  const float iw = clamp0(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])));
  const float ih = clamp0(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])));
  const float inter = __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(clamp0(__fsub_rn(a[2], a[0])), clamp0(__fsub_rn(a[3], a[1])));
  const float area_b = __fmul_rn(clamp0(__fsub_rn(b[2], b[0])), clamp0(__fsub_rn(b[3], b[1])));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// In one warp: the exclusive count of the i < n before i with flag(i),
// handed to put(i, flag(i), count) for every i; returns the total.
template <class Flag, class Put>
__device__ int warp_scan(int n, Flag flag, Put put) {
  const int lane = threadIdx.x & 31;
  int total = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool f = i < n && flag(i);
    const unsigned m = __ballot_sync(FULL, f);
    if (i < n) put(i, f, total + __popc(m & ((1u << lane) - 1u)));
    total += __popc(m);
  }
  __syncwarp();
  return total;
}

// Rows of `rows` (stride `stride`, E used) divided by their L2 norms
// clamped to 1e-12, as the cosine metric normalises; a warp a row.
__device__ void normalize(float* rows, int n, int stride, int E) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n; r += WARPS) {
    float* row = rows + (size_t)r * stride;
    float ss = 0.0f;
    for (int k = lane; k < E; k += 32) ss = fmaf(row[k], row[k], ss);
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
    for (int k = lane; k < E; k += 32) row[k] = __fdiv_rn(row[k], nrm);
  }
}

// An output embedding row: a copy of row a, a copy of row b, the EMA
// keep_w * a + new_w * b, or b * kf (a backdrop masked by its keep flag).
enum RowOp { FROM_A, FROM_B, EMA, SCALED_B };
struct RowSrc {
  const float* a;
  const float* b;
  RowOp op;
  float kf;
};

__device__ __forceinline__ float combine(RowOp op, float a, float b, float kf, float keep_w,
                                         float new_w) {
  switch (op) {
    case FROM_A: return a;
    case FROM_B: return b;
    case EMA: return __fadd_rn(__fmul_rn(keep_w, a), __fmul_rn(new_w, b));
    default: return __fmul_rn(b, kf);
  }
}

__device__ __forceinline__ float4 combine(RowOp op, float4 a, float4 b, float kf, float keep_w,
                                          float new_w) {
  return make_float4(combine(op, a.x, b.x, kf, keep_w, new_w),
                     combine(op, a.y, b.y, kf, keep_w, new_w),
                     combine(op, a.z, b.z, kf, keep_w, new_w),
                     combine(op, a.w, b.w, kf, keep_w, new_w));
}

// Rows [0, n) of dst (E floats a row), row r made as src(r) says, in
// float4s: RW rows a warp, every load of them in flight before the first
// store.
template <class Src>
__device__ void write_rows(float* __restrict__ dst, int n, int E, Src src, float keep_w,
                           float new_w) {
  const int lane = threadIdx.x & 31, W = E / 4;
  for (int r0 = (threadIdx.x >> 5) * RW; r0 < n; r0 += WARPS * RW) {
    RowSrc rs[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i)
      rs[i] = r0 + i < n ? src(r0 + i) : RowSrc{nullptr, nullptr, FROM_A, 0.0f};
    for (int w0 = lane; w0 < W; w0 += 32 * UPL) {
      float4 va[RW][UPL] = {}, vb[RW][UPL] = {};
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int u = 0; u < UPL; ++u) {
          const int w = w0 + 32 * u;
          if (w < W && rs[i].a) va[i][u] = reinterpret_cast<const float4*>(rs[i].a)[w];
          if (w < W && rs[i].b) vb[i][u] = reinterpret_cast<const float4*>(rs[i].b)[w];
        }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int u = 0; u < UPL; ++u) {
          const int w = w0 + 32 * u;
          if (w < W && r0 + i < n)
            reinterpret_cast<float4*>(dst + (size_t)(r0 + i) * E)[w] =
                combine(rs[i].op, va[i][u], vb[i][u], rs[i].kf, keep_w, new_w);
        }
    }
  }
}

// The greedy assignment of the nv valid rows, in score order, by one warp:
// column c of the T + BD in lane c % 32, slot c / 32 (a compile-time count
// of slots, so that a lane's values, track ids and taken bits stay in
// registers).  Each step is a warp argmax over the columns not
// taken, ties to the lowest column; the next row's values are loaded while
// this one's reductions run.  Writes the rows' ids to s.sid.
__device__ void greedy(const Smem& s, const Args& a, int nv, int M, int T) {
  const int lane = threadIdx.x & 31;
  unsigned taken = 0;  // bit k: this lane's column lane + 32 k is taken
  int tids[SLOTS];
  float cur[SLOTS], nxt[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int c = lane + 32 * k;
    tids[k] = c < T ? s.tid[c] : -1;
    cur[k] = c < M ? s.S[c] : 0.0f;
  }
  for (int vi = 0; vi < nv; ++vi) {
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int c = lane + 32 * k;
      nxt[k] = vi + 1 < nv && c < M ? s.S[(vi + 1) * M + c] : 0.0f;
    }
    const int r = s.vrow[vi];
    const float score = s.box[r * 5 + 4];
    unsigned best = 0;
    int bc = INT_MAX, btid = -1;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int c = lane + 32 * k;
      const unsigned key = ordered((taken >> k) & 1 ? 0.0f : cur[k]);
      if (c < M && (bc == INT_MAX || key > best)) {
        best = key;
        bc = c;
        btid = tids[k];
      }
    }
    const unsigned kmax = __reduce_max_sync(FULL, best);
    const int col = __reduce_min_sync(FULL, best == kmax ? bc : INT_MAX);
    const float conf = unordered(kmax);
    const int tid = __shfl_sync(FULL, btid, col & 31);
    const bool matched = conf > a.match_thr && tid > -1;
    const bool take = matched && score > a.obj_thr;
    const bool suppress = matched && score <= a.obj_thr && conf > a.conf_thr;
    if (take && lane == (col & 31)) taken |= 1u << (col >> 5);
    if (lane == 0) s.sid[r] = take ? tid : (suppress ? -2 : -1);
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) cur[k] = nxt[k];
  }
}

__global__ void __launch_bounds__(THREADS) tracker_step_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, T = a.T, BD = a.BD, E = a.E, M = T + BD, ES = E + 4;
  Smem s;
  carve(smem, D, T, BD, E, &s);
  const int b = blockIdx.x, tix = threadIdx.x, lane = tix & 31, warp = tix >> 5;

  const int* __restrict__ ids_in = a.ids + (size_t)b * T;
  const float* __restrict__ emb_in = a.embeds + (size_t)b * T * E;
  const float* __restrict__ box_in = a.bboxes + (size_t)b * T * 5;
  const int* __restrict__ lab_in = a.labels + (size_t)b * T;
  const int* __restrict__ last_in = a.last_frame + (size_t)b * T;
  const float* __restrict__ vel_in = a.velocities + (size_t)b * T * 5;
  const int* __restrict__ acc_in = a.acc_frames + (size_t)b * T;
  const float* __restrict__ bdemb_in = a.bd_embeds + (size_t)b * BD * E;
  const float* __restrict__ bdbox_in = a.bd_bboxes + (size_t)b * BD * 5;
  const int* __restrict__ bdlab_in = a.bd_labels + (size_t)b * BD;
  const unsigned char* __restrict__ bdval_in = a.bd_valid + (size_t)b * BD;
  const float* __restrict__ dbox = a.det_bboxes + (size_t)b * D * 5;
  const int* __restrict__ dlab = a.det_labels + (size_t)b * D;
  const float* __restrict__ demb = a.det_embeds + (size_t)b * D * E;
  const unsigned char* __restrict__ dval = a.det_valid + (size_t)b * D;
  float* __restrict__ emb_out = a.o_embeds + (size_t)b * T * E;
  float* __restrict__ bdemb_out = a.o_bd_embeds + (size_t)b * BD * E;
  const int fid = a.frame_ids[b];
  const int num_in = a.num_tracklets[b];

  // 1. sort keys, the memo columns' validity, ids and labels, cleared tables
  for (int i = tix; i < D; i += THREADS) s.key[i] = dval[i] ? dbox[i * 5 + 4] : -INFINITY;
  for (int c = tix; c < M; c += THREADS) {
    s.mlabel[c] = c < T ? lab_in[c] : bdlab_in[c - T];
    s.mvalid[c] = c < T ? ids_in[c] >= 0 : bdval_in[c - T] != 0;
  }
  for (int t = tix; t < T; t += THREADS) {
    s.tid[t] = ids_in[t];
    s.upd[t] = -1;
    s.neu[t] = -1;
  }
  __syncthreads();

  // 2. stable descending sort by counting; the rows in score order
  for (int i = tix; i < D; i += THREADS) {
    const float ki = s.key[i];
    int rank = 0;
    for (int j = 0; j < D; ++j) {
      const float kj = s.key[j];
      rank += (kj > ki) || (kj == ki && j < i);
    }
    s.order[rank] = i;
  }
  __syncthreads();
  for (int p = tix; p < D; p += THREADS) {
    const int i = s.order[p];
    for (int k = 0; k < 5; ++k) s.box[p * 5 + k] = dbox[i * 5 + k];
    s.label[p] = dlab[i];
    s.valid0[p] = dval[i] != 0;
    s.sid[p] = -1;
    a.o_order[(size_t)b * D + p] = i;
  }
  __syncthreads();

  // 3. IoU of each valid row against every higher-ranked valid row: bit 0
  // over the row's duplicate threshold, bit 1 over the backdrop threshold
  // (the plain version reads a pair's flags only where both rows are
  // valid); a row with a duplicate is no longer valid
  for (int i = warp; i < D; i += WARPS) {
    const bool vi = s.valid0[i];
    const float thr = s.box[i * 5 + 4] < a.obj_thr ? a.bd_iou_thr : a.class_iou_thr;
    bool dup = false;
    for (int j = lane; j < D; j += 32) {
      unsigned char f = 0;
      if (vi && j < i && s.valid0[j]) {
        const float v = iou(&s.box[i * 5], &s.box[j * 5]);
        f = (v > thr ? 1 : 0) | (v > a.bd_iou_thr ? 2 : 0);
      }
      s.flags[i * D + j] = f;
      dup |= f & 1;
    }
    dup = __any_sync(FULL, dup);
    if (lane == 0) s.valid[i] = vi && !dup;
  }
  __syncthreads();

  // 4. the valid rows and the valid memo columns, in order
  if (warp == 0) {
    const int nv = warp_scan(
        D, [&](int p) { return s.valid[p] != 0; },
        [&](int p, bool f, int pos) { if (f) s.vrow[pos] = p; });
    const int mv = warp_scan(
        M, [&](int c) { return s.mvalid[c] != 0; },
        [&](int c, bool f, int pos) { if (f) s.vcol[pos] = c; });
    if (lane == 0) {
      s.misc[0] = nv;
      s.misc[1] = mv;
    }
  }
  __syncthreads();
  const int nv = s.misc[0], mv = s.misc[1];

  if (nv > 0 && mv > 0) {
    // 5. scores of the valid rows against the valid columns
    for (int q = tix; q < nv * M; q += THREADS) s.S[q] = 0.0f;
    for (int q = tix; q < nv * (E / 4); q += THREADS) {
      const int vi = q / (E / 4), k = 4 * (q - vi * (E / 4));
      copy16(&s.det[vi * E + k], demb + (size_t)s.order[s.vrow[vi]] * E + k);
    }
    commit_async();
    // memo rows c0 .. c0 + 31 of the valid columns into buf
    auto stage = [&](int c0, float* buf) {
      const int nc = min(CW, mv - c0);
      for (int q = tix; q < nc * (E / 4); q += THREADS) {
        const int cc = q / (E / 4), k = 4 * (q - cc * (E / 4)), c = s.vcol[c0 + cc];
        copy16(&buf[cc * ES + k],
               c < T ? emb_in + (size_t)c * E + k : bdemb_in + (size_t)(c - T) * E + k);
      }
      commit_async();
    };
    stage(0, s.memo);
    wait_async<1>();  // the detection rows
    __syncthreads();
    if (a.metric == COSINE) {
      normalize(s.det, nv, E, E);
      __syncthreads();
    }
    for (int c0 = 0, chunk = 0; c0 < mv; c0 += CW, ++chunk) {
      float* buf = s.memo + (chunk & 1) * CW * ES;
      const int nc = min(CW, mv - c0);
      if (c0 + CW < mv) {  // the next chunk arrives while this one is multiplied
        stage(c0 + CW, s.memo + ((chunk + 1) & 1) * CW * ES);
        wait_async<1>();
      } else {
        wait_async<0>();
      }
      __syncthreads();
      if (a.metric == COSINE) {
        normalize(buf, nc, ES, E);
        __syncthreads();
      }
      const float4* m4 = reinterpret_cast<const float4*>(buf + (lane < nc ? lane : 0) * ES);
      for (int r0 = warp; r0 < nv; r0 += WARPS * RPT) {
        const int nq = min(RPT, (nv - r0 + WARPS - 1) / WARPS);  // uniform in the warp
        float acc[RPT];
#pragma unroll
        for (int q = 0; q < RPT; ++q) acc[q] = 0.0f;
        for (int k4 = 0; k4 < E / 4; ++k4) {
          const float4 m = m4[k4];
#pragma unroll
          for (int q = 0; q < RPT; ++q) {
            if (q < nq) {
              const float4 d = reinterpret_cast<const float4*>(s.det + (r0 + WARPS * q) * E)[k4];
              acc[q] = fmaf(d.x, m.x, acc[q]);
              acc[q] = fmaf(d.y, m.y, acc[q]);
              acc[q] = fmaf(d.z, m.z, acc[q]);
              acc[q] = fmaf(d.w, m.w, acc[q]);
            }
          }
        }
        if (lane < nc) {
          const int c = s.vcol[c0 + lane];
#pragma unroll
          for (int q = 0; q < RPT; ++q)
            if (q < nq) s.S[(r0 + WARPS * q) * M + c] = acc[q];
        }
      }
      __syncthreads();  // before the next chunk is staged into this buffer
    }

    // the softmax statistics: a warp a row, a thread a column
    if (a.metric != COSINE) {
      for (int vi = warp; vi < nv; vi += WARPS) {
        const float* row = s.S + vi * M;
        float mx = -INFINITY;
        for (int j = lane; j < mv; j += 32) mx = fmaxf(mx, row[s.vcol[j]]);
        mx = warp_max(mx);
        float sm = 0.0f;
        for (int j = lane; j < mv; j += 32) sm += expf(row[s.vcol[j]] - mx);
        sm = warp_sum(sm);
        if (lane == 0) {
          s.rmax[vi] = mx;
          s.rsum[vi] = sm;
        }
      }
      if (a.metric == BISOFTMAX) {
        for (int j = tix; j < mv; j += THREADS) {
          const int c = s.vcol[j];
          float mx = -INFINITY, sm = 0.0f;
          for (int vi = 0; vi < nv; ++vi) mx = fmaxf(mx, s.S[vi * M + c]);
          for (int vi = 0; vi < nv; ++vi) sm += expf(s.S[vi * M + c] - mx);
          s.cmax[j] = mx;
          s.csum[j] = sm;
        }
      }
      __syncthreads();
    }
    for (int vi = warp; vi < nv; vi += WARPS) {
      float* row = s.S + vi * M;
      const int label = s.label[s.vrow[vi]];
      for (int j = lane; j < mv; j += 32) {
        const int c = s.vcol[j];
        const float x = row[c];
        float v = x;  // cosine: the product of the normalised rows
        if (a.metric != COSINE) {
          v = expf(x - s.rmax[vi]) / s.rsum[vi];
          if (a.metric == BISOFTMAX)
            v = __fmul_rn(__fadd_rn(v, expf(x - s.cmax[j]) / s.csum[j]), 0.5f);
        }
        if (a.with_cats && label != s.mlabel[c]) v = __fmul_rn(v, 0.0f);
        row[c] = v;
      }
    }
    __syncthreads();

    // 6. greedy assignment in score order, one warp argmax a valid row
    if (warp == 0) greedy(s, a, nv, M, T);
  }
  __syncthreads();

  // 7. fresh ids for confident unmatched rows
  if (warp == 0) {
    const int fresh = warp_scan(
        D, [&](int p) { return s.sid[p] == -1 && s.box[p * 5 + 4] > a.init_thr && s.valid[p]; },
        [&](int p, bool f, int pos) {
          if (f) s.sid[p] = (int)((unsigned)num_in + (unsigned)pos);
        });
    if (lane == 0) a.o_num_tracklets[b] = (int)((unsigned)num_in + (unsigned)fresh);
  }
  __syncthreads();

  // 8. the slot of each tracked row already in the table: its id's first
  // slot, a warp a row
  for (int p = warp; p < D; p += WARPS) {
    const int id = s.sid[p];
    int slot = -1;
    for (int t0 = 0; id > -1 && slot < 0 && t0 < T; t0 += 32) {
      const unsigned m = __ballot_sync(FULL, t0 + lane < T && s.tid[t0 + lane] == id);
      if (m) slot = t0 + __ffs(m) - 1;
    }
    if (lane == 0) {
      s.slot[p] = slot;
      if (slot >= 0) s.upd[slot] = p;
    }
  }
  __syncthreads();
  // new tracklets into the free slots first, then the occupied ones, each in
  // slot order (a stable argsort of ids >= 0)
  if (warp == 0) {
    const int nfree = warp_scan(
        T, [&](int t) { return s.tid[t] < 0; },
        [&](int t, bool f, int pos) { if (f) s.fo[pos] = t; });
    warp_scan(
        T, [&](int t) { return s.tid[t] >= 0; },
        [&](int t, bool f, int pos) { if (f) s.fo[nfree + pos] = t; });
    warp_scan(
        D, [&](int p) { return s.sid[p] > -1 && s.slot[p] < 0; },
        [&](int p, bool f, int pos) { if (f) s.neu[s.fo[pos]] = p; });
  }
  __syncthreads();

  // 9. the tracklet table, slot by slot: a new tracklet, else the update
  // of its matched row, else the old values; then expiry
  for (int t = tix; t < T; t += THREADS) {
    const int n = s.neu[t], u = s.upd[t];
    int id = s.tid[t], lab = lab_in[t], last = last_in[t], acc = acc_in[t];
    if (n >= 0) {
      id = s.sid[n];
      lab = s.label[n];
      last = fid;
      acc = 0;
    } else if (u >= 0) {
      lab = s.label[u];
      last = fid;
      acc = acc_in[t] + 1;
    }
    const bool expired = id >= 0 && (int)((unsigned)fid - (unsigned)last) >= a.memo_frames;
    const size_t o = (size_t)b * T + t;
    a.o_ids[o] = expired ? -1 : id;
    a.o_labels[o] = lab;
    a.o_last_frame[o] = last;
    a.o_acc_frames[o] = acc;
    const int dt = max((int)((unsigned)fid - (unsigned)last_in[t]), 1);
    for (int k = 0; k < 5; ++k) {
      float bb = box_in[t * 5 + k], v = vel_in[t * 5 + k];
      if (n >= 0) {
        bb = s.box[n * 5 + k];
        v = 0.0f;
      } else if (u >= 0) {
        bb = s.box[u * 5 + k];
        const float vel = __fdiv_rn(__fsub_rn(bb, box_in[t * 5 + k]), (float)dt);
        v = __fdiv_rn(__fadd_rn(__fmul_rn(v, (float)acc_in[t]), vel), (float)(acc_in[t] + 1));
      }
      a.o_bboxes[o * 5 + k] = bb;
      a.o_velocities[o * 5 + k] = v;
    }
  }

  // 10. backdrops: this frame's unmatched rows that overlap no higher-ranked
  // valid row, newest block first; the older blocks shift down by D
  for (int p = tix; p < D; p += THREADS) {
    bool over = false;
    for (int j = 0; j < p; ++j) over |= (s.flags[p * D + j] & 2) && s.valid[j];
    const bool keep = s.sid[p] == -1 && s.valid[p] && !over;
    s.bdkeep[p] = keep;
    const size_t o = (size_t)b * D + p;
    a.o_det_ids[o] = s.sid[p];
    a.o_kept[o] = s.valid[p];
    a.o_bd_labels[(size_t)b * BD + p] = keep ? s.label[p] : -999;
    a.o_bd_valid[(size_t)b * BD + p] = keep;
  }
  for (int p = tix; p < BD - D; p += THREADS) {
    a.o_bd_labels[(size_t)b * BD + D + p] = bdlab_in[p];
    a.o_bd_valid[(size_t)b * BD + D + p] = bdval_in[p];
  }
  __syncthreads();
  float* __restrict__ bdbox_out = a.o_bd_bboxes + (size_t)b * BD * 5;
  for (int q = tix; q < D * 5; q += THREADS)
    bdbox_out[q] = __fmul_rn(s.box[q], s.bdkeep[q / 5] ? 1.0f : 0.0f);
  for (int q = tix; q < (BD - D) * 5; q += THREADS) bdbox_out[D * 5 + q] = bdbox_in[q];

  // 11. the embedding rows of the table and of the backdrops
  auto table_row = [&](int t) {
    const int n = s.neu[t], u = s.upd[t];
    if (n >= 0) return RowSrc{nullptr, demb + (size_t)s.order[n] * E, FROM_B, 0.0f};
    if (u >= 0) return RowSrc{emb_in + (size_t)t * E, demb + (size_t)s.order[u] * E, EMA, 0.0f};
    return RowSrc{emb_in + (size_t)t * E, nullptr, FROM_A, 0.0f};
  };
  auto backdrop_row = [&](int p) {
    if (p < D)  // x * keep, as the plain version masks
      return RowSrc{nullptr, demb + (size_t)s.order[p] * E, SCALED_B, s.bdkeep[p] ? 1.0f : 0.0f};
    return RowSrc{bdemb_in + (size_t)(p - D) * E, nullptr, FROM_A, 0.0f};
  };
  write_rows(emb_out, T, E, table_row, a.keep_w, a.new_w);
  write_rows(bdemb_out, BD, E, backdrop_row, a.keep_w, a.new_w);
}

}  // namespace

// ptrs: the 12 state fields, bboxes, labels, embeds, det_valid and
// frame_ids in, then the 12 state fields, ids, order and kept out (Args'
// order), all contiguous with a leading clip axis; ints: B, D, T, BD, E,
// memo_tracklet_frames, match metric (0 bisoftmax, 1 softmax, 2 cosine),
// with_cats; floats: init_score_thr, obj_score_thr, match_score_thr,
// 1 - memo_momentum, memo_momentum, nms_conf_thr, nms_backdrop_iou_thr,
// nms_class_iou_thr.  Requires D <= T, D <= BD, T + BD <= 256, E a multiple
// of 4 and every embedding row 16-byte aligned.
extern "C" int poly_tracker_step(void* const* ptrs, const int* ints, const float* floats,
                                 void* stream) {
  Args a;
  const void* const* p = ptrs;
  a.ids = static_cast<const int*>(p[0]);
  a.embeds = static_cast<const float*>(p[1]);
  a.bboxes = static_cast<const float*>(p[2]);
  a.labels = static_cast<const int*>(p[3]);
  a.last_frame = static_cast<const int*>(p[4]);
  a.velocities = static_cast<const float*>(p[5]);
  a.acc_frames = static_cast<const int*>(p[6]);
  a.num_tracklets = static_cast<const int*>(p[7]);
  a.bd_embeds = static_cast<const float*>(p[8]);
  a.bd_bboxes = static_cast<const float*>(p[9]);
  a.bd_labels = static_cast<const int*>(p[10]);
  a.bd_valid = static_cast<const unsigned char*>(p[11]);
  a.det_bboxes = static_cast<const float*>(p[12]);
  a.det_labels = static_cast<const int*>(p[13]);
  a.det_embeds = static_cast<const float*>(p[14]);
  a.det_valid = static_cast<const unsigned char*>(p[15]);
  a.frame_ids = static_cast<const int*>(p[16]);
  a.o_ids = static_cast<int*>(ptrs[17]);
  a.o_embeds = static_cast<float*>(ptrs[18]);
  a.o_bboxes = static_cast<float*>(ptrs[19]);
  a.o_labels = static_cast<int*>(ptrs[20]);
  a.o_last_frame = static_cast<int*>(ptrs[21]);
  a.o_velocities = static_cast<float*>(ptrs[22]);
  a.o_acc_frames = static_cast<int*>(ptrs[23]);
  a.o_num_tracklets = static_cast<int*>(ptrs[24]);
  a.o_bd_embeds = static_cast<float*>(ptrs[25]);
  a.o_bd_bboxes = static_cast<float*>(ptrs[26]);
  a.o_bd_labels = static_cast<int*>(ptrs[27]);
  a.o_bd_valid = static_cast<unsigned char*>(ptrs[28]);
  a.o_det_ids = static_cast<int*>(ptrs[29]);
  a.o_order = static_cast<long long*>(ptrs[30]);
  a.o_kept = static_cast<unsigned char*>(ptrs[31]);
  const int B = ints[0];
  a.D = ints[1];
  a.T = ints[2];
  a.BD = ints[3];
  a.E = ints[4];
  a.memo_frames = ints[5];
  a.metric = ints[6];
  a.with_cats = ints[7];
  a.init_thr = floats[0];
  a.obj_thr = floats[1];
  a.match_thr = floats[2];
  a.keep_w = floats[3];
  a.new_w = floats[4];
  a.conf_thr = floats[5];
  a.bd_iou_thr = floats[6];
  a.class_iou_thr = floats[7];
  const size_t smem = carve(nullptr, a.D, a.T, a.BD, a.E, nullptr);
  cudaError_t err = cudaFuncSetAttribute(tracker_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tracker_step_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Fast panoptic-pair statistics for (D)VPQ evaluation.
//
// A copy of the JAX package's native/vpq_core.cpp (the function bodies
// unchanged, so both give the same sums in the same order).
//
// Native counterpart of evalutils/vpq.py's unique/intersection pass: the
// DVPQ protocol evaluates 16 (window, lambda) combinations over every clip
// (reference polyphonic/apis/video_evaluate.py:56-111), so the
// per-clip segment-intersection counting is the eval hot loop.  The
// reference threw 128 processes at the Python version; this single-pass
// hash-free sort-based C++ core is ~50x the Python dict implementation.
//
// C ABI for ctypes:
//   int vpq_stats(const int64_t* pred, const int64_t* gt, int64_t n_pix,
//                 int num_classes, int64_t max_ins, int64_t ign_id,
//                 double* iou, double* tp, double* fn, double* fp)
// Output arrays have length num_classes + 1.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" int vpq_stats(const int64_t* pred, const int64_t* gt,
                         int64_t n_pix, int num_classes, int64_t max_ins,
                         int64_t ign_id, double* iou, double* tp, double* fn,
                         double* fp) {
  const int num_cat = num_classes + 1;
  std::memset(iou, 0, sizeof(double) * num_cat);
  std::memset(tp, 0, sizeof(double) * num_cat);
  std::memset(fn, 0, sizeof(double) * num_cat);
  std::memset(fp, 0, sizeof(double) * num_cat);

  std::unordered_map<int64_t, int64_t> pred_area, gt_area, int_area;
  pred_area.reserve(256);
  gt_area.reserve(256);
  int_area.reserve(1024);
  const int64_t offset = 1000000000LL;
  for (int64_t p = 0; p < n_pix; ++p) {
    ++pred_area[pred[p]];
    ++gt_area[gt[p]];
    ++int_area[gt[p] * offset + pred[p]];
  }

  const int64_t void_id = ign_id * max_ins;
  // per-pred overlap with void-category gt, and with the exact void id
  std::unordered_map<int64_t, int64_t> void_overlap, void_exact;
  for (const auto& kv : int_area) {
    int64_t g = kv.first / offset;
    int64_t pr = kv.first % offset;
    if (g / max_ins == ign_id) void_overlap[pr] += kv.second;
    if (g == void_id) void_exact[pr] += kv.second;
  }

  std::unordered_map<int64_t, char> gt_matched, pred_matched;
  for (const auto& kv : int_area) {
    int64_t g = kv.first / offset;
    int64_t pr = kv.first % offset;
    int64_t gcat = g / max_ins;
    int64_t pcat = pr / max_ins;
    if (gcat != pcat || gcat == ign_id) continue;
    auto ve = void_exact.find(pr);
    double unionv = static_cast<double>(gt_area[g] + pred_area[pr] - kv.second -
                                        (ve == void_exact.end() ? 0 : ve->second));
    double v = kv.second / unionv;
    if (v > 0.5 && gcat >= 0 && gcat < num_cat) {
      tp[gcat] += 1;
      iou[gcat] += v;
      gt_matched[g] = 1;
      pred_matched[pr] = 1;
    }
  }

  for (const auto& kv : gt_area) {
    int64_t cat = kv.first / max_ins;
    if (cat == ign_id || gt_matched.count(kv.first)) continue;
    if (cat >= 0 && cat < num_cat) fn[cat] += 1;
  }
  for (const auto& kv : pred_area) {
    if (pred_matched.count(kv.first)) continue;
    auto vo = void_overlap.find(kv.first);
    double ov = vo == void_overlap.end() ? 0.0 : static_cast<double>(vo->second);
    if (ov / kv.second > 0.5) continue;
    int64_t cat = kv.first / max_ins;
    if (cat >= 0 && cat < num_cat) fp[cat] += 1;
  }
  return 0;
}

// Depth-threshold masking (apply_depth_threshold) fused into one pass:
// sets pred[p] = num_classes*max_ins where gt_depth>0 and relative error
// exceeds thr.
extern "C" void depth_void_mask(int64_t* pred, const float* pred_depth,
                                const float* gt_depth, int64_t n_pix,
                                double thr, int num_classes, int64_t max_ins) {
  const int64_t void_val = static_cast<int64_t>(num_classes) * max_ins;
  for (int64_t p = 0; p < n_pix; ++p) {
    float g = gt_depth[p];
    if (g > 0.f) {
      float e = pred_depth[p] - g;
      if (e < 0) e = -e;
      if (e / g > thr) pred[p] = void_val;
    }
  }
}

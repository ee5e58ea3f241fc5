// cv2.resize INTER_LINEAR on uint8 images (OpenCV's fixed-point bilinear,
// 11-bit coefficients), the body of data/resize.py::resize_linear_u8.
//
// The tap tables come from Python (data/resize.py::linear_taps), the same
// tables the plain numpy version uses: for each output column dx the source
// column xofs[dx] and the weights xa[2 dx], xa[2 dx + 1]; for each output row
// dy the source row yofs[dy] (unclamped: the rows read are clipped to the
// image, the weights stay) and yb[2 dy], yb[2 dy + 1].
//
// Horizontal pass, per source row and channel, in int32:
//   S = p[xofs] * xa0 + p[xofs + 1] * xa1
// Vertical pass, OpenCV's VResizeLinearVec_32s8u (and its scalar tail):
//   out = (((yb0 * (S0 >> 4)) >> 16) + ((yb1 * (S1 >> 4)) >> 16) + 2) >> 2
// saturated to [0, 255].
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

void hpass(const uint8_t* row, int64_t sw, int64_t cn, int64_t dw, const int32_t* xofs,
           const int16_t* xa, int32_t* out) {
  for (int64_t dx = 0; dx < dw; ++dx) {
    const int64_t sx0 = xofs[dx];
    const int64_t sx1 = std::min<int64_t>(sx0 + 1, sw - 1);
    const int32_t a0 = xa[2 * dx], a1 = xa[2 * dx + 1];
    const uint8_t* p0 = row + sx0 * cn;
    const uint8_t* p1 = row + sx1 * cn;
    int32_t* o = out + dx * cn;
    for (int64_t c = 0; c < cn; ++c) o[c] = int32_t(p0[c]) * a0 + int32_t(p1[c]) * a1;
  }
}

}  // namespace

extern "C" int64_t resize_linear_u8(const uint8_t* src, int64_t sh, int64_t sw, int64_t cn,
                                    uint8_t* dst, int64_t dh, int64_t dw,
                                    const int32_t* xofs, const int16_t* xa,
                                    const int32_t* yofs, const int16_t* yb) {
  if (sh <= 0 || sw <= 0 || cn <= 0 || dh <= 0 || dw <= 0) return -1;
  for (int64_t dx = 0; dx < dw; ++dx)
    if (xofs[dx] < 0 || xofs[dx] >= sw) return -2;
  const int64_t n = dw * cn;
  // two horizontal-pass rows, kept while consecutive output rows share them
  std::vector<int32_t> buf(2 * n);
  int64_t held[2] = {-1, -1};
  auto row = [&](int64_t r) -> const int32_t* {
    for (int k = 0; k < 2; ++k)
      if (held[k] == r) return buf.data() + k * n;
    // evict the slot whose row lies furthest behind
    const int k = (held[0] == -1 || (held[1] != -1 && held[0] < held[1])) ? 0 : 1;
    hpass(src + r * sw * cn, sw, cn, dw, xofs, xa, buf.data() + k * n);
    held[k] = r;
    return buf.data() + k * n;
  };
  for (int64_t dy = 0; dy < dh; ++dy) {
    const int64_t r0 = std::clamp<int64_t>(yofs[dy], 0, sh - 1);
    const int64_t r1 = std::clamp<int64_t>(int64_t(yofs[dy]) + 1, 0, sh - 1);
    const int32_t* s0 = row(r0);
    const int32_t* s1 = row(r1);
    const int32_t b0 = yb[2 * dy], b1 = yb[2 * dy + 1];
    uint8_t* o = dst + dy * n;
    for (int64_t i = 0; i < n; ++i) {
      const int32_t v = (((b0 * (s0[i] >> 4)) >> 16) + ((b1 * (s1[i] >> 4)) >> 16) + 2) >> 2;
      o[i] = uint8_t(std::clamp(v, 0, 255));
    }
  }
  return 0;
}

// PNG scanline reconstruction (the inverse of the five filter types of the
// PNG specification, section 9) for data/png.py.
//
// Average and Paeth make each byte depend on the byte reconstructed just to
// its left, so they do not vectorise across a row in numpy; a Python loop
// over a 1024x2048 RGB frame takes seconds.  Here every row is one pass.
//
// C ABI for ctypes:
//   int64_t png_unfilter(const uint8_t* src, uint8_t* dst, int64_t rows,
//                        int64_t row_bytes, int bpp)
// src holds rows x (1 + row_bytes) bytes: each row's filter-type byte, then
// its filtered bytes; dst receives rows x row_bytes reconstructed bytes.
// bpp is the filter's byte distance (bytes per complete pixel, at least 1).
// Returns 0, or -(r + 1) when row r names a filter type above 4 (dst is
// then incomplete).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" int64_t png_unfilter(const uint8_t* src, uint8_t* dst,
                                int64_t rows, int64_t row_bytes, int bpp) {
  if (rows <= 0 || row_bytes <= 0) return 0;
  if (bpp < 1 || bpp > 8) return -(rows + 1);
  const int64_t n = row_bytes;
  const int64_t lead = bpp < n ? bpp : n;
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t ft = src[r * (n + 1)];
    const uint8_t* in = src + r * (n + 1) + 1;
    uint8_t* out = dst + r * n;
    const uint8_t* up = r > 0 ? dst + (r - 1) * n : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(out, in, n);
        break;
      case 1:  // Sub
        std::memcpy(out, in, lead);
        for (int64_t i = bpp; i < n; ++i)
          out[i] = static_cast<uint8_t>(in[i] + out[i - bpp]);
        break;
      case 2:  // Up
        if (up == nullptr) {
          std::memcpy(out, in, n);
        } else {
          for (int64_t i = 0; i < n; ++i)
            out[i] = static_cast<uint8_t>(in[i] + up[i]);
        }
        break;
      case 3:  // Average
        if (up == nullptr) {
          std::memcpy(out, in, lead);
          for (int64_t i = bpp; i < n; ++i)
            out[i] = static_cast<uint8_t>(in[i] + (out[i - bpp] >> 1));
        } else {
          for (int64_t i = 0; i < lead; ++i)
            out[i] = static_cast<uint8_t>(in[i] + (up[i] >> 1));
          for (int64_t i = bpp; i < n; ++i)
            out[i] = static_cast<uint8_t>(
                in[i] + ((static_cast<int>(out[i - bpp]) + up[i]) >> 1));
        }
        break;
      case 4:  // Paeth; with no row above, b = c = 0 and Paeth picks a
        if (up == nullptr) {
          std::memcpy(out, in, lead);
          for (int64_t i = bpp; i < n; ++i)
            out[i] = static_cast<uint8_t>(in[i] + out[i - bpp]);
        } else {
          for (int64_t i = 0; i < lead; ++i)
            out[i] = static_cast<uint8_t>(in[i] + up[i]);
          for (int64_t i = bpp; i < n; ++i)
            out[i] = static_cast<uint8_t>(
                in[i] + paeth(out[i - bpp], up[i], up[i - bpp]));
        }
        break;
      default:
        return -(r + 1);
    }
  }
  return 0;
}

// PNG image data after inflate -> BGR pixels, on the host.
//
// Replaces: the PNG half of cv2.imdecode(buf, cv2.IMREAD_COLOR), which the
// JAX package calls at radnet_tpu/data/dataset.py:74, cli/serve.py:154 and
// cli/predict.py:52 (libpng under OpenCV; no TPU kernel).  The inflate is
// Python's zlib (radnet_torch/data/png.py); this file does the part that runs
// byte by byte: it undoes the five row filters, walks Adam7's seven passes
// (a pass with no columns or no rows has no bytes, not even filter bytes),
// unpacks bit depths 1, 2, 4, 8 and 16, and writes BGR uint8 as libpng's
// transforms under OpenCV do: grey of depth 1/2/4 scaled by 255/85/17, a
// 16-bit sample reduced to its high byte (png_set_strip_16), palette indices
// looked up in a 256-entry table (entries past PLTE are black), alpha and
// tRNS dropped, grey repeated to three channels, RGB turned to BGR.
//
// No codec library is linked.  Plain C interface, called through ctypes
// (which releases the GIL, so threads decode at once).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  // p = a + b - c; the predictor nearest p, ties to a, then b (written so
  // that the compiler selects without branches)
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  const int bc = pb <= pc ? b : c;
  return (uint8_t)(pa <= pb && pa <= pc ? a : bc);
}

// Undo one row's filter in place; prev is the row above (zeros on a pass's
// first row).  Returns false on a filter type above 4.
bool unfilter(int ftype, uint8_t* row, const uint8_t* prev, int64_t n, int bpp) {
  switch (ftype) {
    case 0:
      return true;
    case 1:
      for (int64_t i = bpp; i < n; ++i) row[i] = (uint8_t)(row[i] + row[i - bpp]);
      return true;
    case 2:
      for (int64_t i = 0; i < n; ++i) row[i] = (uint8_t)(row[i] + prev[i]);
      return true;
    case 3:
      for (int64_t i = 0; i < bpp && i < n; ++i) row[i] = (uint8_t)(row[i] + (prev[i] >> 1));
      for (int64_t i = bpp; i < n; ++i)
        row[i] = (uint8_t)(row[i] + ((row[i - bpp] + prev[i]) >> 1));
      return true;
    case 4:
      for (int64_t i = 0; i < bpp && i < n; ++i) row[i] = (uint8_t)(row[i] + prev[i]);
      for (int64_t i = bpp; i < n; ++i)
        row[i] = (uint8_t)(row[i] + paeth(row[i - bpp], prev[i], prev[i - bpp]));
      return true;
    default:
      return false;
  }
}

// Sample k of a row at a bit depth below 8, MSB first.
inline int packed(const uint8_t* row, int64_t k, int depth) {
  int64_t bit = k * depth;
  return (row[bit >> 3] >> (8 - depth - (int)(bit & 7))) & ((1 << depth) - 1);
}

// One unfiltered row of `pw` pixels -> BGR at out[y, x0 + c * dx].
void emit_row(const uint8_t* row, int64_t pw, int depth, int color, const uint8_t* palette,
              uint8_t* dst, int64_t dx) {
  if (depth == 8 && dx == 1 && (color == 0 || color == 2)) {  // the common panels
    if (color == 0)
      for (int64_t c = 0; c < pw; ++c) dst[3 * c] = dst[3 * c + 1] = dst[3 * c + 2] = row[c];
    else
      for (int64_t c = 0; c < pw; ++c)
        dst[3 * c] = row[3 * c + 2], dst[3 * c + 1] = row[3 * c + 1], dst[3 * c + 2] = row[3 * c];
    return;
  }
  const int scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  const int step = depth == 16 ? 2 : 1;  // bytes a sample (its high byte first)
  for (int64_t c = 0; c < pw; ++c, dst += 3 * dx) {
    int r, g, b;
    if (color == 3) {
      int idx = depth < 8 ? packed(row, c, depth) : row[c];
      r = palette[3 * idx], g = palette[3 * idx + 1], b = palette[3 * idx + 2];
    } else if (color == 0 || color == 4) {
      int v;
      if (depth < 8)
        v = packed(row, c, depth) * scale;
      else
        v = row[c * step * (color == 4 ? 2 : 1)];
      r = g = b = v;
    } else {  // 2: RGB, 6: RGBA
      const uint8_t* p = row + c * step * (color == 6 ? 4 : 3);
      r = p[0], g = p[step], b = p[2 * step];
    }
    dst[0] = (uint8_t)b, dst[1] = (uint8_t)g, dst[2] = (uint8_t)r;
  }
}

int channels(int color) { return color == 0 ? 1 : color == 2 ? 3 : color == 3 ? 1 : color == 4 ? 2 : 4; }

}  // namespace

extern "C" {

// raw: the inflated image data (filter byte + filtered bytes, row by row,
// pass by pass); palette: 256 RGB triples; out: height * width * 3 bytes.
// Returns 0, or 1 when raw is shorter than the image needs (the caller
// checks it first), or 2 on a filter type above 4.  Bytes after the image
// data are ignored.
int radnet_png_unfilter(const uint8_t* raw, int64_t raw_len, int32_t width, int32_t height,
                        int32_t depth, int32_t color, int32_t interlace, const uint8_t* palette,
                        uint8_t* out) {
  static const int kX0[7] = {0, 4, 0, 2, 0, 1, 0}, kDx[7] = {8, 8, 4, 4, 2, 2, 1};
  static const int kY0[7] = {0, 0, 4, 0, 2, 0, 1}, kDy[7] = {8, 8, 8, 4, 4, 2, 2};
  const int bits_px = channels(color) * depth;
  const int bpp = bits_px >= 8 ? bits_px / 8 : 1;  // the filters' byte distance
  const int passes = interlace ? 7 : 1;
  std::vector<uint8_t> prev, cur;
  int64_t pos = 0;
  for (int p = 0; p < passes; ++p) {
    const int64_t x0 = interlace ? kX0[p] : 0, dx = interlace ? kDx[p] : 1;
    const int64_t y0 = interlace ? kY0[p] : 0, dy = interlace ? kDy[p] : 1;
    const int64_t pw = width > x0 ? (width - x0 + dx - 1) / dx : 0;
    const int64_t ph = height > y0 ? (height - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;
    const int64_t stride = (pw * bits_px + 7) / 8;
    prev.assign(stride, 0);
    cur.resize(stride);
    for (int64_t r = 0; r < ph; ++r) {
      if (pos + 1 + stride > raw_len) return 1;
      int ftype = raw[pos];
      std::memcpy(cur.data(), raw + pos + 1, stride);
      pos += 1 + stride;
      if (!unfilter(ftype, cur.data(), prev.data(), stride, bpp)) return 2;
      emit_row(cur.data(), pw, depth, color, palette,
               out + ((y0 + r * dy) * (int64_t)width + x0) * 3, dx);
      prev.swap(cur);
    }
  }
  return 0;
}

}  // extern "C"

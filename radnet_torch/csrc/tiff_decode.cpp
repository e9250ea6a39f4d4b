// TIFF strip and tile data -> BGR pixels, on the host.
//
// Replaces: the TIFF half of cv2.imdecode(buf, cv2.IMREAD_COLOR), which the
// JAX package calls at radnet_tpu/data/dataset.py:74, cli/serve.py:154 and
// cli/predict.py:52 (libtiff 4.7.1 under OpenCV 5.0.0, read through libtiff's
// RGBA interface, TIFFReadRGBAStrip / TIFFReadRGBATile; no TPU kernel).  The
// file structure is parsed in Python (radnet_torch/data/tiff.py), and Deflate
// is Python's zlib; this file does the parts that run byte by byte:
//
//  * radnet_tiff_lzw: tif_lzw.c's LZWDecode, its code table included (a
//    chain of entries with length, value and first byte; the unfilled entries
//    zeroed at each Clear code), so that corrupt data decodes to the bytes
//    libtiff gives before it stops: codes of 9 to 12 bits, MSB first, the
//    width raised one code early, a code before the first Clear, a code past
//    the table's end or a string longer than the room left handled as there.
//  * radnet_tiff_packbits: tif_packbits.c's PackBitsDecode.
//  * radnet_tiff_postdecode: Predictor 2 undone per row (tif_predict.c's
//    horAcc8 / horAcc16 / swabHorAcc16, per sample with wrap-around), or the
//    16-bit byte swap of a file in the other byte order.
//  * radnet_tiff_put: tif_getimage.c's "put" routines for one decoded strip
//    or tile, written as BGR into the image: a grey or palette sample looked up
//    in a 256-entry RGB table (1-bit samples unpacked, 16-bit grey by its high
//    byte: put1bitbwtile, putgreytile, putagreytile, put16bitbwtile,
//    put{1,4,8}bitcmaptile); RGB at 8 or 16 bits (16 -> 8 as (v + 128) /
//    257, BuildMapBitdepth16To8), unassociated alpha premultiplied as
//    (a * c + 127) / 255 (BuildMapUaToAa), associated or unspecified alpha
//    dropped; CMYK as (255 - k) * (255 - c) / 255.  Contiguous and separate
//    planes differ only in their sample strides here.  The strip's or tile's
//    place in the image follows libtiff's flips under the Orientation tag
//    (a horizontal flip mirrors each tile within its width) and OpenCV's
//    placement of the RGBA rows; the transposes of orientations 5-8 are
//    applied in Python.
//  * radnet_tiff_put_ycbcr: the YCbCr put routines (putcontig8bitYCbCr{11,
//    12,21,22,41,42,44}tile on packed blocks of hs x vs luma samples and
//    their Cb and Cr, putseparate8bitYCbCr11tile on three planes) with
//    TIFFYCbCrtoRGB's conversion through the tables TIFFYCbCrToRGBInit
//    builds (tif_color.c; built in Python from the file's YCbCrCoefficients
//    and ReferenceBlackWhite), placed as radnet_tiff_put places its pixels.
//
// No codec library is linked.  Plain C interface, called through ctypes
// (which releases the GIL, so threads decode at once).

#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// One entry of LZWDecode's code table (tif_lzw.c code_t); next is an index,
// -1 for none.
struct Code {
  int32_t next;
  uint16_t length;
  uint8_t value;
  uint8_t firstchar;
};

constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kCsize = 4095 + 1024;  // MAXCODE(BITS_MAX) + 1024

inline uint8_t to8(uint16_t v) { return (uint8_t)((v + 128) / 257); }

}  // namespace

extern "C" {

// LZW data src[0, n) -> dst[0, occ).  dst must be zeroed by the caller:
// where libtiff stops early, the rest stays zero (libtiff's buffer is zeroed
// when it is allocated, and LZWDecode zeroes what is short).  Returns 1 when
// occ bytes were decoded, 0 where libtiff reports an error (the caller then
// skips the predictor and the byte swap, as TIFFReadEncodedStrip does).
int radnet_tiff_lzw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ) {
  std::vector<Code> tab(kCsize);
  for (int c = 0; c < 256; ++c) tab[c] = Code{-1, 1, (uint8_t)c, (uint8_t)c};
  std::memset(&tab[kClear], 0, sizeof(Code) * (kFirst - kClear));
  int64_t free_ent = -1;  // dec_codetab - 1 until the first Clear
  int32_t oldcode = 0;
  int nbits = 9;
  int64_t nbitsmask = 511, maxcode = 510;
  int64_t bitpos = 0;
  int64_t op = 0;
  std::vector<uint8_t> padded(src, src + n);  // 3 zero bytes past the end
  padded.resize(n + 3, 0);
  const uint8_t* in = padded.data();
  auto next_code = [&](int& code) -> bool {
    // Codes are MSB first; one whose bits run past the data ends the strip
    // without EOI (an error).
    const int64_t end = bitpos + nbits;
    if (end > n * 8) return false;
    const int64_t byte = bitpos >> 3;
    const uint32_t v = (uint32_t)in[byte] << 16 | (uint32_t)in[byte + 1] << 8 | in[byte + 2];
    code = (int)((v >> (24 - (bitpos & 7) - nbits)) & nbitsmask);
    bitpos = end;
    return true;
  };
  while (occ > 0) {
    int code;
    if (!next_code(code)) return 0;
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        std::memset(&tab[kFirst], 0, sizeof(Code) * (kCsize - kFirst));
        nbits = 9;
        nbitsmask = 511;
        maxcode = nbitsmask - 1;
        if (!next_code(code)) return 0;
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return 0;  // "Corrupted LZW table"
      dst[op++] = (uint8_t)code;
      --occ;
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kCsize) return 0;  // "Corrupted LZW table"
    Code& e = tab[free_ent];
    e.next = oldcode;
    e.firstchar = tab[oldcode].firstchar;
    e.length = (uint16_t)(tab[oldcode].length + 1);
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask - 1;
      if (free_ent >= kCsize) free_ent = -1;
    }
    oldcode = code;
    if (code >= 256) {
      int32_t cp = code;
      if (tab[cp].length == 0) return 0;  // "Wrong length of decoded string"
      if (tab[cp].length > occ) {
        // The string's first occ bytes: skip the entries past them.
        do cp = tab[cp].next; while (cp >= 0 && tab[cp].length > occ);
        if (cp >= 0) {
          int64_t t = op + occ;
          do {
            dst[--t] = tab[cp].value;
            cp = tab[cp].next;
          } while (--occ && cp >= 0);
        }
        return occ == 0 ? 1 : 0;
      }
      const int64_t len = tab[cp].length;
      int64_t t = op + len;
      do {
        dst[--t] = tab[cp].value;
        cp = tab[cp].next;
      } while (cp >= 0 && t > op);
      op += len;
      occ -= len;
    } else {
      dst[op++] = (uint8_t)code;
      --occ;
    }
  }
  return occ == 0 ? 1 : 0;
}

// PackBits data -> dst[0, occ) (zeroed by the caller).  Returns 1 when occ
// bytes were decoded, else 0.
int radnet_tiff_packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ) {
  int64_t cc = n, op = 0;
  const int8_t* bp = (const int8_t*)src;
  while (cc > 0 && occ > 0) {
    long k = *bp++;
    --cc;
    if (k < 0) {
      if (k == -128) continue;
      k = -k + 1;
      if (occ < k) k = (long)occ;
      if (cc == 0) break;
      occ -= k;
      const uint8_t b = (uint8_t)*bp++;
      --cc;
      while (k-- > 0) dst[op++] = b;
    } else {
      if (occ < k + 1) k = (long)occ - 1;
      if (cc < k + 1) break;
      ++k;
      std::memcpy(dst + op, bp, k);
      op += k;
      occ -= k;
      bp += k;
      cc -= k;
    }
  }
  return occ > 0 ? 0 : 1;
}

// After a successful decode of len bytes: undo Predictor 2 row by row
// (rowsize bytes a row, stride samples between neighbours), at 8 or 16 bits,
// swapping 16-bit samples of a file in the other byte order first; or, with
// no predictor, only that swap.  Returns 0 where libtiff's predictor reports
// an error (a length that is not whole rows or whole pixels).
int radnet_tiff_postdecode(uint8_t* buf, int64_t len, int64_t rowsize, int32_t bits,
                           int32_t stride, int32_t predictor, int32_t swap) {
  if (swap && bits == 16)
    for (int64_t i = 0; i + 1 < len; i += 2) std::swap(buf[i], buf[i + 1]);
  if (predictor != 2) return 1;
  if (rowsize <= 0 || len % rowsize) return 0;
  for (int64_t r = 0; r < len; r += rowsize) {
    if (bits == 8) {
      uint8_t* cp = buf + r;
      int64_t cc = rowsize;
      if (cc % stride) return 0;
      if (stride == 1) {  // the common grey row: the running sum in a register
        uint8_t acc = cp[0];
        for (int64_t i = 1; i < cc; ++i) cp[i] = acc = (uint8_t)(acc + cp[i]);
      } else {
        for (int64_t i = stride; i < cc; ++i) cp[i] = (uint8_t)(cp[i] + cp[i - stride]);
      }
    } else if (bits == 16) {
      uint16_t* wp = (uint16_t*)(buf + r);
      int64_t cc = rowsize;
      if (cc % (2 * stride)) return 0;
      const int64_t wc = cc / 2;
      for (int64_t i = stride; i < wc; ++i) wp[i] = (uint16_t)(wp[i] + wp[i - stride]);
    }
  }
  return 1;
}

// Modes of radnet_tiff_put.
enum { kIndex = 0, kRgb = 1, kCmyk = 2 };

// One decoded strip or tile -> BGR rows of out (height x width x 3).
//
// planes[0..3]: each channel's first sample of the block's first row to put
// (contiguous data: the same buffer at 0, 1, 2... samples; separate planes:
// each plane's buffer).  step: bytes from a pixel to the next within a plane;
// rowstride: bytes from a row to the next.  bits: 1, 4, 8 or 16.  w x h: the
// pixels to put; (x0, y0): their place in the image before flips.  mode:
// kIndex (planes[0] looked up in table, 256 RGB triples; a 16-bit sample by
// its high byte), kRgb (alpha: 0 none or kept, 2 unassociated, from
// planes[3]) or kCmyk.  hflip mirrors the block within its w columns; vflip
// puts image row y at height - 1 - y.
void radnet_tiff_put(const uint8_t* const* planes, int64_t step, int64_t rowstride, int32_t bits,
                     int32_t mode, int32_t alpha, const uint8_t* table, int32_t w, int32_t h,
                     int32_t x0, int32_t y0, int32_t hflip, int32_t vflip, uint8_t* out,
                     int32_t width, int32_t height) {
  const int64_t dstep = hflip ? -3 : 3;
  for (int32_t i = 0; i < h; ++i) {
    const int64_t y = vflip ? (int64_t)height - 1 - (y0 + i) : (int64_t)y0 + i;
    uint8_t* px = out + (y * width + x0 + (hflip ? w - 1 : 0)) * 3;
    const int64_t ro = (int64_t)i * rowstride;
    if (mode == kIndex) {
      const uint8_t* src = planes[0] + ro;
      for (int32_t c = 0; c < w; ++c, px += dstep) {
        int idx;
        if (bits == 8) {
          idx = src[c * step];
        } else if (bits < 8) {
          const int64_t bit = (int64_t)c * bits;
          idx = (src[bit >> 3] >> (8 - bits - (int)(bit & 7))) & ((1 << bits) - 1);
        } else {
          uint16_t v;
          std::memcpy(&v, src + c * step, 2);
          idx = v >> 8;
        }
        const uint8_t* rgb = table + 3 * idx;
        px[0] = rgb[2], px[1] = rgb[1], px[2] = rgb[0];
      }
      continue;
    }
    const int n = mode == kCmyk || alpha ? 4 : 3;
    for (int32_t c = 0; c < w; ++c, px += dstep) {
      int s[4];
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = planes[k] + ro + c * step;
        if (bits == 16) {
          uint16_t v;
          std::memcpy(&v, p, 2);
          s[k] = to8(v);
        } else {
          s[k] = *p;
        }
      }
      int r, g, b;
      if (mode == kCmyk) {
        const int k = 255 - s[3];
        r = k * (255 - s[0]) / 255, g = k * (255 - s[1]) / 255, b = k * (255 - s[2]) / 255;
      } else if (alpha == 2) {
        r = (s[0] * s[3] + 127) / 255, g = (s[1] * s[3] + 127) / 255,
        b = (s[2] * s[3] + 127) / 255;
      } else {
        r = s[0], g = s[1], b = s[2];
      }
      px[0] = (uint8_t)b, px[1] = (uint8_t)g, px[2] = (uint8_t)r;
    }
  }
}

// Packed or separate 8-bit YCbCr of one strip or tile -> BGR rows of out.
//
// planes[0]: the block's first byte; contiguous (planes[1] null): blocks of
// hs * vs luma samples (row by row) then Cb and Cr, rowstride bytes from a
// row of blocks to the next (the put routine's own step: its blocks and its
// fromskew), blocks hs * vs + 2 bytes apart along a row; separate (hs = vs =
// 1): Y, Cb and Cr planes, rowstride bytes a row.  tables: libtiff's Y_tab,
// Cr_r_tab, Cb_b_tab, Cr_g_tab and Cb_g_tab, 256 int32 each.  w, h, x0, y0,
// hflip, vflip, out, width, height: as radnet_tiff_put.
void radnet_tiff_put_ycbcr(const uint8_t* const* planes, int32_t hs, int32_t vs, int64_t rowstride,
                           const int32_t* tables, int32_t w, int32_t h, int32_t x0, int32_t y0,
                           int32_t hflip, int32_t vflip, uint8_t* out, int32_t width,
                           int32_t height) {
  const int32_t *y_tab = tables, *cr_r = tables + 256, *cb_b = tables + 512, *cr_g = tables + 768,
                *cb_g = tables + 1024;
  const bool separate = planes[1] != nullptr;
  const int64_t bsize = hs * vs + 2;
  const int64_t dstep = hflip ? -3 : 3;
  for (int32_t i = 0; i < h; ++i) {
    const int64_t y = vflip ? (int64_t)height - 1 - (y0 + i) : (int64_t)y0 + i;
    uint8_t* px = out + (y * width + x0 + (hflip ? w - 1 : 0)) * 3;
    const int64_t brow = (int64_t)(i / vs) * rowstride;
    const int r = i % vs;
    for (int32_t j = 0; j < w; ++j, px += dstep) {
      int Y, Cb, Cr;
      if (separate) {
        const int64_t at = (int64_t)i * rowstride + j;
        Y = planes[0][at], Cb = planes[1][at], Cr = planes[2][at];
      } else {
        const uint8_t* b = planes[0] + brow + (int64_t)(j / hs) * bsize;
        Y = b[r * hs + j % hs], Cb = b[hs * vs], Cr = b[hs * vs + 1];
      }
      // TIFFYCbCrtoRGB
      const int yv = y_tab[Y];
      const int rr = yv + cr_r[Cr];
      const int gg = yv + (int)((cb_g[Cb] + cr_g[Cr]) >> 16);
      const int bb = yv + cb_b[Cb];
      px[0] = (uint8_t)(bb < 0 ? 0 : bb > 255 ? 255 : bb);
      px[1] = (uint8_t)(gg < 0 ? 0 : gg > 255 ? 255 : gg);
      px[2] = (uint8_t)(rr < 0 ? 0 : rr > 255 ? 255 : rr);
    }
  }
}

}  // extern "C"

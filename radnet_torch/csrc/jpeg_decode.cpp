// JPEG entropy decoding, IDCT, upsampling and colour conversion, on the host.
//
// Replaces: the JPEG half of cv2.imdecode(buf, cv2.IMREAD_COLOR), which the
// JAX package calls at radnet_tpu/data/dataset.py:74, cli/serve.py:154 and
// cli/predict.py:52 (libjpeg-turbo 3.1.2 under OpenCV; no TPU kernel), for
// JPEG files and for the strips and tiles of JPEG-compressed TIFFs, which
// OpenCV's libtiff 4.7.1 decodes through the same libjpeg-turbo.  The
// markers, tables and scan headers are parsed in Python
// (radnet_torch/data/jpeg.py); this file does what runs bit by bit or pixel
// by pixel, written to give libjpeg-turbo's output bit for bit:
//
//  * radnet_jpeg_scan decodes one scan's Huffman-coded data into the
//    components' coefficient arrays: sequential (SOF0/SOF1) and the four
//    progressive kinds (SOF2: DC first and refine, AC first and refine with
//    EOB runs and correction bits), with restart intervals (DC predictors and
//    EOB run reset, libjpeg's resync on a wrong RSTn), byte stuffing, and
//    libjpeg's handling of data that ends early: zero bits are fed, and once a
//    bit past the end was used, the rest of that restart segment is left as
//    it was (jdhuff.c / jdphuff.c "insufficient_data").
//  * radnet_jpeg_output dequantizes and runs jidctint.c's ISLOW IDCT (in the
//    16- and 32-bit lanes of its AVX2 version), upsamples as jdsample.c does
//    by default
//    (fancy h2v1, h1v2 and h2v2 with their alternating rounding, context rows
//    clamped at the image's edges; box h2v1/h2v2 when a component is at most
//    2 samples wide; replication for other integral factors such as 4:1:1),
//    and converts with jdcolor.c's fixed-point YCbCr tables to BGR (grey:
//    three equal channels), or for libtiff to R, G, B, or writes the
//    components as they are (its JCS_UNKNOWN), into rows of a given stride.
//    Four components are CMYK, or YCCK that jdcolor.c's ycck_cmyk_convert
//    turns into CMYK with the same tables; OpenCV then writes them as BGR
//    (icvCvt_CMYK2BGR_8u_C4C3R: each of Y, M, C as K - ((255 - X) * K >> 8)).
//
// No codec library is linked.  Plain C interface, called through ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Zigzag index -> natural index, padded with 63 for runs past the end
// (jutils.c jpeg_natural_order).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The data ended where libjpeg-turbo's reader wanted another byte.  OpenCV's
// memory source then suspends the decoder (its fill_input_buffer returns
// FALSE), and cv2.imdecode returns None.  libtiff's source (tif_jpeg.c
// std_fill_input_buffer) instead hands over a fake EOI marker, FF D9, each
// time: with fake_eoi the bytes past the end read FF D9 FF D9 ...
struct Suspend {};

// A Huffman table as jdhuff.c derives it (jpeg_make_d_derived_tbl), with its
// 8-bit lookahead.
struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t lookup[256];  // (length << 8) | symbol; length 9: a code longer than 8 bits
};

void make_huff(const uint8_t* spec, Huff* h) {
  // spec: 16 code counts, a defined flag, 256 symbols (validated in Python).
  std::memcpy(h->vals, spec + 17, 256);
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < spec[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (spec[l - 1]) {
      h->valoffset[l] = p - huffcode[p];
      p += spec[l - 1];
      h->maxcode[l] = huffcode[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->valoffset[17] = 0;
  h->maxcode[17] = 0xFFFFF;
  for (int i = 0; i < 256; ++i) h->lookup[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < spec[l - 1]; ++i, ++p) {
      int lookbits = huffcode[p] << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; --ctr) h->lookup[lookbits++] = (uint16_t)((l << 8) | h->vals[p]);
    }
  }
}

// libjpeg-turbo's bit reader, state for state: which bytes it has read
// decides whether it reaches the end of the data (a Suspend), so both its
// paths are kept as they are.  The slow path (jdhuff.c jpeg_fill_bit_buffer,
// HUFF_DECODE, jpeg_huff_decode) refills to 57 bits when a read needs more
// than it holds; at a marker it stops and feeds zero bits, and a read that
// needs them marks the restart segment short ("insufficient_data").  The
// fast path (decode_mcu_fast) takes 6 bytes whenever 16 bits or fewer are
// left; it runs on a copy, and an MCU in which it meets a marker is decoded
// again by the slow path from the state before it.
struct Reader {
  const uint8_t* d;
  int64_t len, pos;
  bool fake_eoi;
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;  // libjpeg's unread_marker
  bool insufficient = false;

  int input_byte() {
    if (pos >= len) {
      if (!fake_eoi) throw Suspend();
      return ((pos++ - len) & 1) ? 0xD9 : 0xFF;
    }
    return d[pos++];
  }
  void fill(int nbits) {
    while (marker == 0 && bits < 57) {
      int c = input_byte();
      if (c == 0xFF) {
        do c = input_byte();
        while (c == 0xFF);
        if (c != 0) {
          marker = c;
          break;
        }
        c = 0xFF;
      }
      buf = (buf << 8) | (unsigned)c;
      bits += 8;
    }
    if (marker != 0 && nbits > bits) {
      insufficient = true;
      buf <<= 57 - bits;
      bits = 57;
    }
  }
  uint32_t get_bits(int n) {
    bits -= n;
    return (uint32_t)(buf >> bits) & ((1u << n) - 1);
  }
  uint32_t take(int n) {
    if (bits < n) fill(n);
    return get_bits(n);
  }
  int huff_slow(const Huff* h, int l) {
    int32_t code = (int32_t)take(l);
    while (code > h->maxcode[l]) {
      code = (code << 1) | (int32_t)take(1);
      ++l;
    }
    if (l > 16) return 0;  // a bad code: libjpeg warns and returns 0
    return h->vals[(code + h->valoffset[l]) & 0xFF];
  }
  int decode(const Huff* h) {
    if (bits < 8) {
      fill(0);
      if (bits < 8) return huff_slow(h, 1);
    }
    int e = h->lookup[(buf >> (bits - 8)) & 0xFF];
    if ((e >> 8) <= 8) {
      bits -= e >> 8;
      return e & 0xFF;
    }
    return huff_slow(h, 9);
  }
  // decode_mcu_fast's GET_BYTE, FILL_BIT_BUFFER_FAST and HUFF_DECODE_FAST.
  void fill_fast() {
    if (bits > 16) return;
    for (int i = 0; i < 6; ++i) {
      int c0 = pos < len ? d[pos] : 0;
      ++pos;
      int c1 = pos < len ? d[pos] : 0;
      buf = (buf << 8) | (unsigned)c0;
      bits += 8;
      if (c0 == 0xFF) {
        ++pos;
        if (c1 != 0) {
          marker = c1;
          pos -= 2;
          buf &= ~(uint64_t)0xFF;
        }
      }
    }
  }
  int decode_fast(const Huff* h) {
    fill_fast();
    int e = h->lookup[(buf >> (bits - 8)) & 0xFF];
    int nb = e >> 8, s = e & 0xFF;
    bits -= nb;
    if (nb > 8) {
      int32_t code = (int32_t)(buf >> bits) & ((1 << nb) - 1);
      while (code > h->maxcode[nb]) {
        code = (code << 1) | (int32_t)get_bits(1);
        ++nb;
      }
      s = nb > 16 ? 0 : h->vals[(code + h->valoffset[nb]) & 0xFF];
    }
    return s;
  }
  uint32_t take_fast(int n) {
    fill_fast();
    return get_bits(n);
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)(((unsigned)-1 << s) + 1) : r; }

// jdmarker.c next_marker: skip to an FF, past fill FFs, and past FF 00 pairs.
int next_marker(Reader& r) {
  for (;;) {
    int c = r.input_byte();
    while (c != 0xFF) c = r.input_byte();
    do c = r.input_byte();
    while (c == 0xFF);
    if (c != 0) return c;
  }
}

// jdhuff.c process_restart with jdmarker.c read_restart_marker and
// jpeg_resync_to_restart.
void process_restart(Reader& r, int* next_rst) {
  r.bits = 0;
  if (r.marker == 0) r.marker = next_marker(r);
  const int desired = *next_rst;
  for (;;) {
    const int m = r.marker;
    int action;
    if (m < 0xC0) {
      action = 2;
    } else if (m < 0xD0 || m > 0xD7) {
      action = 3;
    } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;  // the wanted RSTn, or one too far away to resync on
    }
    if (action == 1) r.marker = 0;
    if (action != 2) break;
    r.marker = next_marker(r);
  }
  *next_rst = (*next_rst + 1) & 7;
  if (r.marker == 0) r.insufficient = false;
}

struct ScanComp {
  int h, v, stride;  // sampling factors, blocks a row of the coefficient array
  int bw, bh;        // the component's own blocks (a non-interleaved scan's extent)
  const Huff *dc, *ac;
  int16_t* coef;
};

// One block of a sequential scan (jdhuff.c decode_mcu_slow / decode_mcu_fast).
template <bool kFast>
void sequential_block(Reader& r, const ScanComp& c, int16_t* blk, int* last_dc) {
  int s = kFast ? r.decode_fast(c.dc) : r.decode(c.dc);
  if (s) s = extend((int)(kFast ? r.take_fast(s) : r.take(s)), s);
  *last_dc += s;
  blk[0] = (int16_t)*last_dc;
  for (int k = 1; k < 64; ++k) {
    int rs = kFast ? r.decode_fast(c.ac) : r.decode(c.ac);
    int run = rs >> 4;
    s = rs & 15;
    if (s) {
      k += run;
      blk[kNatural[k]] = (int16_t)extend((int)(kFast ? r.take_fast(s) : r.take(s)), s);
    } else {
      if (run != 15) break;
      k += 15;
    }
  }
}

}  // namespace

extern "C" {

// One scan from data[pos] (just after its SOS header).
//   p: [ncomp, Ss, Se, Ah, Al, progressive, restart_interval, mcus_x, mcus_y,
//       fake_eoi (1: past the end the data reads as fake EOI markers, as
//       under libtiff, instead of ending the decode), then for each scan
//       component: h, v, stride, bw, bh, dc table, ac table
//       (-1 where the scan reads none; the tables it reads were checked), 0]
//   tables: 8 Huffman specs of 273 bytes (DC 0-3, then AC 0-3): 16 counts, a
//       defined flag, 256 symbols;
//   coefs: a pointer a scan component to its int16 (blocks, 64) array, natural
//       order, blocks row-major with `stride` blocks a row.
// Returns where libjpeg-turbo's reader goes on after the scan (the FF of the
// marker it stopped at, or the next byte it has not read; past len under
// fake_eoi), or -1 when the data ended where it wanted another byte.
int64_t radnet_jpeg_scan(const uint8_t* data, int64_t len, int64_t pos, const int32_t* p,
                         const uint8_t* tables, int16_t** coefs) {
  const int ncomp = p[0], Ss = p[1], Se = p[2], Ah = p[3], Al = p[4], progressive = p[5];
  const int restart_interval = p[6], mcus_x = p[7], mcus_y = p[8];
  const bool fake_eoi = p[9] != 0;
  Huff huffs[8];
  bool built[8] = {false};
  ScanComp comps[4];
  int blocks_in_mcu = 0;
  for (int i = 0; i < ncomp; ++i) {
    const int32_t* c = p + 10 + 8 * i;
    const int t[2] = {c[5], c[6] < 0 ? -1 : 4 + c[6]};  // -1: the scan reads no such table
    for (int j = 0; j < 2; ++j)
      if (t[j] >= 0 && !built[t[j]]) {
        make_huff(tables + 273 * t[j], &huffs[t[j]]);
        built[t[j]] = true;
      }
    comps[i] = {c[0], c[1], c[2], c[3], c[4], t[0] < 0 ? nullptr : &huffs[t[0]],
                t[1] < 0 ? nullptr : &huffs[t[1]], coefs[i]};
    blocks_in_mcu += ncomp == 1 ? 1 : c[0] * c[1];
  }
  Reader r{data, len, pos, fake_eoi};
  int last_dc[4] = {0, 0, 0, 0};
  int restarts_to_go = restart_interval, next_rst = 0, eobrun = 0;
  // A non-interleaved scan's MCU is one block of the component's own extent.
  const int64_t nx = ncomp == 1 ? comps[0].bw : mcus_x, ny = ncomp == 1 ? comps[0].bh : mcus_y;
  const int p1 = 1 << Al, m1 = (int)((unsigned)-1 << Al);

  try {
    for (int64_t my = 0; my < ny; ++my) {
      for (int64_t mx = 0; mx < nx; ++mx) {
        if (restart_interval && restarts_to_go == 0) {
          process_restart(r, &next_rst);
          for (int i = 0; i < ncomp; ++i) last_dc[i] = 0;
          eobrun = 0;
          restarts_to_go = restart_interval;
        }
        // libjpeg-turbo takes the fast path with no restart interval, no
        // marker read and BUFSIZE (512) bytes a block of the MCU left.
        const bool fast = !progressive && !restart_interval && r.marker == 0 &&
                          len - r.pos >= 512 * (int64_t)blocks_in_mcu;
        if (!r.insufficient) {  // else the rest of the segment stays as it is
          Reader t = r;
          int dc[4] = {last_dc[0], last_dc[1], last_dc[2], last_dc[3]};
          bool redo = false;
          for (int i = 0; i < ncomp; ++i) {
            const ScanComp& c = comps[i];
            const int hb = ncomp == 1 ? 1 : c.h, vb = ncomp == 1 ? 1 : c.v;
            for (int by = 0; by < vb; ++by) {
              for (int bx = 0; bx < hb; ++bx) {
                int16_t* blk = c.coef + ((my * vb + by) * c.stride + (mx * hb + bx)) * 64;
                if (!progressive) {
                  if (fast)
                    sequential_block<true>(t, c, blk, &dc[i]);
                  else
                    sequential_block<false>(r, c, blk, &last_dc[i]);
                } else if (Ss == 0 && Ah == 0) {  // DC first
                  int s = r.decode(c.dc);
                  if (s) s = extend((int)r.take(s), s);
                  last_dc[i] += s;
                  blk[0] = (int16_t)((unsigned)last_dc[i] << Al);
                } else if (Ss == 0) {  // DC refine
                  if (r.take(1)) blk[0] = (int16_t)(blk[0] | p1);
                } else if (Ah == 0) {  // AC first
                  if (eobrun > 0) {
                    --eobrun;
                    continue;
                  }
                  for (int k = Ss; k <= Se; ++k) {
                    int rs = r.decode(c.ac);
                    int run = rs >> 4, s = rs & 15;
                    if (s) {
                      k += run;
                      int v = extend((int)r.take(s), s);
                      blk[kNatural[k]] = (int16_t)((unsigned)v << Al);
                    } else if (run == 15) {
                      k += 15;
                    } else {
                      eobrun = 1 << run;
                      if (run) eobrun += (int)r.take(run);
                      --eobrun;
                      break;
                    }
                  }
                } else {  // AC refine
                  int k = Ss;
                  if (eobrun == 0) {
                    for (; k <= Se; ++k) {
                      int rs = r.decode(c.ac);
                      int run = rs >> 4, s = rs & 15;
                      if (s) {
                        s = r.take(1) ? p1 : m1;
                      } else if (run != 15) {
                        eobrun = 1 << run;
                        if (run) eobrun += (int)r.take(run);
                        break;
                      }
                      do {
                        int16_t* coef = blk + kNatural[k];
                        if (*coef != 0) {
                          if (r.take(1) && (*coef & p1) == 0)
                            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                        } else if (--run < 0) {
                          break;
                        }
                        ++k;
                      } while (k <= Se);
                      if (s) blk[kNatural[k]] = (int16_t)s;
                    }
                  }
                  if (eobrun > 0) {
                    for (; k <= Se; ++k) {
                      int16_t* coef = blk + kNatural[k];
                      if (*coef != 0 && r.take(1) && (*coef & p1) == 0)
                        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                    }
                    --eobrun;
                  }
                }
              }
            }
          }
          if (fast) {
            if (t.marker != 0) {  // met a marker: the slow path decodes the MCU again
              redo = true;
            } else {
              r = t;
              std::memcpy(last_dc, dc, sizeof(dc));
            }
          }
          if (redo) {
            for (int i = 0; i < ncomp; ++i) {
              const ScanComp& c = comps[i];
              const int hb = ncomp == 1 ? 1 : c.h, vb = ncomp == 1 ? 1 : c.v;
              for (int by = 0; by < vb; ++by)
                for (int bx = 0; bx < hb; ++bx)
                  sequential_block<false>(
                      r, c, c.coef + ((my * vb + by) * c.stride + (mx * hb + bx)) * 64, &last_dc[i]);
            }
          }
        }
        if (restart_interval) --restarts_to_go;
      }
    }
  } catch (const Suspend&) {
    return -1;
  }
  return r.marker ? r.pos - 2 : r.pos;
}

}  // extern "C"

namespace {

// jidctint.c: constants scaled by 2^13.
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

// jidctint.c's ISLOW IDCT as libjpeg-turbo's AVX2 version (jidctint-avx2.asm,
// which OpenCV's libjpeg-turbo runs on x86) computes it.  On coefficients
// that keep every value below in 16 bits, as an encoder's always do, it
// equals the C version; it differs only on corrupt data, so this keeps the
// SIMD version's lanes: dequantized values, in0 +- in4, in7 + in3 and
// in5 + in1 wrap at 16 bits (vpmullw, vpaddw), products and sums at 32 bits
// (vpmaddwd, vpaddd), pass 1 saturates to 16 bits (vpackssdw), the output to
// 8 bits (vpacksswb) before the +128, and a block whose rows 1-7 are all zero
// takes pass 1 as dc << 2 in 16 bits (vpsllw).
inline int16_t wrap16(int64_t x) { return (int16_t)(uint16_t)x; }
inline int32_t wrap32(int64_t x) { return (int32_t)(uint32_t)x; }
inline int16_t sat16(int32_t x) { return (int16_t)(x < -32768 ? -32768 : x > 32767 ? 32767 : x); }

// One 1-D pass (the AVX2 dodct macro) over v[0..7]; out = the 8 results
// descaled by n bits, before the pass's saturation.
void dodct(const int16_t* v, int n, int32_t* out) {
  const int64_t in0 = v[0], in1 = v[1], in2 = v[2], in3 = v[3], in4 = v[4], in5 = v[5],
                in6 = v[6], in7 = v[7];
  const int64_t tmp3 = in2 * (F0541 + F0765) + in6 * F0541;
  const int64_t tmp2 = in2 * F0541 + in6 * (F0541 - F1847);
  const int64_t tmp0 = (int64_t)wrap16(in0 + in4) * 8192, tmp1 = (int64_t)wrap16(in0 - in4) * 8192;
  const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  const int64_t z3 = wrap16(in7 + in3), z4 = wrap16(in5 + in1);
  const int64_t z3n = z3 * (F1175 - F1961) + z4 * F1175;
  const int64_t z4n = z3 * F1175 + z4 * (F1175 - F0390);
  const int64_t o0 = in7 * (F0298 - F0899) + in1 * -F0899 + z3n;
  const int64_t o1 = in5 * (F2053 - F2562) + in3 * -F2562 + z4n;
  const int64_t o2 = in5 * -F2562 + in3 * (F3072 - F2562) + z3n;
  const int64_t o3 = in7 * -F0899 + in1 * (F1501 - F0899) + z4n;
  const int64_t r = (int64_t)1 << (n - 1);  // sums wrap at 32 bits, then shift
  out[0] = wrap32(t10 + o3 + r) >> n;
  out[7] = wrap32(t10 - o3 + r) >> n;
  out[1] = wrap32(t11 + o2 + r) >> n;
  out[6] = wrap32(t11 - o2 + r) >> n;
  out[2] = wrap32(t12 + o1 + r) >> n;
  out[5] = wrap32(t12 - o1 + r) >> n;
  out[3] = wrap32(t13 + o0 + r) >> n;
  out[4] = wrap32(t13 - o0 + r) >> n;
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int64_t out_stride) {
  int16_t ws[64], v[8];
  int32_t res[8];
  bool ac_zero = true;
  for (int k = 8; k < 64 && ac_zero; ++k) ac_zero = in[k] == 0;
  for (int c = 0; c < 8; ++c) {
    if (ac_zero) {
      int16_t dc = wrap16(wrap16((int32_t)in[c] * q[c]) * 4);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    for (int r = 0; r < 8; ++r) v[r] = wrap16((int32_t)in[r * 8 + c] * q[r * 8 + c]);
    dodct(v, 11, res);
    for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(res[r]);
  }
  for (int r = 0; r < 8; ++r) {
    dodct(ws + r * 8, 18, res);
    uint8_t* o = out + r * out_stride;
    for (int c = 0; c < 8; ++c) {
      int32_t x = sat16(res[c]);
      o[c] = (uint8_t)((x < -128 ? -128 : x > 127 ? 127 : x) + 128);
    }
  }
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF folded into Cb's G.
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

// One component's samples (cw x ch, row stride ps) upsampled to the image's
// W x H by the method jdsample.c picks for factors (rh, rv) = (hmax / h,
// vmax / v).
void upsample(const uint8_t* in, int64_t ps, int64_t cw, int64_t ch, int rh, int rv, int64_t W,
              int64_t H, uint8_t* out) {
  std::vector<uint8_t> row(2 * cw + 8);
  std::vector<int> cs(cw);
  for (int64_t y = 0; y < H; ++y) {
    uint8_t* o = out + y * W;
    const int64_t r = y / rv;  // the input row this output row lies in
    const uint8_t* in0 = in + r * ps;
    if (rh == 1 && rv == 1) {
      std::memcpy(o, in0, W);
    } else if (rh == 2 && rv == 1 && cw > 2) {  // h2v1 fancy
      uint8_t* d = row.data();
      d[0] = in0[0];
      d[1] = (uint8_t)((in0[0] * 3 + in0[1] + 2) >> 2);
      for (int64_t i = 1; i < cw - 1; ++i) {
        int v = in0[i] * 3;
        d[2 * i] = (uint8_t)((v + in0[i - 1] + 1) >> 2);
        d[2 * i + 1] = (uint8_t)((v + in0[i + 1] + 2) >> 2);
      }
      d[2 * cw - 2] = (uint8_t)((in0[cw - 1] * 3 + in0[cw - 2] + 1) >> 2);
      d[2 * cw - 1] = in0[cw - 1];
      std::memcpy(o, d, W);
    } else if (rh == 1 && rv == 2) {  // h1v2 fancy
      const bool upper = (y % 2) == 0;
      const int64_t r1 = upper ? (r > 0 ? r - 1 : 0) : (r + 1 < ch ? r + 1 : ch - 1);
      const uint8_t* in1 = in + r1 * ps;
      const int bias = upper ? 1 : 2;
      for (int64_t x = 0; x < W; ++x) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (rh == 2 && rv == 2 && cw > 2) {  // h2v2 fancy
      const bool upper = (y % 2) == 0;
      const int64_t r1 = upper ? (r > 0 ? r - 1 : 0) : (r + 1 < ch ? r + 1 : ch - 1);
      const uint8_t* in1 = in + r1 * ps;
      for (int64_t i = 0; i < cw; ++i) cs[i] = in0[i] * 3 + in1[i];
      uint8_t* d = row.data();
      d[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
      d[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
      for (int64_t i = 1; i < cw - 1; ++i) {
        d[2 * i] = (uint8_t)((cs[i] * 3 + cs[i - 1] + 8) >> 4);
        d[2 * i + 1] = (uint8_t)((cs[i] * 3 + cs[i + 1] + 7) >> 4);
      }
      d[2 * cw - 2] = (uint8_t)((cs[cw - 1] * 3 + cs[cw - 2] + 8) >> 4);
      d[2 * cw - 1] = (uint8_t)((cs[cw - 1] * 4 + 7) >> 4);
      std::memcpy(o, d, W);
    } else {  // box (h2v1, h2v2 at most 2 wide) and other integral factors
      for (int64_t x = 0; x < W; ++x) o[x] = in0[x / rh];
    }
  }
}

}  // namespace

extern "C" {

// The decoded coefficients -> pixels, row by row.
//   p: [ncomp, W, H, hmax, vmax, colour, stride (bytes from one output row
//       to the next), rows (the first rows written, at most H), then for
//       each component: h, v, stride (blocks a row of its coefficient
//       array), 0]
//   colour: 0 YCbCr converted and written B, G, R (grey: three equal
//       channels); 1 the three components are R, G, B and written B, G, R;
//       2 YCbCr converted and written R, G, B (libjpeg's JCS_RGB output, as
//       libtiff's JPEGCOLORMODE_RGB asks it); 3 the components written as
//       they are, interleaved (JCS_UNKNOWN's null conversion); 4 CMYK and
//       5 YCCK (libjpeg's JCS_CMYK output of a JCS_CMYK or JCS_YCCK frame),
//       written B, G, R as OpenCV converts CMYK;
//   coefs: a pointer a component to its int16 coefficients (natural order);
//   quant: a component's 64 dequantization values (natural order, int16 as
//       libjpeg-turbo's ISLOW_MULT_TYPE holds them), one after another.
int radnet_jpeg_output(const int32_t* p, int16_t** coefs, const int16_t* quant, uint8_t* out) {
  const int ncomp = p[0], hmax = p[3], vmax = p[4], colour = p[5];
  const int64_t W = p[1], H = p[2], stride = p[6], rows = p[7];
  std::vector<std::vector<uint8_t>> full(ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    const int32_t* c = p + 8 + 4 * ci;
    const int h = c[0], v = c[1], cstride = c[2];
    const int64_t cw = (W * h + hmax - 1) / hmax, ch = (H * v + vmax - 1) / vmax;
    const int64_t bw = (cw + 7) / 8, bh = (ch + 7) / 8;
    const int64_t ps = bw * 8;
    std::vector<uint8_t> plane(ps * bh * 8);
    for (int64_t by = 0; by < bh; ++by)
      for (int64_t bx = 0; bx < bw; ++bx)
        idct_islow(coefs[ci] + (by * cstride + bx) * 64, quant + 64 * ci,
                   plane.data() + by * 8 * ps + bx * 8, ps);
    full[ci].resize(W * H);
    upsample(plane.data(), ps, cw, ch, hmax / h, vmax / v, W, H, full[ci].data());
  }
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* o = out + y * stride;
    const int64_t i0 = y * W;
    if (colour == 3) {
      for (int ci = 0; ci < ncomp; ++ci) {
        const uint8_t* s = full[ci].data() + i0;
        for (int64_t x = 0; x < W; ++x) o[x * ncomp + ci] = s[x];
      }
    } else if (ncomp == 1) {
      const uint8_t* Y = full[0].data() + i0;
      for (int64_t x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = Y[x];
    } else if (colour == 4 || colour == 5) {
      const uint8_t *C = full[0].data() + i0, *M = full[1].data() + i0, *Y = full[2].data() + i0,
                    *K = full[3].data() + i0;
      for (int64_t x = 0; x < W; ++x) {
        int c = C[x], m = M[x], y = Y[x];
        const int k = K[x];
        if (colour == 5) {  // jdcolor.c ycck_cmyk_convert: C, M, Y = 255 - R, G, B of YCbCr
          const int yy = c, cb = m, cr = y;
          c = clamp255(255 - (yy + kYcc.cr_r[cr]));
          m = clamp255(255 - (yy + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
          y = clamp255(255 - (yy + kYcc.cb_b[cb]));
        }
        o[3 * x] = (uint8_t)(k - (((255 - y) * k) >> 8));
        o[3 * x + 1] = (uint8_t)(k - (((255 - m) * k) >> 8));
        o[3 * x + 2] = (uint8_t)(k - (((255 - c) * k) >> 8));
      }
    } else if (colour == 1) {  // jdcolor.c rgb_rgb_convert: only the order changes
      const uint8_t *R = full[0].data() + i0, *G = full[1].data() + i0, *B = full[2].data() + i0;
      for (int64_t x = 0; x < W; ++x) o[3 * x] = B[x], o[3 * x + 1] = G[x], o[3 * x + 2] = R[x];
    } else {
      const uint8_t *Y = full[0].data() + i0, *Cb = full[1].data() + i0, *Cr = full[2].data() + i0;
      const int ro = colour == 2 ? 0 : 2, bo = 2 - ro;
      for (int64_t x = 0; x < W; ++x) {
        const int yy = Y[x], cb = Cb[x], cr = Cr[x];
        o[3 * x + ro] = clamp255(yy + kYcc.cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[3 * x + bo] = clamp255(yy + kYcc.cb_b[cb]);
      }
    }
  }
  return 0;
}

}  // extern "C"

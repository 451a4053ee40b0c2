// _jpeg.cpp: a baseline JPEG codec with a plain C interface, loaded with
// ctypes (see simplestereo_tpu_torch/native/__init__.py).
//
// It takes the place of Pillow for the port's JPEG files and Motion-JPEG
// video (simplestereo_tpu_torch/imgio.py, videoio.py). The decoder uses
// libjpeg's arithmetic, so that its pixels can equal what Pillow (built on
// libjpeg-turbo) gives: the ISLOW integer IDCT of jidctint.c, the "fancy"
// triangle upsampling of jdsample.c and the fixed-point YCbCr -> RGB tables
// of jdcolor.c.
//
// Decoder: SOF0, SOF1 and SOF2 (progressive, Huffman), SOF9 and SOF10
// (sequential and progressive, arithmetic-coded: jdarith.c's QM decoder,
// its statistics bins, DAC conditioning) and SOF3 (lossless: predictors
// 1-7, point transform, Huffman-coded differences; sampling 1x1) at 8
// bits; 1, 3 or 4 components (YCbCr or Adobe RGB; CMYK or YCCK, which
// Pillow reads inverted, "CMYK;I"); sampling factors of 1 to 4 (4:4:4,
// 4:2:2, 4:2:0, 4:4:0 with libjpeg's "fancy" upsampling; other integer
// ratios replicated, as libjpeg's int_upsample does), at most 10 blocks in
// an interleaved MCU; interleaved or one-component scans, DRI/RSTn
// restart intervals, and the Annex K standard Huffman tables where a
// frame has no DHT segment (Motion JPEG frames of webcams and IP cameras
// usually carry none; libjpeg fills them in the same way). A progressive
// frame's scans (DC first and refinement, AC first with EOB runs and AC
// refinement, the successive approximation of T.81 G.1.2) are
// entropy-decoded into the same coefficient arrays as a baseline frame's,
// as jdphuff.c does, and the IDCT, upsampling and colour conversion are
// shared, so both kinds decode to libjpeg's pixels. libjpeg smooths the
// blocks of a progressive image whose low AC coefficients are not all
// sent (jdcoefct.c's decompress_smooth_data); every scan script that
// sends all 64 (Pillow's, libjpeg's jpeg_simple_progression) needs no
// smoothing, and this decoder does none. Hierarchical frames, lossless
// arithmetic frames and samples of other than 8 bits are refused with an
// error naming the feature; so does Pillow's libjpeg-turbo (its 8-bit API)
// for all but lossless arithmetic. libtiff's settings for JPEG-in-TIFF
// are the colour argument of jpeg_decode.
//
// Encoder: baseline, JFIF, 1 or 3 components, luma sampling factors h x v
// of 1 to 4 (at most 8 blocks; 2x2 = 4:2:0 by default, as Pillow) against
// chroma's 1x1, the Annex K quantisation tables
// scaled by the IJG quality formula, the standard Huffman tables and the
// ISLOW forward DCT of jfdctint.c; its pixels decode as Pillow's encoder's.
//
// C entries (each returns 0 or a byte count on success and -1 on error;
// jpeg_error() then gives the message, kept per thread):
//   jpeg_header(data, n, info)              info: int[3] = height, width,
//                                           components (1, 3 or 4)
//   jpeg_decode(data, n, out, cap, bgr, colour)
//       out: height x width x components uint8, colour in BGR order when
//       bgr else RGB; colour 0 as the markers say, 1 YCbCr, 2 as stored
//   jpeg_encode(img, h, w, c, bgr, quality, hs, vs, out, cap)
//       img: h x w x c uint8 (c 1 or 3); returns the byte count, or
//       -2 - (bytes needed) when cap is too small.
//   jpeg_error()

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

thread_local char g_error[256];

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, int a = 0, int b = 0) {
  char buf[256];
  snprintf(buf, sizeof(buf), fmt, a, b);
  throw Error{buf};
}

// zigzag index -> natural (row-major) index; 16 extra entries keep a
// corrupt run length inside the block, as libjpeg's table does.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ITU T.81 Annex K.3 tables: bits[1..16] (bits[0] unused) and values.
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Annex K.1 quantisation tables, natural order.
const int kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jidctint.c / jfdctint.c constants (CONST_BITS 13).
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// ---------------------------------------------------------------- Huffman

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << 9];  // (length << 8) | value; length 0: longer code
  uint32_t code[256];     // encoder: code and length of each symbol
  uint8_t size[256];
};

void set_table(Huffman& t, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int l = 1; l <= 16; ++l) n += bits[l];
  if (n > 256) fail("corrupt JPEG: Huffman table with %d codes", n);
  memset(t.vals, 0, sizeof(t.vals));
  memcpy(t.vals, vals, n);
  // Canonical codes (T.81 Annex C), then libjpeg's decoding tables.
  uint32_t codes[257];
  int p = 0;
  uint32_t c = 0;
  for (int l = 1; l <= 16; ++l) {
    t.valoffset[l] = p - int(c);
    for (int i = 0; i < bits[l]; ++i) codes[p++] = c++;
    if (c > (1u << l)) fail("corrupt JPEG: bad Huffman table");
    t.maxcode[l] = bits[l] ? int(c) - 1 : -1;
    c <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  memset(t.look, 0, sizeof(t.look));
  memset(t.size, 0, sizeof(t.size));
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      t.code[t.vals[p]] = codes[p];
      t.size[t.vals[p]] = uint8_t(l);
      if (l <= 9) {
        uint32_t first = codes[p] << (9 - l);
        for (uint32_t k = 0; k < (1u << (9 - l)); ++k)
          t.look[first + k] = uint16_t((l << 8) | t.vals[p]);
      }
    }
  }
  t.defined = true;
}

// --------------------------------------------------------------- Decoder

struct BitReader {
  const uint8_t* data;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool marker = false;  // stopped at a marker (or the end of the data)
  bool at_end = false;  // the data ran out inside the scan
  int64_t pad_bits = 0; // zero bits fed after the marker

  void fill() {
    while (nbits <= 56) {
      uint8_t b = 0;
      if (!marker) {
        if (pos >= n) {
          marker = at_end = true;
        } else if (data[pos] == 0xFF) {
          if (pos + 1 < n && data[pos + 1] == 0x00) {
            b = 0xFF;
            pos += 2;
          } else {
            marker = true;
            if (pos + 1 >= n) at_end = true;
          }
        } else {
          b = data[pos++];
        }
      }
      if (marker) pad_bits += 8;
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }
  inline uint32_t peek(int k) {
    if (nbits < k) fill();
    return uint32_t(acc >> (nbits - k)) & ((1u << k) - 1);
  }
  inline void skip(int k) { nbits -= k; }
  inline int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return int(v);
  }
  // Bits of the zero padding that decoding has consumed.
  int64_t padding_used() const { return pad_bits > nbits ? pad_bits - nbits : 0; }
  void reset() {
    acc = 0;
    nbits = 0;
    pad_bits = 0;
  }
};

inline int decode_symbol(BitReader& br, const Huffman& t) {
  if (br.nbits < 16) br.fill();
  uint16_t e = t.look[br.peek(9)];
  if (e >> 8) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  int l = 10;
  int32_t c = int32_t(br.peek(l));
  while (l <= 16 && c > t.maxcode[l]) {
    ++l;
    c = int32_t(br.peek(l));
  }
  if (l > 16) return 0;  // corrupt data: libjpeg warns and decodes a zero
  br.skip(l);
  return t.vals[(c + t.valoffset[l]) & 0xFF];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | next index
// after an MPS << 8 | switch-MPS flag << 7 | next index after an LPS.
const int32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171,
};

// jdarith.c's arith_decode: the QM decoder of T.81 Annex D over the scan's
// bytes (0xFF 0x00 stuffing; at a marker, zeros from then on).
struct ArithReader {
  const uint8_t* data;
  size_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  int marker = 0;         // the marker the data ran into, 0 before
  size_t marker_at = 0;   // its 0xFF (n: the data's end)
  int byte() {
    if (marker) return 0;
    if (pos >= n) {
      marker = 0xD9;
      marker_at = n;
      return 0;
    }
    const size_t at = pos;
    int d = data[pos++];
    if (d == 0xFF) {
      while (pos < n && data[pos] == 0xFF) ++pos;
      if (pos >= n) {
        marker = 0xD9;
        marker_at = n;
        return 0;
      }
      const int m = data[pos++];
      if (m == 0) return 0xFF;
      marker = m;
      marker_at = at;
      return 0;
    }
    return d;
  }
  bool broken = false;  // a bad code: the rest of the interval decodes
                        // nothing (jdarith.c's ct = -1)
  void reset() {
    c = 0;
    a = 0;
    ct = -16;
    broken = false;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const uint8_t nl = uint8_t(qe & 0xFF);
    qe >>= 8;
    const uint8_t nm = uint8_t(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;       // Huffman tables of the current scan
  int bw = 0, bh = 0;       // blocks stored (whole MCUs)
  int dw = 0, dh = 0;       // downsampled size in samples
  bool latched = false;     // quantisation table copied at its first scan
  int quant[64];
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint16_t> raw;  // lossless: the samples before the transform
  std::vector<uint8_t> plane; // bw*8 x bh*8 samples after the IDCT
};

struct Decoder {
  const uint8_t* data;
  size_t n, pos = 0;
  int height = 0, width = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart = 0;
  int scans = 0;
  bool progressive = false, arith = false, lossless = false;
  int eobrun = 0;  // blocks left in the current AC end-of-band run
  // Arithmetic coding: the statistics bins of each table (jdarith.c's
  // DC_STAT_BINS, AC_STAT_BINS) and the DAC conditioning (L, U, Kx).
  uint8_t dc_stats[4][64], ac_stats[4][256];
  int dac_l[4] = {0, 0, 0, 0}, dac_u[4] = {1, 1, 1, 1},
      dac_k[4] = {5, 5, 5, 5};
  Component comp[4];
  int quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  int u8(size_t p) {
    if (p >= n) fail("truncated JPEG data");
    return data[p];
  }
  int u16(size_t p) { return (u8(p) << 8) | u8(p + 1); }

  // The next marker code at or after pos (fill 0xFF bytes skipped); pos
  // is left after it.
  int next_marker() {
    while (pos < n && data[pos] != 0xFF) ++pos;
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) return -1;
    return data[pos++];
  }

  void parse_sof(size_t p, int len, int marker) {
    if (frame) fail("corrupt JPEG: two frame headers");
    int precision = u8(p);
    if (precision != 8)
      fail("%d-bit JPEG is not supported (8-bit samples only)", precision);
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = u8(p + 5);
    if (height == 0) fail("JPEG with height 0 (DNL) is not supported");
    if (width == 0) fail("corrupt JPEG: width 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("JPEG with %d components is not supported", ncomp);
    if (len < 8 + 3 * ncomp) fail("corrupt JPEG: short SOF%d", marker - 0xC0);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8(p + 6 + 3 * i);
      c.h = u8(p + 7 + 3 * i) >> 4;
      c.v = u8(p + 7 + 3 * i) & 15;
      c.tq = u8(p + 8 + 3 * i);
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: sampling %dx%d", c.h, c.v);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        fail("JPEG sampling factors %d/%d are not integer ratios", hmax, c.h);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
    }
    frame = true;
  }

  void parse_dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = u8(p) >> 4, tq = u8(p) & 15;
      if (tq > 3) fail("corrupt JPEG: quantisation table %d", tq);
      ++p;
      for (int k = 0; k < 64; ++k) {
        int q = pq ? u16(p + 2 * k) : u8(p + k);
        quant[tq][kNatural[k]] = q;
      }
      p += pq ? 128 : 64;
      quant_defined[tq] = true;
    }
  }

  void parse_dht(size_t p, size_t end) {
    while (p < end) {
      int tc = u8(p) >> 4, th = u8(p) & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: Huffman table %d/%d", tc, th);
      uint8_t bits[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += bits[l] = uint8_t(u8(p + l));
      if (total > 256) fail("corrupt JPEG: Huffman table with %d codes", total);
      uint8_t vals[256] = {0};
      for (int i = 0; i < total; ++i) vals[i] = uint8_t(u8(p + 17 + i));
      set_table(tc ? ac[th] : dc[th], bits, vals);
      p += 17 + total;
    }
  }

  // jdmarker.c's examine_app0 and examine_app14: a JFIF payload of at
  // least 14 bytes, an Adobe one of at least 12.
  void parse_app(size_t p, int len, int marker) {
    if (marker == 0xE0 && len >= 14 && memcmp(data + p, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 12 && memcmp(data + p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = data[p + 11];
    }
  }

  // libjpeg: a table a scan needs and no DHT defined is the standard one.
  void default_tables() {
    if (!dc[0].defined) set_table(dc[0], kDcLumBits, kDcVals);
    if (!dc[1].defined) set_table(dc[1], kDcChromBits, kDcVals);
    if (!ac[0].defined) set_table(ac[0], kAcLumBits, kAcLumVals);
    if (!ac[1].defined) set_table(ac[1], kAcChromBits, kAcChromVals);
  }

  void decode_block(BitReader& br, Component& c, int& pred, int16_t* blk) {
    const Huffman& dct = dc[c.td];
    const Huffman& act = ac[c.ta];
    int s = decode_symbol(br, dct);
    if (s > 15) s = 0;
    int diff = s ? extend(br.get(s), s) : 0;
    pred += diff;
    blk[0] = int16_t(pred);
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(br, act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  // Progressive scans (jdphuff.c): each block's share of one scan, into
  // the coefficients decoded by the scans before it.
  void decode_dc_first(BitReader& br, Component& c, int& pred, int16_t* blk,
                       int al) {
    int s = decode_symbol(br, dc[c.td]);
    if (s > 15) s = 0;
    pred += s ? extend(br.get(s), s) : 0;
    blk[0] = int16_t(unsigned(pred) << al);
  }

  void decode_ac_first(BitReader& br, Component& c, int16_t* blk, int ss,
                       int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& t = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = decode_symbol(br, t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(unsigned(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;  // sixteen zeros
      } else {
        eobrun = (1 << r) + (r ? br.get(r) : 0) - 1;
        break;
      }
    }
  }

  // One correction bit for a coefficient already nonzero: a 1 adds the
  // scan's bit to its magnitude.
  static void refine(BitReader& br, int16_t* co, int p1) {
    if (br.get(1) && (*co & p1) == 0) *co = int16_t(*co + (*co >= 0 ? p1 : -p1));
  }

  void decode_ac_refine(BitReader& br, Component& c, int16_t* blk, int ss,
                        int se, int al) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      const Huffman& t = ac[c.ta];
      for (; k <= se; ++k) {
        int rs = decode_symbol(br, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : -p1;  // a newly nonzero coefficient
        } else if (r != 15) {
          eobrun = (1 << r) + (r ? br.get(r) : 0);
          break;
        }
        // Past the nonzero coefficients (each takes a correction bit) and
        // r zero ones, to the zero coefficient that becomes s.
        do {
          int16_t* co = blk + kNatural[k];
          if (*co != 0) {
            refine(br, co, p1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k)
        if (blk[kNatural[k]] != 0) refine(br, blk + kNatural[k], p1);
      --eobrun;
    }
  }

  // A lossless scan (T.81 Annex H, libjpeg-turbo's jdlossls.c): Huffman-
  // coded differences (category 16: 32768) from predictor `psv`, samples
  // scaled up by the point transform `pt`, into the components' planes.
  // Sampling 1x1, restarts at row boundaries.
  void lossless_scan(Component** sc, int ns, int psv, int pt, size_t start) {
    if (psv < 1 || psv > 7) fail("corrupt JPEG: lossless predictor %d", psv);
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (c.h != hmax || c.v != vmax)
        fail("lossless JPEG with subsampled components is not supported");
      if (!dc[c.td].defined)
        fail("corrupt JPEG: Huffman table %d is not defined", c.td);
      if (c.raw.empty()) c.raw.assign(size_t(width) * height, 0);
    }
    if (restart && restart % width)
      fail("lossless JPEG restart interval %d is not whole rows", restart);
    BitReader br{data, n, start};
    int preds[4] = {0, 0, 0, 0};
    int left = restart;
    bool first_row = true;
    for (int y = 0; y < height; ++y) {
      if (y && restart && left == 0) {
        restart_marker(br, preds);
        left = restart;
        first_row = true;
      }
      for (int x = 0; x < width; ++x) {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          int s = decode_symbol(br, dc[c.td]);
          int diff;
          if (s == 16) {
            diff = 32768;
          } else {
            if (s > 15) s = 0;
            diff = s ? extend(br.get(s), s) : 0;
          }
          uint16_t* row = &c.raw[size_t(y) * width];
          int pred;
          if (first_row) {
            pred = x == 0 ? 1 << (8 - pt - 1) : row[x - 1];
          } else if (x == 0) {
            pred = row[x - width];
          } else {
            const int ra = row[x - 1], rb = row[x - width],
                      rc = row[x - width - 1];
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1;
            }
          }
          row[x] = uint16_t((diff + pred) & 0xFFFF);
        }
        if (restart) --left;
      }
      first_row = false;
    }
    for (int i = 0; i < ns; ++i) {  // the point transform, to 8 bits
      Component& c = *sc[i];
      const int stride = c.bw * 8;
      c.plane.assign(size_t(stride) * c.bh * 8, 0);
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x)
          c.plane[size_t(y) * stride + x] =
              uint8_t(c.raw[size_t(y) * width + x] << pt);
    }
    if (br.at_end && br.padding_used() > 0) fail("truncated JPEG data");
    size_t q = br.pos;
    while (q < n && !(data[q] == 0xFF && q + 1 < n && data[q + 1] != 0x00 &&
                      data[q + 1] != 0xFF &&
                      !(data[q + 1] >= 0xD0 && data[q + 1] <= 0xD7)))
      ++q;
    pos = q;
    ++scans;
  }

  // One block's share of an arithmetic-coded scan (jdarith.c's
  // decode_mcu, decode_mcu_DC_first, _AC_first, _DC_refine, _AC_refine;
  // kind as in parse_sos).
  // A bad code (a magnitude or a run past its range) is libjpeg's
  // warning: the block keeps what it has, and the rest of the restart
  // interval decodes nothing.
  void arith_unit(ArithReader& ar, Component& c, int& pred, int& ctx,
                  int16_t* blk, int kind, int ss, int se, int al) {
    if (ar.broken) return;
    uint8_t fixed = 113;  // the fixed-probability bin
    if (kind == 0 || kind == 1) {  // DC (sequential or first stage)
      uint8_t* st = dc_stats[c.td] + ctx;
      if (ar.decode(st) == 0) {
        ctx = 0;
      } else {
        const int sign = ar.decode(st + 1);
        st += 2 + sign;
        int v;
        int m0 = ar.decode(st), m = m0;
        if (m0) {
          st = dc_stats[c.td] + 20;
          while (ar.decode(st)) {
            if ((m <<= 1) == 0x8000) {
              ar.broken = true;
              return;
            }
            ++st;
          }
        }
        if (m < ((1 << dac_l[c.td]) >> 1))
          ctx = 0;
        else if (m > ((1 << dac_u[c.td]) >> 1))
          ctx = 12 + sign * 4;
        else
          ctx = 4 + sign * 4;
        v = m;
        st += 14;
        while (m >>= 1)
          if (ar.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        pred += v;
      }
      blk[0] = int16_t(kind == 1 ? pred * (1 << al) : pred);
      if (kind == 1) return;
    }
    if (kind == 2) {
      if (ar.decode(&fixed)) blk[0] = int16_t(blk[0] | (1 << al));
      return;
    }
    if (kind == 4) {  // AC refinement
      const int p1 = 1 << al, m1 = -1 * (1 << al);
      int kex = se;
      for (; kex > 0; --kex)
        if (blk[kNatural[kex]]) break;
      for (int k = ss; k <= se; ++k) {
        uint8_t* st = ac_stats[c.ta] + 3 * (k - 1);
        if (k > kex && ar.decode(st)) break;
        for (;;) {
          int16_t& co = blk[kNatural[k]];
          if (co) {
            if (ar.decode(st + 2)) co = int16_t(co < 0 ? co + m1 : co + p1);
            break;
          }
          if (ar.decode(st + 1)) {
            co = int16_t(ar.decode(&fixed) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > se) {
            ar.broken = true;
            return;
          }
        }
      }
      return;
    }
    // AC: every coefficient (sequential) or the band ss..se (first stage).
    const int k0 = kind == 0 ? 1 : ss, k1 = kind == 0 ? 63 : se;
    const int shift = kind == 0 ? 0 : al;
    for (int k = k0; k <= k1; ++k) {
      uint8_t* st = ac_stats[c.ta] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > k1) {
          ar.broken = true;
          return;
        }
      }
      const int sign = ar.decode(&fixed);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = ac_stats[c.ta] + (k <= dac_k[c.ta] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.broken = true;
            return;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(v * (1 << shift));
    }
  }

  // At a restart boundary: drop the bits left, step over RSTn (or find the
  // next one, if the data lost it) and reset the DC predictions.
  void restart_marker(BitReader& br, int* preds) {
    br.reset();
    size_t p = br.pos;
    while (p < n) {
      if (data[p] == 0xFF && p + 1 < n && data[p + 1] == 0xFF) {
        ++p;
      } else if (data[p] == 0xFF && p + 1 < n && data[p + 1] >= 0xD0 &&
                 data[p + 1] <= 0xD7) {
        br.pos = p + 2;
        br.marker = false;
        break;
      } else if (data[p] == 0xFF && p + 1 < n && data[p + 1] != 0x00) {
        br.pos = p;  // another marker: the rest of the scan decodes as 0
        break;
      } else {
        ++p;
      }
    }
    if (p >= n) {
      br.pos = n;
    }
    for (int i = 0; i < 4; ++i) preds[i] = 0;
    eobrun = 0;
  }

  void parse_sos(size_t p, int len) {
    if (!frame) fail("corrupt JPEG: scan before the frame header");
    int ns = u8(p);
    if (ns < 1 || ns > ncomp || len < 6 + 2 * ns)
      fail("corrupt JPEG: scan of %d components", ns);
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8(p + 1 + 2 * i), t = u8(p + 2 + 2 * i);
      Component* c = nullptr;
      for (int k = 0; k < ncomp; ++k)
        if (comp[k].id == id) c = &comp[k];
      if (c == nullptr) fail("corrupt JPEG: scan names component %d", id);
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) fail("corrupt JPEG: Huffman table index");
      sc[i] = c;
    }
    int ss = u8(p + 1 + 2 * ns), se = u8(p + 2 + 2 * ns),
        ah = u8(p + 3 + 2 * ns) >> 4, al = u8(p + 3 + 2 * ns) & 15;
    // kind 0: baseline; progressive 1: DC first, 2: DC refinement, 3: AC
    // first, 4: AC refinement.
    int kind = 0;
    if (lossless) {
      lossless_scan(sc, ns, ss, al, p + len - 2);
      return;
    }
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        fail("corrupt JPEG: baseline scan with spectral range %d..%d", ss, se);
    } else {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1))
        fail("corrupt JPEG: progressive scan with spectral range %d..%d", ss,
             se);
      if (al > 13 || (ah && ah != al + 1))
        fail("corrupt JPEG: successive approximation %d/%d", ah, al);
      kind = ss == 0 ? (ah ? 2 : 1) : (ah ? 4 : 3);
    }
    if (ns > 1) {  // jdinput.c: at most 10 blocks in an interleaved MCU
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) fail("corrupt JPEG: %d blocks in an MCU", blocks);
    }
    default_tables();
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!arith && (!dc[c.td].defined || !ac[c.ta].defined))
        fail("corrupt JPEG: Huffman table %d/%d is not defined", c.td, c.ta);
      if (!c.latched) {
        if (!quant_defined[c.tq])
          fail("corrupt JPEG: quantisation table %d is not defined", c.tq);
        memcpy(c.quant, quant[c.tq], sizeof(c.quant));
        c.latched = true;
      }
      if (c.coef.empty()) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    BitReader br{data, n, p + len - 2};
    ArithReader ar{data, n, p + len - 2};
    int preds[4] = {0, 0, 0, 0}, dc_ctx[4] = {0, 0, 0, 0};
    int left = restart;
    eobrun = 0;
    // jdarith.c's start_pass and process_restart: the statistics of the
    // scan's tables and the DC predictions start again.
    auto arith_start = [&]() {
      for (int i = 0; i < ns; ++i) {
        if (!progressive || (ss == 0 && ah == 0)) {
          memset(dc_stats[sc[i]->td], 0, 64);
          preds[i] = dc_ctx[i] = 0;
        }
        if (!progressive || ss) memset(ac_stats[sc[i]->ta], 0, 256);
      }
      ar.reset();
    };
    if (arith) arith_start();
    auto restart_now = [&]() {
      if (!arith) {
        restart_marker(br, preds);
        return;
      }
      if (!(ar.marker >= 0xD0 && ar.marker <= 0xD7)) {
        size_t q = ar.pos;
        while (q + 1 < n && !(data[q] == 0xFF && data[q + 1] >= 0xD0 &&
                              data[q + 1] <= 0xD7))
          ++q;
        ar.pos = q + 2 <= n ? q + 2 : n;
      }
      ar.marker = 0;
      arith_start();
    };
    auto unit = [&](int i, int16_t* blk) {
      Component& c = *sc[i];
      int& pred = preds[i];
      if (arith) {
        arith_unit(ar, c, pred, dc_ctx[i], blk, kind, ss, se, al);
        return;
      }
      switch (kind) {
        case 0: decode_block(br, c, pred, blk); break;
        case 1: decode_dc_first(br, c, pred, blk, al); break;
        case 2: if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << al)); break;
        case 3: decode_ac_first(br, c, blk, ss, se, al); break;
        default: decode_ac_refine(br, c, blk, ss, se, al);
      }
    };
    if (ns == 1) {
      Component& c = *sc[0];
      int bx = (c.dw + 7) / 8, by = (c.dh + 7) / 8;
      for (int y = 0; y < by; ++y)
        for (int x = 0; x < bx; ++x) {
          if (restart) {
            if (left == 0) {
              restart_now();
              left = restart;
            }
            --left;
          }
          unit(0, &c.coef[(size_t(y) * c.bw + x) * 64]);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart) {
            if (left == 0) {
              restart_now();
              left = restart;
            }
            --left;
          }
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h) {
                size_t b = size_t(my * c.v + v) * c.bw + mx * c.h + h;
                unit(i, &c.coef[b * 64]);
              }
          }
        }
    }
    if (!arith && br.at_end && br.padding_used() > 0)
      fail("truncated JPEG data");
    if (arith && ar.marker == 0xD9 && ar.marker_at >= n)
      fail("truncated JPEG data");
    // Step past the entropy-coded data to the next marker.
    size_t q = arith ? (ar.marker ? ar.marker_at : ar.pos) : br.pos;
    while (q < n) {
      if (data[q] == 0xFF && q + 1 < n && data[q + 1] != 0x00 &&
          data[q + 1] != 0xFF && !(data[q + 1] >= 0xD0 && data[q + 1] <= 0xD7))
        break;
      q += (data[q] == 0xFF && q + 1 < n && data[q + 1] == 0x00) ? 2 : 1;
    }
    pos = q;
    ++scans;
  }

  // Frame types this decoder refuses, named.
  static void refuse(int m) {
    if (m == 0xC7 || m == 0xCB || m == 0xCF)
      fail("lossless JPEG (SOF%d) is not supported", m - 0xC0);
    if (m == 0xC5 || m == 0xC6 || m == 0xCD || m == 0xCE)
      fail("hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
  }

  // Reads the markers and decodes every scan; with header_only, stops
  // after the frame header.
  void parse(bool header_only = false) {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (header_only && (m < 0 || m == 0xD9 || m == 0xDA))
        fail("JPEG without a frame header");
      if (m < 0) {
        if (scans) return;  // no EOI: what was decoded stands, as libjpeg
        fail("truncated JPEG data");
      }
      if (m == 0xD9) return;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int len = u16(pos);
      if (len < 2) fail("corrupt JPEG: marker length %d", len);
      size_t p = pos + 2, end = pos + len;
      if (end > n) fail("truncated JPEG data");
      pos = end;
      refuse(m);
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
          m == 0xCA) {
        progressive = m == 0xC2 || m == 0xCA;
        arith = m >= 0xC9;
        lossless = m == 0xC3;
        parse_sof(p, len, m);
        if (header_only) return;
      } else if (header_only) {
        continue;
      } else if (m == 0xC4) {
        parse_dht(p, end);
      } else if (m == 0xDB) {
        parse_dqt(p, end);
      } else if (m == 0xDD) {
        restart = u16(p);
      } else if (m == 0xCC) {  // DAC: arithmetic conditioning (jdmarker.c)
        for (size_t q = p; q + 1 < end; q += 2) {
          const int t = u8(q), v = u8(q + 1);
          if ((t & 15) > 3) fail("corrupt JPEG: DAC table %d", t & 15);
          if (t >> 4) {
            if (v < 1 || v > 63) fail("corrupt JPEG: DAC value %d", v);
            dac_k[t & 15] = v;
          } else {
            dac_l[t & 15] = v & 15;
            dac_u[t & 15] = v >> 4;
            if (dac_l[t & 15] > dac_u[t & 15])
              fail("corrupt JPEG: DAC value %d", v);
          }
        }
      } else if (m == 0xDA) {
        parse_sos(p, len);
      } else if (m >= 0xE0 && m <= 0xEF) {
        parse_app(p, len - 2, m);
      }
    }
  }
};

// jidctint.c's range limit after the IDCT: index (x & 1023) -> x + 128
// clamped to [0, 255] for x in [-512, 511].
struct IdctRange {
  uint8_t t[1024];
  IdctRange() {
    for (int i = 0; i < 1024; ++i) {
      int v = (i < 512 ? i : i - 1024) + 128;
      t[i] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const IdctRange kRange;

// jpeg_idct_islow: dequantise and inverse-DCT one block into out (stride).
void idct_islow(const int16_t* in, const int* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int k = 0; k < 8; ++k) wp[8 * k] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, sh));
    wp[56] = int(descale(tmp10 - tmp3, sh));
    wp[8] = int(descale(tmp11 + tmp2, sh));
    wp[48] = int(descale(tmp11 - tmp2, sh));
    wp[16] = int(descale(tmp12 + tmp1, sh));
    wp[40] = int(descale(tmp12 - tmp1, sh));
    wp[24] = int(descale(tmp13 + tmp0, sh));
    wp[32] = int(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + size_t(r) * stride;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// One component at full size (height x width): jdsample.c's methods.
// src: dh rows of dw samples with the given stride.
void upsample(const Component& c, const uint8_t* src, int stride, int hr,
              int vr, int width, int height, uint8_t* dst) {
  const int dw = c.dw, dh = c.dh;
  std::vector<uint8_t> row(size_t(dw) * hr + 16);
  auto row_of = [&](int y) { return src + size_t(y < 0 ? 0 : y >= dh ? dh - 1 : y) * stride; };
  for (int y = 0; y < height; ++y) {
    int iy = y / vr;
    const uint8_t* in0 = row_of(iy);
    uint8_t* out = dst + size_t(y) * width;
    if (hr == 1 && vr == 1) {
      memcpy(out, in0, width);
      continue;
    }
    uint8_t* r = row.data();
    if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      r[0] = in0[0];
      r[1] = uint8_t((in0[0] * 3 + in0[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        int v = in0[x] * 3;
        r[2 * x] = uint8_t((v + in0[x - 1] + 1) >> 2);
        r[2 * x + 1] = uint8_t((v + in0[x + 1] + 2) >> 2);
      }
      r[2 * dw - 2] = uint8_t((in0[dw - 1] * 3 + in0[dw - 2] + 1) >> 2);
      r[2 * dw - 1] = in0[dw - 1];
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      const bool upper = (y & 1) == 0;
      const uint8_t* in1 = row_of(upper ? iy - 1 : iy + 1);
      const int bias = upper ? 1 : 2;
      for (int x = 0; x < dw; ++x)
        r[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      const uint8_t* in1 = row_of((y & 1) == 0 ? iy - 1 : iy + 1);
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      r[0] = uint8_t((this_sum * 4 + 8) >> 4);
      r[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 1; x < dw - 1; ++x) {
        next_sum = in0[x + 1] * 3 + in1[x + 1];
        r[2 * x] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        r[2 * x + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      r[2 * dw - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      r[2 * dw - 1] = uint8_t((this_sum * 4 + 7) >> 4);
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      for (int x = 0; x < dw; ++x)
        for (int k = 0; k < hr; ++k) r[x * hr + k] = in0[x];
    }
    memcpy(out, r, width);
  }
}

// jdcolor.c's ycc_rgb_convert tables.
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// colour: 0 as libjpeg's default_decompress_parms decides from the
// markers, 1 YCbCr whatever the markers say, 2 none (the components as
// stored: libtiff's JCS_UNKNOWN for a photometric other than YCbCr).
void decode(const uint8_t* data, size_t n, uint8_t* out, size_t cap, bool bgr,
            int colour) {
  Decoder d{data, n};
  d.parse();
  if (!d.frame) fail("JPEG without a frame header");
  if (!d.scans) fail("JPEG without a scan");
  const int H = d.height, W = d.width, C = d.ncomp;
  if (cap < size_t(H) * W * C) fail("output buffer too small");
  std::vector<std::vector<uint8_t>> full(C);
  for (int i = 0; i < C; ++i) {
    Component& c = d.comp[i];
    const int stride = c.bw * 8;
    if (!d.lossless) c.plane.assign(size_t(stride) * c.bh * 8, 128);
    if (d.lossless && c.plane.empty()) c.plane.assign(size_t(stride) * c.bh * 8, 0);
    if (!c.coef.empty()) {
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                     &c.plane[size_t(by) * 8 * stride + bx * 8], stride);
    }
    c.coef.clear();
    c.coef.shrink_to_fit();
    full[i].resize(size_t(H) * W);
    upsample(c, c.plane.data(), stride, d.hmax / c.h, d.vmax / c.v, W, H,
             full[i].data());
  }
  if (C == 1) {
    memcpy(out, full[0].data(), size_t(H) * W);
    return;
  }
  const size_t np = size_t(H) * W;
  if (C == 4) {
    // default_decompress_parms: YCCK under an Adobe marker whose
    // transform is not 0, else CMYK; out_color_space CMYK either way
    // (ycck_cmyk_convert). Pillow reads the result as "CMYK;I": inverted.
    const bool ycck = colour != 2 && d.adobe && d.adobe_transform != 0;
    const uint8_t *p0 = full[0].data(), *p1 = full[1].data(),
                  *p2 = full[2].data(), *p3 = full[3].data();
    for (size_t k = 0; k < np; ++k) {
      uint8_t* o = out + 4 * k;
      if (ycck) {
        int y = p0[k], cb = p1[k], cr = p2[k];
        // 255 - range_limit[255 - (y + ...)]: the YCbCr -> RGB values.
        o[0] = clamp255(y + kYcc.cr_r[cr]);
        o[1] = clamp255(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[2] = clamp255(y + kYcc.cb_b[cb]);
      } else {
        o[0] = uint8_t(255 - p0[k]);
        o[1] = uint8_t(255 - p1[k]);
        o[2] = uint8_t(255 - p2[k]);
      }
      o[3] = uint8_t(255 - p3[k]);
    }
    return;
  }
  // jdapimin.c's default_decompress_parms: YCbCr unless marked RGB.
  bool rgb = false;
  if (colour == 1) {
    rgb = false;
  } else if (colour == 2) {
    rgb = true;
  } else if (d.jfif) {
    rgb = false;
  } else if (d.adobe) {
    rgb = d.adobe_transform == 0;
  } else {
    rgb = d.comp[0].id == 82 && d.comp[1].id == 71 && d.comp[2].id == 66;
  }
  const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
  const int ri = bgr ? 2 : 0, bi = bgr ? 0 : 2;
  for (size_t k = 0; k < np; ++k) {
    uint8_t* o = out + 3 * k;
    if (rgb) {
      o[ri] = p0[k];
      o[1] = p1[k];
      o[bi] = p2[k];
      continue;
    }
    int y = p0[k], cb = p1[k], cr = p2[k];
    o[ri] = clamp255(y + kYcc.cr_r[cr]);
    o[1] = clamp255(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    o[bi] = clamp255(y + kYcc.cb_b[cb]);
  }
}

// --------------------------------------------------------------- Encoder

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {  // pad the last byte with 1-bits
    if (nbits > 0) put(0x7F, 8 - nbits);
    acc = 0;
    nbits = 0;
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v));
}

// jpeg_fdct_islow: one block of level-shifted samples, in place; the
// output is the DCT scaled up by 8.
void fdct_islow(int* d) {
  for (int r = 0; r < 8; ++r) {
    int* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0541;
    const int sh = kConstBits - kPass1Bits;
    p[2] = int(descale(z1 + tmp13 * F0765, sh));
    p[6] = int(descale(z1 + tmp12 * -F1847, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1175;
    tmp4 *= F0298;
    tmp5 *= F2053;
    tmp6 *= F3072;
    tmp7 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    p[7] = int(descale(tmp4 + z1 + z3, sh));
    p[5] = int(descale(tmp5 + z2 + z4, sh));
    p[3] = int(descale(tmp6 + z2 + z3, sh));
    p[1] = int(descale(tmp7 + z1 + z4, sh));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0541;
    const int sh = kConstBits + kPass1Bits;
    p[16] = int(descale(z1 + tmp13 * F0765, sh));
    p[48] = int(descale(z1 + tmp12 * -F1847, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1175;
    tmp4 *= F0298;
    tmp5 *= F2053;
    tmp6 *= F3072;
    tmp7 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    p[56] = int(descale(tmp4 + z1 + z3, sh));
    p[40] = int(descale(tmp5 + z2 + z4, sh));
    p[24] = int(descale(tmp6 + z2 + z3, sh));
    p[8] = int(descale(tmp7 + z1 + z4, sh));
  }
}

void encode_block(BitWriter& bw, const int* samples, const int* q, int& pred,
                  const Huffman& dct, const Huffman& act) {
  int d[64];
  for (int k = 0; k < 64; ++k) d[k] = samples[k] - 128;
  fdct_islow(d);
  int z[64];
  for (int k = 0; k < 64; ++k) {  // zigzag order, divided with rounding
    int v = d[kNatural[k]];
    int div = q[kNatural[k]] * 8;
    z[k] = v < 0 ? -((-v + (div >> 1)) / div) : (v + (div >> 1)) / div;
  }
  auto magnitude = [](int v) {
    int a = v < 0 ? -v : v, s = 0;
    while (a) {
      ++s;
      a >>= 1;
    }
    return s;
  };
  int diff = z[0] - pred;
  pred = z[0];
  int s = magnitude(diff);
  bw.put(dct.code[s], dct.size[s]);
  if (s) bw.put(uint32_t(diff < 0 ? diff - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    if (z[k] == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    s = magnitude(z[k]);
    int rs = (run << 4) | s;
    bw.put(act.code[rs], act.size[rs]);
    bw.put(uint32_t(z[k] < 0 ? z[k] - 1 : z[k]), s);
    run = 0;
  }
  if (run) bw.put(act.code[0x00], act.size[0x00]);
}

std::vector<uint8_t> encode(const uint8_t* img, int H, int W, int C, bool bgr,
                            int quality, int hs, int vs) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535)
    fail("cannot encode a %dx%d image as JPEG", W, H);
  if (C != 1 && C != 3) fail("cannot encode %d channels as JPEG", C);
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  if (C == 1) hs = vs = 1;
  if (hs < 1 || hs > 4 || vs < 1 || vs > 4 || hs * vs > 8)
    fail("luma sampling %dx%d is not supported (1 to 4, at most 8 blocks)",
         hs, vs);
  // The IJG quality scaling, baseline tables (1..255).
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qt[2][64];
  for (int k = 0; k < 64; ++k) {
    for (int t = 0; t < 2; ++t) {
      long v = ((t ? kChromQuant[k] : kLumQuant[k]) * long(scale) + 50) / 100;
      qt[t][k] = int(v < 1 ? 1 : v > 255 ? 255 : v);
    }
  }
  // Planes: Y (and Cb, Cr) at full size, jccolor.c's arithmetic.
  const size_t np = size_t(H) * W;
  std::vector<uint8_t> plane[3];
  for (int i = 0; i < C; ++i) plane[i].resize(np);
  if (C == 1) {
    memcpy(plane[0].data(), img, np);
  } else {
    const int64_t one_half = int64_t(1) << 15, off = int64_t(128) << 16;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    const int ri = bgr ? 2 : 0, bi = bgr ? 0 : 2;
    for (size_t k = 0; k < np; ++k) {
      int64_t r = img[3 * k + ri], g = img[3 * k + 1], b = img[3 * k + bi];
      plane[0][k] = uint8_t((fix(0.29900) * r + fix(0.58700) * g +
                             fix(0.11400) * b + one_half) >> 16);
      plane[1][k] = uint8_t((-fix(0.16874) * r - fix(0.33126) * g +
                             fix(0.5) * b + off + one_half - 1) >> 16);
      plane[2][k] = uint8_t((fix(0.5) * r - fix(0.41869) * g -
                             fix(0.08131) * b + off + one_half - 1) >> 16);
    }
  }
  const int mcux = (W + 8 * hs - 1) / (8 * hs), mcuy = (H + 8 * vs - 1) / (8 * vs);
  // Sample (x, y) of component i at its own resolution, edges replicated
  // as jcprepct.c and jcsample.c do: the full-size rows to the right
  // before chroma is averaged over hs x vs, the chroma rows at the bottom
  // after it.
  const int chroma_h = (H + vs - 1) / vs;
  auto sample = [&](int i, int x, int y) -> int {
    if (i == 0 || (hs == 1 && vs == 1)) {
      int xx = x < W ? x : W - 1, yy = y < H ? y : H - 1;
      return plane[i][size_t(yy) * W + xx];
    }
    if (y >= chroma_h) y = chroma_h - 1;
    int sum = 0;
    for (int dy = 0; dy < vs; ++dy)
      for (int dx = 0; dx < hs; ++dx) {
        int xx = x * hs + dx, yy = y * vs + dy;
        xx = xx < W ? xx : W - 1;
        yy = yy < H ? yy : H - 1;
        sum += plane[i][size_t(yy) * W + xx];
      }
    // jcsample.c's biases: 1, 2, 1, 2, ... (2x2) and 0, 1, 0, 1, ...
    // (2x1) along the row; int_downsample's half the count otherwise.
    if (hs == 2 && vs == 2) return (sum + 1 + (x & 1)) >> 2;
    if (hs == 2 && vs == 1) return (sum + (x & 1)) >> 1;
    return (sum + hs * vs / 2) / (hs * vs);
  };
  Huffman dch[2], ach[2];
  set_table(dch[0], kDcLumBits, kDcVals);
  set_table(dch[1], kDcChromBits, kDcVals);
  set_table(ach[0], kAcLumBits, kAcLumVals);
  set_table(ach[1], kAcChromBits, kAcChromVals);

  std::vector<uint8_t> o;
  o.reserve(np / 2 + 1024);
  const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F',
                              'I',  'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01,
                              0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), soi_app0, soi_app0 + sizeof(soi_app0));
  for (int t = 0; t < (C == 1 ? 1 : 2); ++t) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(uint8_t(t));
    for (int k = 0; k < 64; ++k) o.push_back(uint8_t(qt[t][kNatural[k]]));
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * C);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back(uint8_t(C));
  for (int i = 0; i < C; ++i) {
    o.push_back(uint8_t(i + 1));
    o.push_back(uint8_t(i == 0 ? (hs << 4) | vs : 0x11));
    o.push_back(uint8_t(i == 0 ? 0 : 1));
  }
  for (int t = 0; t < (C == 1 ? 1 : 2); ++t) {
    for (int cls = 0; cls < 2; ++cls) {
      const uint8_t* bits = cls ? (t ? kAcChromBits : kAcLumBits)
                                : (t ? kDcChromBits : kDcLumBits);
      const uint8_t* vals = cls ? (t ? kAcChromVals : kAcLumVals) : kDcVals;
      int nv = 0;
      for (int l = 1; l <= 16; ++l) nv += bits[l];
      o.push_back(0xFF);
      o.push_back(0xC4);
      put16(o, 2 + 1 + 16 + nv);
      o.push_back(uint8_t((cls << 4) | t));
      o.insert(o.end(), bits + 1, bits + 17);
      o.insert(o.end(), vals, vals + nv);
    }
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * C);
  o.push_back(uint8_t(C));
  for (int i = 0; i < C; ++i) {
    o.push_back(uint8_t(i + 1));
    o.push_back(uint8_t(i == 0 ? 0x00 : 0x11));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  BitWriter bw{o};
  int preds[3] = {0, 0, 0};
  int blk[64];
  if (C == 1) {  // one component: a non-interleaved scan of its blocks
    for (int by = 0; by < (H + 7) / 8; ++by)
      for (int bx = 0; bx < (W + 7) / 8; ++bx) {
        for (int k = 0; k < 64; ++k) blk[k] = sample(0, bx * 8 + k % 8, by * 8 + k / 8);
        encode_block(bw, blk, qt[0], preds[0], dch[0], ach[0]);
      }
  } else {
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        for (int v = 0; v < vs; ++v)
          for (int h = 0; h < hs; ++h) {
            const int x0 = (mx * hs + h) * 8, y0 = (my * vs + v) * 8;
            for (int k = 0; k < 64; ++k) blk[k] = sample(0, x0 + k % 8, y0 + k / 8);
            encode_block(bw, blk, qt[0], preds[0], dch[0], ach[0]);
          }
        for (int i = 1; i < 3; ++i) {
          for (int k = 0; k < 64; ++k)
            blk[k] = sample(i, mx * 8 + k % 8, my * 8 + k / 8);
          encode_block(bw, blk, qt[1], preds[i], dch[1], ach[1]);
        }
      }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

void set_error(const char* msg) {
  snprintf(g_error, sizeof(g_error), "%s", msg);
}

}  // namespace

extern "C" {

const char* jpeg_error() { return g_error; }

int jpeg_header(const uint8_t* data, long long n, int* info) {
  try {
    Decoder d{data, size_t(n)};
    d.parse(true);
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    return 0;
  } catch (const Error& e) {
    set_error(e.msg.c_str());
  } catch (const std::bad_alloc&) {
    set_error("out of memory");
  }
  return -1;
}

int jpeg_decode(const uint8_t* data, long long n, uint8_t* out, long long cap,
                int bgr, int colour) {
  try {
    decode(data, size_t(n), out, size_t(cap), bgr != 0, colour);
    return 0;
  } catch (const Error& e) {
    set_error(e.msg.c_str());
  } catch (const std::bad_alloc&) {
    set_error("out of memory");
  }
  return -1;
}

long long jpeg_encode(const uint8_t* img, int h, int w, int c, int bgr,
                      int quality, int hs, int vs, uint8_t* out,
                      long long cap) {
  try {
    std::vector<uint8_t> o = encode(img, h, w, c, bgr != 0, quality, hs, vs);
    if (size_t(cap) < o.size()) return -2 - (long long)o.size();
    memcpy(out, o.data(), o.size());
    return (long long)o.size();
  } catch (const Error& e) {
    set_error(e.msg.c_str());
  } catch (const std::bad_alloc&) {
    set_error("out of memory");
  }
  return -1;
}

}  // extern "C"

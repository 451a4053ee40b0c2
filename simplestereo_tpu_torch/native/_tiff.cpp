// _tiff.cpp: the two TIFF compressions that are byte chains, LZW and
// PackBits, with a plain C interface loaded with ctypes (see
// simplestereo_tpu_torch/formats/tiff.py).
//
// The port reads TIFF without Pillow (which decodes compressed TIFF
// through libtiff). Each code of an LZW strip extends the string table
// that the next code reads, and each PackBits header says how many of the
// following bytes are literal, so both are sequential chains; a Python
// loop over a 720p frame's codes takes seconds. Deflate strips go through
// Python's zlib, and the predictor and the sample layouts are whole-array
// numpy work.
//
// LZW follows libtiff's LZWDecode (tif_lzw.c): MSB-first codes of 9 to 12
// bits, Clear 256, EndOfInformation 257, and the code width growing one
// code early ("early change": 10 bits once the table's next free entry is
// 511, 11 at 1023, 12 at 2047). The pre-6.0 LSB-first form ("old-style"
// LZW, which libtiff recognises by its first two bytes) is refused.
//
// C entries (each returns the bytes written, or -1 with tiff_error()
// naming the fault; decoding stops once cap bytes are written, as
// libtiff stops at the strip's size):
//   tiff_lzw(in, n, out, cap)
//   tiff_packbits(in, n, out, cap)
//   tiff_error()

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

thread_local char g_error[256];

long long fail(const char* msg) {
  snprintf(g_error, sizeof(g_error), "%s", msg);
  return -1;
}

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12;

}  // namespace

extern "C" {

const char* tiff_error() { return g_error; }

long long tiff_lzw(const uint8_t* in, long long n, uint8_t* out,
                   long long cap) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1))
    return fail("old-style (LSB-first) LZW TIFF is not supported");
  // The table: each code's prefix code, first and last byte and string
  // length.
  static thread_local int16_t prefix[1 << kMaxBits];
  static thread_local uint8_t first[1 << kMaxBits], suffix[1 << kMaxBits];
  static thread_local uint16_t length[1 << kMaxBits];
  for (int c = 0; c < 256; ++c) {
    prefix[c] = -1;
    first[c] = suffix[c] = uint8_t(c);
    length[c] = 1;
  }
  long long pos = 0, written = 0;
  uint32_t acc = 0;
  int have = 0, nbits = 9, free_ent = kFirst, old = -1;
  while (written < cap) {
    while (have < nbits && pos < n) {
      acc = (acc << 8) | in[pos++];
      have += 8;
    }
    if (have < nbits) break;  // the data ran out without an EOI code
    const int code = int(acc >> (have - nbits)) & ((1 << nbits) - 1);
    have -= nbits;
    if (code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = 9;
      old = -1;
      continue;
    }
    if (old < 0) {  // the first code after a Clear: one byte
      if (code > 255) return fail("corrupt LZW TIFF data");
      out[written++] = uint8_t(code);
      old = code;
      continue;
    }
    if (code > free_ent) return fail("corrupt LZW TIFF data");
    // The new entry is old's string plus the first byte of code's string
    // (of old's own, when code is the entry being made: the KwKwK case).
    if (free_ent < (1 << kMaxBits)) {
      prefix[free_ent] = int16_t(old);
      first[free_ent] = first[old];
      suffix[free_ent] = first[code < free_ent ? code : old];
      length[free_ent] = uint16_t(length[old] + 1);
      ++free_ent;
      if (free_ent > (1 << nbits) - 2 && nbits < kMaxBits) ++nbits;
    }
    // Write code's string backwards from its last byte, clipped to cap.
    const long long len = length[code];
    long long end = written + len;
    int c = code;
    for (long long k = end - 1; k >= written; --k, c = prefix[c])
      if (k < cap) out[k] = suffix[c];
    written = end < cap ? end : cap;
    old = code;
  }
  return written;
}

long long tiff_packbits(const uint8_t* in, long long n, uint8_t* out,
                        long long cap) {
  long long pos = 0, written = 0;
  while (pos < n && written < cap) {
    const int h = int8_t(in[pos++]);
    if (h >= 0) {  // h + 1 literal bytes
      long long k = h + 1;
      if (pos + k > n) k = n - pos;
      if (written + k > cap) k = cap - written;
      memcpy(out + written, in + pos, size_t(k));
      pos += h + 1;
      written += k;
    } else if (h != -128) {  // the next byte 1 - h times
      if (pos >= n) break;
      long long k = 1 - h;
      if (written + k > cap) k = cap - written;
      memset(out + written, in[pos++], size_t(k));
      written += k;
    }
  }
  return written;
}

}  // extern "C"

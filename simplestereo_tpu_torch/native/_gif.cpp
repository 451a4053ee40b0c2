// _gif.cpp: GIF's LZW, with a plain C interface loaded with ctypes (see
// simplestereo_tpu_torch/formats/gif.py).
//
// The port reads GIF without Pillow. A frame's indices are one LZW chain
// (each code extends the table the next code reads), split into data
// sub-blocks of at most 255 bytes; a Python loop over a 720p frame's
// codes takes seconds. The decoder follows Pillow's GifDecode.c: codes
// LSB first, from (minimum code size + 1) bits, growing by one bit when
// the next free entry reaches the width's limit, at most 12 bits (a full
// table takes no more entries until a Clear); Clear = 1 << size, End =
// Clear + 1.
//
// C entry:
//   gif_lzw(in, n, min_size, out, cap)
//       in: the sub-blocks (each a length byte and its bytes, ended by a
//       zero length) from just after the frame's LZW minimum code size;
//       writes at most cap indices; returns the count written (cap once
//       the frame is full), or -1 for a code past the table.

#include <cstdint>

extern "C" {

long long gif_lzw(const uint8_t* in, long long n, int min_size, uint8_t* out,
                  long long cap) {
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint16_t length[4096];
  static thread_local uint8_t stack[4097];
  if (min_size < 1 || min_size > 11) return -1;
  const int clear = 1 << min_size, end = clear + 1;
  for (int c = 0; c < clear; ++c) {
    prefix[c] = 0xFFFF;
    suffix[c] = first[c] = uint8_t(c);
    length[c] = 1;
  }
  int bits = min_size + 1, next = clear + 2, old = -1;
  uint32_t acc = 0;
  int have = 0;
  long long pos = 0, block_left = 0, written = 0;
  while (written < cap) {
    while (have < bits) {
      if (block_left == 0) {
        if (pos >= n) return written;
        block_left = in[pos++];
        if (block_left == 0) return written;  // the block terminator
      }
      if (pos >= n) return written;
      acc |= uint32_t(in[pos++]) << have;
      have += 8;
      --block_left;
    }
    const int code = int(acc & ((1u << bits) - 1));
    acc >>= bits;
    have -= bits;
    if (code == clear) {
      bits = min_size + 1;
      next = clear + 2;
      old = -1;
      continue;
    }
    if (code == end) return written;
    if (old < 0) {
      if (code >= clear) return -1;
      out[written++] = uint8_t(code);
      old = code;
      continue;
    }
    int emit;
    uint8_t head;
    if (code < next) {
      emit = code;
      head = first[code];
    } else if (code == next) {  // the KwKwK case: old + old's first byte
      emit = -1;
      head = first[old];
    } else {
      return -1;
    }
    if (next < 4096) {
      prefix[next] = uint16_t(old);
      suffix[next] = head;
      first[next] = first[old];
      length[next] = uint16_t(length[old] + 1);
      ++next;
      if (next == (1 << bits) && bits < 12) ++bits;
    }
    if (emit < 0) emit = next - 1;
    // Write emit's string, last byte first, into the stack.
    int len = length[emit], k = len;
    for (int c = emit; k > 0; c = prefix[c]) stack[--k] = suffix[c];
    for (int i = 0; i < len && written < cap; ++i) out[written++] = stack[i];
    old = code;
  }
  return written;
}

}  // extern "C"

// _bmp.cpp: the RLE8 and RLE4 compressions of BMP, with a plain C
// interface loaded with ctypes (see simplestereo_tpu_torch/formats/bmp.py).
//
// Each RLE record says how many pixels, and of which kind, the next bytes
// hold, so the stream is a sequential chain. The decoder follows Pillow's
// BmpRleDecoder (BmpImagePlugin.py), which is what the JAX package reads
// BMP through, also where it departs from the BMP documentation:
//   - a delta record (0, 2) skips two bytes and reads its (right, up)
//     from the two after them;
//   - an RLE4 absolute run of n pixels reads n / 2 bytes (rounded down),
//     two pixels each, and counts n pixels;
//   - an absolute run is followed by a padding byte where the file
//     position is odd (the position in the file, not in the stream);
//   - an end-of-line record pads the pixels written so far to a whole
//     row; a run that would pass the row's end is cut at it.
// Pixels are written in stream order, one byte each (the palette index),
// from the first stored row.
//
// C entries:
//   bmp_rle(in, n, start, rle4, width, out, cap)
//       in: the n bytes of the stream, which starts at file offset start;
//       out: cap bytes (width x height). Returns the pixels the stream
//       gave (which may pass cap; only cap are written).

#include <cstdint>
#include <cstring>

extern "C" long long bmp_rle(const uint8_t* in, long long n, long long start,
                             int rle4, long long width, uint8_t* out,
                             long long cap) {
  long long pos = 0, len = 0, x = 0;
  auto put = [&](uint8_t v) {
    if (len < cap) out[len] = v;
    ++len;
  };
  auto zeros = [&](long long k) {
    if (len < cap) memset(out + len, 0, size_t(k < cap - len ? k : cap - len));
    len += k;
  };
  while (len < cap) {
    if (pos + 2 > n) break;
    long long count = in[pos];
    const uint8_t byte = in[pos + 1];
    pos += 2;
    if (count) {  // encoded: count pixels of byte (RLE4: its two nibbles)
      if (x + count > width) count = width - x > 0 ? width - x : 0;
      for (long long i = 0; i < count; ++i)
        put(rle4 ? ((i & 1) ? byte & 15 : byte >> 4) : byte);
      x += count;
    } else if (byte == 0) {  // end of line
      if (len % width) zeros(width - len % width);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) return -1;
      zeros(in[pos] + in[pos + 1] * width);
      pos += 2;
      x = len % width;
    } else {  // absolute: byte pixels stored as they are
      const long long want = rle4 ? byte / 2 : byte;
      const long long got = pos + want > n ? n - pos : want;
      for (long long i = 0; i < got; ++i) {
        if (rle4) {
          put(in[pos + i] >> 4);
          put(in[pos + i] & 15);
        } else {
          put(in[pos + i]);
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if ((start + pos) % 2) ++pos;
    }
  }
  return len;
}

// _png.cpp: the PNG row filters undone, with a plain C interface loaded
// with ctypes (see simplestereo_tpu_torch/imgio.py).
//
// The port reads PNG without Pillow: zlib (Python's standard library)
// inflates the IDAT stream, and this function reverses the five row
// filters of the PNG specification (None, Sub, Up, Average, Paeth). Sub,
// Average and Paeth make each byte depend on the byte one pixel to its
// left, so a row is a sequential chain; numpy has no form of it that is
// not a Python loop over the pixels.
//
// C entry:
//   png_unfilter(in, height, stride, bpp, out)
//       in: height rows of 1 filter byte + stride bytes; out: height rows
//       of stride bytes; bpp: bytes a pixel (1 to 4 here). Returns 0, or
//       1 + the row index of the first row with an unknown filter type.

#include <cstdlib>
#include <cstring>

extern "C" long long png_unfilter(const unsigned char* in, long long height,
                                  long long stride, int bpp,
                                  unsigned char* out) {
  for (long long y = 0; y < height; ++y) {
    const unsigned char* f = in + y * (stride + 1);
    const unsigned char type = f[0];
    const unsigned char* src = f + 1;
    unsigned char* cur = out + y * stride;
    const unsigned char* up = y > 0 ? cur - stride : nullptr;
    switch (type) {
      case 0:  // None
        memcpy(cur, src, stride);
        break;
      case 1:  // Sub
        for (long long x = 0; x < stride; ++x)
          cur[x] = src[x] + (x >= bpp ? cur[x - bpp] : 0);
        break;
      case 2:  // Up
        for (long long x = 0; x < stride; ++x)
          cur[x] = src[x] + (up ? up[x] : 0);
        break;
      case 3:  // Average
        for (long long x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          cur[x] = src[x] + ((a + b) >> 1);
        }
        break;
      case 4:  // Paeth
        for (long long x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = src[x] + pred;
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

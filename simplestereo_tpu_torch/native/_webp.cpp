// _webp.cpp: a WebP decoder with a plain C interface, loaded with ctypes
// (see simplestereo_tpu_torch/formats/webp.py).
//
// The port reads WebP without Pillow, which decodes it through libwebp's
// animation decoder onto an RGBA canvas; this decoder gives the same
// pixels, bit for bit:
//   - the RIFF container: a simple file (one "VP8 " or "VP8L" chunk), or
//     "VP8X" with an "ALPH" chunk beside "VP8 ", or an animation ("ANIM"
//     and "ANMF" frames), of which the first frame is read onto a canvas
//     of transparent black, as WebPAnimDecoder draws a key frame;
//   - VP8L (lossless, the WebP lossless bitstream specification): prefix
//     codes (simple and normal, with their code-length codes), meta prefix
//     codes, the colour cache, LZ77 copies with the 120 short distances,
//     and the four transforms (predictor with its 14 modes, cross-colour,
//     subtract-green, colour indexing with pixel bundling), undone in the
//     reverse of their order;
//   - VP8 (lossy, RFC 6386, key frames): the boolean decoder, segments
//     and quantiser deltas, the 16x16, 4x4 and chroma intra modes, the
//     coefficient tokens, the inverse WHT and DCT, and the simple and
//     normal loop filters with sharpness and mode deltas, as libwebp's
//     dec/ and dsp/ compute them; then libwebp's "fancy" upsampling of
//     chroma and its 14-bit fixed-point YUV -> RGB (yuv.h);
//   - alpha ("ALPH"): raw or VP8L-compressed (the green of an image
//     stream without header), with the horizontal, vertical and gradient
//     filters undone.
//
// C entries (each returns 0 on success and -1 on error; webp_error()
// then names the fault):
//   webp_info(data, n, info)        info: int[3] = width, height, alpha
//                                   (Pillow's mode RGBA when 1, else RGB)
//   webp_decode(data, n, out)       out: height x width x 4 RGBA
//   webp_error()

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
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

// RFC 6386 tables, flattened: coefficient probabilities and their update
// probabilities [type 4][band 8][context 3][11] (13.5, 13.4), the
// key-frame sub-block mode probabilities [above 10][left 10][9] in
// libwebp's mode order (11.5), the quantiser tables (14.1).
const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// WebP lossless: the 120 short distances, (yoffset << 4) | (8 - xoffset).
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57,
    21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74,
    36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34, 46,
    84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114,
    126, 97, 111, 80, 113, 127, 96, 112,
};

// ------------------------------------------------------------- VP8L

// LSB-first bits; zeros past the end (eos set), as libwebp's reader.
struct LBits {
  const uint8_t* in;
  size_t n, pos = 0;  // in bits
  bool eos = false;
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++pos) {
      if ((pos >> 3) >= n) {
        eos = true;
        continue;
      }
      v |= uint32_t((in[pos >> 3] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      const size_t p = pos + i;
      if ((p >> 3) < n) v |= uint32_t((in[p >> 3] >> (p & 7)) & 1) << i;
    }
    return v;
  }
};

// A canonical prefix code: codes assigned in order of length, then of
// symbol; the first bit read is the code's most significant. Codes of at
// most kRoot bits decode by one lookup of the next kRoot bits (reversed);
// longer ones walk the lengths.
struct Prefix {
  static constexpr int kRoot = 8;
  int single = -1;                  // the only symbol (a 0-bit code)
  std::vector<int16_t> root_sym;    // by the next kRoot bits
  std::vector<uint8_t> root_len;    // 0: longer than kRoot
  int first[16], count[16], offset[16];
  std::vector<int> sorted;          // symbols by (length, symbol)

  void build(const std::vector<int>& lengths) {
    int used = 0, last = 0;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) ++used, last = int(s);
    if (used == 0) fail("corrupt WebP: empty prefix code");
    if (used == 1) {
      single = last;
      return;
    }
    memset(count, 0, sizeof(count));
    for (int l : lengths) count[l]++;
    count[0] = 0;
    int code = 0, k = 0;
    sorted.assign(used, 0);
    for (int l = 1; l < 16; ++l) {
      first[l] = code;
      offset[l] = k;
      k += count[l];
      code = (code + count[l]) << 1;
    }
    // A complete code: the last length's codes fill it.
    long long space = 0;
    for (int l = 1; l < 16; ++l) space += (long long)count[l] << (15 - l);
    if (space != (1LL << 15)) fail("corrupt WebP: incomplete prefix code");
    std::vector<int> fill(16, 0);
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) sorted[offset[lengths[s]] + fill[lengths[s]]++] = int(s);
    root_sym.assign(1 << kRoot, 0);
    root_len.assign(1 << kRoot, 0);
    for (int l = 1; l <= kRoot; ++l)
      for (int i = 0; i < count[l]; ++i) {
        const int c = first[l] + i;
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((c >> (l - 1 - b)) & 1) << b;
        for (int hi = 0; hi < (1 << (kRoot - l)); ++hi) {
          root_sym[rev | (hi << l)] = int16_t(sorted[offset[l] + i]);
          root_len[rev | (hi << l)] = uint8_t(l);
        }
      }
  }
  int read(LBits& b) const {
    if (single >= 0) return single;
    const uint32_t look = b.peek(kRoot);
    if (root_len[look]) {
      b.pos += root_len[look];
      if ((b.pos >> 3) > b.n) b.eos = true;
      return root_sym[look];
    }
    int code = 0;
    for (int l = 1; l < 16; ++l) {
      code = (code << 1) | int(b.read(1));
      if (code - first[l] < count[l]) return sorted[offset[l] + code - first[l]];
    }
    fail("corrupt WebP: bad prefix code");
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};

void read_prefix(LBits& b, int alphabet, Prefix& out) {
  std::vector<int> lengths(alphabet, 0);
  if (b.read(1)) {  // simple code: one or two symbols
    const int n = int(b.read(1)) + 1;
    const int first_bits = b.read(1) ? 8 : 1;
    const int s0 = int(b.read(first_bits));
    if (s0 >= alphabet) fail("corrupt WebP: symbol %d", s0);
    lengths[s0] = 1;
    if (n == 2) {
      const int s1 = int(b.read(8));
      if (s1 >= alphabet) fail("corrupt WebP: symbol %d", s1);
      lengths[s1] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    const int ncodes = int(b.read(4)) + 4;
    for (int i = 0; i < ncodes; ++i) cl[kCodeLengthOrder[i]] = int(b.read(3));
    Prefix lc;
    lc.build(cl);
    int max_symbol = alphabet;
    if (b.read(1)) {
      const int nbits = 2 + 2 * int(b.read(3));
      max_symbol = 2 + int(b.read(nbits));
      if (max_symbol > alphabet) fail("corrupt WebP: code length count");
    }
    int prev = 8, s = 0;
    while (s < alphabet) {
      if (max_symbol-- == 0) break;
      const int c = lc.read(b);
      if (c < 16) {
        lengths[s++] = c;
        if (c) prev = c;
      } else {
        const int extra[3] = {2, 3, 7}, base[3] = {3, 3, 11};
        const int rep = int(b.read(extra[c - 16])) + base[c - 16];
        if (s + rep > alphabet) fail("corrupt WebP: code lengths overrun");
        const int v = c == 16 ? prev : 0;
        for (int k = 0; k < rep; ++k) lengths[s++] = v;
      }
    }
  }
  if (b.eos) fail("truncated WebP data");
  out.build(lengths);
}

inline uint32_t argb_add(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int channel(uint32_t v, int s) { return int((v >> s) & 0xff); }
uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
  int d = 0;
  for (int s = 0; s < 32; s += 8)
    d += std::abs(channel(l, s) - channel(tl, s)) -
         std::abs(channel(t, s) - channel(tl, s));
  return d <= 0 ? t : l;
}
uint32_t clamp_full(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t o = 0;
  for (int s = 0; s < 32; s += 8)
    o |= uint32_t(clip255(channel(l, s) + channel(t, s) - channel(tl, s))) << s;
  return o;
}
uint32_t clamp_half(uint32_t l, uint32_t t, uint32_t tl) {
  const uint32_t a = average2(l, t);
  uint32_t o = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = channel(a, s);
    o |= uint32_t(clip255(x + (x - channel(tl, s)) / 2)) << s;
  }
  return o;
}

struct Transform {
  int type, bits, xsize;  // xsize: the width the transform acts on
  std::vector<uint32_t> data;
};

inline int div_round_up(int a, int bits) { return (a + (1 << bits) - 1) >> bits; }

std::vector<uint32_t> decode_stream(LBits& b, int xsize, int ysize, bool top,
                                    std::vector<Transform>* transforms);

std::vector<uint32_t> entropy_image(LBits& b, int xsize, int ysize, bool top) {
  int cache_bits = 0;
  if (b.read(1)) {
    cache_bits = int(b.read(4));
    if (cache_bits < 1 || cache_bits > 11) fail("corrupt WebP: colour cache");
  }
  int meta_bits = 0, groups = 1;
  std::vector<uint32_t> meta;
  if (top && b.read(1)) {
    meta_bits = int(b.read(3)) + 2;
    meta = decode_stream(b, div_round_up(xsize, meta_bits),
                         div_round_up(ysize, meta_bits), false, nullptr);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      groups = std::max(groups, int(m) + 1);
    }
  }
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int alphabet[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  std::vector<Prefix> codes(size_t(groups) * 5);
  for (int g = 0; g < groups; ++g)
    for (int k = 0; k < 5; ++k) read_prefix(b, alphabet[k], codes[g * 5 + k]);
  std::vector<uint32_t> cache(cache_size, 0);
  std::vector<uint32_t> px(size_t(xsize) * ysize);
  const size_t total = px.size();
  const int mw = meta_bits ? div_round_up(xsize, meta_bits) : 0;
  size_t pos = 0, cached = 0;
  int x = 0, y = 0;
  const Prefix* g = codes.data();
  auto group_at = [&](int gx, int gy) {
    return meta_bits ? &codes[size_t(meta[size_t(gy >> meta_bits) * mw +
                                          (gx >> meta_bits)]) * 5]
                     : codes.data();
  };
  auto flush_cache = [&]() {
    if (!cache_bits) return;
    for (; cached < pos; ++cached)
      cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
  };
  while (pos < total) {
    if (meta_bits && (x & ((1 << meta_bits) - 1)) == 0) g = group_at(x, y);
    const int s = g[0].read(b);
    if (s < 256) {
      const uint32_t r = uint32_t(g[1].read(b)), bl = uint32_t(g[2].read(b)),
                     a = uint32_t(g[3].read(b));
      px[pos++] = (a << 24) | (r << 16) | (uint32_t(s) << 8) | bl;
      if (++x == xsize) x = 0, ++y;
    } else if (s < 256 + 24) {
      auto extra = [&](int sym) {
        if (sym < 4) return sym + 1;
        const int eb = (sym - 2) >> 1;
        const int off = (2 + (sym & 1)) << eb;
        return off + int(b.read(eb)) + 1;
      };
      const int len = extra(s - 256);
      const int dsym = g[4].read(b);
      const int dcode = extra(dsym);
      int dist;
      if (dcode > 120) {
        dist = dcode - 120;
      } else {
        const int c = kCodeToPlane[dcode - 1];
        dist = (c >> 4) * xsize + (8 - (c & 0xf));
        if (dist < 1) dist = 1;
      }
      if (size_t(dist) > pos || pos + len > total)
        fail("corrupt WebP: copy out of the image");
      for (int k = 0; k < len; ++k, ++pos) px[pos] = px[pos - dist];
      x += len;
      while (x >= xsize) x -= xsize, ++y;
      if (meta_bits && pos < total && (x & ((1 << meta_bits) - 1)))
        g = group_at(x, y);
    } else {
      const int key = s - 280;
      if (key >= cache_size) fail("corrupt WebP: colour cache index");
      flush_cache();
      px[pos++] = cache[key];
      if (++x == xsize) x = 0, ++y;
    }
    if (b.eos) fail("truncated WebP data");
    if (s >= 256 && s < 256 + 24) flush_cache();
  }
  return px;
}

std::vector<uint32_t> decode_stream(LBits& b, int xsize, int ysize, bool top,
                                    std::vector<Transform>* transforms) {
  if (top) {
    int seen = 0;
    while (b.read(1)) {
      Transform t;
      t.type = int(b.read(2));
      if (seen & (1 << t.type)) fail("corrupt WebP: transform %d twice", t.type);
      seen |= 1 << t.type;
      t.xsize = xsize;
      t.bits = 0;
      if (t.type == 0 || t.type == 1) {
        t.bits = int(b.read(3)) + 2;
        t.data = decode_stream(b, div_round_up(xsize, t.bits),
                               div_round_up(ysize, t.bits), false, nullptr);
      } else if (t.type == 3) {
        const int ncol = int(b.read(8)) + 1;
        t.bits = ncol > 16 ? 0 : ncol > 4 ? 1 : ncol > 2 ? 2 : 3;
        std::vector<uint32_t> pal = decode_stream(b, ncol, 1, false, nullptr);
        for (int i = 1; i < ncol; ++i) pal[i] = argb_add(pal[i], pal[i - 1]);
        t.data.assign(256, 0);
        std::copy(pal.begin(), pal.end(), t.data.begin());
        xsize = div_round_up(xsize, t.bits);
      }
      transforms->push_back(std::move(t));
    }
  }
  return entropy_image(b, xsize, ysize, top);
}

void undo(const Transform& t, std::vector<uint32_t>& px, int ysize) {
  const int w = t.xsize;
  if (t.type == 2) {  // subtract green
    for (uint32_t& p : px) {
      const uint32_t g = (p >> 8) & 0xff;
      p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 0xff) << 16) |
          (((p & 0xff) + g) & 0xff);
    }
  } else if (t.type == 0) {  // predictor
    const int bw = div_round_up(w, t.bits);
    for (int y = 0; y < ysize; ++y)
      for (int x = 0; x < w; ++x) {
        uint32_t* p = &px[size_t(y) * w + x];
        uint32_t pred;
        if (y == 0) {
          pred = x == 0 ? 0xff000000u : p[-1];
        } else if (x == 0) {
          pred = p[-w];
        } else {
          const int mode =
              (t.data[size_t(y >> t.bits) * bw + (x >> t.bits)] >> 8) & 0xf;
          const uint32_t L = p[-1], T = p[-w], TL = p[-w - 1], TR = p[-w + 1];
          switch (mode) {
            case 0: pred = 0xff000000u; break;
            case 1: pred = L; break;
            case 2: pred = T; break;
            case 3: pred = TR; break;
            case 4: pred = TL; break;
            case 5: pred = average2(average2(L, TR), T); break;
            case 6: pred = average2(L, TL); break;
            case 7: pred = average2(L, T); break;
            case 8: pred = average2(TL, T); break;
            case 9: pred = average2(T, TR); break;
            case 10: pred = average2(average2(L, TL), average2(T, TR)); break;
            case 11: pred = select_pred(T, L, TL); break;
            case 12: pred = clamp_full(L, T, TL); break;
            case 13: pred = clamp_half(L, T, TL); break;
            default: pred = 0xff000000u;
          }
        }
        *p = argb_add(*p, pred);
      }
  } else if (t.type == 1) {  // cross colour
    const int bw = div_round_up(w, t.bits);
    for (int y = 0; y < ysize; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t m = t.data[size_t(y >> t.bits) * bw + (x >> t.bits)];
        const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff),
                     r2b = int8_t((m >> 16) & 0xff);
        uint32_t& p = px[size_t(y) * w + x];
        const int8_t green = int8_t((p >> 8) & 0xff);
        int red = int((p >> 16) & 0xff), blue = int(p & 0xff);
        red = (red + ((int(g2r) * green) >> 5)) & 0xff;
        blue += (int(g2b) * green) >> 5;
        blue += (int(r2b) * int8_t(red)) >> 5;
        blue &= 0xff;
        p = (p & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
      }
  }
}

// The colour-indexing transform expands (packed width) rows to xsize.
std::vector<uint32_t> expand(const Transform& t, const std::vector<uint32_t>& px,
                             int ysize) {
  const int w = t.xsize, pw = div_round_up(w, t.bits);
  std::vector<uint32_t> out(size_t(w) * ysize);
  const int bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
  for (int y = 0; y < ysize; ++y)
    for (int x = 0; x < w; ++x) {
      const uint32_t g = (px[size_t(y) * pw + (x >> t.bits)] >> 8) & 0xff;
      const int idx = t.bits ? int(g >> ((x & ((1 << t.bits) - 1)) * bpp)) & mask
                             : int(g);
      out[size_t(y) * w + x] = t.data[idx];
    }
  return out;
}

// A VP8L image stream (after the 5-byte header for an image, straight away
// for an ALPH chunk's): xsize x ysize ARGB.
std::vector<uint32_t> vp8l_pixels(const uint8_t* in, size_t n, int xsize,
                                  int ysize) {
  LBits b{in, n};
  std::vector<Transform> ts;
  std::vector<uint32_t> px = decode_stream(b, xsize, ysize, true, &ts);
  for (size_t k = ts.size(); k-- > 0;) {
    if (ts[k].type == 3)
      px = expand(ts[k], px, ysize);
    else
      undo(ts[k], px, ysize);
  }
  return px;
}

void vp8l_header(const uint8_t* in, size_t n, int* w, int* h, bool* alpha) {
  if (n < 5 || in[0] != 0x2f) fail("corrupt WebP: no VP8L signature");
  const uint32_t bits = uint32_t(in[1]) | (uint32_t(in[2]) << 8) |
                        (uint32_t(in[3]) << 16) | (uint32_t(in[4]) << 24);
  *w = int(bits & 0x3fff) + 1;
  *h = int((bits >> 14) & 0x3fff) + 1;
  *alpha = (bits >> 28) & 1;
  if ((bits >> 29) != 0) fail("corrupt WebP: VP8L version %d", int(bits >> 29));
}

// -------------------------------------------------------------- VP8

// RFC 6386's boolean decoder (7.3), zeros past the end as libwebp feeds
// them.
struct BoolDecoder {
  const uint8_t* in;
  size_t n, pos = 0;
  uint32_t value = 0, range = 255;
  int bit_count = 0;
  void init(const uint8_t* d, size_t len) {
    in = d;
    n = len;
    pos = 0;
    value = (uint32_t(byte()) << 8);
    value |= byte();
    range = 255;
    bit_count = 0;
  }
  uint8_t byte() { return pos < n ? in[pos++] : (++pos, 0); }
  int bit(int prob) {
    const uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
    const uint32_t big = split << 8;
    int r;
    if (value >= big) {
      r = 1;
      range -= split;
      value -= big;
    } else {
      r = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= byte();
      }
    }
    return r;
  }
  int literal(int k) {
    int v = 0;
    while (k--) v = (v << 1) | bit(128);
    return v;
  }
  int signed_literal(int k) {
    const int v = literal(k);
    return bit(128) ? -v : v;
  }
  bool overrun() const { return pos > n + 2; }
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// libwebp's intra 4x4 mode tree (dec/tree_dec.c); modes: DC 0, TM 1, VE 2,
// HE 3, RD 4, VR 5, LD 6, VL 7, HD 8, HU 9. The 16x16 and chroma modes
// share the first four numbers (DC, TM, V, H).
const int8_t kYModesIntra4[18] = {-0, 1, -1, 2, -2, 3, 4, 6, -3, 5,
                                  -4, -5, -6, 7, -7, 8, -8, -9};
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

struct Probas {
  uint8_t p[4][8][3][11];
};

struct MB {
  int segment = 0, skip = 0, i4x4 = 0;
  uint8_t ymode = 0, uvmode = 0, imodes[16];
  int16_t coeffs[384];
  uint32_t nz_y = 0, nz_uv = 0;  // any coefficient in a block
  bool any = false;              // any coefficient in the macroblock
};

int large_value(BoolDecoder& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  } else if (!br.bit(p[6])) {
    if (!br.bit(p[7])) {
      v = 5 + br.bit(159);
    } else {
      v = 7 + 2 * br.bit(165);
      v += br.bit(145);
    }
  } else {
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* t = kCat3456[cat]; *t; ++t) v += v + br.bit(*t);
    v += 3 + (8 << cat);
  }
  return v;
}

// libwebp's GetCoeffs: the tokens of one block from position n; returns
// the position after the last one decoded (16 at most).
int coeffs(BoolDecoder& br, const Probas& pr, int type, int ctx,
           const int dq[2], int n, int16_t* out) {
  const uint8_t* p = pr.p[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = pr.p[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = pr.p[type][kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = pr.p[type][kBands[n + 1]][2];
    }
    out[kZigzag[n]] = int16_t((br.bit(128) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne: the inverse DCT of a block added to dst.
void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += stride) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
  }
}

#define AVG3(a, b, c) uint8_t(((a) + 2 * (b) + (c) + 2) >> 2)
#define AVG2(a, b) uint8_t(((a) + (b) + 1) >> 1)

// Intra prediction into dst (stride s) from the samples above and to the
// left (dst[-s..], dst[-1]), libwebp's dsp/dec.c.
void pred4(int mode, uint8_t* d, int s) {
  auto D = [&](int x, int y) -> uint8_t& { return d[x + y * s]; };
  const uint8_t* top = d - s;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], Dd = top[3],
            E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = d[-1], J = d[-1 + s], K = d[-1 + 2 * s], L = d[-1 + 3 * s];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + d[-1 + i * s];
      dc >>= 3;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) D(x, y) = uint8_t(dc);
      break;
    }
    case B_TM:
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) D(x, y) = clip8(d[-1 + y * s] + top[x] - X);
      break;
    case B_VE: {
      const uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, Dd),
                            AVG3(C, Dd, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) D(x, y) = v[x];
      break;
    }
    case B_HE: {
      const uint8_t v[4] = {AVG3(X, I, J), AVG3(I, J, K), AVG3(J, K, L),
                            AVG3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) D(x, y) = v[y];
      break;
    }
    case B_RD:
      D(0, 3) = AVG3(J, K, L);
      D(1, 3) = D(0, 2) = AVG3(I, J, K);
      D(2, 3) = D(1, 2) = D(0, 1) = AVG3(X, I, J);
      D(3, 3) = D(2, 2) = D(1, 1) = D(0, 0) = AVG3(A, X, I);
      D(3, 2) = D(2, 1) = D(1, 0) = AVG3(B, A, X);
      D(3, 1) = D(2, 0) = AVG3(C, B, A);
      D(3, 0) = AVG3(Dd, C, B);
      break;
    case B_LD:
      D(0, 0) = AVG3(A, B, C);
      D(1, 0) = D(0, 1) = AVG3(B, C, Dd);
      D(2, 0) = D(1, 1) = D(0, 2) = AVG3(C, Dd, E);
      D(3, 0) = D(2, 1) = D(1, 2) = D(0, 3) = AVG3(Dd, E, F);
      D(3, 1) = D(2, 2) = D(1, 3) = AVG3(E, F, G);
      D(3, 2) = D(2, 3) = AVG3(F, G, H);
      D(3, 3) = AVG3(G, H, H);
      break;
    case B_VR:
      D(0, 0) = D(1, 2) = AVG2(X, A);
      D(1, 0) = D(2, 2) = AVG2(A, B);
      D(2, 0) = D(3, 2) = AVG2(B, C);
      D(3, 0) = AVG2(C, Dd);
      D(0, 3) = AVG3(K, J, I);
      D(0, 2) = AVG3(J, I, X);
      D(0, 1) = D(1, 3) = AVG3(I, X, A);
      D(1, 1) = D(2, 3) = AVG3(X, A, B);
      D(2, 1) = D(3, 3) = AVG3(A, B, C);
      D(3, 1) = AVG3(B, C, Dd);
      break;
    case B_VL:
      D(0, 0) = AVG2(A, B);
      D(1, 0) = D(0, 2) = AVG2(B, C);
      D(2, 0) = D(1, 2) = AVG2(C, Dd);
      D(3, 0) = D(2, 2) = AVG2(Dd, E);
      D(0, 1) = AVG3(A, B, C);
      D(1, 1) = D(0, 3) = AVG3(B, C, Dd);
      D(2, 1) = D(1, 3) = AVG3(C, Dd, E);
      D(3, 1) = D(2, 3) = AVG3(Dd, E, F);
      D(3, 2) = AVG3(E, F, G);
      D(3, 3) = AVG3(F, G, H);
      break;
    case B_HU:
      D(0, 0) = AVG2(I, J);
      D(2, 0) = D(0, 1) = AVG2(J, K);
      D(2, 1) = D(0, 2) = AVG2(K, L);
      D(1, 0) = AVG3(I, J, K);
      D(3, 0) = D(1, 1) = AVG3(J, K, L);
      D(3, 1) = D(1, 2) = AVG3(K, L, L);
      D(3, 2) = D(2, 2) = D(0, 3) = D(1, 3) = D(2, 3) = D(3, 3) = uint8_t(L);
      break;
    default:  // B_HD
      D(0, 0) = D(2, 1) = AVG2(I, X);
      D(0, 1) = D(2, 2) = AVG2(J, I);
      D(0, 2) = D(2, 3) = AVG2(K, J);
      D(0, 3) = AVG2(L, K);
      D(3, 0) = AVG3(A, B, C);
      D(2, 0) = AVG3(X, A, B);
      D(1, 0) = D(3, 1) = AVG3(I, X, A);
      D(1, 1) = D(3, 2) = AVG3(J, I, X);
      D(1, 2) = D(3, 3) = AVG3(K, J, I);
      D(1, 3) = AVG3(L, K, J);
  }
}

// 16x16 (size 16) and chroma (size 8) prediction; mode DC, TM, V, H, with
// DC's edge forms chosen by the macroblock's place (CheckMode).
void pred_block(int mode, uint8_t* d, int s, int size, bool has_top,
                bool has_left) {
  const uint8_t* top = d - s;
  if (mode == B_DC) {
    const int sh = size == 16 ? 4 : 3;
    int dc;
    if (has_top && has_left) {
      dc = size;
      for (int i = 0; i < size; ++i) dc += top[i] + d[-1 + i * s];
      dc >>= sh + 1;
    } else if (has_top || has_left) {
      dc = size >> 1;
      for (int i = 0; i < size; ++i) dc += has_top ? top[i] : d[-1 + i * s];
      dc >>= sh;
    } else {
      dc = 0x80;
    }
    for (int y = 0; y < size; ++y) memset(d + y * s, dc, size);
  } else if (mode == B_TM) {
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x)
        d[x + y * s] = clip8(d[-1 + y * s] + top[x] - top[-1]);
  } else if (mode == B_VE) {
    for (int y = 0; y < size; ++y) memcpy(d + y * s, top, size);
  } else {
    for (int y = 0; y < size; ++y) memset(d + y * s, d[-1 + y * s], size);
  }
}

// ---- loop filter (dsp/dec.c, the C versions)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

void filter2(uint8_t* p, int st) {
  const int p1 = p[-2 * st], p0 = p[-st], q0 = p[0], q1 = p[st];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-st] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
void filter4(uint8_t* p, int st) {
  const int p1 = p[-2 * st], p0 = p[-st], q0 = p[0], q1 = p[st];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * st] = clip8(p1 + a3);
  p[-st] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[st] = clip8(q1 - a3);
}
void filter6(uint8_t* p, int st) {
  const int p2 = p[-3 * st], p1 = p[-2 * st], p0 = p[-st];
  const int q0 = p[0], q1 = p[st], q2 = p[2 * st];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
            a3 = (9 * a + 63) >> 7;
  p[-3 * st] = clip8(p2 + a3);
  p[-2 * st] = clip8(p1 + a2);
  p[-st] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[st] = clip8(q1 - a2);
  p[2 * st] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int st, int t) {
  return std::abs(p[-2 * st] - p[-st]) > t || std::abs(p[st] - p[0]) > t;
}
inline bool needs(const uint8_t* p, int st, int t) {
  return 4 * std::abs(p[-st] - p[0]) + std::abs(p[-2 * st] - p[st]) <= t;
}
inline bool needs2(const uint8_t* p, int st, int t, int it) {
  if (4 * std::abs(p[-st] - p[0]) + std::abs(p[-2 * st] - p[st]) > t)
    return false;
  return std::abs(p[-4 * st] - p[-3 * st]) <= it &&
         std::abs(p[-3 * st] - p[-2 * st]) <= it &&
         std::abs(p[-2 * st] - p[-st]) <= it &&
         std::abs(p[3 * st] - p[2 * st]) <= it &&
         std::abs(p[2 * st] - p[st]) <= it && std::abs(p[st] - p[0]) <= it;
}
// One edge of `size` pixels: hs steps across it, vs along it.
void simple_edge(uint8_t* p, int hs, int vs, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vs)
    if (needs(p, hs, t2)) filter2(p, hs);
}
void normal_edge(uint8_t* p, int hs, int vs, int size, int thresh, int ithresh,
                 int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vs)
    if (needs2(p, hs, t2, ithresh)) {
      if (hev(p, hs, hev_t))
        filter2(p, hs);
      else if (mb_edge)
        filter6(p, hs);
      else
        filter4(p, hs);
    }
}

struct VP8Frame {
  int width = 0, height = 0, mbw = 0, mbh = 0;
  std::vector<uint8_t> y, u, v;  // mbw*16 x mbh*16 and mbw*8 x mbh*8
  int ys = 0, uvs = 0;
};

void vp8_decode(const uint8_t* d, size_t n, VP8Frame& f) {
  if (n < 10) fail("truncated WebP: VP8 frame header");
  const uint32_t tag = d[0] | (d[1] << 8) | (d[2] << 16);
  if (tag & 1) fail("WebP with a VP8 inter frame");
  if (((tag >> 1) & 7) > 3) fail("corrupt WebP: VP8 version %d", (tag >> 1) & 7);
  const size_t part0 = tag >> 5;
  if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a)
    fail("corrupt WebP: no VP8 start code");
  f.width = (d[6] | (d[7] << 8)) & 0x3fff;
  f.height = (d[8] | (d[9] << 8)) & 0x3fff;
  if (!f.width || !f.height) fail("corrupt WebP: VP8 size 0");
  if (10 + part0 > n) fail("truncated WebP: VP8 first partition");
  f.mbw = (f.width + 15) >> 4;
  f.mbh = (f.height + 15) >> 4;
  BoolDecoder br;
  br.init(d + 10, part0);
  br.bit(128);  // colour space
  br.bit(128);  // clamping type
  // Segments (9.3).
  bool use_segment = br.bit(128), update_map = false, absolute = false;
  int seg_q[4] = {0, 0, 0, 0}, seg_f[4] = {0, 0, 0, 0};
  uint8_t seg_p[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.bit(128);
    if (br.bit(128)) {
      absolute = br.bit(128);
      for (int s = 0; s < 4; ++s) seg_q[s] = br.bit(128) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s) seg_f[s] = br.bit(128) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_p[s] = uint8_t(br.bit(128) ? br.literal(8) : 255);
  }
  // Loop filter (9.6).
  const bool simple = br.bit(128);
  const int level = br.literal(6), sharpness = br.literal(3);
  const bool use_lf_delta = br.bit(128);
  int ref_delta0 = 0, mode_delta0 = 0;
  if (use_lf_delta && br.bit(128)) {
    for (int i = 0; i < 4; ++i)
      if (br.bit(128)) {
        const int v = br.signed_literal(6);
        if (i == 0) ref_delta0 = v;
      }
    for (int i = 0; i < 4; ++i)
      if (br.bit(128)) {
        const int v = br.signed_literal(6);
        if (i == 0) mode_delta0 = v;
      }
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  // Partitions (9.5).
  const int nparts = 1 << br.literal(2);
  std::vector<BoolDecoder> parts(nparts);
  {
    const uint8_t* sz = d + 10 + part0;
    size_t left = n - 10 - part0;
    if (left < size_t(3 * (nparts - 1))) fail("truncated WebP: VP8 partitions");
    const uint8_t* start = sz + 3 * (nparts - 1);
    left -= 3 * (nparts - 1);
    for (int p = 0; p < nparts - 1; ++p, sz += 3) {
      size_t ps = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (ps > left) ps = left;
      parts[p].init(start, ps);
      start += ps;
      left -= ps;
    }
    parts[nparts - 1].init(start, left);
  }
  // Quantisers (9.6, 14.1).
  const int base_q = br.literal(7);
  const int dy1_dc = br.bit(128) ? br.signed_literal(4) : 0;
  const int dy2_dc = br.bit(128) ? br.signed_literal(4) : 0;
  const int dy2_ac = br.bit(128) ? br.signed_literal(4) : 0;
  const int duv_dc = br.bit(128) ? br.signed_literal(4) : 0;
  const int duv_ac = br.bit(128) ? br.signed_literal(4) : 0;
  auto clipq = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  int q1[4][2], q2[4][2], quv[4][2];
  for (int s = 0; s < 4; ++s) {
    int q = base_q;
    if (use_segment) {
      q = seg_q[s] + (absolute ? 0 : base_q);
    }
    q1[s][0] = kDcTable[clipq(q + dy1_dc, 127)];
    q1[s][1] = kAcTable[clipq(q, 127)];
    q2[s][0] = kDcTable[clipq(q + dy2_dc, 127)] * 2;
    q2[s][1] = (kAcTable[clipq(q + dy2_ac, 127)] * 101581) >> 16;
    if (q2[s][1] < 8) q2[s][1] = 8;
    quv[s][0] = kDcTable[clipq(q + duv_dc, 117)];
    quv[s][1] = kAcTable[clipq(q + duv_ac, 127)];
  }
  br.bit(128);  // refresh entropy probabilities: one frame, no effect
  Probas pr;
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int k = ((t * 8 + b) * 3 + c) * 11 + p;
          pr.p[t][b][c][p] = uint8_t(br.bit(kCoeffsUpdateProba[k])
                                         ? br.literal(8)
                                         : kCoeffsProba0[k]);
        }
  const bool use_skip = br.bit(128);
  const int skip_p = use_skip ? br.literal(8) : 0;
  // Filter strengths by segment and 4x4-ness (PrecomputeFilterStrengths).
  int f_limit[4][2], f_ilevel[4][2], f_hev[4][2];
  for (int s = 0; s < 4; ++s) {
    int base = level;
    if (use_segment) base = seg_f[s] + (absolute ? 0 : level);
    for (int i4 = 0; i4 <= 1; ++i4) {
      int lv = base;
      if (use_lf_delta) {
        lv += ref_delta0;
        if (i4) lv += mode_delta0;
      }
      lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
      f_limit[s][i4] = 0;
      if (lv > 0) {
        int il = lv;
        if (sharpness > 0) {
          il >>= sharpness > 4 ? 2 : 1;
          if (il > 9 - sharpness) il = 9 - sharpness;
        }
        if (il < 1) il = 1;
        f_ilevel[s][i4] = il;
        f_limit[s][i4] = 2 * lv + il;
        f_hev[s][i4] = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
      }
    }
  }
  // Planes with a border of one sample above and to the left; the border
  // is 127 above the frame, 129 left of it (ReconstructRow).
  f.ys = f.mbw * 16 + 1 + 4;
  f.uvs = f.mbw * 8 + 1;
  std::vector<uint8_t> Y(size_t(f.ys) * (f.mbh * 16 + 1)),
      U(size_t(f.uvs) * (f.mbh * 8 + 1)), V(U.size());
  uint8_t* y0 = Y.data() + f.ys + 1;
  uint8_t* u0 = U.data() + f.uvs + 1;
  uint8_t* v0 = V.data() + f.uvs + 1;
  memset(Y.data(), 127, f.ys);
  memset(U.data(), 127, f.uvs);
  memset(V.data(), 127, f.uvs);
  for (int r = 0; r < f.mbh * 16; ++r) y0[r * f.ys - 1] = 129;
  for (int r = 0; r < f.mbh * 8; ++r) u0[r * f.uvs - 1] = v0[r * f.uvs - 1] = 129;
  // Per macroblock: its filter strength, whether to filter inner edges.
  std::vector<int> mb_fs(size_t(f.mbw) * f.mbh), mb_inner(mb_fs.size());
  std::vector<uint8_t> intra_top(size_t(f.mbw) * 4, B_DC);
  std::vector<uint8_t> nz_top(f.mbw, 0), nz_dc_top(f.mbw, 0);
  uint8_t tr[4];
  for (int my = 0; my < f.mbh; ++my) {
    BoolDecoder& tb = parts[my & (nparts - 1)];
    uint8_t intra_left[4] = {B_DC, B_DC, B_DC, B_DC};
    uint8_t nz_left = 0, nz_dc_left = 0;
    for (int mx = 0; mx < f.mbw; ++mx) {
      MB mb;
      // Intra modes (ParseIntraMode).
      if (update_map)
        mb.segment = !br.bit(seg_p[0]) ? br.bit(seg_p[1]) : br.bit(seg_p[2]) + 2;
      if (use_skip) mb.skip = br.bit(skip_p);
      mb.i4x4 = !br.bit(145);
      uint8_t* top = &intra_top[size_t(mx) * 4];
      if (!mb.i4x4) {
        const int ym = br.bit(156) ? (br.bit(128) ? B_TM : B_HE)
                                   : (br.bit(163) ? B_VE : B_DC);
        mb.ymode = uint8_t(ym);
        memset(top, ym, 4);
        memset(intra_left, ym, 4);
      } else {
        for (int yy = 0; yy < 4; ++yy) {
          int ym = intra_left[yy];
          for (int xx = 0; xx < 4; ++xx) {
            const uint8_t* prob = &kBModesProba[(top[xx] * 10 + ym) * 9];
            int i = kYModesIntra4[br.bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
            ym = -i;
            top[xx] = uint8_t(ym);
            mb.imodes[yy * 4 + xx] = uint8_t(ym);
          }
          intra_left[yy] = uint8_t(ym);
        }
      }
      mb.uvmode = uint8_t(!br.bit(142) ? B_DC : !br.bit(114) ? B_VE
                                       : br.bit(183) ? B_TM : B_HE);
      // Residuals (ParseResiduals).
      memset(mb.coeffs, 0, sizeof(mb.coeffs));
      const int s = mb.segment;
      if (!mb.skip) {
        int16_t* dst = mb.coeffs;
        int first, type;
        if (!mb.i4x4) {
          int16_t dc[16] = {0};
          const int ctx = nz_dc_top[mx] + nz_dc_left;
          const int nz = coeffs(tb, pr, 1, ctx, q2[s], 0, dc);
          nz_dc_top[mx] = nz_dc_left = nz > 0;
          if (nz > 1) {
            inverse_wht(dc, dst);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) dst[i] = int16_t(dc0);
          }
          first = 1;
          type = 0;
        } else {
          first = 0;
          type = 3;
        }
        uint32_t tnz = nz_top[mx] & 0x0f, lnz = nz_left & 0x0f;
        for (int yy = 0; yy < 4; ++yy) {
          int l = lnz & 1;
          for (int xx = 0; xx < 4; ++xx, dst += 16) {
            const int ctx = l + (tnz & 1);
            const int nz = coeffs(tb, pr, type, ctx, q1[s], first, dst);
            l = nz > first;
            tnz = (tnz >> 1) | (uint32_t(l) << 7);
          }
          tnz >>= 4;
          lnz = (lnz >> 1) | (uint32_t(l) << 7);
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          uint32_t t2 = nz_top[mx] >> (4 + ch), l2 = nz_left >> (4 + ch);
          for (int yy = 0; yy < 2; ++yy) {
            int l = l2 & 1;
            for (int xx = 0; xx < 2; ++xx, dst += 16) {
              const int ctx = l + (t2 & 1);
              const int nz = coeffs(tb, pr, 2, ctx, quv[s], 0, dst);
              l = nz > 0;
              t2 = (t2 >> 1) | (uint32_t(l) << 3);
            }
            t2 >>= 2;
            l2 = (l2 >> 1) | (uint32_t(l) << 5);
          }
          out_t |= (t2 << 4) << ch;
          out_l |= (l2 & 0xf0) << ch;
        }
        nz_top[mx] = uint8_t(out_t);
        nz_left = uint8_t(out_l);
        for (int i = 0; i < 384; ++i)
          if (mb.coeffs[i]) {
            mb.any = true;
            break;
          }
      } else {
        nz_top[mx] = nz_left = 0;
        if (!mb.i4x4) nz_dc_top[mx] = nz_dc_left = 0;
      }
      const size_t mi = size_t(my) * f.mbw + mx;
      mb_fs[mi] = s * 2 + mb.i4x4;
      mb_inner[mi] = mb.i4x4 || mb.any;
      // Reconstruction (ReconstructRow).
      uint8_t* yd = y0 + size_t(my) * 16 * f.ys + mx * 16;
      uint8_t* ud = u0 + size_t(my) * 8 * f.uvs + mx * 8;
      uint8_t* vd = v0 + size_t(my) * 8 * f.uvs + mx * 8;
      if (my > 0 && mx == 0) yd[-1 - f.ys] = ud[-1 - f.uvs] = vd[-1 - f.uvs] = 129;
      if (mb.i4x4) {
        // The 4 samples above and right of the macroblock: the next one's
        // bottom row (127 in the first row, the last sample repeated at
        // the right edge); the same 4 serve the sub-blocks of column 3.
        if (my == 0) {
          memset(tr, 127, 4);
        } else if (mx == f.mbw - 1) {
          memset(tr, yd[-f.ys + 15], 4);
        } else {
          memcpy(tr, yd - f.ys + 16, 4);
        }
        for (int nb = 0; nb < 16; ++nb) {
          const int bx = nb & 3, by = nb >> 2;
          uint8_t* bd = yd + by * 4 * f.ys + bx * 4;
          uint8_t save[4];
          uint8_t* above_right = bd - f.ys + 4;
          const bool patch = bx == 3;
          if (patch) {
            memcpy(save, above_right, 4);
            memcpy(above_right, tr, 4);
          }
          pred4(mb.imodes[nb], bd, f.ys);
          if (patch) memcpy(above_right, save, 4);
          idct_add(mb.coeffs + nb * 16, bd, f.ys);
        }
      } else {
        pred_block(mb.ymode, yd, f.ys, 16, my > 0, mx > 0);
        for (int nb = 0; nb < 16; ++nb)
          idct_add(mb.coeffs + nb * 16, yd + (nb >> 2) * 4 * f.ys + (nb & 3) * 4,
                   f.ys);
      }
      pred_block(mb.uvmode, ud, f.uvs, 8, my > 0, mx > 0);
      pred_block(mb.uvmode, vd, f.uvs, 8, my > 0, mx > 0);
      for (int nb = 0; nb < 4; ++nb) {
        idct_add(mb.coeffs + 256 + nb * 16,
                 ud + (nb >> 1) * 4 * f.uvs + (nb & 1) * 4, f.uvs);
        idct_add(mb.coeffs + 320 + nb * 16,
                 vd + (nb >> 1) * 4 * f.uvs + (nb & 1) * 4, f.uvs);
      }
    }
    if (tb.overrun() || br.overrun()) fail("truncated WebP: VP8 data");
  }
  // Loop filter (DoFilter), macroblocks in raster order.
  if (filter_type > 0) {
    for (int my = 0; my < f.mbh; ++my)
      for (int mx = 0; mx < f.mbw; ++mx) {
        const size_t mi = size_t(my) * f.mbw + mx;
        const int s = mb_fs[mi] >> 1, i4 = mb_fs[mi] & 1;
        const int limit = f_limit[s][i4];
        if (limit == 0) continue;
        const bool inner = mb_inner[mi];
        uint8_t* yd = y0 + size_t(my) * 16 * f.ys + mx * 16;
        if (filter_type == 1) {
          if (mx > 0) simple_edge(yd, 1, f.ys, limit + 4);
          if (inner)
            for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k, 1, f.ys, limit);
          if (my > 0) simple_edge(yd, f.ys, 1, limit + 4);
          if (inner)
            for (int k = 1; k < 4; ++k)
              simple_edge(yd + 4 * k * f.ys, f.ys, 1, limit);
          continue;
        }
        const int il = f_ilevel[s][i4], ht = f_hev[s][i4];
        uint8_t* ud = u0 + size_t(my) * 8 * f.uvs + mx * 8;
        uint8_t* vd = v0 + size_t(my) * 8 * f.uvs + mx * 8;
        if (mx > 0) {
          normal_edge(yd, 1, f.ys, 16, limit + 4, il, ht, true);
          normal_edge(ud, 1, f.uvs, 8, limit + 4, il, ht, true);
          normal_edge(vd, 1, f.uvs, 8, limit + 4, il, ht, true);
        }
        if (inner) {
          for (int k = 1; k < 4; ++k)
            normal_edge(yd + 4 * k, 1, f.ys, 16, limit, il, ht, false);
          normal_edge(ud + 4, 1, f.uvs, 8, limit, il, ht, false);
          normal_edge(vd + 4, 1, f.uvs, 8, limit, il, ht, false);
        }
        if (my > 0) {
          normal_edge(yd, f.ys, 1, 16, limit + 4, il, ht, true);
          normal_edge(ud, f.uvs, 1, 8, limit + 4, il, ht, true);
          normal_edge(vd, f.uvs, 1, 8, limit + 4, il, ht, true);
        }
        if (inner) {
          for (int k = 1; k < 4; ++k)
            normal_edge(yd + 4 * k * f.ys, f.ys, 1, 16, limit, il, ht, false);
          normal_edge(ud + 4 * f.uvs, f.uvs, 1, 8, limit, il, ht, false);
          normal_edge(vd + 4 * f.uvs, f.uvs, 1, 8, limit, il, ht, false);
        }
      }
  }
  f.y.swap(Y);
  f.u.swap(U);
  f.v.swap(V);
}

// yuv.h: 14-bit fixed-point YUV -> RGB.
inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t yuv_clip(int v) {
  return ((v & ~16383) == 0) ? uint8_t(v >> 6) : v < 0 ? 0 : 255;
}
inline void yuv_rgba(int y, int u, int v, uint8_t* o) {
  o[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  o[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  o[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  o[3] = 255;
}

// upsampling.c's UPSAMPLE_FUNC: one pair of rows (bottom may be null) from
// the chroma rows above (top) and below (cur) them.
void upsample_pair(const uint8_t* ty, const uint8_t* by, const uint8_t* tu,
                   const uint8_t* tv, const uint8_t* cu, const uint8_t* cv,
                   uint8_t* tdst, uint8_t* bdst, int len) {
  auto load = [](int u, int v) { return uint32_t(u) | (uint32_t(v) << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl = load(tu[0], tv[0]), l = load(cu[0], cv[0]);
  {
    const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
    yuv_rgba(ty[0], uv0 & 0xff, uv0 >> 16, tdst);
  }
  if (by) {
    const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
    yuv_rgba(by[0], uv0 & 0xff, uv0 >> 16, bdst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t = load(tu[x], tv[x]), uv = load(cu[x], cv[x]);
    const uint32_t avg = tl + t + l + uv + 0x00080008u;
    const uint32_t d12 = (avg + 2 * (t + l)) >> 3;
    const uint32_t d03 = (avg + 2 * (tl + uv)) >> 3;
    {
      const uint32_t uv0 = (d12 + tl) >> 1, uv1 = (d03 + t) >> 1;
      yuv_rgba(ty[2 * x - 1], uv0 & 0xff, uv0 >> 16, tdst + (2 * x - 1) * 4);
      yuv_rgba(ty[2 * x], uv1 & 0xff, uv1 >> 16, tdst + 2 * x * 4);
    }
    if (by) {
      const uint32_t uv0 = (d03 + l) >> 1, uv1 = (d12 + uv) >> 1;
      yuv_rgba(by[2 * x - 1], uv0 & 0xff, uv0 >> 16, bdst + (2 * x - 1) * 4);
      yuv_rgba(by[2 * x], uv1 & 0xff, uv1 >> 16, bdst + 2 * x * 4);
    }
    tl = t;
    l = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
      yuv_rgba(ty[len - 1], uv0 & 0xff, uv0 >> 16, tdst + (len - 1) * 4);
    }
    if (by) {
      const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
      yuv_rgba(by[len - 1], uv0 & 0xff, uv0 >> 16, bdst + (len - 1) * 4);
    }
  }
}

// EmitFancyRGB over the whole frame: RGBA rows of `stride` bytes.
void vp8_rgba(const VP8Frame& f, uint8_t* out, size_t stride) {
  const uint8_t* Y = f.y.data() + f.ys + 1;
  const uint8_t* U = f.u.data() + f.uvs + 1;
  const uint8_t* V = f.v.data() + f.uvs + 1;
  const int W = f.width, H = f.height;
  auto yr = [&](int r) { return Y + size_t(r) * f.ys; };
  auto ur = [&](int r) { return U + size_t(r) * f.uvs; };
  auto vr = [&](int r) { return V + size_t(r) * f.uvs; };
  upsample_pair(yr(0), nullptr, ur(0), vr(0), ur(0), vr(0), out, nullptr, W);
  int k = 1;
  for (; 2 * k < H; ++k)
    upsample_pair(yr(2 * k - 1), yr(2 * k), ur(k - 1), vr(k - 1), ur(k), vr(k),
                  out + size_t(2 * k - 1) * stride, out + size_t(2 * k) * stride,
                  W);
  if (!(H & 1))
    upsample_pair(yr(H - 1), nullptr, ur(H / 2 - 1), vr(H / 2 - 1), ur(H / 2 - 1),
                  vr(H / 2 - 1), out + size_t(H - 1) * stride, nullptr, W);
}

// ------------------------------------------------------------ alpha

// An ALPH chunk's plane (w x h) into the alpha bytes of RGBA rows.
void alpha_plane(const uint8_t* d, size_t n, int w, int h, uint8_t* rgba,
                 size_t stride) {
  if (n < 1) fail("truncated WebP: empty ALPH chunk");
  const int method = d[0] & 3, filter = (d[0] >> 2) & 3;
  std::vector<uint8_t> a(size_t(w) * h);
  if (method == 0) {
    if (n - 1 < a.size()) fail("truncated WebP: ALPH data");
    memcpy(a.data(), d + 1, a.size());
  } else if (method == 1) {
    std::vector<uint32_t> px = vp8l_pixels(d + 1, n - 1, w, h);
    for (size_t i = 0; i < a.size(); ++i) a[i] = uint8_t(px[i] >> 8);
  } else {
    fail("corrupt WebP: ALPH compression %d", method);
  }
  // Unfilter (filters.c): each row from the one above, in place.
  for (int y = 0; y < h; ++y) {
    uint8_t* row = &a[size_t(y) * w];
    const uint8_t* prev = y ? row - w : nullptr;
    if (filter == 0) continue;
    if (filter == 1 || !prev) {  // horizontal (and every filter's first row)
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = uint8_t(row[x] + pred);
    } else if (filter == 2) {
      for (int x = 0; x < w; ++x) row[x] = uint8_t(row[x] + prev[x]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        left = uint8_t(row[x] + clip8(left + top - top_left));
        top_left = top;
        row[x] = left;
      }
    }
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) rgba[y * stride + 4 * size_t(x) + 3] = a[size_t(y) * w + x];
}

// -------------------------------------------------------- container

struct Chunk {
  uint32_t fourcc;
  const uint8_t* data;
  size_t size;
};

constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) | (uint32_t(uint8_t(s[1])) << 8) |
         (uint32_t(uint8_t(s[2])) << 16) | (uint32_t(uint8_t(s[3])) << 24);
}

std::vector<Chunk> chunks(const uint8_t* d, size_t n) {
  std::vector<Chunk> out;
  size_t p = 0;
  while (p + 8 <= n) {
    const uint32_t cc = d[p] | (d[p + 1] << 8) | (d[p + 2] << 16) |
                        (uint32_t(d[p + 3]) << 24);
    const size_t sz = d[p + 4] | (d[p + 5] << 8) | (d[p + 6] << 16) |
                      (size_t(d[p + 7]) << 24);
    if (p + 8 + sz > n) fail("truncated WebP: chunk past the end");
    out.push_back({cc, d + p + 8, sz});
    p += 8 + sz + (sz & 1);
  }
  return out;
}

// What Pillow's decoder gives: the canvas (width, height), whether the
// mode is RGBA, and the first frame's image chunks and place.
struct Still {
  int width = 0, height = 0, x0 = 0, y0 = 0;
  bool alpha = false;
  Chunk image{0, nullptr, 0}, alph{0, nullptr, 0};
};

Still parse(const uint8_t* d, size_t n) {
  if (n < 12 || memcmp(d, "RIFF", 4) || memcmp(d + 8, "WEBP", 4))
    fail("not a WebP file");
  size_t riff = d[4] | (d[5] << 8) | (d[6] << 16) | (size_t(d[7]) << 24);
  if (riff + 8 > n) fail("truncated WebP: RIFF size %d past the end", int(riff));
  std::vector<Chunk> cs = chunks(d + 12, riff - 4);
  if (cs.empty()) fail("truncated WebP: no chunk");
  Still s;
  const uint32_t kVP8 = fourcc("VP8 "), kVP8L = fourcc("VP8L"),
                 kVP8X = fourcc("VP8X"), kALPH = fourcc("ALPH"),
                 kANMF = fourcc("ANMF");
  auto image_of = [&](const std::vector<Chunk>& list, Still& st) {
    for (const Chunk& c : list) {
      if (c.fourcc == kALPH && !st.alph.data) st.alph = c;
      if (c.fourcc == kVP8 || c.fourcc == kVP8L) {
        st.image = c;
        return true;
      }
    }
    return false;
  };
  if (cs[0].fourcc == kVP8X) {
    if (cs[0].size < 10) fail("corrupt WebP: short VP8X chunk");
    const uint8_t* x = cs[0].data;
    s.alpha = (x[0] & 0x10) != 0;
    s.width = 1 + (x[4] | (x[5] << 8) | (x[6] << 16));
    s.height = 1 + (x[7] | (x[8] << 8) | (x[9] << 16));
    if (x[0] & 0x02) {  // animation: the first ANMF frame
      for (const Chunk& c : cs)
        if (c.fourcc == kANMF) {
          if (c.size < 16) fail("corrupt WebP: short ANMF chunk");
          s.x0 = 2 * (c.data[0] | (c.data[1] << 8) | (c.data[2] << 16));
          s.y0 = 2 * (c.data[3] | (c.data[4] << 8) | (c.data[5] << 16));
          std::vector<Chunk> sub = chunks(c.data + 16, c.size - 16);
          if (!image_of(sub, s)) fail("corrupt WebP: ANMF frame without image");
          return s;
        }
      fail("corrupt WebP: animation without a frame");
    }
    if (!image_of(cs, s)) fail("corrupt WebP: no image chunk");
    return s;
  }
  if (cs[0].fourcc == kVP8L) {
    s.image = cs[0];
    vp8l_header(s.image.data, s.image.size, &s.width, &s.height, &s.alpha);
  } else if (cs[0].fourcc == kVP8) {
    s.image = cs[0];
    if (s.image.size < 10) fail("truncated WebP: VP8 frame header");
    s.width = (s.image.data[6] | (s.image.data[7] << 8)) & 0x3fff;
    s.height = (s.image.data[8] | (s.image.data[9] << 8)) & 0x3fff;
  } else {
    fail("corrupt WebP: first chunk is not VP8, VP8L or VP8X");
  }
  return s;
}

void decode(const uint8_t* d, size_t n, uint8_t* out) {
  const Still s = parse(d, n);
  const size_t stride = size_t(s.width) * 4;
  memset(out, 0, stride * s.height);  // the canvas: transparent black
  uint8_t* at = out + size_t(s.y0) * stride + size_t(s.x0) * 4;
  int fw, fh;
  if (s.image.fourcc == fourcc("VP8L")) {
    bool alpha;
    vp8l_header(s.image.data, s.image.size, &fw, &fh, &alpha);
    if (s.x0 + fw > s.width || s.y0 + fh > s.height)
      fail("corrupt WebP: frame outside the canvas");
    std::vector<uint32_t> px =
        vp8l_pixels(s.image.data + 5, s.image.size - 5, fw, fh);
    for (int y = 0; y < fh; ++y)
      for (int x = 0; x < fw; ++x) {
        const uint32_t p = px[size_t(y) * fw + x];
        uint8_t* o = at + y * stride + 4 * size_t(x);
        o[0] = uint8_t(p >> 16);
        o[1] = uint8_t(p >> 8);
        o[2] = uint8_t(p);
        o[3] = uint8_t(p >> 24);
      }
    return;
  }
  VP8Frame f;
  vp8_decode(s.image.data, s.image.size, f);
  fw = f.width;
  fh = f.height;
  if (s.x0 + fw > s.width || s.y0 + fh > s.height)
    fail("corrupt WebP: frame outside the canvas");
  vp8_rgba(f, at, stride);
  if (s.alph.data) alpha_plane(s.alph.data, s.alph.size, fw, fh, at, stride);
}

void set_error(const char* msg) { snprintf(g_error, sizeof(g_error), "%s", msg); }

}  // namespace

extern "C" {

const char* webp_error() { return g_error; }

int webp_info(const uint8_t* data, long long n, int* info) {
  try {
    const Still s = parse(data, size_t(n));
    info[0] = s.width;
    info[1] = s.height;
    info[2] = s.alpha ? 1 : 0;
    return 0;
  } catch (const Error& e) {
    set_error(e.msg.c_str());
  } catch (const std::bad_alloc&) {
    set_error("out of memory");
  }
  return -1;
}

int webp_decode(const uint8_t* data, long long n, uint8_t* out) {
  try {
    decode(data, size_t(n), out);
    return 0;
  } catch (const Error& e) {
    set_error(e.msg.c_str());
  } catch (const std::bad_alloc&) {
    set_error("out of memory");
  }
  return -1;
}

}  // extern "C"

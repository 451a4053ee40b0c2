// _fax.cpp: the CCITT bilevel compressions of TIFF (compression 2, 3, 4
// and 32771), with a plain C interface loaded with ctypes (see
// simplestereo_tpu_torch/formats/tiff.py).
//
// Pillow reads these through libtiff's tif_fax3.c; this decoder gives the
// same rows. Each row is a chain of run lengths, in the modified Huffman
// codes of ITU-T T.4 (white and black terminating codes 0-63, makeup
// codes of multiples of 64, and the shared extended makeup codes up to
// 2560), or coded against the row above (T.4's two-dimensional READ
// coding, which T.6 uses alone): pass, horizontal (two runs) and the
// seven vertical modes V0, VR1-3, VL1-3.
//   compression 2 (RLE): one-dimensional rows, each starting on a byte;
//   compression 32771 (RLEW): the same, each row starting on 16 bits;
//   compression 3 (Group 3): each row after an EOL code (eleven zeros and
//     a one, found by skipping zeros as libtiff does, so fill bits are
//     read too); with T4Options bit 0, a tag bit after the EOL says
//     whether the row is one- (1) or two-dimensional (0);
//   compression 4 (Group 4): two-dimensional rows, the first coded
//     against an all-white row, no EOLs.
// Runs alternate white and black from a white run at each row's start;
// the output sets the bits of black runs, as libtiff's _TIFFFax3fillruns
// does (photometric decides later which colour a set bit is).
//
// C entries:
//   tiff_fax(in, n, compression, t4options, width, rows, out, stride)
//       out: rows x stride bytes, MSB first; returns the rows decoded
//       (fewer when the data ends first), or -1 with tiff_fax_error().
//   tiff_fax_error()

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local char g_error[256];

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const char* msg, int a = 0) {
  char buf[256];
  snprintf(buf, sizeof(buf), msg, a);
  throw Error{buf};
}

struct Code {
  const char* bits;
  int run;
};

// ITU-T T.4 Tables 2 and 3: terminating and makeup codes.
const Code kWhite[] = {
    {"00110101", 0},    {"000111", 1},      {"0111", 2},
    {"1000", 3},        {"1011", 4},        {"1100", 5},
    {"1110", 6},        {"1111", 7},        {"10011", 8},
    {"10100", 9},       {"00111", 10},      {"01000", 11},
    {"001000", 12},     {"000011", 13},     {"110100", 14},
    {"110101", 15},     {"101010", 16},     {"101011", 17},
    {"0100111", 18},    {"0001100", 19},    {"0001000", 20},
    {"0010111", 21},    {"0000011", 22},    {"0000100", 23},
    {"0101000", 24},    {"0101011", 25},    {"0010011", 26},
    {"0100100", 27},    {"0011000", 28},    {"00000010", 29},
    {"00000011", 30},   {"00011010", 31},   {"00011011", 32},
    {"00010010", 33},   {"00010011", 34},   {"00010100", 35},
    {"00010101", 36},   {"00010110", 37},   {"00010111", 38},
    {"00101000", 39},   {"00101001", 40},   {"00101010", 41},
    {"00101011", 42},   {"00101100", 43},   {"00101101", 44},
    {"00000100", 45},   {"00000101", 46},   {"00001010", 47},
    {"00001011", 48},   {"01010010", 49},   {"01010011", 50},
    {"01010100", 51},   {"01010101", 52},   {"00100100", 53},
    {"00100101", 54},   {"01011000", 55},   {"01011001", 56},
    {"01011010", 57},   {"01011011", 58},   {"01001010", 59},
    {"01001011", 60},   {"00110010", 61},   {"00110011", 62},
    {"00110100", 63},   {"11011", 64},      {"10010", 128},
    {"010111", 192},    {"0110111", 256},   {"00110110", 320},
    {"00110111", 384},  {"01100100", 448},  {"01100101", 512},
    {"01101000", 576},  {"01100111", 640},  {"011001100", 704},
    {"011001101", 768}, {"011010010", 832}, {"011010011", 896},
    {"011010100", 960}, {"011010101", 1024}, {"011010110", 1088},
    {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472},
    {"010011001", 1536}, {"010011010", 1600}, {"011000", 1664},
    {"010011011", 1728}};
const Code kBlack[] = {
    {"0000110111", 0},    {"010", 1},           {"11", 2},
    {"10", 3},            {"011", 4},           {"0011", 5},
    {"0010", 6},          {"00011", 7},         {"000101", 8},
    {"000100", 9},        {"0000100", 10},      {"0000101", 11},
    {"0000111", 12},      {"00000100", 13},     {"00000111", 14},
    {"000011000", 15},    {"0000010111", 16},   {"0000011000", 17},
    {"0000001000", 18},   {"00001100111", 19},  {"00001101000", 20},
    {"00001101100", 21},  {"00000110111", 22},  {"00000101000", 23},
    {"00000010111", 24},  {"00000011000", 25},  {"000011001010", 26},
    {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32},
    {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38},
    {"000011010111", 39}, {"000001101100", 40}, {"000001101101", 41},
    {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50},
    {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53},
    {"000000111000", 54}, {"000000100111", 55}, {"000000101000", 56},
    {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62},
    {"000001100111", 63}, {"0000001111", 64},   {"000011001000", 128},
    {"000011001001", 192}, {"000001011011", 256}, {"000000110011", 320},
    {"000000110100", 384}, {"000000110101", 448}, {"0000001101100", 512},
    {"0000001101101", 576}, {"0000001001010", 640}, {"0000001001011", 704},
    {"0000001001100", 768}, {"0000001001101", 832}, {"0000001110010", 896},
    {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152},
    {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408},
    {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664},
    {"0000001100101", 1728}};
// T.4 Table 3 (continued): extended makeup codes, both colours.
const Code kExtended[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
// T.4 Table 4: the two-dimensional modes (value: 0 pass, 1 horizontal,
// 2 + 3 + k vertical with a1 - b1 = k).
const Code kModes[] = {{"0001", 0},    {"001", 1},     {"1", 5},
                       {"011", 6},     {"000011", 7},  {"0000011", 8},
                       {"010", 4},     {"000010", 3},  {"0000010", 2}};

// A lookup of codes of at most 13 bits: (length, value) by the next 13
// bits; length 0 is no code.
struct Table {
  uint8_t len[1 << 13];
  int16_t val[1 << 13];
  void add(const Code* codes, size_t n) {
    for (size_t i = 0; i < n; ++i) {
      const int l = int(strlen(codes[i].bits));
      int c = 0;
      for (int k = 0; k < l; ++k) c = c * 2 + (codes[i].bits[k] - '0');
      for (int rest = 0; rest < (1 << (13 - l)); ++rest) {
        len[(c << (13 - l)) | rest] = uint8_t(l);
        val[(c << (13 - l)) | rest] = int16_t(codes[i].run);
      }
    }
  }
  Table(const Code* a, size_t na, const Code* b, size_t nb) {
    memset(len, 0, sizeof(len));
    add(a, na);
    add(b, nb);
  }
};
const Table kWhiteTable(kWhite, sizeof(kWhite) / sizeof(Code), kExtended,
                        sizeof(kExtended) / sizeof(Code));
const Table kBlackTable(kBlack, sizeof(kBlack) / sizeof(Code), kExtended,
                        sizeof(kExtended) / sizeof(Code));
const Table kModeTable(kModes, sizeof(kModes) / sizeof(Code), kModes, 0);

struct Bits {
  const uint8_t* in;
  size_t n, pos = 0;  // pos in bits
  bool end() const { return pos >= 8 * n; }
  int peek(int k) const {  // the next k bits, zeros past the end
    int v = 0;
    for (int i = 0; i < k; ++i) {
      const size_t p = pos + i;
      v = v * 2 + (p < 8 * n ? (in[p >> 3] >> (7 - (p & 7))) & 1 : 0);
    }
    return v;
  }
  void skip(int k) { pos += k; }
  void align(int bits) { pos = (pos + bits - 1) / bits * bits; }
};

struct EndOfData {};

int code(Bits& b, const Table& t) {
  if (b.end()) throw EndOfData{};
  const int i = b.peek(13);
  if (!t.len[i]) fail("corrupt CCITT data: bad code word");
  b.skip(t.len[i]);
  return t.val[i];
}

// One run of a colour: makeup codes, then a terminating code.
int run(Bits& b, int colour) {
  int total = 0;
  for (;;) {
    const int r = code(b, colour ? kBlackTable : kWhiteTable);
    total += r;
    if (r < 64) return total;
  }
}

// Skip to just past the next EOL (eleven or more zeros, then a one), as
// libtiff's SYNC_EOL.
void sync_eol(Bits& b) {
  int zeros = 0;
  for (;;) {
    if (b.end()) throw EndOfData{};
    const int bit = b.peek(1);
    b.skip(1);
    if (bit == 0) {
      ++zeros;
    } else if (zeros >= 11) {
      return;
    } else {
      zeros = 0;
    }
  }
}

// Changing elements of a row: positions where the colour changes,
// starting from white; fills `changes` and returns it.
void decode_1d(Bits& b, int width, std::vector<int>& changes) {
  changes.clear();
  int a0 = 0, colour = 0;
  while (a0 < width) {
    a0 += run(b, colour);
    if (a0 > width) a0 = width;
    changes.push_back(a0);
    colour ^= 1;
  }
}

void decode_2d(Bits& b, int width, const std::vector<int>& ref,
               std::vector<int>& changes) {
  changes.clear();
  int a0 = -1, colour = 0;
  size_t bi = 0;
  auto at = [&](size_t i) { return i < ref.size() ? ref[i] : width; };
  while (a0 < width) {
    // b1: the first change on the reference row right of a0 to the
    // colour opposite a0's (even entries turn white to black).
    bi = bi >= 2 ? bi - 2 : 0;
    while (bi < ref.size() && (at(bi) <= a0 || int(bi & 1) != colour)) ++bi;
    const int b1 = at(bi), b2 = at(bi + 1);
    const int mode = code(b, kModeTable);
    if (mode == 0) {  // pass
      a0 = b2;
    } else if (mode == 1) {  // horizontal
      if (a0 < 0) a0 = 0;
      int a1 = a0 + run(b, colour);
      int a2 = a1 + run(b, colour ^ 1);
      if (a1 > width) a1 = width;
      if (a2 > width) a2 = width;
      changes.push_back(a1);
      changes.push_back(a2);
      a0 = a2;
    } else {  // vertical
      int a1 = b1 + (mode - 5);
      if (a1 < (a0 < 0 ? 0 : a0) || a1 > width)
        fail("corrupt CCITT data: vertical mode out of the row");
      changes.push_back(a1);
      a0 = a1;
      colour ^= 1;
    }
  }
}

void fill(const std::vector<int>& changes, int width, uint8_t* row) {
  int x = 0;
  for (size_t i = 0; i < changes.size(); ++i) {
    const int end = changes[i] < width ? changes[i] : width;
    if (i & 1)
      for (int k = x; k < end; ++k) row[k >> 3] |= uint8_t(0x80 >> (k & 7));
    x = end;
  }
}

long long decode(const uint8_t* in, long long n, int compression,
                 int t4options, int width, int rows, uint8_t* out,
                 long long stride) {
  Bits b{in, size_t(n)};
  std::vector<int> ref, cur;
  memset(out, 0, size_t(rows) * stride);
  int y = 0;
  try {
    for (; y < rows; ++y) {
      bool two_d = compression == 4;
      if (compression == 3) {
        sync_eol(b);
        if (t4options & 1) {
          if (b.end()) throw EndOfData{};
          two_d = b.peek(1) == 0;
          b.skip(1);
        }
      }
      if (two_d) {
        if (y == 0 && compression == 4) ref.clear();
        decode_2d(b, width, ref, cur);
      } else {
        decode_1d(b, width, cur);
      }
      fill(cur, width, out + size_t(y) * stride);
      ref.swap(cur);
      if (compression == 2) b.align(8);
      if (compression == 32771) b.align(16);
    }
  } catch (const EndOfData&) {
  }
  return y;
}

}  // namespace

extern "C" {

const char* tiff_fax_error() { return g_error; }

long long tiff_fax(const uint8_t* in, long long n, int compression,
                   int t4options, int width, int rows, uint8_t* out,
                   long long stride) {
  try {
    return decode(in, n, compression, t4options, width, rows, out, stride);
  } catch (const Error& e) {
    snprintf(g_error, sizeof(g_error), "%s", e.msg.c_str());
  } catch (const std::bad_alloc&) {
    snprintf(g_error, sizeof(g_error), "out of memory");
  }
  return -1;
}

}  // extern "C"

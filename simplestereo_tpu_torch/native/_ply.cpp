// _ply.cpp: ASCII PLY point-cloud writer and parser with a plain C
// interface, loaded with ctypes (see simplestereo_tpu_torch/native).
//
// The port of simplestereo_tpu/native/_ply.cpp. The bytes are the same:
// every coordinate as printf("%.<precision>f"), colours as " %u %u %u",
// an integer intensity as " %lld" of the value cast to long long, a float
// intensity as " %.<precision>f", one '\n' per point. The JAX package's
// module is a CPython extension; this one needs no Python.h, so it builds
// with g++ in about a second.
//
// Formatting dominates a write (three to seven numbers a point, ~900k
// points for a 1280x720 cloud). Two levers, neither of which changes a
// byte:
//   - std::to_chars in fixed format with the given precision, which the
//     standard defines as printf's "%.<precision>f" in the C locale, where
//     the library has it (__cpp_lib_to_chars); snprintf otherwise;
//   - the points are cut into chunks, each formatted by its own host
//     thread into its own buffer, and the buffers are written in order.
// The parser reads the whole body, cuts it at line ends into chunks, and
// parses them on the same threads with strtod, as the JAX package does.
//
// C entries (0 on success, else an errno value or -1 for a malformed body):
//   ply_write(path, header, header_len, xyz, n, mode, rgb, vals, as_int,
//             precision)
//       mode 0: xyz; 1: xyz + rgb (uint8, n x 3); 2: xyz + intensity
//       (float64, n). xyz is float64, n x 3, row-major.
//   ply_read(path, n_skip, n_rows, n_cols, out)
//       Skips n_skip lines, then parses n_rows lines of n_cols
//       whitespace-separated numbers into out (float64, row-major).

#include <algorithm>
#include <cerrno>
#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// One thread a core, at most one per `per_thread` items.
int pick_threads(long long items, long long per_thread) {
  long long t = std::thread::hardware_concurrency();
  t = std::min(t, (items + per_thread - 1) / per_thread);
  return (int)std::max(1LL, std::min(t, 64LL));
}

// Runs fn(k) for k in [0, n) on n threads (the calling thread takes 0).
template <class Fn>
void run_threads(int n, Fn fn) {
  std::vector<std::thread> pool;
  for (int k = 1; k < n; ++k) pool.emplace_back(fn, k);
  fn(0);
  for (auto& t : pool) t.join();
}

// printf("%.<prec>f", v) appended at p; returns the new end.
char* put_fixed(char* p, char* end, double v, int prec) {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  auto r = std::to_chars(p, end, v, std::chars_format::fixed, prec);
  if (r.ec == std::errc()) return r.ptr;
#endif
  int len = snprintf(p, end - p, "%.*f", prec, v);
  return p + len;
}

char* put_uint(char* p, char* end, unsigned v) {
  auto r = std::to_chars(p, end, v);
  return r.ptr;
}

char* put_ll(char* p, char* end, long long v) {
  auto r = std::to_chars(p, end, v);
  return r.ptr;
}

// Formats points [i0, i1) into out.
void format_points(std::string& out, const double* xyz,
                   const unsigned char* rgb, const double* vals, int mode,
                   int as_int, int prec, long long i0, long long i1) {
  // A fixed-format double may need up to 309 integer digits + precision.
  const size_t line_max = 4 * (330 + (size_t)prec) + 64;
  std::vector<char> line(line_max);
  char* const base = line.data();
  char* const end = base + line_max;
  out.clear();
  out.reserve((size_t)(i1 - i0) * (3 * (prec + 6) + 14));
  for (long long i = i0; i < i1; ++i) {
    char* p = base;
    p = put_fixed(p, end, xyz[3 * i], prec);
    *p++ = ' ';
    p = put_fixed(p, end, xyz[3 * i + 1], prec);
    *p++ = ' ';
    p = put_fixed(p, end, xyz[3 * i + 2], prec);
    if (mode == 1) {
      for (int c = 0; c < 3; ++c) {
        *p++ = ' ';
        p = put_uint(p, end, rgb[3 * i + c]);
      }
    } else if (mode == 2) {
      *p++ = ' ';
      p = as_int ? put_ll(p, end, (long long)vals[i])
                 : put_fixed(p, end, vals[i], prec);
    }
    *p++ = '\n';
    out.append(base, p - base);
  }
}

struct File {
  FILE* f;
  ~File() {
    if (f) fclose(f);
  }
};

}  // namespace

extern "C" int ply_write(const char* path, const char* header,
                         long long header_len, const double* xyz, long long n,
                         int mode, const unsigned char* rgb,
                         const double* vals, int as_int, int precision) {
  if (mode < 0 || mode > 2 || precision < 0 || precision > 100) return EINVAL;
  if ((mode == 1 && !rgb) || (mode == 2 && !vals)) return EINVAL;
  File file{fopen(path, "wb")};
  if (!file.f) return errno ? errno : EIO;
  if (fwrite(header, 1, header_len, file.f) != (size_t)header_len) return EIO;
  const long long chunk = 1 << 14;  // points a buffer holds
  const long long n_chunks = (n + chunk - 1) / chunk;
  const int nt = pick_threads(n_chunks, 1);
  // Thread k formats chunks k, k + nt, ...; a round of nt chunks is
  // written in order before the next round starts.
  std::vector<std::string> bufs(nt);
  for (long long c0 = 0; c0 < n_chunks; c0 += nt) {
    const int live = (int)std::min<long long>(nt, n_chunks - c0);
    run_threads(live, [&](int k) {
      const long long i0 = (c0 + k) * chunk;
      format_points(bufs[k], xyz, rgb, vals, mode, as_int, precision, i0,
                    std::min(n, i0 + chunk));
    });
    for (int k = 0; k < live; ++k)
      if (fwrite(bufs[k].data(), 1, bufs[k].size(), file.f) != bufs[k].size())
        return EIO;
  }
  if (fflush(file.f) != 0) return errno ? errno : EIO;
  return 0;
}

extern "C" int ply_read(const char* path, long long n_skip, long long n_rows,
                        long long n_cols, double* out) {
  File file{fopen(path, "rb")};
  if (!file.f) return errno ? errno : EIO;
  if (fseek(file.f, 0, SEEK_END) != 0) return EIO;
  const long size = ftell(file.f);
  if (size < 0 || fseek(file.f, 0, SEEK_SET) != 0) return EIO;
  std::vector<char> text((size_t)size + 1);
  if (fread(text.data(), 1, size, file.f) != (size_t)size) return EIO;
  text[size] = '\0';
  const char* p = text.data();
  const char* const end = p + size;
  for (long long i = 0; i < n_skip; ++i) {
    p = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!p) return -1;
    ++p;
  }
  // Line starts of the body, then each thread parses a range of lines.
  std::vector<const char*> starts;
  starts.reserve((size_t)n_rows + 1);
  for (long long r = 0; r < n_rows; ++r) {
    if (p >= end) return -1;
    starts.push_back(p);
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    p = nl ? nl + 1 : end;
  }
  const int nt = pick_threads(n_rows, 1 << 15);
  std::vector<int> bad(nt, 0);
  run_threads(nt, [&](int k) {
    const long long r0 = n_rows * k / nt, r1 = n_rows * (k + 1) / nt;
    for (long long r = r0; r < r1 && !bad[k]; ++r) {
      const char* s = starts[r];
      for (long long c = 0; c < n_cols; ++c) {
        char* e;
        const double v = strtod(s, &e);
        // strtod skips leading blanks, newlines included: a short line
        // must not borrow numbers from the next one.
        if (e == s || memchr(s, '\n', e - s)) {
          bad[k] = 1;
          break;
        }
        out[r * n_cols + c] = v;
        s = e;
      }
    }
  });
  for (int b : bad)
    if (b) return -1;
  return 0;
}

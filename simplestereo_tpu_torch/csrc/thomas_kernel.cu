// WLS line-solve kernel (S2) for Hopper (sm_90a): a warp a line, solved
// by the partition method.
//
// Replaces simplestereo_tpu/passive/wls.py::_thomas_rows, the tridiagonal
// solver under the WLS smoother (the Fast Global Smoother of Min et al.
// 2014). The JAX package writes it as two lax.scans along each line (the
// forward elimination and the back substitution), vmapped over the lines;
// XLA compiles them, so it is not a Pallas kernel. Eager PyTorch would pay
// some ten launches a line position, ~10,000 a solve at 1280x720, so the
// port needs a kernel of its own.
//
// What it computes, for every line of a (B, H, W) stack (a row for the
// solve along x, a column for the solve along y), of L positions, from the
// data weight conf, the neighbour weights w (L-1 a line), lam and u, the
// solution of the tridiagonal system
//   d_p  = (conf_p + eps) + lam * (w_{p-1} + w_p)   (w_{-1} = w_{L-1} = 0)
//   lo_p = -(lam * w_{p-1}) (0 at p = 0), up_p = -(lam * w_p) (0 at L-1)
//   r_p  = conf_p * u_p + eps * u_p
// which is _fgs's (C + lam L) x = C u + eps u along one axis, built as
// wls._solve_plain builds it and solved as wls._thomas_partitioned_plain
// (the plain twin) solves it:
//   - the line is padded to 32 segments of m positions (m = ceil(L / 32),
//     made odd), identity rows past its end; lane s owns segment s, its
//     first m-1 positions the interior, the last one the separator;
//   - each lane eliminates its interior top down with three right-hand
//     sides (r, the coupling to the separator on its left, the one to its
//     own), then back-substitutes the three to the interior's first
//     position (its last one's values are the forward ones);
//   - the separators' rows, with their interior neighbours put in, form a
//     tridiagonal system of one unknown a lane, solved by parallel cyclic
//     reduction with shuffles in 5 steps (strides 1..16);
//   - each lane fills its interior from its separator and its left one.
// Every operation is an explicitly rounded intrinsic (__fadd_rn,
// __fmul_rn, __fdiv_rn: IEEE division, no FMA contraction), in the twin's
// order, so the kernel agrees with the twin on the card bit for bit.
//
// What bounds it on this card: latency. The bytes are few (conf, w, u in
// and out: 14.7 MB a 1280x720 solve, 4.4 us at 3.35 TB/s) and so are the
// operations (~40 a position), but the sequential Thomas is a chain of 2L
// dependent steps a line, an IEEE division in each forward one. The
// partition cuts a lane's chain to about 3m steps (m = 41 for a 1280 row,
// 23 for a 720 column) plus the reduction's 5, and puts a warp on every
// line: 720 or 1,280 warps a 720p solve, not 23 or 40. The design:
//   - A block is `lines` warps, a line each. It stages its lines' conf, u
//     and w in shared memory, line by line ([line][position], a stride of
//     `stride` floats), with neighbouring threads on neighbouring
//     addresses: a row solve's warp reads its own row, a column solve's
//     block reads row segments of its `lines` neighbouring columns. Then
//     each lane walks its segment there: with m odd, the 32 lanes' reads
//     (position lane * m + i) hit 32 banks.
//   - c', y' and v' overwrite conf, u and w in place as the forward sweep
//     passes them (a lane keeps the w it still needs in a register), and
//     the fill writes the solution over y': no workspace in device memory.
//   - The separator system and its reduction live in registers; a lane
//     reads its right neighbour's first-position values and the
//     reduction's neighbours by shuffles.
//   - The solution is stored from shared memory in the input's layout, as
//     it was loaded. The grid is (line blocks, frames): a stack of more
//     than 65,535 frames is cut into launches by the wrapper
//     (_build.frame_pieces).

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // segments a line: the lanes of its warp
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int L;             // positions a line
  int lpf;           // lines a frame
  int W;             // image width (the row stride)
  int along_y;       // 1: lines are columns, 0: rows
  int m;             // positions a segment (odd)
  int stride;        // floats between two lines' arrays in shared memory
  long long frame;   // elements of conf, u, out a frame (H*W)
  long long wframe;  // elements of w a frame
};

__device__ __forceinline__ long long data_off(const Geometry& g, int j,
                                              int p) {
  return g.along_y ? (long long)p * g.W + j : (long long)j * g.W + p;
}

__device__ __forceinline__ long long w_off(const Geometry& g, int j, int p) {
  return g.along_y ? (long long)p * g.W + j : (long long)j * (g.W - 1) + p;
}

// The row of position p of a line: (d, lo, up, r), identity past L.
// w_left is w_{p-1} (0 at p = 0); w_right is read here when p < L-1.
struct Row {
  float d, lo, up, r;
};

__device__ __forceinline__ Row make_row(const Geometry& g, float lam,
                                        float eps, float conf, float u,
                                        float w_left, float w_right, int p) {
  Row row;
  if (p >= g.L) {
    row.d = 1.f;
    row.lo = 0.f;
    row.up = 0.f;
    row.r = 0.f;
    return row;
  }
  row.d = __fadd_rn(__fadd_rn(conf, eps),
                    __fmul_rn(lam, __fadd_rn(w_left, w_right)));
  row.lo = p > 0 ? -__fmul_rn(lam, w_left) : 0.f;
  row.up = p < g.L - 1 ? -__fmul_rn(lam, w_right) : 0.f;
  row.r = __fadd_rn(__fmul_rn(conf, u), __fmul_rn(eps, u));
  return row;
}

// Stage (or store back, when `store`) the block's lines: conf, u, w
// into sc, su, sw at [line][position], or su to out.
__device__ __forceinline__ void stage(const Geometry& g, const float* conf,
                                      const float* w, const float* u,
                                      float* out, float* sc, float* su,
                                      float* sw, int j0, int lines,
                                      bool store) {
  if (!g.along_y) {
    // A warp a row: lanes along the row.
    const int li = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
    const int j = j0 + li;
    if (j >= g.lpf) return;
    float* c = sc + li * g.stride;
    float* uu = su + li * g.stride;
    float* ww = sw + li * g.stride;
#pragma unroll 8
    for (int p = lane; p < g.L; p += kLanes) {
      const long long o = data_off(g, j, p);
      if (store) {
        out[o] = uu[p];
      } else {
        c[p] = conf[o];
        uu[p] = u[o];
        if (p < g.L - 1) ww[p] = w[w_off(g, j, p)];
      }
    }
  } else {
    // Columns: `lines` neighbouring columns, threads along them.
    const int n = lines * g.L;
#pragma unroll 8
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int li = e % lines, p = e / lines, j = j0 + li;
      if (j >= g.lpf) continue;
      const long long o = data_off(g, j, p);
      const int s = li * g.stride + p;
      if (store) {
        out[o] = su[s];
      } else {
        sc[s] = conf[o];
        su[s] = u[o];
        if (p < g.L - 1) sw[s] = w[w_off(g, j, p)];
      }
    }
  }
}

// At most 8 warps a block (wls._plan), so that a thread may keep 255
// registers.
constexpr int kMaxLines = 8;

__global__ void __launch_bounds__(kMaxLines * kLanes)
    thomas_kernel(const float* __restrict__ conf, const float* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ out,
                  Geometry g, float lam, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int lines = blockDim.x / kLanes;
  const int li = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int j0 = blockIdx.x * lines;
  const long long f = blockIdx.y;
  conf += f * g.frame;
  u += f * g.frame;
  out += f * g.frame;
  w += f * g.wframe;
  float* sc = smem;
  float* su = sc + lines * g.stride;
  float* sw = su + lines * g.stride;

  stage(g, conf, w, u, out, sc, su, sw, j0, lines, false);
  __syncthreads();

  if (j0 + li < g.lpf) {
    float* C = sc + li * g.stride;  // conf, then c'
    float* Y = su + li * g.stride;  // u, then y', then the solution
    float* V = sw + li * g.stride;  // w, then v'
    const int m = g.m, n = m - 1;
    const int a = lane * m, b = a + n;
    // 1. Forward elimination of the interior [a, b).
    float w_left = (a > 0 && a < g.L) ? V[a - 1] : 0.f;
    float c = 0.f, y = 0.f, v = 0.f;
    for (int i = 0; i < n; ++i) {
      const int p = a + i;
      const bool in = p < g.L;
      const float w_right = p < g.L - 1 ? V[p] : 0.f;
      const Row row = make_row(g, lam, eps, in ? C[p] : 0.f,
                               in ? Y[p] : 0.f, w_left, w_right, p);
      float den, yn, vn;
      if (i == 0) {
        den = row.d;
        yn = row.r;
        vn = row.lo;
      } else {
        den = __fsub_rn(row.d, __fmul_rn(row.lo, c));
        yn = __fsub_rn(row.r, __fmul_rn(row.lo, y));
        vn = -__fmul_rn(row.lo, v);
      }
      c = __fdiv_rn(row.up, den);
      y = __fdiv_rn(yn, den);
      v = __fdiv_rn(vn, den);
      if (in) {
        C[p] = c;
        Y[p] = y;
        V[p] = v;
      }
      w_left = w_right;
    }
    // 2. (y, v, w) at the last (E) and the first (F) interior position.
    float yE, vE, wE, yF, vF, wF;
    if (n > 0) {
      yE = y;
      vE = v;
      wE = c;
      yF = y;
      vF = v;
      wF = c;
      for (int i = n - 2; i >= 0; --i) {
        const int p = a + i;
        float cc = 0.f, yy = 0.f, vv = 0.f;
        if (p < g.L) {
          cc = C[p];
          yy = Y[p];
          vv = V[p];
        } else {  // past the line: an identity row's values
          cc = 0.f;
          yy = 0.f;
          vv = 0.f;
        }
        yF = __fsub_rn(yy, __fmul_rn(cc, yF));
        vF = __fsub_rn(vv, __fmul_rn(cc, vF));
        wF = -__fmul_rn(cc, wF);
      }
    } else {
      yE = 0.f;
      vE = -1.f;
      wE = 0.f;
      yF = 0.f;
      vF = 0.f;
      wF = -1.f;
    }
    // 3. The separators' system and its reduction.
    float yF1 = __shfl_down_sync(kFull, yF, 1);
    float vF1 = __shfl_down_sync(kFull, vF, 1);
    float wF1 = __shfl_down_sync(kFull, wF, 1);
    if (lane == kLanes - 1) {
      yF1 = 0.f;
      vF1 = 0.f;
      wF1 = 0.f;
    }
    const bool sep_in = b < g.L;
    const float w_right = b < g.L - 1 ? V[b] : 0.f;
    const Row row = make_row(g, lam, eps, sep_in ? C[b] : 0.f,
                             sep_in ? Y[b] : 0.f, w_left, w_right, b);
    float A = -__fmul_rn(row.lo, vE);
    float B = __fsub_rn(__fsub_rn(row.d, __fmul_rn(row.lo, wE)),
                        __fmul_rn(row.up, vF1));
    float Cs = -__fmul_rn(row.up, wF1);
    float D = __fsub_rn(__fsub_rn(row.r, __fmul_rn(row.lo, yE)),
                        __fmul_rn(row.up, yF1));
#pragma unroll
    for (int delta = 1; delta < kLanes; delta <<= 1) {
      float Am = __shfl_up_sync(kFull, A, delta);
      float Bm = __shfl_up_sync(kFull, B, delta);
      float Cm = __shfl_up_sync(kFull, Cs, delta);
      float Dm = __shfl_up_sync(kFull, D, delta);
      float Ap = __shfl_down_sync(kFull, A, delta);
      float Bp = __shfl_down_sync(kFull, B, delta);
      float Cp = __shfl_down_sync(kFull, Cs, delta);
      float Dp = __shfl_down_sync(kFull, D, delta);
      if (lane < delta) {
        Am = 0.f;
        Bm = 1.f;
        Cm = 0.f;
        Dm = 0.f;
      }
      if (lane + delta >= kLanes) {
        Ap = 0.f;
        Bp = 1.f;
        Cp = 0.f;
        Dp = 0.f;
      }
      const float k1 = __fdiv_rn(A, Bm);
      const float k2 = __fdiv_rn(Cs, Bp);
      const float nA = -__fmul_rn(Am, k1);
      const float nB = __fsub_rn(__fsub_rn(B, __fmul_rn(Cm, k1)),
                                 __fmul_rn(Ap, k2));
      const float nC = -__fmul_rn(Cp, k2);
      const float nD = __fsub_rn(__fsub_rn(D, __fmul_rn(Dm, k1)),
                                 __fmul_rn(Dp, k2));
      A = nA;
      B = nB;
      Cs = nC;
      D = nD;
    }
    const float S = __fdiv_rn(D, B);
    float S_left = __shfl_up_sync(kFull, S, 1);
    if (lane == 0) S_left = 0.f;
    // 4. The fill, from the separator down.
    if (sep_in) Y[b] = S;
    if (n > 0) {
      float x = __fsub_rn(__fsub_rn(y, __fmul_rn(v, S_left)),
                          __fmul_rn(c, S));
      if (b - 1 < g.L) Y[b - 1] = x;
      for (int i = n - 2; i >= 0; --i) {
        const int p = a + i;
        if (p >= g.L) {  // an identity row past the line: x stays exact
          x = __fsub_rn(__fsub_rn(0.f, __fmul_rn(0.f, S_left)),
                        __fmul_rn(0.f, x));
          continue;
        }
        x = __fsub_rn(__fsub_rn(Y[p], __fmul_rn(V[p], S_left)),
                      __fmul_rn(C[p], x));
        Y[p] = x;
      }
    }
  }
  __syncthreads();
  stage(g, conf, w, u, out, sc, su, sw, j0, lines, true);
}

}  // namespace

// One launch: frames [0, B) of the stack (B <= 65,535) whose pointers the
// caller has offset to the first frame; blocks of `lines` warps, segments
// of m positions, `stride` floats a line in `smem` bytes of shared memory.
extern "C" int thomas_solve(const void* conf, const void* w, const void* u,
                            void* out, int B, int H, int W, int along_y,
                            float lam, float eps, int m, int lines,
                            int stride, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || m <= 0 || lines <= 0 ||
      lines > kMaxLines)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.L = along_y ? H : W;
  g.lpf = along_y ? W : H;
  g.W = W;
  g.along_y = along_y;
  g.m = m;
  g.stride = stride;
  g.frame = (long long)H * W;
  g.wframe = along_y ? (long long)(H - 1) * W : (long long)H * (W - 1);
  if (kLanes * m < g.L || stride < g.L) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        thomas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((g.lpf + lines - 1) / lines, B);
  thomas_kernel<<<grid, lines * kLanes, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(out), g, lam, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* thomas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Thomas line-solve kernel (S2) for Hopper (sm_90a).
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
// data weight conf, the neighbour weights w (L-1 a line), lam and u:
//   d_p  = (conf_p + eps) + lam * (w_{p-1} + w_p)   (w_{-1} = w_{L-1} = 0)
//   lo_p = -(lam * w_{p-1}) (0 at p = 0), up_p = -(lam * w_p) (0 at L-1)
//   r_p  = conf_p * u_p + eps * u_p
//   forward:  den = d_p - lo_p c'_{p-1}; c'_p = up_p / den;
//             r'_p = (r_p - lo_p r'_{p-1}) / den          (c'_{-1} = r'_{-1} = 0)
//   backward: out_p = r'_p - c'_p out_{p+1}                (out_L = 0)
// which is _fgs's (C + lam L) x = C u + eps u along one axis, built and
// solved as wls._solve_plain (the plain twin) builds and solves it. The
// diagonal, the off-diagonals and the right-hand side never reach memory.
// Every operation is an explicitly rounded intrinsic (__fadd_rn,
// __fmul_rn, __fdiv_rn: IEEE division, no FMA contraction), in the twin's
// order, so the kernel agrees with the twin on the card bit for bit.
//
// What bounds it on this card: the chain of dependent steps. The bytes are
// few (conf, w, u in and out: 14.7 MB a 1280x720 solve, 4.4 us at
// 3.35 TB/s), but position p needs c'_{p-1} through a multiply, a subtract
// and an IEEE division: W = 1,280 steps for a row solve and H = 720 for a
// column solve, then as many multiply-subtract steps back. The design:
//   - A thread a line, a warp (one block) of 32 neighbouring lines. A
//     720p frame has 720 rows and 1,280 columns: 23 and 40 blocks, about a
//     warp an SM. That occupancy is the first version's lever for later
//     work (ROADMAP.md: a warp-parallel cyclic reduction a line).
//   - Neither axis is transposed. The warp stages chunks of 32 positions x
//     32 lines of conf, w and u in shared memory with cp.async, always
//     with neighbouring lanes on neighbouring addresses: a column solve
//     reads a row segment a position, a row solve a row segment a line.
//     Each thread then walks its line in the tile. STAGES chunks are in
//     flight, so the loads run ahead of the chain.
//   - c' and r' go to a workspace in device memory, laid out position-major
//     ([p][line]) so that a warp's 32 stores of a step fill one 128-byte
//     line and the back substitution stages them back the same way. The
//     output is staged in a tile and stored in the input's orientation.
//   - The grid is (line blocks, frames): a stack of more than 65,535
//     frames is cut into launches by the wrapper (_build.frame_pieces).

#include <cuda_runtime.h>

namespace {

constexpr int kLines = 32;           // lines a block: one warp
constexpr int kChunk = 32;           // positions a staged chunk
constexpr int kPad = kLines + 1;     // tile row stride: no bank conflicts
constexpr int kStages = 3;           // chunks in flight
constexpr int kTile = kChunk * kPad;  // floats a tile

struct Geometry {
  int L;             // positions a line
  int lpf;           // lines a frame
  int W;             // image width (the row stride)
  int along_y;       // 1: lines are columns, 0: rows
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

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kStages - 1 committed groups are pending.
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

// Tile cell (position pi, line li) staged by copy i of this lane: lanes on
// lines for a column solve, on positions for a row solve, so that
// neighbouring lanes read neighbouring addresses either way.
__device__ __forceinline__ void cell(const Geometry& g, int i, int lane,
                                     int& pi, int& li) {
  pi = g.along_y ? i : lane;
  li = g.along_y ? lane : i;
}

// Chunk ch of conf (tile 0), w (tile 1) and u (tile 2) into stage buf.
__device__ __forceinline__ void stage_inputs(
    const Geometry& g, const float* conf, const float* w, const float* u,
    float* smem, int j0, int ch, int buf, int lane) {
  float* t = smem + buf * 3 * kTile;
  const int p0 = ch * kChunk;
  for (int i = 0; i < kChunk; ++i) {
    int pi, li;
    cell(g, i, lane, pi, li);
    const int p = p0 + pi, j = j0 + li;
    if (p >= g.L || j >= g.lpf) continue;
    const long long o = data_off(g, j, p);
    cp_async4(t + pi * kPad + li, conf + o);
    cp_async4(t + 2 * kTile + pi * kPad + li, u + o);
    if (p < g.L - 1) cp_async4(t + kTile + pi * kPad + li, w + w_off(g, j, p));
  }
}

// Chunk ch of c' (tile 0) and r' (tile 1) into stage buf; the workspace
// is [p][line] for either axis.
__device__ __forceinline__ void stage_work(const Geometry& g, const float* cw,
                                           const float* rw, float* smem,
                                           int j0, int ch, int buf,
                                           int lane) {
  float* t = smem + buf * 2 * kTile;
  const int p0 = ch * kChunk, j = j0 + lane;
  if (j >= g.lpf) return;
  for (int i = 0; i < kChunk && p0 + i < g.L; ++i) {
    const long long o = (long long)(p0 + i) * g.lpf + j;
    cp_async4(t + i * kPad + lane, cw + o);
    cp_async4(t + kTile + i * kPad + lane, rw + o);
  }
}

__global__ void __launch_bounds__(kLines)
    thomas_kernel(const float* __restrict__ conf, const float* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ out,
                  float* __restrict__ work, Geometry g, float lam,
                  float eps) {
  __shared__ __align__(16) float smem[3 * kStages * kTile];
  const int lane = threadIdx.x;
  const int j0 = blockIdx.x * kLines;
  const int j = j0 + lane;
  const bool live = j < g.lpf;
  const long long f = blockIdx.y;
  conf += f * g.frame;
  u += f * g.frame;
  out += f * g.frame;
  w += f * g.wframe;
  float* cw = work + f * 2LL * g.L * g.lpf;
  float* rw = cw + (long long)g.L * g.lpf;
  const int nch = (g.L + kChunk - 1) / kChunk;

  // 1. Forward elimination, chunk by chunk, STAGES - 1 chunks ahead.
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch) stage_inputs(g, conf, w, u, smem, j0, s, s, lane);
    cp_async_commit();
  }
  float c_prev = 0.f, r_prev = 0.f, w_left = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    const int ahead = ch + kStages - 1;
    if (ahead < nch)
      stage_inputs(g, conf, w, u, smem, j0, ahead, ahead % kStages, lane);
    cp_async_commit();
    cp_async_wait_stage();
    __syncthreads();
    const float* t = smem + (ch % kStages) * 3 * kTile;
    const int p0 = ch * kChunk;
    const int n = min(kChunk, g.L - p0);
    if (live) {
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const int p = p0 + i;
        const bool last = p == g.L - 1;
        const float cf = t[i * kPad + lane];
        const float uu = t[2 * kTile + i * kPad + lane];
        const float w_right = last ? 0.f : t[kTile + i * kPad + lane];
        const float li = p > 0 ? -__fmul_rn(lam, w_left) : 0.f;
        const float ui = last ? 0.f : -__fmul_rn(lam, w_right);
        const float d = __fadd_rn(__fadd_rn(cf, eps),
                                  __fmul_rn(lam, __fadd_rn(w_left, w_right)));
        const float ri = __fadd_rn(__fmul_rn(cf, uu), __fmul_rn(eps, uu));
        const float den = __fsub_rn(d, __fmul_rn(li, c_prev));
        const float c = __fdiv_rn(ui, den);
        const float r = __fdiv_rn(__fsub_rn(ri, __fmul_rn(li, r_prev)), den);
        const long long o = (long long)p * g.lpf + j;
        cw[o] = c;
        rw[o] = r;
        c_prev = c;
        r_prev = r;
        w_left = w_right;
      }
    }
    __syncthreads();
  }
  // Every lane stages back only what it stored itself; the barrier also
  // orders the stores before the asynchronous reads.
  __threadfence_block();
  __syncthreads();

  // 2. Back substitution, last chunk first; the outputs go through a tile
  // (after the STAGES c'/r' stages) to be stored in the input's layout.
  float* otile = smem + kStages * 2 * kTile;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch) stage_work(g, cw, rw, smem, j0, nch - 1 - s, s, lane);
    cp_async_commit();
  }
  float u_next = 0.f;
  for (int k = 0; k < nch; ++k) {
    const int ch = nch - 1 - k;
    const int ahead = k + kStages - 1;
    if (ahead < nch)
      stage_work(g, cw, rw, smem, j0, nch - 1 - ahead, ahead % kStages, lane);
    cp_async_commit();
    cp_async_wait_stage();
    __syncthreads();
    const float* t = smem + (k % kStages) * 2 * kTile;
    const int p0 = ch * kChunk;
    const int n = min(kChunk, g.L - p0);
    if (live) {
#pragma unroll 4
      for (int i = n - 1; i >= 0; --i) {
        const float v = __fsub_rn(t[kTile + i * kPad + lane],
                                  __fmul_rn(t[i * kPad + lane], u_next));
        otile[i * kPad + lane] = v;
        u_next = v;
      }
    }
    __syncthreads();
    for (int i = 0; i < kChunk; ++i) {
      int pi, li;
      cell(g, i, lane, pi, li);
      const int p = p0 + pi, jj = j0 + li;
      if (p < g.L && jj < g.lpf) out[data_off(g, jj, p)] = otile[pi * kPad + li];
    }
    __syncthreads();
  }
}

}  // namespace

// One launch: frames [0, B) of the stack (B <= 65,535) whose pointers the
// caller has offset to the first frame. work holds 2 * L * lines floats a
// frame.
extern "C" int thomas_solve(const void* conf, const void* w, const void* u,
                            void* out, void* work, int B, int H, int W,
                            int along_y, float lam, float eps, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.L = along_y ? H : W;
  g.lpf = along_y ? W : H;
  g.W = W;
  g.along_y = along_y;
  g.frame = (long long)H * W;
  g.wframe = along_y ? (long long)(H - 1) * W : (long long)H * (W - 1);
  const dim3 grid((g.lpf + kLines - 1) / kLines, B);
  thomas_kernel<<<grid, kLines, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(out),
      static_cast<float*>(work), g, lam, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* thomas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

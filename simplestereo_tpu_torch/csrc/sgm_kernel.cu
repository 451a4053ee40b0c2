// SGM path aggregation kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel simplestereo_tpu/passive/sgm_pallas.py
// ::_sgm_scan_kernel (launched by _scan_family from aggregate_pallas). It
// computes what that kernel computes, not how: the disparity padding with a
// 1e30 sentinel and the perpendicular axis padded to 128 lanes there were
// TPU layout needs. Here D is exact and d-1, d+1 are clamped at its ends.
//
// For each direction r (dy, dx), over a (B, H, W, D) float32 volume C with
// D innermost:
//     m       = min_d' L(p - r, d')
//     best(d) = min(L(p - r, d), min(L(p - r, d - 1), L(p - r, d + 1)) + P1,
//                   m + P2)
//     L(p, d) = (C(p, d) + best(d)) - m
// with L(p - r, .) = 0 before the first pixel of each scan line, so
// L = C there. That is the zero restart of sgm._roll_cols at the image
// border of a diagonal path. Only min and add: no multiply that nvcc could
// contract into an FMA, so the result is bit-equal to the plain twin
// simplestereo_tpu_torch/passive/sgm_cuda.py::_aggregate, which does the
// same operations in the same order.
//
// sgm_path_kernel: one warp per scan line. A horizontal direction has H
// lines, a vertical one W, a diagonal one W + H - 1 (starting on the first
// row, then down the first column). The lanes walk d in strides of 32, so
// any D works. L(p - r, .) and L(p, .) live in two shared-memory rows per
// warp (ping-pong), from which each lane reads its d - 1, d, d + 1; m is a
// shuffle reduction of the previous step's L. The frame is blockIdx.y.
//
// sgm_aggregate launches one kernel per direction, in the summation order of
// sgm._aggregate: horizontal forward, horizontal backward, then for the
// column rolls 0, +1, -1 the downward scan and the upward one (roll 0 only
// with 4 paths). The first launch writes S = L and each later one adds its
// L into S. Within one launch no two lines touch the same pixel, so S needs
// no atomics and its summation order is fixed: a frame stack gives the
// per-frame results bit for bit.
//
// What bounds it on this card: each direction reads C once and reads and
// writes S once. At 1280x720 and D = 128 that is about 1.4 GB per direction
// and 11 GB for 8, so at least 3.4 ms at 3.35 TB/s. But a line is W or H
// dependent steps, each of which waits on a global load of C and S. The
// 720 to 2,000 lines of a launch fill only a fraction of the card's 8,448
// warp slots. So latency, not bandwidth, sets its time. Prefetching the
// next steps' C and S, and running independent directions side by side
// into separate sums, are the levers. They are left for a later version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;  // scan lines (warps) per block

// (dy, dx) of each direction, in the summation order of sgm._aggregate.
constexpr int kDirs[8][2] = {{0, 1},  {0, -1}, {1, 0},  {-1, 0},
                             {1, 1},  {-1, 1}, {1, -1}, {-1, -1}};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32) sgm_path_kernel(
    const float* __restrict__ C, float* __restrict__ S, int H, int W, int D,
    int dy, int dx, int nlines, float P1, float P2, int first) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * kWarps + warp;
  if (line >= nlines) return;  // the whole warp leaves together

  const long long frame = (long long)blockIdx.y * H * W * D;
  const float* Cf = C + frame;
  float* Sf = S + frame;
  float* cur = smem + 2 * warp * D;  // L(p - r, .)
  float* nxt = cur + D;              // L(p, .)

  // First pixel of the line.
  const int row0 = dy > 0 ? 0 : H - 1;
  const int col0 = dx > 0 ? 0 : W - 1;
  int y, x;
  if (dy == 0) {
    y = line;
    x = col0;
  } else if (line < W) {
    y = row0;
    x = line;
  } else {  // diagonal lines that start on the first column, below row0
    const int k = line - W + 1;
    y = dy > 0 ? k : H - 1 - k;
    x = col0;
  }

  for (int d = lane; d < D; d += 32) cur[d] = 0.0f;
  float m = 0.0f;
  __syncwarp();

  for (; y >= 0 && y < H && x >= 0 && x < W; y += dy, x += dx) {
    const long long p = ((long long)y * W + x) * D;
    float lmin = INFINITY;
    for (int d = lane; d < D; d += 32) {
      const float lp = cur[d];
      const float up = cur[min(d + 1, D - 1)];
      const float dn = cur[max(d - 1, 0)];
      const float best = fminf(fminf(lp, fminf(up, dn) + P1), m + P2);
      const float l = (Cf[p + d] + best) - m;
      nxt[d] = l;
      Sf[p + d] = first ? l : Sf[p + d] + l;
      lmin = fminf(lmin, l);
    }
    m = warp_min(lmin);
    float* t = cur;
    cur = nxt;
    nxt = t;
    __syncwarp();  // this step's L is read by other lanes in the next one
  }
}

}  // namespace

extern "C" int sgm_aggregate(const void* C, void* S, int B, int H, int W,
                             int D, float P1, float P2, int paths, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kWarps * 2 * D * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sgm_path_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int ndirs = paths >= 8 ? 8 : 4;
  for (int i = 0; i < ndirs; ++i) {
    const int dy = kDirs[i][0];
    const int dx = kDirs[i][1];
    const int nlines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
    const dim3 grid((nlines + kWarps - 1) / kWarps, B);
    sgm_path_kernel<<<grid, kWarps * 32, smem, s>>>(
        static_cast<const float*>(C), static_cast<float*>(S), H, W, D, dy,
        dx, nlines, P1, P2, i == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* sgm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

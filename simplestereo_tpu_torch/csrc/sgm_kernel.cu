// SGM path aggregation kernels for Hopper (sm_90a).
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
// A horizontal direction has H scan lines, a vertical one W, a diagonal one
// W + H - 1 (starting on the first row, then down the first column). The
// directions are numbered in the summation order of sgm._aggregate:
// horizontal forward, horizontal backward, then for the column rolls 0, +1,
// -1 the downward scan and the upward one (roll 0 only with 4 paths).
//
// What bounds it on this card: a line is W or H dependent steps, and each
// direction reads C once and reads and writes S once (1.4 GB a direction at
// 1280x720, D = 128). The first version (one warp a line, ping-pong rows in
// shared memory, no fetch ahead) waited on a global load every step and ran
// at 23x its bound. This version:
//
// sgm_lines_kernel<NPL, kVec>: a group of G lanes walks one line (G a power
// of two, G * NPL >= D; 32 / G lines a warp, so no lane idles at D = 16).
// Lane g holds disparities [g * NPL, g * NPL + NPL) of L(p - r, .) in
// registers; d - 1 and d + 1 across lanes come from one shuffle up and one
// down, m from a shuffle reduction over the group. C (and S) of the next P
// steps are loaded into a register ring before they are needed, so a step
// waits only on its shuffles: P loads a lane are in flight at once. With
// D % 4 == 0 and NPL >= 4 the loads and stores are 16 bytes wide.
//   - sequential (mode 0): one launch a direction, in summation order; the
//     first writes S = L, each later one adds its L into S.
//   - concurrent (mode 1): one launch runs every direction side by side
//     (grid z = direction), each into its own L buffer of a workspace, then
//     sgm_sum_kernel adds the buffers in summation order. That removes the
//     chain of 4 or 8 launches where the lines are few (small frames); the
//     caller's plan picks it where its workspace fits a stated cap.
// Within one launch no two lines of a direction touch the same pixel, so
// no atomics are needed and the summation order is fixed: a frame stack
// gives the per-frame results bit for bit.
//
// sgm_path_kernel: the first version, for D > 256 (more than 8 registers a
// lane): one warp a line, lanes over d in strides of 32, ping-pong rows in
// shared memory.
//
// Frames ride grid y; the caller (sgm_cuda.aggregate) splits a larger stack
// into launches of at most 65,535 frames.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps a block
constexpr unsigned kFull = 0xffffffffu;

// (dy, dx) of direction i, in the summation order of sgm._aggregate:
// (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, 1), (1, -1), (-1, -1).
__host__ __device__ __forceinline__ void direction(int i, int& dy, int& dx) {
  if (i < 2) {
    dy = 0;
    dx = i == 0 ? 1 : -1;
  } else {
    dy = (i & 1) ? -1 : 1;
    dx = i < 4 ? 0 : (i < 6 ? 1 : -1);
  }
}

__host__ __device__ __forceinline__ int num_lines(int dy, int dx, int H,
                                                  int W) {
  return dy == 0 ? H : (dx == 0 ? W : W + H - 1);
}

// First pixel (y, x) of scan line `line` of direction (dy, dx); returns the
// line's length in pixels.
__device__ __forceinline__ int line_start(int line, int dy, int dx, int H,
                                          int W, int& y, int& x) {
  const int row0 = dy > 0 ? 0 : H - 1;
  const int col0 = dx > 0 ? 0 : W - 1;
  if (dy == 0) {
    y = line;
    x = col0;
    return W;
  }
  if (dx == 0) {
    y = row0;
    x = line;
    return H;
  }
  if (line < W) {
    y = row0;
    x = line;
    return min(H, dx > 0 ? W - line : line + 1);
  }
  const int k = line - W + 1;  // lines that start on the first column
  y = dy > 0 ? k : H - 1 - k;
  x = col0;
  return min(H - k, W);
}

// Loads the NPL values of one step into dst (0 where t leaves the line or
// d leaves [0, D)). kNc: read through the non-coherent cache (C only; S is
// written by the same launch).
template <int NPL, bool kVec, bool kNc>
__device__ __forceinline__ void load_step(float (&dst)[NPL], const float* q,
                                          bool on, int d0, int D) {
  if (!on) {
#pragma unroll
    for (int k = 0; k < NPL; ++k) dst[k] = 0.0f;
    return;
  }
  if constexpr (kVec) {
#pragma unroll
    for (int v = 0; v < NPL / 4; ++v) {
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (d0 + 4 * v < D) {
        const float4* a = reinterpret_cast<const float4*>(q) + v;
        f = kNc ? __ldg(a) : *a;
      }
      dst[4 * v] = f.x;
      dst[4 * v + 1] = f.y;
      dst[4 * v + 2] = f.z;
      dst[4 * v + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      dst[k] = d0 + k < D ? (kNc ? __ldg(q + k) : q[k]) : 0.0f;
  }
}

// grid (line blocks, frames, directions run side by side); block kWarps
// warps. Direction dir0 + blockIdx.z writes out + blockIdx.z * dir_stride:
// L itself (acc == 0) or S + L into S (acc != 0).
template <int NPL, bool kVec>
__global__ void __launch_bounds__(kWarps * 32) sgm_lines_kernel(
    const float* __restrict__ C, float* __restrict__ out, int H, int W, int D,
    int G, int dir0, long long dir_stride, float P1, float P2, int acc) {
  constexpr int P = NPL <= 4 ? 8 : 4;  // steps of C and S fetched ahead
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);  // lane within its line's group
  const int per_warp = 32 / G;   // lines a warp
  int dy, dx;
  direction(dir0 + blockIdx.z, dy, dx);
  const int nlines = num_lines(dy, dx, H, W);
  const int first = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * per_warp;
  if (first >= nlines) return;  // the whole warp leaves together
  const int line = first + lane / G;
  int y = 0, x = 0, n = 0;
  if (line < nlines) n = line_start(line, dy, dx, H, W, y, x);
  const int nmax = __reduce_max_sync(kFull, n);  // steps the warp walks

  const long long frame = (long long)blockIdx.y * H * W * D;
  const float* Cf = C + frame;
  float* Of = out + frame + blockIdx.z * dir_stride;
  const int d0 = g * NPL;
  const bool lane_on = d0 < D;
  const long long stride = ((long long)dy * W + dx) * D;  // one step
  const long long p0 = ((long long)y * W + x) * D + d0;

  float cb[P][NPL], sb[P][NPL];  // the ring: steps t .. t + P - 1
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const bool on = lane_on && j < n;
    load_step<NPL, kVec, true>(cb[j], Cf + p0 + j * stride, on, d0, D);
    load_step<NPL, kVec, false>(sb[j], Of + p0 + j * stride, on && acc, d0, D);
  }

  float lp[NPL];  // L(p - r, .) of this lane's disparities
#pragma unroll
  for (int k = 0; k < NPL; ++k) lp[k] = 0.0f;
  float m = 0.0f;

  for (int t0 = 0; t0 < nmax; t0 += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int t = t0 + j;
      if (t >= nmax) continue;  // warp-uniform: the line's last block
      float c[NPL], s[NPL];
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        c[k] = cb[j][k];
        s[k] = sb[j][k];
      }
      {  // refill the slot with step t + P
        const bool on = lane_on && t + P < n;
        const long long q = p0 + (long long)(t + P) * stride;
        load_step<NPL, kVec, true>(cb[j], Cf + q, on, d0, D);
        load_step<NPL, kVec, false>(sb[j], Of + q, on && acc, d0, D);
      }

      // L(p - r, d0 - 1) from the lane below, L(p - r, d0 + NPL) from the
      // lane above (within the group).
      const float below = __shfl_up_sync(kFull, lp[NPL - 1], 1, G);
      const float above = __shfl_down_sync(kFull, lp[0], 1, G);
      float l[NPL];
      float lmin = INFINITY;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const int d = d0 + k;
        const float dn = k > 0 ? lp[k - 1] : (d > 0 ? below : lp[0]);
        const float up = d + 1 < D ? (k + 1 < NPL ? lp[k + 1] : above) : lp[k];
        const float best = fminf(fminf(lp[k], fminf(up, dn) + P1), m + P2);
        l[k] = (c[k] + best) - m;
        if (d < D) lmin = fminf(lmin, l[k]);
      }
      for (int o = G >> 1; o > 0; o >>= 1)
        lmin = fminf(lmin, __shfl_xor_sync(kFull, lmin, o, G));

      if (lane_on && t < n) {
        float* q = Of + p0 + (long long)t * stride;
        float v[NPL];
#pragma unroll
        for (int k = 0; k < NPL; ++k) v[k] = acc ? s[k] + l[k] : l[k];
        if constexpr (kVec) {
#pragma unroll
          for (int u = 0; u < NPL / 4; ++u)
            if (d0 + 4 * u < D)
              reinterpret_cast<float4*>(q)[u] =
                  make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < NPL; ++k)
            if (d0 + k < D) q[k] = v[k];
        }
      }
#pragma unroll
      for (int k = 0; k < NPL; ++k) lp[k] = l[k];
      m = lmin;
    }
  }
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// S = L_0 + L_1 + ... + L_{ndirs-1}, left to right (the summation order of
// sgm._aggregate), over n elements of T (float, or float4 where the volume
// is a multiple of 4 floats); buffer k at L + k * stride.
template <typename T>
__global__ void __launch_bounds__(256) sgm_sum_kernel(
    const T* __restrict__ L, T* __restrict__ S, long long n, long long stride,
    int ndirs) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    T s = add(__ldcs(L + i), __ldcs(L + stride + i));
    for (int k = 2; k < ndirs; ++k) s = add(s, __ldcs(L + k * stride + i));
    S[i] = s;
  }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The first version, for any D: one warp a line, L(p - r, .) and L(p, .)
// in two shared-memory rows a warp (ping-pong). Frame blockIdx.y.
__global__ void __launch_bounds__(kWarps * 32) sgm_path_kernel(
    const float* __restrict__ C, float* __restrict__ S, int H, int W, int D,
    int dir, float P1, float P2, int first) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int dy, dx;
  direction(dir, dy, dx);
  const int line = blockIdx.x * kWarps + warp;
  if (line >= num_lines(dy, dx, H, W)) return;  // the whole warp leaves

  const long long frame = (long long)blockIdx.y * H * W * D;
  const float* Cf = C + frame;
  float* Sf = S + frame;
  float* cur = smem + 2 * warp * D;  // L(p - r, .)
  float* nxt = cur + D;              // L(p, .)
  int y, x;
  const int n = line_start(line, dy, dx, H, W, y, x);

  for (int d = lane; d < D; d += 32) cur[d] = 0.0f;
  float m = 0.0f;
  __syncwarp();

  for (int t = 0; t < n; ++t, y += dy, x += dx) {
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
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    __syncwarp();  // this step's L is read by other lanes in the next one
  }
}

template <int NPL, bool kVec>
cudaError_t launch_lines(dim3 grid, cudaStream_t s, const float* C,
                         float* out, int H, int W, int D, int G, int dir0,
                         long long dir_stride, float P1, float P2, int acc) {
  sgm_lines_kernel<NPL, kVec><<<grid, kWarps * 32, 0, s>>>(
      C, out, H, W, D, G, dir0, dir_stride, P1, P2, acc);
  return cudaGetLastError();
}

using LinesFn = cudaError_t (*)(dim3, cudaStream_t, const float*, float*, int,
                                int, int, int, int, long long, float, float,
                                int);

LinesFn lines_fn(int npl, int vec) {
  switch (npl) {
    case 1: return &launch_lines<1, false>;
    case 2: return &launch_lines<2, false>;
    case 4: return vec ? &launch_lines<4, true> : &launch_lines<4, false>;
    case 8: return vec ? &launch_lines<8, true> : &launch_lines<8, false>;
    default: return nullptr;
  }
}

}  // namespace

// C, S: (B, H, W, D) float32. The plan comes from the caller
// (sgm_cuda._plan): mode 0 runs sgm_lines_kernel<npl, vec> one direction a
// launch, mode 1 every direction in one launch into `work` (ndirs buffers
// of B x H x W x D floats, each rounded up to a multiple of 4) and then the
// sum, mode 2 the first version. `group` lanes
// walk a line (a power of two, group * npl >= D). B <= 65,535.
extern "C" int sgm_aggregate(const void* C, void* S, void* work, int B, int H,
                             int W, int D, float P1, float P2, int paths,
                             int mode, int npl, int group, int vec,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(C);
  float* out = static_cast<float*>(S);
  const int ndirs = paths >= 8 ? 8 : 4;

  if (mode == 2) {
    const size_t smem = (size_t)kWarps * 2 * D * sizeof(float);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(sgm_path_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    for (int i = 0; i < ndirs; ++i) {
      int dy, dx;
      direction(i, dy, dx);
      const dim3 grid((num_lines(dy, dx, H, W) + kWarps - 1) / kWarps, B);
      sgm_path_kernel<<<grid, kWarps * 32, smem, s>>>(c, out, H, W, D, i, P1,
                                                      P2, i == 0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }

  if (group < 1 || group > 32 || (group & (group - 1)) != 0 ||
      group * npl < D)
    return (int)cudaErrorInvalidValue;
  if (vec && (D % 4 != 0 || npl < 4 ||
              (((uintptr_t)C | (uintptr_t)S | (uintptr_t)work) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const LinesFn launch = lines_fn(npl, vec);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  const int per_block = kWarps * 32 / group;  // lines a block
  if (mode == 0) {
    for (int i = 0; i < ndirs; ++i) {
      int dy, dx;
      direction(i, dy, dx);
      const dim3 grid((num_lines(dy, dx, H, W) + per_block - 1) / per_block,
                      B, 1);
      err = launch(grid, s, c, out, H, W, D, group, i, 0, P1, P2, i > 0);
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  if (mode != 1 || work == nullptr) return (int)cudaErrorInvalidValue;
  // One L buffer a direction, each padded to a multiple of 4 floats.
  float* L = static_cast<float*>(work);
  const long long vol = (long long)B * H * W * D;
  const long long stride = (vol + 3) / 4 * 4;
  const int most = ndirs == 8 ? W + H - 1 : (H > W ? H : W);
  const dim3 grid((most + per_block - 1) / per_block, B, ndirs);
  err = launch(grid, s, c, L, H, W, D, group, 0, stride, P1, P2, 0);
  if (err != cudaSuccess) return (int)err;
  const bool v4 =
      vol % 4 == 0 && (((uintptr_t)S | (uintptr_t)work) & 15) == 0;
  const long long n = v4 ? vol / 4 : vol;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (v4)
    sgm_sum_kernel<float4><<<(unsigned)blocks, 256, 0, s>>>(
        reinterpret_cast<const float4*>(L), reinterpret_cast<float4*>(out),
        n, stride / 4, ndirs);
  else
    sgm_sum_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(L, out, n, stride,
                                                           ndirs);
  return (int)cudaGetLastError();
}

extern "C" const char* sgm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// A subset of directions with a carry-in (sgm_scan): the row-tiled matcher
// (simplestereo_tpu_torch/parallel/sgm.py) runs a tile's horizontal pair,
// then its k downward and its k upward directions as stages of a wavefront
// across tiles, each direction's L into its own buffer, and sums the
// buffers in the summation order above (sgm_sum). A vertical or diagonal
// line that starts on the tile's first row (last row, scanning up) then
// takes L(p - r, .) = carry[x - dx, .] of the tile before it, zero where
// x - dx leaves [0, W), and m = min_d of that row: the JAX wavefront's
// _roll_cols(carry, roll) (simplestereo_tpu/parallel/sgm.py). A line that
// starts on the first column has no predecessor in any tile and starts
// from zero as before. The carry-out is the last (first) row of the
// direction's L buffer; the caller cuts it out.
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
// warps. Direction dir0 + blockIdx.z * dir_step writes out + blockIdx.z *
// dir_stride: L itself (acc == 0) or S + L into S (acc != 0). carry: null,
// or (frames, gridDim.z, W, D), the row before the first row of each
// direction of the launch (see sgm_scan).
template <int NPL, bool kVec>
__global__ void __launch_bounds__(kWarps * 32) sgm_lines_kernel(
    const float* __restrict__ C, float* __restrict__ out,
    const float* __restrict__ carry, int H, int W, int D, int G, int dir0,
    int dir_step, long long dir_stride, float P1, float P2, int acc) {
  constexpr int P = NPL <= 4 ? 8 : 4;  // steps of C and S fetched ahead
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);  // lane within its line's group
  const int per_warp = 32 / G;   // lines a warp
  int dy, dx;
  direction(dir0 + blockIdx.z * dir_step, dy, dx);
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

  // L(p - r, .) of this lane's disparities before the first step: zero,
  // or the carried row at column x - dx for a line that starts on the
  // tile's first row; m is its minimum over the group.
  float lp[NPL];
  const int xc = x - dx;
  const bool carried = carry != nullptr && dy != 0 && n > 0 &&
                       y == (dy > 0 ? 0 : H - 1) && xc >= 0 && xc < W;
  float m = INFINITY;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    lp[k] = 0.0f;
    if (carried && d0 + k < D)
      lp[k] = __ldg(carry + (((long long)blockIdx.y * gridDim.z + blockIdx.z) *
                                 W + xc) * D + d0 + k);
    if (d0 + k < D) m = fminf(m, lp[k]);
  }
  for (int o = G >> 1; o > 0; o >>= 1)
    m = fminf(m, __shfl_xor_sync(kFull, m, o, G));

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
// in two shared-memory rows a warp (ping-pong). Frame blockIdx.y. carry:
// null, or (frames, ncarry, W, D) with this direction's rows at index cz.
__global__ void __launch_bounds__(kWarps * 32) sgm_path_kernel(
    const float* __restrict__ C, float* __restrict__ S,
    const float* __restrict__ carry, int H, int W, int D, int dir, float P1,
    float P2, int first, int cz, int ncarry) {
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

  const int xc = x - dx;
  const bool carried = carry != nullptr && dy != 0 &&
                       y == (dy > 0 ? 0 : H - 1) && xc >= 0 && xc < W;
  const float* cr =
      carried ? carry + (((long long)blockIdx.y * ncarry + cz) * W + xc) * D
              : nullptr;
  float lmin = INFINITY;
  for (int d = lane; d < D; d += 32) {
    cur[d] = carried ? cr[d] : 0.0f;
    lmin = fminf(lmin, cur[d]);
  }
  float m = warp_min(lmin);
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
                         float* out, const float* carry, int H, int W, int D,
                         int G, int dir0, int dir_step, long long dir_stride,
                         float P1, float P2, int acc) {
  sgm_lines_kernel<NPL, kVec><<<grid, kWarps * 32, 0, s>>>(
      C, out, carry, H, W, D, G, dir0, dir_step, dir_stride, P1, P2, acc);
  return cudaGetLastError();
}

using LinesFn = cudaError_t (*)(dim3, cudaStream_t, const float*, float*,
                                const float*, int, int, int, int, int, int,
                                long long, float, float, int);

LinesFn lines_fn(int npl, int vec) {
  switch (npl) {
    case 1: return &launch_lines<1, false>;
    case 2: return &launch_lines<2, false>;
    case 4: return vec ? &launch_lines<4, true> : &launch_lines<4, false>;
    case 8: return vec ? &launch_lines<8, true> : &launch_lines<8, false>;
    default: return nullptr;
  }
}

// Dynamic shared memory of sgm_path_kernel (two rows of D a warp), and the
// opt-in above 48 KB.
cudaError_t path_smem(int D, size_t& smem) {
  smem = (size_t)kWarps * 2 * D * sizeof(float);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(sgm_path_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// S = L_0 + ... + L_{nbuf-1} over vol floats a buffer, buffer k at
// L + k * stride (float4 loads where vol, stride and both pointers allow).
cudaError_t launch_sum(cudaStream_t s, const float* L, float* S,
                       long long vol, long long stride, int nbuf) {
  const bool v4 = vol % 4 == 0 && stride % 4 == 0 &&
                  (((uintptr_t)S | (uintptr_t)L) & 15) == 0;
  const long long n = v4 ? vol / 4 : vol;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (v4)
    sgm_sum_kernel<float4><<<(unsigned)blocks, 256, 0, s>>>(
        reinterpret_cast<const float4*>(L), reinterpret_cast<float4*>(S), n,
        stride / 4, nbuf);
  else
    sgm_sum_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(L, S, n, stride,
                                                           nbuf);
  return cudaGetLastError();
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
    size_t smem;
    err = path_smem(D, smem);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < ndirs; ++i) {
      int dy, dx;
      direction(i, dy, dx);
      const dim3 grid((num_lines(dy, dx, H, W) + kWarps - 1) / kWarps, B);
      sgm_path_kernel<<<grid, kWarps * 32, smem, s>>>(
          c, out, nullptr, H, W, D, i, P1, P2, i == 0, 0, 1);
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
      err = launch(grid, s, c, out, nullptr, H, W, D, group, i, 1, 0, P1,
                   P2, i > 0);
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
  err = launch(grid, s, c, L, nullptr, H, W, D, group, 0, 1, stride, P1, P2,
               0);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum(s, L, out, vol, stride, ndirs);
}

// A subset of the directions, each into its own buffer, with an optional
// carry-in (see the note at sgm_path_kernel). Directions dir0 + j *
// dir_step for j < ndir; direction j writes its L to L + j * slot_stride
// ((B, H, W, D) floats) and reads its carry rows at carry + j * W * D of
// each frame ((B, ndir, W, D) floats, or null for a zero start). npl 0
// runs the first version (one launch a direction), else the line kernel
// with `group` lanes a line (one launch). B <= 65,535.
extern "C" int sgm_scan(const void* C, void* L, const void* carry, int B,
                        int H, int W, int D, float P1, float P2, int dir0,
                        int ndir, int dir_step, long long slot_stride,
                        int npl, int group, int vec, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(C);
  float* out = static_cast<float*>(L);
  const float* cy = static_cast<const float*>(carry);
  if (ndir < 1 || dir_step < 1 || dir0 < 0 || dir0 + (ndir - 1) * dir_step > 7)
    return (int)cudaErrorInvalidValue;
  int most = 0;  // lines of the direction with the most
  for (int j = 0; j < ndir; ++j) {
    int dy, dx;
    direction(dir0 + j * dir_step, dy, dx);
    const int lines = num_lines(dy, dx, H, W);
    if (lines > most) most = lines;
  }
  if (npl == 0) {
    size_t smem;
    err = path_smem(D, smem);
    if (err != cudaSuccess) return (int)err;
    for (int j = 0; j < ndir; ++j) {
      int dy, dx;
      direction(dir0 + j * dir_step, dy, dx);
      const dim3 grid((num_lines(dy, dx, H, W) + kWarps - 1) / kWarps, B);
      sgm_path_kernel<<<grid, kWarps * 32, smem, s>>>(
          c, out + j * slot_stride, cy, H, W, D, dir0 + j * dir_step, P1, P2,
          1, j, ndir);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 ||
      group * npl < D)
    return (int)cudaErrorInvalidValue;
  if (vec && (D % 4 != 0 || npl < 4 || slot_stride % 4 != 0 ||
              (((uintptr_t)C | (uintptr_t)L) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const LinesFn launch = lines_fn(npl, vec);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  const int per_block = kWarps * 32 / group;
  const dim3 grid((most + per_block - 1) / per_block, B, ndir);
  return (int)launch(grid, s, c, out, cy, H, W, D, group, dir0, dir_step,
                     slot_stride, P1, P2, 0);
}

// S = L_0 + L_1 + ... + L_{nbuf-1}, left to right (each buffer vol floats,
// buffer k at L + k * stride): the sum of sgm_scan's buffers in the
// summation order of sgm._aggregate.
extern "C" int sgm_sum(const void* L, void* S, long long vol,
                       long long stride, int nbuf, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nbuf < 2) return (int)cudaErrorInvalidValue;
  return (int)launch_sum(static_cast<cudaStream_t>(stream),
                         static_cast<const float*>(L), static_cast<float*>(S),
                         vol, stride, nbuf);
}

// ---------------------------------------------------------------------------
// The census cost volume that the kernels above read (sgm_census_cost).
//
// Replaces no TPU kernel: the JAX package leaves the census cost to XLA,
// which fuses it. The port's torch code for it (sgm.py: _census_words,
// _census_cost, _edge_fill_rows, _box_sum) is its twin, and ran as ~500
// launches over int64 volumes. For (B, H, W) float32 gray images L and R
// it computes
//     C(y, x, d) = sum over the k x k box of
//                  popcount(code_L(cy, cx) ^ code_R(cy, clamp(cx - dv)))
// with cx the box's columns clamped to the image and cy its rows clamped
// to [row_lo, row_hi] (the image's rows, or the valid rows of a row-tiled
// block: _box_sum's edge pad over _edge_fill_rows), dv = min_disp + d
// (_shift_edge's edge fill), and bit j of a pixel's code set iff its j-th
// window neighbour (row-major, centre skipped, clamped to the image) is
// greater than the pixel. Every sum is a whole number of at most
// 48 * k * k < 2^24 for the blocks the kernel takes (k <= 591), so the
// float32 C equals the twin's bit for bit in any order of summation.
//
// What bounds it: writing C once (354 MB a 1280x720 frame at D = 96, 0.106
// ms at 3.35 TB/s); the codes are 8 bytes a pixel and read from L2. Then
// the instructions a cell of C takes, which the design keeps few:
//   - census_words_kernel: one thread a pixel, the tile and its window
//     halo staged in shared memory, the window's comparisons unrolled;
//     both images and all frames in one launch; codes (B, 2, H, W) uint64.
//   - census_cost_kernel: a block a tile of kCensusTY x kCensusTX pixels
//     of one frame and a chunk of dc candidates (4 <= dc <= 32). It stages
//     the left codes of the tile and its box halo, and the right codes of
//     the same rows over the columns the chunk's shifts reach, rc of the
//     box's rows at a time (all of them unless the block is large);
//     computes each Hamming distance once into shared memory (uint8, a
//     lane a candidate); then a thread takes four candidates: it sums the
//     box's rows as 16-bit lanes of 32-bit words (two candidates a word:
//     48 * k < 2^16), then its columns, in the same lanes while
//     48 * k * k < 2^16 (k <= 35) and a candidate a word above, and
//     converts to float only at the store, 16 bytes at
//     once where D % 4 == 0. The entry picks dc and rc so that the shared
//     memory fits the card (census_smem).

namespace {

constexpr int kCensusTX = 32;        // tile columns
constexpr int kCensusTY = 8;         // tile rows
constexpr int kCensusThreads = 256;  // threads a block, both kernels
constexpr int kCensusNarrowMax = 35;  // largest block: box sums in 16 bits
constexpr int kCensusBlockMax = 591;  // largest block: box sums below 2^24

__device__ __forceinline__ int clamp_to(int v, int n) {
  return min(max(v, 0), n - 1);
}

// Calls f(r, c) for the cells of an nr x nc row-major grid that thread
// `slot` of `slots` owns (cells slot, slot + slots, ...), without a
// division a step.
template <typename F>
__device__ __forceinline__ void for_cells(int nr, int nc, int slot,
                                          int slots, F&& f) {
  const int dr = slots / nc, dcol = slots - dr * nc;
  int r = slot / nc, c = slot - r * nc;
  while (r < nr) {
    f(r, c);
    c += dcol;
    r += dr;
    if (c >= nc) {
      c -= nc;
      ++r;
    }
  }
}

// grid (tiles of kCensusTY x kCensusTX pixels, frames, 2 images). The
// tile and its window halo (clamped to the image) are staged in shared
// memory; kWin is the census window (3, 5 or 7).
template <int kWin>
__global__ void __launch_bounds__(kCensusThreads) census_words_kernel(
    const float* __restrict__ g1, const float* __restrict__ g2,
    unsigned long long* __restrict__ codes, int H, int W) {
  constexpr int p = kWin / 2;
  constexpr int sh = kCensusTY + 2 * p, sw = kCensusTX + 2 * p;
  __shared__ float tile[sh][sw];
  const int tiles_x = (W + kCensusTX - 1) / kCensusTX;
  const int x0 = (blockIdx.x % tiles_x) * kCensusTX;
  const int y0 = (blockIdx.x / tiles_x) * kCensusTY;
  const long long hw = (long long)H * W;
  const float* g = (blockIdx.z ? g2 : g1) + blockIdx.y * hw;
  for (int e = threadIdx.x; e < sh * sw; e += kCensusThreads) {
    const int r = e / sw, c = e - r * sw;
    tile[r][c] = g[(long long)clamp_to(y0 - p + r, H) * W +
                   clamp_to(x0 - p + c, W)];
  }
  __syncthreads();
  const int tx = threadIdx.x % kCensusTX, ty = threadIdx.x / kCensusTX;
  if (x0 + tx >= W || y0 + ty >= H) return;
  const float c = tile[ty + p][tx + p];
  unsigned long long code = 0;
  int k = 0;
#pragma unroll
  for (int di = 0; di < kWin; ++di) {
#pragma unroll
    for (int dj = 0; dj < kWin; ++dj) {
      if (di == p && dj == p) continue;
      code |= (unsigned long long)(tile[ty + di][tx + dj] > c) << k;
      ++k;
    }
  }
  codes[(blockIdx.y * 2 + blockIdx.z) * hw + (long long)(y0 + ty) * W + x0 +
        tx] = code;
}

// Bytes of census_cost_kernel's dynamic shared memory with rc of the box's
// rows staged at a time and dc candidates a block: left codes (rc x ni),
// right codes (rc x (ni + dc - 1)), Hamming distances (rc x ni x dc
// uint8, padded to 16 bytes) and the box's row sums (kCensusTY x ni x dc
// uint16).
size_t census_smem(int block, int dc, int rc) {
  const size_t p = block / 2, ni = kCensusTX + 2 * p;
  return rc * ni * 8 + rc * (ni + dc - 1) * 8 + (rc * ni * dc + 15) / 16 * 16 +
         (size_t)kCensusTY * ni * dc * 2;
}

// grid (tiles of kCensusTY x kCensusTX pixels times chunks of dc
// candidates, frames); codes (frames, 2, H, W), C (frames, H, W, D).
// rows: null, or the first and last row the box reads (of every frame).
// kVec: D % 4 == 0, so a thread's four candidates are one aligned float4
// of C. kWide: block > kCensusNarrowMax, so the box's columns are summed a
// candidate a 32-bit word.
template <bool kVec, bool kWide>
__global__ void __launch_bounds__(kCensusThreads) census_cost_kernel(
    const unsigned long long* __restrict__ codes,
    const int* __restrict__ rows, float* __restrict__ C, int H, int W,
    int D, int min_disp, int block, int dc_log2, int rc) {
  extern __shared__ __align__(16) unsigned char census_buf[];
  const int p = block >> 1;
  const int dc = 1 << dc_log2;
  const int nr = kCensusTY + 2 * p;  // the box's rows: the tile's and halo
  const int ni = kCensusTX + 2 * p;  // staged left columns
  const int nj = ni + dc - 1;        // staged right columns (row stride)
  const int tiles_x = (W + kCensusTX - 1) / kCensusTX;
  const int tiles = tiles_x * ((H + kCensusTY - 1) / kCensusTY);
  const int tile = blockIdx.x % tiles;
  const int x0 = (tile % tiles_x) * kCensusTX;
  const int y0 = (tile / tiles_x) * kCensusTY;
  const int dc0 = blockIdx.x / tiles * dc;      // the chunk's first candidate
  const int dv_hi = min_disp + dc0 + dc - 1;    // its largest shift
  const int cx_lo = clamp_to(x0 - p, W);        // smallest clamped column
  const int base = cx_lo - dv_hi;               // column of right column 0
  const int row_lo = rows ? clamp_to(rows[0], H) : 0;
  const int row_hi = rows ? clamp_to(rows[1], H) : H - 1;

  unsigned long long* Ls = reinterpret_cast<unsigned long long*>(census_buf);
  unsigned long long* Rs = Ls + rc * ni;
  unsigned char* hs = reinterpret_cast<unsigned char*>(Rs + rc * nj);
  uint2* vs = reinterpret_cast<uint2*>(hs + (rc * ni * dc + 15) / 16 * 16);

  const long long hw = (long long)H * W;
  const unsigned long long* Lg = codes + blockIdx.y * 2 * hw;
  const unsigned long long* Rg = Lg + hw;
  // A thread four candidates 4g .. 4g + 3: byte q of word g of a cell's
  // distances is candidate 4g + q. Row sums are kept two candidates a
  // word, 16 bits each: .x holds 4g and 4g + 2, .y 4g + 1 and 4g + 3.
  const int groups = dc >> 2;
  const int g = threadIdx.x & (groups - 1);
  const int slot = threadIdx.x >> (dc_log2 - 2);
  const int slots = blockDim.x >> (dc_log2 - 2);
  const unsigned* h4 = reinterpret_cast<const unsigned*>(hs);

  // The box's rows r0 .. r0 + n - 1 of the nr (row r is image row
  // y0 - p + r, clamped): staged, their Hamming distances, and their part
  // of v(y, i) = h(y, i) + ... + h(y + block - 1, i).
  const auto rows_part = [&](int r0, int n) {
    for_cells(n, ni, threadIdx.x, blockDim.x, [&](int r, int i) {
      const int y = min(max(y0 - p + r0 + r, row_lo), row_hi);
      Ls[r * ni + i] = Lg[(long long)y * W + clamp_to(x0 - p + i, W)];
    });
    for_cells(n, nj, threadIdx.x, blockDim.x, [&](int r, int j) {
      const int y = min(max(y0 - p + r0 + r, row_lo), row_hi);
      Rs[r * nj + j] = Rg[(long long)y * W + clamp_to(base + j, W)];
    });
    __syncthreads();
    {  // a lane a candidate d of the chunk
      const int d = threadIdx.x & (dc - 1);
      // Hamming distance of staged cell (r, i) at shift dv = dv_hi - (dc
      // - 1 - d): the right code at column clamp(cx - dv), cx = clamp(x0 -
      // p + i), is staged right column cx - cx_lo + dc - 1 - d.
      for_cells(n, ni, threadIdx.x >> dc_log2, blockDim.x >> dc_log2,
                [&](int r, int i) {
        const int j = clamp_to(x0 - p + i, W) - cx_lo + dc - 1 - d;
        hs[(r * ni + i) * dc + d] =
            (unsigned char)__popcll(Ls[r * ni + i] ^ Rs[r * nj + j]);
      });
    }
    __syncthreads();
    for_cells(kCensusTY, ni, slot, slots, [&](int y, int i) {
      uint2* v = vs + (y * ni + i) * groups + g;
      unsigned even = r0 ? v->x : 0, odd = r0 ? v->y : 0;
      const unsigned* h = h4 + i * groups + g;
      for (int t = max(y, r0) - r0, t1 = min(y + block, r0 + n) - r0;
           t < t1; ++t) {
        const unsigned w = h[t * ni * groups];
        even += w & 0x00ff00ffu;
        odd += (w >> 8) & 0x00ff00ffu;
      }
      *v = make_uint2(even, odd);
    });
  };
  if constexpr (kWide) {  // rc of the rows at a time
    for (int r0 = 0; r0 < nr; r0 += rc) rows_part(r0, min(rc, nr - r0));
  } else {  // all at once (the entry keeps rc = nr here)
    rows_part(0, nr);
  }
  __syncthreads();
  // The box's columns, then the store: C(y0 + y, x0 + x, dc0 + 4g + q).
  const int d4 = dc0 + 4 * g;
  if (d4 >= D) return;
  float* Cf = C + blockIdx.y * hw * D + d4;
  for_cells(kCensusTY, kCensusTX, slot, slots, [&](int y, int x) {
    if (y0 + y >= H || x0 + x >= W) return;
    const uint2* v = vs + (y * ni + x) * groups + g;
    float4 c;
    if constexpr (kWide) {
      unsigned s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      for (int t = 0; t < block; ++t) {
        const uint2 w = v[t * groups];
        s0 += w.x & 0xffffu;
        s1 += w.y & 0xffffu;
        s2 += w.x >> 16;
        s3 += w.y >> 16;
      }
      c = make_float4(s0, s1, s2, s3);
    } else {
      unsigned even = 0, odd = 0;
      for (int t = 0; t < block; ++t) {
        const uint2 w = v[t * groups];
        even += w.x;
        odd += w.y;
      }
      c = make_float4(even & 0xffffu, odd & 0xffffu, even >> 16, odd >> 16);
    }
    float* q = Cf + ((long long)(y0 + y) * W + x0 + x) * D;
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(q) = c;
    } else {
      q[0] = c.x;
      if (d4 + 1 < D) q[1] = c.y;
      if (d4 + 2 < D) q[2] = c.z;
      if (d4 + 3 < D) q[3] = c.w;
    }
  });
}

}  // namespace

// C (B, H, W, D) float32: the box-summed census cost of the (B, H, W)
// float32 gray stacks gray1 (reference) and gray2 (target), candidates
// min_disp .. min_disp + D - 1, the box's rows clamped to rows[0] ..
// rows[1] (int32 on the card; null: the image's); codes: scratch of B * 2
// * H * W uint64. win 3, 5 or 7; block odd, at most kCensusBlockMax;
// B <= 65,535; C 16-byte aligned where D % 4 == 0. Candidates a block:
// the power of two >= D, 4 to 32; where the shared memory would not fit
// the card, fewer of the box's rows are staged at a time (above
// kCensusNarrowMax), then fewer candidates.
extern "C" int sgm_census_cost(const void* gray1, const void* gray2,
                               const void* rows, void* codes, void* C, int B,
                               int H, int W, int min_disp, int D, int win,
                               int block, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D < 1 ||
      (win != 3 && win != 5 && win != 7) || block < 1 ||
      block > kCensusBlockMax || (block & 1) == 0 ||
      (D % 4 == 0 && ((uintptr_t)C & 15) != 0))
    return (int)cudaErrorInvalidValue;
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = D % 4 == 0, wide = block > kCensusNarrowMax;
  int dc_log2 = 2, rc = kCensusTY + block - 1;
  while (dc_log2 < 5 && (1 << dc_log2) < D) ++dc_log2;
  size_t smem;  // at most 177,264 bytes for a narrow block (35, dc 32)
  while ((smem = census_smem(block, 1 << dc_log2, rc)) > (size_t)smem_max) {
    if (wide && rc > 1)
      rc = (rc + 1) / 2;
    else if (dc_log2 > 2)
      --dc_log2;
    else
      return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (long long)((H + kCensusTY - 1) / kCensusTY) *
                          ((W + kCensusTX - 1) / kCensusTX);
  const long long chunks = (D + (1 << dc_log2) - 1) >> dc_log2;
  if (tiles * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const unsigned long long*, const int*, float*, int,
                          int, int, int, int, int, int);
  const Kernel kernel =
      vec ? (wide ? census_cost_kernel<true, true>
                  : census_cost_kernel<true, false>)
          : (wide ? census_cost_kernel<false, true>
                  : census_cost_kernel<false, false>);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* cw = static_cast<unsigned long long*>(codes);
  const auto words = win == 3   ? census_words_kernel<3>
                     : win == 5 ? census_words_kernel<5>
                                : census_words_kernel<7>;
  words<<<dim3((unsigned)tiles, B, 2), kCensusThreads, 0, s>>>(
      static_cast<const float*>(gray1), static_cast<const float*>(gray2), cw,
      H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)(tiles * chunks), B), kCensusThreads, smem, s>>>(
      cw, static_cast<const int*>(rows), static_cast<float*>(C), H, W, D,
      min_disp, block, dc_log2, rc);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The Birchfield-Tomasi cost volume that the kernels above read
// (sgm_bt_cost).
//
// Replaces no TPU kernel: the JAX package leaves BT's cost to XLA, which
// fuses it. The port's torch code for it (sgm.py: _xsobel, _interval,
// _bt_cost, _edge_fill_rows, _box_sum) is its twin, and ran as ~90
// launches over float volumes. For (B, H, W) float32 gray images L
// (reference) and R (target) it computes, in the twin's float32
// operations and order,
//     s      = clamp((((((a + 2b) + c) - d) - 2e) - f) / 4, -cap, cap)
//              the x-Sobel: a, b, c the column right of the pixel, top to
//              bottom, d, e, f the column left, rows and columns clamped
//              to the image (_xsobel)
//     lo, hi = min(min(s-, s+), s), max(max(s-, s+), s) with s- = 0.5 *
//              (s + s(x - 1)), s+ = 0.5 * (s + s(x + 1)), the neighbour
//              clamped to the image (_interval)
//     h(y, x, d) = min(max(max(sL - hiR, loR - sL), 0),
//                      max(max(sR - hiL, loL - sR), 0))
//              R's planes at column clamp(x - dv), dv = min_disp + d
//              (_bt_cost, _shift_edge's edge fill)
//     C(y, x, d) = the box of h: at each of the box's k columns (clamped
//              to the image) a left fold over its k rows, top row first
//              (clamped to [row_lo, row_hi]: the image's rows, or the valid
//              rows of a row-tiled block), then a left fold of those k sums,
//              leftmost first (_box_sum over _edge_fill_rows).
// BT's costs are not whole numbers, so the order of the sums is part of
// the result: there is no running or sliding-window sum and no tree. The
// only multiplies (x2, /4, x0.5) are by powers of two, so they are exact
// and an FMA that nvcc contracts from a + 2b or d - 2e gives the same
// bits. min and max are exact, and gray values >= 0 give no -0, so their
// rule for signed zeros does not matter either. C equals the twin's bit
// for bit.
//
// What bounds it: writing C once (354 MB a 1280x720 frame at D = 96,
// 0.106 ms at 3.35 TB/s); the planes are 24 bytes a pixel and read from
// L2. Then the shared memory and the instructions a cell of C takes, which
// the design keeps few:
//   - bt_prefilter_kernel: one thread a pixel, the tile's gray and its
//     halo, then its Sobel and a column each side, staged in shared
//     memory; both images and all frames in one launch; planes (B, 2, 3,
//     H, W): s, lo, hi.
//   - bt_cost_kernel<K>, one kernel a block size K: a block a strip of
//     kBtRows rows x TX columns of one frame and a chunk of dc = 4 *
//     groups candidates (4 to 32). It walks the strip's rows and their box
//     halo top to bottom. A row's planes are loaded one row ahead into
//     registers, then staged: ni = 256 / groups columns of L, ni + dc - 1
//     of R (the columns the chunk's shifts reach). Thread (i, g) computes
//     h of staged column i for candidates 4g .. 4g + 3, once, into a ring
//     of the box's K rows held in its registers (the row loop is unrolled
//     K times, so every ring index is static). From the K-th row on it
//     folds the ring, oldest row first, into shared memory; then thread
//     (x, g), x < TX = ni - K + 1, folds K of those sums across the
//     columns and stores its four candidates, 16 bytes at once where D %
//     4 == 0, the lanes of a warp on consecutive candidates. The entry
//     picks groups, the least power of two with 4 * groups >= D, up to 8.
// kBtBlockMax bounds K: the ring takes 4K registers a thread, and the
// strip's halo takes K - 1 of its 32 staged columns at 32 candidates.

namespace {

constexpr int kBtThreads = 256;  // threads a block, both kernels
constexpr int kBtPreTX = 32;     // prefilter tile columns
constexpr int kBtPreTY = 8;      // prefilter tile rows
constexpr int kBtRows = 48;      // output rows of a cost block's strip
constexpr int kBtBlockMax = 11;  // largest block
// Staged plane columns of a row, at most: ni + ni + dc - 1 at groups 1.
constexpr int kBtStaged = 2 * kBtThreads + 3;
constexpr int kBtStage = (kBtStaged + kBtThreads - 1) / kBtThreads;

// grid (tiles of kBtPreTY x kBtPreTX pixels, frames, 2 images); planes
// (frames, 2, 3, H, W).
__global__ void __launch_bounds__(kBtThreads) bt_prefilter_kernel(
    const float* __restrict__ g1, const float* __restrict__ g2,
    float* __restrict__ planes, int H, int W, float cap) {
  constexpr int gw = kBtPreTX + 4, sw = kBtPreTX + 2;
  // gray of rows y0 - 1 .. y0 + kBtPreTY and columns x0 - 2 .. x0 +
  // kBtPreTX + 1, each clamped to the image; the Sobel of the tile's rows
  // at columns clamp(x0 - 1 + c), c < sw
  __shared__ float gs[kBtPreTY + 2][gw];
  __shared__ float ss[kBtPreTY][sw];
  const int tiles_x = (W + kBtPreTX - 1) / kBtPreTX;
  const int x0 = (blockIdx.x % tiles_x) * kBtPreTX;
  const int y0 = (blockIdx.x / tiles_x) * kBtPreTY;
  const long long hw = (long long)H * W;
  const float* g = (blockIdx.z ? g2 : g1) + blockIdx.y * hw;
  for (int e = threadIdx.x; e < (kBtPreTY + 2) * gw; e += kBtThreads) {
    const int r = e / gw, c = e - r * gw;
    gs[r][c] = g[(long long)clamp_to(y0 - 1 + r, H) * W +
                 clamp_to(x0 - 2 + c, W)];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBtPreTY * sw; e += kBtThreads) {
    const int r = e / sw, c = e - r * sw;
    // gray column x - 1 (x + 1) of column x is staged column x - x0 + 1
    // (x - x0 + 3)
    const int x = clamp_to(x0 - 1 + c, W);
    const int cl = x - x0 + 1, cr = x - x0 + 3;
    float dx = gs[r][cr] + 2.0f * gs[r + 1][cr];
    dx = dx + gs[r + 2][cr];
    dx = dx - gs[r][cl];
    dx = dx - 2.0f * gs[r + 1][cl];
    dx = dx - gs[r + 2][cl];
    ss[r][c] = fminf(fmaxf(dx * 0.25f, -cap), cap);
  }
  __syncthreads();
  const int tx = threadIdx.x % kBtPreTX, ty = threadIdx.x / kBtPreTX;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  const float s = ss[ty][tx + 1];
  const float am = 0.5f * (s + ss[ty][tx]);
  const float ap = 0.5f * (s + ss[ty][tx + 2]);
  float* out = planes + (blockIdx.y * 2 + blockIdx.z) * 3 * hw +
               (long long)y * W + x;
  out[0] = s;
  out[hw] = fminf(fminf(am, ap), s);
  out[2 * hw] = fmaxf(fmaxf(am, ap), s);
}

// h of a reference pixel's planes l and the target's r (s, lo, hi).
__device__ __forceinline__ float bt_cell(float4 l, float4 r) {
  const float c_rt = fmaxf(l.x - r.z, r.y - l.x);
  const float c_tr = fmaxf(r.x - l.z, l.y - r.x);
  return fminf(fmaxf(c_rt, 0.0f), fmaxf(c_tr, 0.0f));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// grid (strips of kBtRows x TX pixels times chunks of 4 << groups_log2
// candidates, frames); planes (frames, 2, 3, H, W), C (frames, H, W, D).
// rows: null, or the first and last row the box reads (of every frame).
// vec: D % 4 == 0, so a thread's four candidates are one aligned float4
// of C.
template <int K>
__global__ void __launch_bounds__(kBtThreads) bt_cost_kernel(
    const float* __restrict__ planes, const int* __restrict__ rows,
    float* __restrict__ C, int H, int W, int D, int min_disp,
    int groups_log2, int vec) {
  constexpr int p = K / 2;
  // a row's staged planes (s, lo, hi, unused): L's columns, then R's; and
  // the row sums, candidate group g at g * (ni + 1) (padded: the column
  // pass reads the groups of one column side by side). Two of each, by
  // the row's parity, so one barrier a row orders their reuse.
  __shared__ float4 ps[2][kBtStaged];
  __shared__ float4 vs[2][kBtThreads + 8];
  const int groups = 1 << groups_log2, dc = 4 * groups;
  const int ni = kBtThreads >> groups_log2;  // staged L columns
  const int nst = 2 * ni + dc - 1;           // with R's ni + dc - 1
  const int tx_n = ni - (K - 1);             // output columns
  const int tiles_x = (W + tx_n - 1) / tx_n;
  const int tiles = tiles_x * ((H + kBtRows - 1) / kBtRows);
  const int tile = blockIdx.x % tiles;
  const int x0 = (tile % tiles_x) * tx_n;
  const int y0 = (tile / tiles_x) * kBtRows;
  const int dc0 = blockIdx.x / tiles * dc;    // the chunk's first candidate
  const int dv_hi = min_disp + dc0 + dc - 1;  // its largest shift
  const int cx_lo = clamp_to(x0 - p, W);      // smallest clamped column
  const int base = cx_lo - dv_hi;             // column of R's column 0
  const int row_lo = rows ? clamp_to(rows[0], H) : 0;
  const int row_hi = rows ? clamp_to(rows[1], H) : H - 1;
  const long long hw = (long long)H * W;
  const float* Lp = planes + blockIdx.y * 6 * hw;
  const float* Rp = Lp + 3 * hw;

  // The row pass: staged column i (image column clamp(x0 - p + i)) and
  // candidates 4g .. 4g + 3, lanes on consecutive columns. Candidate 4g +
  // q reads R's staged column j0 - q.
  const int i = threadIdx.x % ni, g = threadIdx.x / ni;
  const int j0 = clamp_to(x0 - p + i, W) - cx_lo + dc - 1 - 4 * g;
  const int vi = g * (ni + 1) + i;
  // The column pass: output column x0 + xc and candidates 4gc .. 4gc + 3,
  // lanes on consecutive candidates.
  const int gc = threadIdx.x & (groups - 1), xc = threadIdx.x >> groups_log2;
  const int d4 = dc0 + 4 * gc;
  const bool store = xc < tx_n && x0 + xc < W && d4 < D;
  float* Cq = C + blockIdx.y * hw * D + ((long long)y0 * W + x0 + xc) * D + d4;
  const int vc = gc * (ni + 1) + xc;

  const int nsteps = min(kBtRows, H - y0) + K - 1;  // rows, halo included
  float st[kBtStage][3];
  // the planes of step r's row (image row y0 - p + r, clamped), into st
  const auto fetch = [&](int r) {
    const long long row =
        (long long)min(max(y0 - p + r, row_lo), row_hi) * W;
#pragma unroll
    for (int u = 0; u < kBtStage; ++u) {
      const int e = threadIdx.x + u * kBtThreads;
      if (e < nst) {
        const float* q = e < ni ? Lp + row + clamp_to(x0 - p + e, W)
                                : Rp + row + clamp_to(base + e - ni, W);
        st[u][0] = q[0];
        st[u][1] = q[hw];
        st[u][2] = q[2 * hw];
      }
    }
  };
  float4 ring[K];
  fetch(0);
  for (int r0 = 0; r0 < nsteps; r0 += K) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int r = r0 + s;
      if (r < nsteps) {
        const int b = r & 1;
#pragma unroll
        for (int u = 0; u < kBtStage; ++u) {
          const int e = threadIdx.x + u * kBtThreads;
          if (e < nst) ps[b][e] = make_float4(st[u][0], st[u][1], st[u][2],
                                              0.0f);
        }
        __syncthreads();
        if (r + 1 < nsteps) fetch(r + 1);
        const float4 l = ps[b][i];
        const float4* R = ps[b] + ni + j0;
        ring[s] = make_float4(bt_cell(l, R[0]), bt_cell(l, R[-1]),
                              bt_cell(l, R[-2]), bt_cell(l, R[-3]));
        if (r >= K - 1) {  // the box's rows r - K + 1 .. r: slots s + 1 ..
          float4 v = ring[(s + 1) % K];
#pragma unroll
          for (int t = 2; t <= K; ++t) v = add4(v, ring[(s + t) % K]);
          vs[b][vi] = v;
          __syncthreads();
          if (store) {
            const float4* w = vs[b] + vc;
            float4 c = w[0];
#pragma unroll
            for (int t = 1; t < K; ++t) c = add4(c, w[t]);
            float* q = Cq + (long long)(r - (K - 1)) * W * D;
            if (vec) {
              *reinterpret_cast<float4*>(q) = c;
            } else {
              q[0] = c.x;
              if (d4 + 1 < D) q[1] = c.y;
              if (d4 + 2 < D) q[2] = c.z;
              if (d4 + 3 < D) q[3] = c.w;
            }
          }
        }
      }
    }
  }
}

using BtCostFn = void (*)(const float*, const int*, float*, int, int, int,
                          int, int, int);

BtCostFn bt_cost_fn(int block) {
  switch (block) {
    case 1: return bt_cost_kernel<1>;
    case 3: return bt_cost_kernel<3>;
    case 5: return bt_cost_kernel<5>;
    case 7: return bt_cost_kernel<7>;
    case 9: return bt_cost_kernel<9>;
    case 11: return bt_cost_kernel<11>;
    default: return nullptr;
  }
}

static_assert(kBtBlockMax == 11, "bt_cost_fn has a kernel a block to 11");

}  // namespace

// C (B, H, W, D) float32: the box-summed Birchfield-Tomasi cost of the
// (B, H, W) float32 gray stacks gray1 (reference) and gray2 (target) on
// their x-Sobel clipped to [-cap, cap], candidates min_disp .. min_disp +
// D - 1, the box's rows clamped to rows[0] .. rows[1] (int32 on the card;
// null: the image's); planes: scratch of B * 2 * 3 * H * W floats. block
// odd, at most kBtBlockMax; B <= 65,535; C 16-byte aligned where D % 4 ==
// 0.
extern "C" int sgm_bt_cost(const void* gray1, const void* gray2,
                           const void* rows, void* planes, void* C, int B,
                           int H, int W, int min_disp, int D, int block,
                           float cap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const BtCostFn kernel = bt_cost_fn(block);
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D < 1 || kernel == nullptr ||
      (D % 4 == 0 && ((uintptr_t)C & 15) != 0))
    return (int)cudaErrorInvalidValue;
  int groups_log2 = 0;
  while (groups_log2 < 3 && (4 << groups_log2) < D) ++groups_log2;
  const int tx_n = (kBtThreads >> groups_log2) - (block - 1);
  const long long strips = (long long)((H + kBtRows - 1) / kBtRows) *
                           ((W + tx_n - 1) / tx_n);
  const long long chunks = (D + (4 << groups_log2) - 1) >> (groups_log2 + 2);
  const long long tiles = (long long)((H + kBtPreTY - 1) / kBtPreTY) *
                          ((W + kBtPreTX - 1) / kBtPreTX);
  if (strips * chunks > 0x7fffffffLL || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pl = static_cast<float*>(planes);
  bt_prefilter_kernel<<<dim3((unsigned)tiles, B, 2), kBtThreads, 0, s>>>(
      static_cast<const float*>(gray1), static_cast<const float*>(gray2), pl,
      H, W, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)(strips * chunks), B), kBtThreads, 0, s>>>(
      pl, static_cast<const int*>(rows), static_cast<float*>(C), H, W, D,
      min_disp, groups_log2, (int)(D % 4 == 0));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The post pass over the path sum S (sgm_post): winner-take-all,
// uniqueness, the quadratic subpixel fit and the left-right check.
//
// Replaces no TPU kernel: the JAX package's _sgm_post is jnp that XLA
// fuses. The port's torch code for it (sgm.py: _sgm_post_plain) is its
// twin, and ran as 67 launches (89 with the left-right check), some over
// int64 volumes of S's shape. For S (B, H, W, D) float32, candidate
// k at disparity dv = min_disp + k, and S(x, k) = inf where x - dv leaves
// [0, W) (the off-image mask), it writes the int16 map
//     best  = the least k of min_k S(x, k) (torch.argmin's tie rule)
//     valid = S(x, best) finite, and with uniqueness u > 0
//             !(s2 * 100 < S(x, best) * (100 + u)), s2 = min over
//             |k - best| > 1
//     out   = round(16 * (best + min_disp) + 16 * delta) if valid, else
//             16 * (min_disp - 1)
// with delta the clamped quadratic fit through S(best - 1), S(best),
// S(best + 1) at interior best (non-finite neighbours read S(best)), in
// the twin's float32 operations and order: __fmul_rn, __fadd_rn and
// __fdiv_rn keep nvcc from contracting them into an FMA. With the
// left-right check (disp12_max_diff >= 0) a pixel also stays valid only
// where |dr - (best + min_disp)| <= disp12_max_diff, dr the right view's
// winner at column clamp(x - best - min_disp): min_dv + argmin_k
// S(xr + dv, k) over the candidates that land in the image. S holds no
// NaN (it is a sum of finite costs).
//
// What bounds it: reading S once (354 MB a 1280x720 frame at D = 96,
// 0.106 ms at 3.35 TB/s); the map is 2 bytes a pixel. The design reads S
// once, the left-right check included:
//   - a block takes one (frame, row); a pixel takes a group of G lanes
//     (8 up to D = 128), lane g holding candidates g + G * j, j < NJ, in
//     registers, so a load of the warp reads whole 32-byte sectors. Each
//     of the block's streams walks a contiguous run of the row and loads
//     its next pixel before it reduces this one.
//   - one butterfly over the group gives the (value, index) minimum, a
//     second one the minimum outside best +- 1; S(best +- 1) come from
//     the lanes that hold them by shuffle. The mask is applied as S is
//     loaded.
//   - the right view's winner: the row keeps one 64-bit key a column xr
//     in shared memory, the value's order-preserving bits (-0 read as +0)
//     in the high word and k in the low. Each pixel's in-image candidates
//     atomicMin their key at xr = x - dv as they are loaded, so the key
//     ends as the least value, then the least k: torch.argmin of the
//     gathered right-view volume. After a barrier the row's pixels are
//     checked against it and the row is written, coalesced.
// A row too wide for shared memory (about 16,600 columns with the check)
// keeps its keys, winners and map in scratch in device memory instead;
// D > 512 (NJ 0) reads each candidate from S at each use instead of
// holding it.

namespace {

constexpr int kPostWarps = 4;  // warps a block

// The order-preserving key of a right-view candidate: value, then k.
__device__ __forceinline__ unsigned long long right_key(float v, int k) {
  unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)k;
}

// torch.round(v).to(torch.int16): half to even, then the integer's low
// 16 bits.
__device__ __forceinline__ short to_int16(float v) {
  return (short)(int)rintf(v);
}

// grid (H, frames); block kPostWarps warps. kSmem: the row's keys,
// winners and map in dynamic shared memory; else in keys, disps (one
// entry a pixel of the launch) and out itself.
template <int NJ, bool kSmem>
__global__ void __launch_bounds__(kPostWarps * 32) sgm_post_kernel(
    const float* __restrict__ S, short* __restrict__ out,
    unsigned long long* __restrict__ gkeys, int* __restrict__ gdisps, int H,
    int W, int D, int G, int min_disp, float uniq_factor, int uniq,
    int lr_max, int subpixel) {
  extern __shared__ unsigned long long post_buf[];
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int streams = kPostWarps * (32 / G);
  const int stream = (lane / G) * kPostWarps + (threadIdx.x >> 5);
  const int nj = NJ > 0 ? NJ : (D + G - 1) / G;
  const bool lr = lr_max >= 0;
  const long long row = (long long)blockIdx.y * H + blockIdx.x;
  const float* Sr = S + row * W * D;
  short* orow = out + row * W;
  unsigned long long* keys;
  int* disps;
  short* stage;
  if constexpr (kSmem) {
    keys = post_buf;
    disps = reinterpret_cast<int*>(keys + (lr ? W : 0));
    stage = reinterpret_cast<short*>(disps + (lr ? W : 0));
  } else {
    keys = gkeys + row * W;
    disps = gdisps + row * W;
    stage = orow;
  }
  if (lr) {
    for (int x = threadIdx.x; x < W; x += blockDim.x)
      keys[x] = right_key(INFINITY, 0);
    __syncthreads();
  }
  const float marker = (float)((min_disp - 1) * 16);

  // Candidate k of pixel x is in the image for k in [x - W + 1 - min_disp,
  // x - min_disp]; the masked value, inf outside it and past D.
  const auto load = [&](float (&v)[NJ > 0 ? NJ : 1], int x) {
    const float* px = Sr + (long long)x * D;
    const int lo = x - (W - 1) - min_disp, hi = x - min_disp;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = g + G * j;
      v[j] = x < W && k < D && k >= lo && k <= hi ? __ldcs(px + k) : INFINITY;
    }
  };
  const int L = (W + streams - 1) / streams;  // pixels a stream walks
  const int x0 = stream * L;
  float cur[NJ > 0 ? NJ : 1], nxt[NJ > 0 ? NJ : 1];
  if constexpr (NJ > 0) load(cur, x0);
  for (int t = 0; t < L; ++t) {  // uniform: every lane shuffles each step
    const int x = x0 + t;
    if constexpr (NJ > 0) {
      if (t + 1 < L) load(nxt, x + 1);
    }
    const float* px = Sr + (long long)x * D;
    const int lo = x - (W - 1) - min_disp, hi = x - min_disp;
    const auto val = [&](int j) -> float {
      if constexpr (NJ > 0) {
        return cur[j];
      } else {
        const int k = g + G * j;
        return x < W && k < D && k >= lo && k <= hi ? __ldg(px + k)
                                                    : INFINITY;
      }
    };

    // The winner: the least (value, k), and the right view's keys.
    float bv = val(0);
    int bk = g;
#pragma unroll
    for (int j = 0; j < nj; ++j) {
      const int k = g + G * j;
      const float v = val(j);
      if (v < bv) {  // k grows along the lane: the first of equals stays
        bv = v;
        bk = k;
      }
      if (lr && x < W && k < D && k >= lo && k <= hi)
        atomicMin(keys + (x - min_disp - k), right_key(v, k));
    }
    for (int o = G >> 1; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o, G);
      const int ok = __shfl_xor_sync(kFull, bk, o, G);
      if (ov < bv || (ov == bv && ok < bk)) {
        bv = ov;
        bk = ok;
      }
    }
    bool valid = isfinite(bv);
    if (uniq) {
      float s2 = INFINITY;
#pragma unroll
      for (int j = 0; j < nj; ++j)
        if ((unsigned)(g + G * j - bk + 1) > 2u) s2 = fminf(s2, val(j));
      for (int o = G >> 1; o > 0; o >>= 1)
        s2 = fminf(s2, __shfl_xor_sync(kFull, s2, o, G));
      valid = valid &&
              !(__fmul_rn(s2, 100.0f) < __fmul_rn(bv, uniq_factor));
    }
    const int disp = bk + min_disp;
    float d16 = __fmul_rn((float)disp, 16.0f);
    if (subpixel) {
      // S(k) of the group, from the lane that holds it.
      const auto pick = [&](int k) -> float {
        if constexpr (NJ > 0) {
          const int jk = k >> (__ffs(G) - 1);  // k / G
          float v = INFINITY;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            if (j == jk) v = cur[j];
          return __shfl_sync(kFull, v, k & (G - 1), G);
        } else {
          return x < W && k >= lo && k <= hi ? __ldg(px + k) : INFINITY;
        }
      };
      float bm1 = pick(max(bk - 1, 0)), bp1 = pick(min(bk + 1, D - 1));
      bm1 = isfinite(bm1) ? bm1 : bv;
      bp1 = isfinite(bp1) ? bp1 : bv;
      const float denom =
          __fsub_rn(__fadd_rn(bm1, bp1), __fmul_rn(2.0f, bv));
      float delta = denom > 1e-6f ? __fdiv_rn(__fsub_rn(bm1, bp1),
                                              __fmul_rn(2.0f, denom))
                                  : 0.0f;
      delta = fminf(fmaxf(delta, -0.5f), 0.5f);
      const bool interior = bk > 0 && bk < D - 1;
      d16 = __fadd_rn(d16, __fmul_rn(interior ? delta : 0.0f, 16.0f));
    }
    if (g == 0 && x < W) {
      stage[x] = to_int16(valid ? d16 : marker);
      if (lr) disps[x] = disp;
    }
    if constexpr (NJ > 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) cur[j] = nxt[j];
    }
  }
  if (!kSmem && !lr) return;  // written in place
  __syncthreads();
  const short bad = to_int16(marker);
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    short o = stage[x];
    if (lr) {
      const int disp = disps[x];
      const int xr = min(max(x - disp, 0), W - 1);
      const int dr = (int)(unsigned)(keys[xr] & 0xffffffffu) + min_disp;
      if (abs(dr - disp) > lr_max) o = bad;
    }
    orow[x] = o;
  }
}

using PostFn = void (*)(const float*, short*, unsigned long long*, int*, int,
                        int, int, int, int, float, int, int, int);

template <bool kSmem>
PostFn post_fn(int nj) {
  switch (nj) {
    case 0: return sgm_post_kernel<0, kSmem>;
    case 4: return sgm_post_kernel<4, kSmem>;
    case 8: return sgm_post_kernel<8, kSmem>;
    case 12: return sgm_post_kernel<12, kSmem>;
    case 16: return sgm_post_kernel<16, kSmem>;
    default: return nullptr;
  }
}

}  // namespace

// out (B, H, W) int16: the post pass of S (B, H, W, D) float32 (see the
// note above). nj, group: candidates a lane (4, 8, 12 or 16 in registers;
// 0 reads them from S) and lanes a pixel (a power of two, group * nj >= D
// unless nj is 0), from sgm_cuda._post_plan. keys, disps: null to keep a
// row in shared memory; else scratch of B * H * W uint64 and int32 (when
// the row does not fit). uniq_factor is 100 + uniqueness in float32, uniq
// nonzero turns the uniqueness test on, lr_max < 0 turns the left-right
// check off. B <= 65,535.
extern "C" int sgm_post(const void* S, void* out, void* keys, void* disps,
                        int B, int H, int W, int D, int min_disp,
                        float uniq_factor, int uniq, int lr_max,
                        int subpixel, int nj, int group, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D < 1 || group < 1 ||
      group > 32 || (group & (group - 1)) != 0 ||
      (nj > 0 && group * nj < D) || (nj == 0 && group != 32) ||
      (keys == nullptr) != (disps == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool smem_row = keys == nullptr;
  const PostFn kernel = smem_row ? post_fn<true>(nj) : post_fn<false>(nj);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  if (smem_row) {
    smem = (size_t)W * (2 + (lr_max >= 0 ? 12 : 0));
    int smem_max = 0;
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  kernel<<<dim3(H, B), kPostWarps * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<short*>(out),
      static_cast<unsigned long long*>(keys), static_cast<int*>(disps), H, W,
      D, group, min_disp, uniq_factor, uniq, lr_max, subpixel);
  return (int)cudaGetLastError();
}

extern "C" const char* sgm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

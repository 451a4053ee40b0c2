// Adaptive Support-Weight matching kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel simplestereo_tpu/passive/asw_pallas.py
// ::_asw_kernel (launched by _asw_pass). It computes what that kernel
// computes, not how: the lane rolls, band tiling and unroll splits there
// were answers to the TPU compiler and are gone.
//
// asw_cost_kernel: one thread per (frame, y, x), a (32, 8) block. For each
// chunk of up to 16 disparities it walks the window-offset lattice (every
// `step`-th offset, anchored at the centre; column offset outer, row offset
// inner, as the TPU kernel does) and keeps num/den per disparity in
// registers:
//     e1  = expf(-sqrtf(|Lab1(win) - Lab1(ctr)|^2) * inv_gc) * prox[i][j]
//     e2  = expf(-sqrtf(|Lab2(win - d) - Lab2(ctr - d)|^2) * inv_gc)
//     tad = min(40, sum_c |BGR1(win) - BGR2(win - d)|)
//     num += e1 * e2 * tad;   den += e1 * e2
// with squared distances summed over channels in order 0, 1, 2. The planes
// are padded (1e6 Lab sentinel, zero BGR) wide enough that every read is
// in bounds and an out-of-image window pixel weighs exactly 0. It writes
// the cost volume (B, D, H, W) = num / den, or inf where the matched column
// x - d leaves [0, W-1]. den >= 1 for every valid candidate (the centre
// weighs exp(0) * exp(0)), so the division is safe. A chunk re-walks the
// window, so D > 16 costs ceil(D / 16) walks.
//
// asw_select_kernel: one thread per (frame, y, x) over that volume. Left
// map = first argmin over d (strict <, from index 0, so an all-inf column
// gives index 0); optional csub = (c[best-1], c[best], c[best+1]), 0 where
// the neighbour does not exist; optional right map from the same volume,
// cost_R(x, d) = cost(x + d, d), inf where x + d leaves [0, W-1]. This is
// the cross-column step the TPU kernel did on a row band in VMEM; here
// the volume lives in device memory between the two launches.
//
// What bounds it on this card: per (pixel, window offset, disparity) the
// cost kernel does one expf and one sqrtf (IEEE sqrtf and full-precision
// expf, no fast math: the argmin is sensitive to ulps) plus six cached
// loads; per (pixel, offset) one more expf and sqrtf. The FP32 and
// special-function pipes bound it, with L1 traffic close behind, and the
// 16-wide register chunk limits occupancy to two blocks per SM. A later
// version would stage the window of each block in shared memory and
// factor e2 across pixels as the TPU kernel does (asw_pallas.py:228-285:
// e2 is a function of the target column only, so one evaluation serves
// every (x, d) with the same x - d), cutting the expf/sqrtf count by
// about D.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 16;
constexpr float kTadCap = 40.0f;

// Two blocks per SM: caps registers at 128 (from 160 uncapped, which
// left one block of 8 warps per SM); 1.4-1.5x faster, bit-equal results.
__global__ void __launch_bounds__(256, 2) asw_cost_kernel(
    const float* __restrict__ planes, const float* __restrict__ prox,
    float* __restrict__ cost, int H, int W, int Hp, int Wp, int x0, int win,
    int step, int min_disp, int D, float inv_gc) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;

  const long long plane = (long long)Hp * Wp;
  const float* lab1 = planes + (long long)b * 12 * plane;
  const float* lab2 = lab1 + 3 * plane;
  const float* bgr1 = lab1 + 6 * plane;
  const float* bgr2 = lab1 + 9 * plane;

  const int pad = win / 2;
  // Plane offset of the centre pixel (image (y, x) -> plane (y + pad, x0 + x)).
  const long long ctr = (long long)(y + pad) * Wp + x0 + x;
  float c1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) c1[c] = __ldg(lab1 + c * plane + ctr);

  const int half = pad / step;
  const long long hw = (long long)H * W;
  float* out = cost + (long long)b * D * hw + (long long)y * W + x;

  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int nd = min(kChunk, D - d0);
    const int dbase = min_disp + d0;
    float num[kChunk], den[kChunk], c2[kChunk][3];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      num[k] = 0.0f;
      den[k] = 0.0f;
      if (k < nd) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          c2[k][c] = __ldg(lab2 + c * plane + ctr - (dbase + k));
      }
    }

    for (int m = 0; m <= 2 * half; ++m) {
      const int j = (m - half) * step + pad;  // window column, 0..win-1
      for (int i = pad % step; i < win; i += step) {
        // Window pixel (y + i - pad, x + j - pad) in plane coordinates.
        const long long p = ctr + (long long)(i - pad) * Wp + (j - pad);
        float dsq = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float dl = __ldg(lab1 + c * plane + p) - c1[c];
          dsq += dl * dl;
        }
        const float e1 = expf(-sqrtf(dsq) * inv_gc) * __ldg(prox + i * win + j);
        float b1[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) b1[c] = __ldg(bgr1 + c * plane + p);

#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (k < nd) {
            const long long q = p - (dbase + k);
            float dsq2 = 0.0f;
            float sad = 0.0f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float dl = __ldg(lab2 + c * plane + q) - c2[k][c];
              dsq2 += dl * dl;
              sad += fabsf(b1[c] - __ldg(bgr2 + c * plane + q));
            }
            const float e2 = expf(-sqrtf(dsq2) * inv_gc);
            const float w = e1 * e2;
            num[k] += w * fminf(sad, kTadCap);
            den[k] += w;
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < nd) {
        const int tx = x - (dbase + k);
        out[(d0 + k) * hw] =
            (tx >= 0 && tx < W) ? num[k] / den[k] : INFINITY;
      }
    }
  }
}

__global__ void __launch_bounds__(256) asw_select_kernel(
    const float* __restrict__ cost, int* __restrict__ dispL,
    int* __restrict__ dispR, float* __restrict__ csub, int H, int W,
    int min_disp, int D) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;

  const long long hw = (long long)H * W;
  const float* row = cost + (long long)b * D * hw + (long long)y * W;
  const long long o = (long long)b * hw + (long long)y * W + x;

  int best = 0;
  float bv = row[x];
  for (int dd = 1; dd < D; ++dd) {
    const float v = row[dd * hw + x];
    if (v < bv) {
      bv = v;
      best = dd;
    }
  }
  dispL[o] = best + min_disp;

  if (csub != nullptr) {
    float* s = csub + (long long)b * 3 * hw + (long long)y * W + x;
    s[0] = best > 0 ? row[(best - 1) * hw + x] : 0.0f;
    s[hw] = bv;
    s[2 * hw] = best < D - 1 ? row[(best + 1) * hw + x] : 0.0f;
  }

  if (dispR != nullptr) {
    int bestR = 0;
    float bvR = INFINITY;
    for (int dd = 0; dd < D; ++dd) {
      const int src = x + min_disp + dd;
      const float v = (src >= 0 && src < W) ? row[dd * hw + src] : INFINITY;
      if (dd == 0 || v < bvR) {
        bvR = v;
        bestR = dd;
      }
    }
    dispR[o] = bestR + min_disp;
  }
}

}  // namespace

extern "C" int asw_pass(const void* planes, const void* prox, void* cost,
                        void* dispL, void* dispR, void* csub, int B, int H,
                        int W, int Hp, int Wp, int x0, int win, int step,
                        int min_disp, int D, float inv_gc, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, B);
  asw_cost_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(planes), static_cast<const float*>(prox),
      static_cast<float*>(cost), H, W, Hp, Wp, x0, win, step, min_disp, D,
      inv_gc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  asw_select_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(cost), static_cast<int*>(dispL),
      static_cast<int*>(dispR), static_cast<float*>(csub), H, W, min_disp, D);
  return (int)cudaGetLastError();
}

extern "C" const char* asw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Geodesic Support-Weight matching kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel simplestereo_tpu/passive/gsw_pallas.py
// ::_gsw_kernel (line 99, launched by _gsw_pass_pallas). It computes what
// that kernel computes, not how: the row bands, lane rolls and unroll
// splits there were answers to the TPU compiler and are gone.
//
// Per frame, with the BGR planes padded by win/2 (BGR(ref) with a 1e6
// sentinel, BGR(tgt) or the caller's volume with zeros):
//     vol_d(y, x) = min(fMax, sqrtf(sum_c (ref_c(y, x) - tgt_c(y, x - d))^2))
// summed over the channels in order 0, 1, 2, and 0 where x - d leaves
// [0, W-1] (for 8-bit images every term and partial sum is an integer below
// 2^24, so the volume is exact, as in the twin); for each window offset on
// the `step` lattice (anchored at the centre; rows outer, columns inner),
//     w = expf(-sqrtf(|BGR1(win) - BGR1(ctr)|^2) / gamma)
// (on the tile path from the hardware's approximate sqrt and exp2, on the
// L1 path from IEEE sqrtf, a division and expf; the argmin is sensitive to
// ulps, so both are held to the twin within rtol 2e-5), and
//     num_d += w * vol_d(win)      and, with normalize,
//     den_d += w  where 0 <= x_win - d <= W-1.
// A window pixel outside the image is skipped: it weighs exactly 0 for any
// gamma (the 1e6 sentinel alone gives 0 only while sqrt(3)*1e6/gamma >
// 104). The cost is num_d (num_d / max(den_d, 1e-12) with normalize), inf
// where the centre's candidate column x - d leaves the image; the first
// minimum wins (strict <, from d index 0, so an all-inf column gives index
// 0). The cost volume is written only when the caller passes a pointer.
// With ext_vol the volume is the caller's (the MI path).
//
// What bounds it on this card: per (pixel, window offset) the weight takes
// a square root, an exponential, ten flops and 3 reads of BGR1; per
// (pixel, offset, d) one FMA and one read of the volume. At 1280x720,
// win 23, D = 11 (2 frames) that is 1.0 G weights: instruction issue and
// its latency, and shared-memory reads, not device memory (a few tens of
// MB), set its time. The first version (one thread a pixel, a runtime
// chunk with a predicate on every disparity, a separate volume launch into
// device memory, IEEE sqrtf/division/expf) ran at 13.8x its operation
// bound. This version:
//
// gsw_tile_kernel<ND, kNorm>: a block of 32 x 8 threads computes a 32 x 32
// pixel tile, each thread four vertically neighbouring pixels. Its tile of
// BGR(ref) (the pixels and their windows) is staged in shared memory with
// cp.async; for each chunk of ND disparities (ND = 4, 8, 12 or 16, fixed
// at compile time; a padded disparity reads zeros and is never written) the
// chunk's volume planes are built in shared memory straight from BGR(ref)
// there and BGR(tgt) in device memory (no volume launch, no device-memory
// volume), or with ext_vol copied from the caller's volume with cp.async.
// Window row i of a thread's pixel q is row i + q - q' of its pixel q', so
// each staged value (3 of BGR1 and ND of the volume) read from shared
// memory serves all four pixels: the reads a (pixel, offset) fall to about
// a quarter, the weights stay one a (pixel, offset) (a pixel that does not
// use a staged row weighs it 0, which keeps the loop free of branches). A
// thread's valid window columns are one range, computed once; a window row
// is checked once, not each offset. A warp reads 32 neighbouring words: no
// bank conflicts. The weight is computed on the hardware's approximate
// sqrt and exp2 (see weight()); at win 23, D = 11 the tile takes 174,960
// bytes of shared memory, one block (8 warps) an SM.
//
// gsw_l1_kernel<kNorm> with gsw_volume_kernel: the first version, the path
// for a window whose tile does not fit 227 KB of shared memory (win > 59):
// the volume is built in device memory by its own launch and every window
// read goes through L1; one thread a pixel, IEEE sqrtf, division and expf.
//
// The launch plan (path, ND, shared memory) comes from the caller
// (gsw_cuda._plan), which also splits a stack into launches whose grid z
// (frames, or frames x D for the volume launch) fits 65,535.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTW = 32;  // threads a block along x: one pixel column each
constexpr int kTH = 8;   // threads a block along y
constexpr int kPY = 4;   // pixels a thread, along y
constexpr int kRows = kTH * kPY;  // tile rows of pixels
constexpr int kThreads = kTW * kTH;
constexpr int kChunkL1 = 16;  // disparities a walk, L1 path

// Asynchronous 4-byte copy of device memory into shared memory; with !ok
// nothing is read and the word is set to 0.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The tile kernel's support weight exp(-sqrt(dsq) / gamma) as
// 2^(sqrt(dsq) * kexp), kexp = -log2(e) / gamma, on the hardware's
// approximate sqrt and exp2 (relative error about 2^-22 each): no branch,
// no slow path, so the compiler interleaves the weights of a thread's
// pixels. The IEEE sequence (sqrtf, a division, expf) has slow-path
// branches that kept the weights of one thread apart and made the kernel
// latency-bound; the costs stay within the gate's rtol 2e-5 of the twin
// (gsw_variants.py times and gates both).
__device__ __forceinline__ float weight(float r0, float r1, float r2,
                                        const float (&c)[3], float gamma,
                                        float kexp) {
  const float a = r0 - c[0], b = r1 - c[1], e = r2 - c[2];
  float dsq = 0.0f;
  dsq += a * a;
  dsq += b * b;
  dsq += e * e;
  return ex2_approx(sqrt_approx(dsq) * kexp);
}

// planes: frame b at planes + b * p_stride; BGR(ref) in planes 0-2, then
// BGR(tgt) (planes 3-5) or, with ext, the caller's D volume planes.
template <int ND, bool kNorm>
__global__ void __launch_bounds__(kThreads, 1) gsw_tile_kernel(
    const float* __restrict__ planes, long long p_stride,
    int* __restrict__ disp, float* __restrict__ cost, int H, int W, int Hp,
    int Wp, int win, int step, int min_disp, int D, float gamma, float f_max,
    int ext) {
  extern __shared__ float tile[];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int pad = win / 2;
  const int R = kRows + 2 * pad;  // tile rows (padded rows y0 ..)
  const int Cw = kTW + 2 * pad;   // tile columns (padded columns x0 ..)
  const int ps = R * Cw;          // floats a tile plane
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const long long gplane = (long long)Hp * Wp;
  const float* gref = planes + b * p_stride;
  float* sref = tile;
  float* svol = tile + 3 * ps;

  // BGR(ref) of the tile; rows or columns past the planes' end read as 0
  // (never weighted).
  for (int e = tid; e < 3 * ps; e += kThreads) {
    const int c = e / ps, rc = e - c * ps;
    const int r = rc / Cw, col = rc - r * Cw;
    const bool ok = y0 + r < Hp && x0 + col < Wp;
    copy_async(sref + e,
               gref + c * gplane + (ok ? (long long)(y0 + r) * Wp + x0 + col : 0),
               ok);
  }
  copy_wait();
  __syncthreads();

  const int x = x0 + tx;           // image column of the thread's pixels
  const int yb = y0 + kPY * ty;    // image row of its first pixel
  bool act[kPY];
  float ctr[kPY][3];
#pragma unroll
  for (int q = 0; q < kPY; ++q) {
    act[q] = x < W && yb + q < H;
    const int at = (kPY * ty + q + pad) * Cw + tx + pad;
#pragma unroll
    for (int c = 0; c < 3; ++c) ctr[q][c] = act[q] ? sref[c * ps + at] : 0.0f;
  }
  // The thread's window columns inside the image, on the lattice:
  // x + j - pad in [0, W-1], j = pad (mod step).
  const int jlo = max(0, pad - x);
  const int jhi = min(win - 1, W - 1 - x + pad);
  const int j0 = pad - ((pad - jlo) / step) * step;
  const long long hw = (long long)H * W;
  const float kexp = -1.4426950408889634f / gamma;
  int best[kPY];
  float bv[kPY];
#pragma unroll
  for (int q = 0; q < kPY; ++q) {
    best[q] = 0;
    bv[q] = INFINITY;
  }

  for (int d0 = 0; d0 < D; d0 += ND) {
    const int dbase = min_disp + d0;
    __syncthreads();  // every read of the previous chunk is done
    if (ext) {
      const float* gvol = gref + (3 + d0) * gplane;
      for (int e = tid; e < ND * ps; e += kThreads) {
        const int k = e / ps, rc = e - k * ps;
        const int r = rc / Cw, col = rc - r * Cw;
        const bool ok = d0 + k < D && y0 + r < Hp && x0 + col < Wp;
        copy_async(svol + e,
                   gvol + (ok ? k * gplane + (long long)(y0 + r) * Wp + x0 + col : 0),
                   ok);
      }
      copy_wait();
    } else {
      const float* gtgt = gref + 3 * gplane;
#pragma unroll 4
      for (int e = tid; e < ND * ps; e += kThreads) {
        const int k = e / ps, rc = e - k * ps;
        const int r = rc / Cw, col = rc - r * Cw;
        const int yi = y0 + r - pad, xi = x0 + col - pad;  // image pixel
        const int t = xi - (dbase + k);  // its candidate column
        float v = 0.0f;
        if (d0 + k < D && yi >= 0 && yi < H && xi >= 0 && xi < W && t >= 0 &&
            t < W) {
          const float* g = gtgt + (long long)(y0 + r) * Wp + t + pad;
          float dsq = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float dl = sref[c * ps + rc] - __ldg(g + c * gplane);
            dsq += dl * dl;
          }
          v = fminf(sqrtf(dsq), f_max);
        }
        svol[e] = v;
      }
    }
    __syncthreads();

    float num[kPY][ND], den[kPY][ND];
#pragma unroll
    for (int q = 0; q < kPY; ++q)
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        num[q][k] = 0.0f;
        den[q][k] = 0.0f;
      }

    // Staged row rr is window row rr - q of the thread's pixel q: the same
    // image row for all of them.
    for (int rr = 0; rr < win + kPY - 1; ++rr) {
      const int yw = yb + rr - pad;
      if (yw < 0 || yw >= H) continue;
      bool use[kPY];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kPY; ++q) {
        const int i = rr - q;  // window row of pixel q
        use[q] = act[q] && i >= 0 && i < win && (i - pad) % step == 0;
        any = any || use[q];
      }
      if (!any) continue;
      const float* row = tile + (kPY * ty + rr) * Cw + tx;
      for (int j = j0; j <= jhi; j += step) {
        const float r0 = row[j], r1 = row[ps + j], r2 = row[2 * ps + j];
        float v[ND];
#pragma unroll
        for (int k = 0; k < ND; ++k) v[k] = row[(3 + k) * ps + j];
#pragma unroll
        for (int q = 0; q < kPY; ++q) {
          // a pixel that does not use this row weighs it 0: no branch
          const float w = weight(r0, r1, r2, ctr[q], gamma, kexp) *
                          (use[q] ? 1.0f : 0.0f);
#pragma unroll
          for (int k = 0; k < ND; ++k) {
            num[q][k] += w * v[k];
            if (kNorm) {
              const int t = x + j - pad - (dbase + k);
              if (t >= 0 && t < W) den[q][k] += w;
            }
          }
        }
      }
    }

#pragma unroll
    for (int q = 0; q < kPY; ++q) {
      if (!act[q]) continue;
      const long long px = (long long)b * D * hw + (long long)(yb + q) * W + x;
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        if (d0 + k >= D) continue;
        const int t = x - (dbase + k);
        float c = INFINITY;
        if (t >= 0 && t < W)
          c = kNorm ? num[q][k] / fmaxf(den[q][k], 1e-12f) : num[q][k];
        if (cost != nullptr) cost[px + (d0 + k) * hw] = c;
        if (d0 + k == 0 || c < bv[q]) {
          bv[q] = c;
          best[q] = d0 + k;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kPY; ++q)
    if (act[q])
      disp[(long long)b * hw + (long long)(yb + q) * W + x] = best[q] + min_disp;
}

// The L1 path's volume: one thread per (frame, d, row, column) of the
// padded volume (B, D, Hp, Wp), a (32, 8) block; frame and d on grid z.
__global__ void __launch_bounds__(256) gsw_volume_kernel(
    const float* __restrict__ planes, float* __restrict__ vol, int H, int W,
    int Hp, int Wp, int min_disp, int D, float f_max) {
  const int xp = blockIdx.x * blockDim.x + threadIdx.x;
  const int yp = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z / D;
  const int dd = blockIdx.z - b * D;
  if (xp >= Wp || yp >= Hp) return;

  const int pad = (Hp - H) / 2;
  const long long plane = (long long)Hp * Wp;
  const int y = yp - pad;
  const int x = xp - pad;
  const int t = x - (min_disp + dd);  // candidate column in the target
  float v = 0.0f;
  if (y >= 0 && y < H && x >= 0 && x < W && t >= 0 && t < W) {
    const float* ref = planes + (long long)b * 6 * plane + (long long)yp * Wp;
    const float* tgt = ref + 3 * plane;
    float dsq = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float dl = __ldg(ref + c * plane + xp) - __ldg(tgt + c * plane + t + pad);
      dsq += dl * dl;
    }
    v = fminf(sqrtf(dsq), f_max);
  }
  vol[((long long)b * D + dd) * plane + (long long)yp * Wp + xp] = v;
}

// One thread a pixel, a (32, 8) block, frame blockIdx.z; window reads go
// to device memory (through L1) at ref + (y + i) * Wp + x + j, plane c at
// c * plane further, and the volume's likewise.
template <bool kNorm>
__global__ void __launch_bounds__(256) gsw_l1_kernel(
    const float* __restrict__ ref, long long ref_stride,
    const float* __restrict__ vol, long long vol_stride,
    int* __restrict__ disp, float* __restrict__ cost, int H, int W, int Hp,
    int Wp, int win, int step, int min_disp, int D, float gamma) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const int pad = win / 2;
  const long long gplane = (long long)Hp * Wp;
  const float* sref = ref + b * ref_stride;
  const float* svol = vol + b * vol_stride;

  float c0[3];
  const long long ctr = (long long)(y + pad) * Wp + x + pad;
#pragma unroll
  for (int c = 0; c < 3; ++c) c0[c] = sref[c * gplane + ctr];

  const int half = pad / step;
  const long long hw = (long long)H * W;
  float* out = cost == nullptr ? nullptr
                               : cost + (long long)b * D * hw + (long long)y * W + x;
  int best = 0;
  float bv = INFINITY;

  for (int d0 = 0; d0 < D; d0 += kChunkL1) {
    const int nd = min(kChunkL1, D - d0);
    const float* cvol = svol + (long long)d0 * gplane;
    const int dbase = min_disp + d0;
    float num[kChunkL1], den[kChunkL1];
#pragma unroll
    for (int k = 0; k < kChunkL1; ++k) {
      num[k] = 0.0f;
      den[k] = 0.0f;
    }

    for (int i = pad % step; i < win; i += step) {  // window row
      const int yw = y + i - pad;                     // its image row
      if (yw < 0 || yw >= H) continue;
      for (int m = 0; m <= 2 * half; ++m) {
        const int j = (m - half) * step + pad;  // window column
        const int xw = x + j - pad;             // its image column
        if (xw < 0 || xw >= W) continue;
        const long long q = (long long)(y + i) * Wp + x + j;
        float dsq = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float dl = sref[c * gplane + q] - c0[c];
          dsq += dl * dl;
        }
        const float w = expf(-sqrtf(dsq) / gamma);
#pragma unroll
        for (int k = 0; k < kChunkL1; ++k) {
          if (k < nd) {
            num[k] += w * cvol[k * gplane + q];
            if (kNorm) {
              const int t = xw - (dbase + k);
              if (t >= 0 && t < W) den[k] += w;
            }
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kChunkL1; ++k) {
      if (k < nd) {
        const int t = x - (dbase + k);
        float c = INFINITY;
        if (t >= 0 && t < W) c = kNorm ? num[k] / fmaxf(den[k], 1e-12f) : num[k];
        if (out != nullptr) out[(d0 + k) * hw] = c;
        if (d0 + k == 0 || c < bv) {
          bv = c;
          best = d0 + k;
        }
      }
    }
  }
  disp[(long long)b * hw + (long long)y * W + x] = best + min_disp;
}

template <int ND, bool kNorm>
cudaError_t prepare_tile(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      gsw_tile_kernel<ND, kNorm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gsw_tile_kernel<ND, kNorm>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int ND, bool kNorm>
cudaError_t launch_tile(dim3 grid, int smem, cudaStream_t s, const float* p,
                        long long p_stride, int* disp, float* cost, int H,
                        int W, int Hp, int Wp, int win, int step,
                        int min_disp, int D, float gamma, float f_max,
                        int ext) {
  const cudaError_t err = prepare_tile<ND, kNorm>(smem);
  if (err != cudaSuccess) return err;
  gsw_tile_kernel<ND, kNorm><<<grid, dim3(kTW, kTH), smem, s>>>(
      p, p_stride, disp, cost, H, W, Hp, Wp, win, step, min_disp, D, gamma,
      f_max, ext);
  return cudaGetLastError();
}

template <int ND, bool kNorm>
cudaError_t tile_occupancy(int smem, cudaFuncAttributes* attr, int* blocks) {
  cudaError_t err = prepare_tile<ND, kNorm>(smem);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(attr, gsw_tile_kernel<ND, kNorm>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, gsw_tile_kernel<ND, kNorm>, kThreads, smem);
  return err;
}

using TileFn = cudaError_t (*)(dim3, int, cudaStream_t, const float*,
                               long long, int*, float*, int, int, int, int,
                               int, int, int, int, float, float, int);
using OccFn = cudaError_t (*)(int, cudaFuncAttributes*, int*);

template <bool kNorm>
TileFn tile_fn(int nd) {
  return nd == 4 ? &launch_tile<4, kNorm>
         : nd == 8 ? &launch_tile<8, kNorm>
         : nd == 12 ? &launch_tile<12, kNorm>
         : nd == 16 ? &launch_tile<16, kNorm>
         : nullptr;
}

template <bool kNorm>
OccFn occ_fn(int nd) {
  return nd == 4 ? &tile_occupancy<4, kNorm>
         : nd == 8 ? &tile_occupancy<8, kNorm>
         : nd == 12 ? &tile_occupancy<12, kNorm>
         : nd == 16 ? &tile_occupancy<16, kNorm>
         : nullptr;
}

}  // namespace

// planes: (B, C, Hp, Wp) float32, C = 6 (BGR ref, BGR tgt) or, with
// ext_vol, 3 + D (BGR ref, then the caller's volume). disp: (B, H, W)
// int32. cost: (B, D, H, W) float32 or null. smem > 0 runs the tile kernel
// with `nd` (4, 8, 12 or 16) disparities a chunk and that much dynamic
// shared memory (B <= 65,535); smem == 0 the L1 path, which needs vol, a
// (B, D, Hp, Wp) scratch, unless ext_vol (B * D <= 65,535 without ext_vol).
extern "C" int gsw_pass(const void* planes, void* vol, void* disp, void* cost,
                        int B, int C, int H, int W, int Hp, int Wp, int win,
                        int step, int min_disp, int D, float gamma,
                        float f_max, int normalize, int ext_vol, int nd,
                        int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = (long long)Hp * Wp;
  const long long p_stride = (long long)C * plane;
  const float* p = static_cast<const float*>(planes);
  int* d = static_cast<int*>(disp);
  float* c = static_cast<float*>(cost);

  if (smem > 0) {
    const TileFn launch = normalize ? tile_fn<true>(nd) : tile_fn<false>(nd);
    if (launch == nullptr) return (int)cudaErrorInvalidValue;
    const dim3 grid((W + kTW - 1) / kTW, (H + kRows - 1) / kRows, B);
    return (int)launch(grid, smem, s, p, p_stride, d, c, H, W, Hp, Wp, win,
                       step, min_disp, D, gamma, f_max, ext_vol);
  }

  const dim3 block(32, 8);
  const float* v;
  long long v_stride;
  if (ext_vol) {
    v = p + 3 * plane;
    v_stride = p_stride;
  } else {
    if (vol == nullptr) return (int)cudaErrorInvalidValue;
    const dim3 grid_v((Wp + 31) / 32, (Hp + 7) / 8, B * D);
    gsw_volume_kernel<<<grid_v, block, 0, s>>>(
        p, static_cast<float*>(vol), H, W, Hp, Wp, min_disp, D, f_max);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    v = static_cast<const float*>(vol);
    v_stride = (long long)D * plane;
  }
  const dim3 grid((W + 31) / 32, (H + 7) / 8, B);
  if (normalize)
    gsw_l1_kernel<true><<<grid, block, 0, s>>>(p, p_stride, v, v_stride, d,
                                               c, H, W, Hp, Wp, win, step,
                                               min_disp, D, gamma);
  else
    gsw_l1_kernel<false><<<grid, block, 0, s>>>(p, p_stride, v, v_stride, d,
                                                c, H, W, Hp, Wp, win, step,
                                                min_disp, D, gamma);
  return (int)cudaGetLastError();
}

// Occupancy inputs of the tile kernel of `nd` disparities with that much
// dynamic shared memory: info = {registers a thread, local (spill) bytes a
// thread, blocks resident per SM}.
extern "C" int gsw_occupancy(int nd, int normalize, int smem, int device,
                             int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const OccFn query = normalize ? occ_fn<true>(nd) : occ_fn<false>(nd);
  if (query == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  int blocks = 0;
  err = query(smem, &attr, &blocks);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = blocks;
  return 0;
}

extern "C" const char* gsw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

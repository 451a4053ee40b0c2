// Geodesic Support-Weight matching kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel simplestereo_tpu/passive/gsw_pallas.py
// ::_gsw_kernel (line 99, launched by _gsw_pass_pallas). It computes what
// that kernel computes, not how: the row bands, lane rolls and unroll
// splits there were answers to the TPU compiler and are gone.
//
// gsw_volume_kernel: one thread per (frame, d, row, column) of the padded
// volume (B, D, Hp, Wp), a (32, 8) block:
//     vol_d(y, x) = min(fMax, sqrtf(sum_c (ref_c(y, x) - tgt_c(y, x - d))^2))
// with the channels summed in order 0, 1, 2, and 0 where x - d leaves
// [0, W-1] or (y, x) is padding. For 8-bit images every term and partial
// sum is an integer below 2^24, so the volume is exact, as in the twin.
//
// gsw_aggregate_kernel: one thread per (frame, y, x), a (32, 8) block. For
// each chunk of up to 16 disparities it walks the window-offset lattice
// (every `step`-th offset, anchored at the centre; row offset outer,
// column offset inner, so that neighbouring offsets are neighbouring
// addresses; the TPU kernel walks columns outer, and the sums differ from
// its order only in the last ulps), computes the support weight once per
// offset,
//     w = expf(-sqrtf(|BGR1(win) - BGR1(ctr)|^2) / gamma)
// (IEEE sqrtf and division, full-precision expf, no fast math: the argmin
// is sensitive to ulps), and keeps in registers
//     num_d += w * vol_d(win)      and, with normalize,
//     den_d += w  where 0 <= x_win - d <= W-1.
// A window pixel outside the image is skipped: it weighs exactly 0 for any
// gamma (the 1e6 sentinel of the planes alone gives 0 only while
// sqrt(3)*1e6/gamma > 104). The cost is num_d (num_d / max(den_d, 1e-12)
// with normalize), inf where the centre's candidate column x - d leaves
// the image; the first minimum wins (strict <, from d index 0, so an
// all-inf column gives index 0). The cost volume is written only when the
// caller passes a pointer. With ext_vol the volume is the caller's (the MI
// path) and only this kernel runs.
//
// What bounds it on this card: per (pixel, window offset) the weight takes
// an expf, a sqrtf, a division and ten flops; per (pixel, offset, d) one
// FMA and a cached load of the volume. At the main path (2 x 288 x 384
// pixels, 529 offsets, D = 11) that is 3.7 GFLOP against a few MB of
// device memory traffic: operations bound it (a 0.06 ms floor at 67
// TFLOP/s float32), and in practice the 14 reads per (pixel, offset) and
// the weight's IEEE sqrtf, division and expf. The design builds the
// volume once in device memory, then each block stages its tile (its
// 32 x 8 pixels and their windows) of BGR(ref) and of a chunk of volume
// planes in shared memory, so every window read is a shared-memory load,
// and keeps the D sums in registers. At win 23 the tile is 30 x 54 floats
// a plane; BGR(ref) and 11 volume planes take 91 KB, two blocks an SM.
// Up to win 65 two blocks fit an SM, up to win 101 one; a larger window
// (no tile with even one volume plane fits) reads device memory through
// L1 instead (kTile = false).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kChunk = 16;  // disparities summed in registers per walk
constexpr int kTW = 32;     // output tile of a block: kTW x kTH pixels
constexpr int kTH = 8;
// Shared memory for one block's tile: at most two blocks' worth per SM
// first, then one, else the window reads go to device memory.
constexpr size_t kTileBudgets[2] = {113 * 1024, 227 * 1024};

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

// Window reads come from `src`: window pixel (i, j) of thread (tx, ty) sits
// at src + (ty + i) * rs + tx + j, plane c at c * ps further.
template <bool kTile, bool kNorm>
__global__ void __launch_bounds__(kTW * kTH) gsw_aggregate_kernel(
    const float* __restrict__ ref, long long ref_stride,
    const float* __restrict__ vol, long long vol_stride,
    int* __restrict__ disp, float* __restrict__ cost, int H, int W, int Hp,
    int Wp, int win, int step, int min_disp, int D, int chunk, float gamma) {
  using Idx = typename std::conditional<kTile, int, long long>::type;
  extern __shared__ float tile[];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const int b = blockIdx.z;
  const bool active = x < W && y < H;
  const int pad = win / 2;
  const int R = kTH + 2 * pad;   // tile rows (padded coordinates y0 ..)
  const int Cw = kTW + 2 * pad;  // tile columns (padded coordinates x0 ..)
  const long long gplane = (long long)Hp * Wp;
  const float* gref = ref + b * ref_stride + (long long)y0 * Wp + x0;
  const float* gvol = vol + b * vol_stride + (long long)y0 * Wp + x0;
  const Idx rs = kTile ? Cw : Wp;
  const Idx ps = kTile ? (Idx)R * Cw : (Idx)gplane;
  const float* sref = kTile ? tile : gref;
  const float* svol = kTile ? tile + 3 * ps : gvol;

  // Copies planes [0, n) of g (device memory) into the tile at dst; rows
  // or columns past the planes' end read as 0 (never weighted).
  auto stage = [&](float* dst, const float* g, int n) {
    for (int c = 0; c < n; ++c)
      for (int r = ty; r < R; r += kTH)
        for (int col = tx; col < Cw; col += kTW)
          dst[c * R * Cw + r * Cw + col] =
              (y0 + r < Hp && x0 + col < Wp) ? __ldg(g + c * gplane + (long long)r * Wp + col)
                                             : 0.0f;
  };
  if constexpr (kTile) {
    stage(tile, gref, 3);
    __syncthreads();
  }

  float c0[3] = {0.0f, 0.0f, 0.0f};
  const Idx ctr = (Idx)(ty + pad) * rs + tx + pad;
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c) c0[c] = sref[c * ps + ctr];
  }

  const int half = pad / step;
  const long long hw = (long long)H * W;
  float* out = cost == nullptr ? nullptr
                               : cost + (long long)b * D * hw + (long long)y * W + x;
  int best = 0;
  float bv = INFINITY;

  for (int d0 = 0; d0 < D; d0 += chunk) {
    const int nd = min(chunk, D - d0);
    const float* cvol = svol;
    if constexpr (kTile) {
      __syncthreads();  // every read of the previous chunk is done
      stage(tile + 3 * ps, gvol + d0 * gplane, nd);
      __syncthreads();
    } else {
      cvol = svol + (Idx)d0 * ps;
    }
    if (!active) continue;

    const int dbase = min_disp + d0;
    float num[kChunk], den[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
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
        const Idx q = (Idx)(ty + i) * rs + tx + j;
        float dsq = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float dl = sref[c * ps + q] - c0[c];
          dsq += dl * dl;
        }
        const float w = expf(-sqrtf(dsq) / gamma);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (k < nd) {
            num[k] += w * cvol[k * ps + q];
            if (kNorm) {
              const int t = xw - (dbase + k);
              if (t >= 0 && t < W) den[k] += w;
            }
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
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
  if (active) disp[(long long)b * hw + (long long)y * W + x] = best + min_disp;
}

template <bool kTile, bool kNorm>
cudaError_t launch_aggregate(dim3 grid, size_t smem, cudaStream_t s,
                             const float* p, long long p_stride, const float* v,
                             long long v_stride, int* disp, float* cost, int H,
                             int W, int Hp, int Wp, int win, int step,
                             int min_disp, int D, int chunk, float gamma) {
  auto kernel = gsw_aggregate_kernel<kTile, kNorm>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, dim3(kTW, kTH), smem, s>>>(p, p_stride, v, v_stride, disp,
                                            cost, H, W, Hp, Wp, win, step,
                                            min_disp, D, chunk, gamma);
  return cudaGetLastError();
}

}  // namespace

// planes: (B, C, Hp, Wp) float32, C = 6 (BGR ref, BGR tgt) or, with
// ext_vol, 3 + D (BGR ref, then the caller's volume). vol: (B, D, Hp, Wp)
// scratch for the built volume (unused with ext_vol). disp: (B, H, W)
// int32. cost: (B, D, H, W) float32 or null.
extern "C" int gsw_pass(const void* planes, void* vol, void* disp, void* cost,
                        int B, int C, int H, int W, int Hp, int Wp, int win,
                        int step, int min_disp, int D, float gamma,
                        float f_max, int normalize, int ext_vol, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = (long long)Hp * Wp;
  const float* p = static_cast<const float*>(planes);
  const dim3 block(32, 8);

  const float* v;
  long long v_stride;
  if (ext_vol) {
    v = p + 3 * plane;
    v_stride = (long long)C * plane;
  } else {
    const dim3 grid_v((Wp + 31) / 32, (Hp + 7) / 8, B * D);
    gsw_volume_kernel<<<grid_v, block, 0, s>>>(
        p, static_cast<float*>(vol), H, W, Hp, Wp, min_disp, D, f_max);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    v = static_cast<const float*>(vol);
    v_stride = (long long)D * plane;
  }

  // The block's tile: its kTW x kTH pixels and their windows, BGR(ref) and
  // a chunk of the volume's planes, if it fits.
  const int pad = win / 2;
  const size_t tile_plane = (size_t)(kTH + 2 * pad) * (kTW + 2 * pad) * sizeof(float);
  int chunk = D < kChunk ? D : kChunk;
  size_t smem = 0;
  for (size_t budget : kTileBudgets) {
    const long long fit = (long long)(budget / tile_plane) - 3;
    if (fit >= 1) {
      chunk = chunk < fit ? chunk : (int)fit;
      smem = (3 + chunk) * tile_plane;
      break;
    }
  }
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  const long long p_stride = (long long)C * plane;
  int* d = static_cast<int*>(disp);
  float* c = static_cast<float*>(cost);
  if (smem > 0)
    err = normalize ? launch_aggregate<true, true>(grid, smem, s, p, p_stride, v, v_stride, d, c, H, W, Hp, Wp, win, step, min_disp, D, chunk, gamma)
                    : launch_aggregate<true, false>(grid, smem, s, p, p_stride, v, v_stride, d, c, H, W, Hp, Wp, win, step, min_disp, D, chunk, gamma);
  else
    err = normalize ? launch_aggregate<false, true>(grid, 0, s, p, p_stride, v, v_stride, d, c, H, W, Hp, Wp, win, step, min_disp, D, chunk, gamma)
                    : launch_aggregate<false, false>(grid, 0, s, p, p_stride, v, v_stride, d, c, H, W, Hp, Wp, win, step, min_disp, D, chunk, gamma);
  return (int)err;
}

extern "C" const char* gsw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Adaptive Support-Weight matching kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel simplestereo_tpu/passive/asw_pallas.py
// ::_asw_kernel (launched by _asw_pass). It computes what that kernel
// computes, not how: the lane rolls, band tiling and unroll splits there
// were answers to the TPU compiler and are gone.
//
// The cost volume (B, D, H, W) is num / den over the window-offset lattice
// (every `step`-th offset, anchored at the centre) of
//     e1  = expf(-sqrtf(|Lab1(win) - Lab1(ctr)|^2) * inv_gc) * prox[i][j]
//     e2  = expf(-sqrtf(|Lab2(win - d) - Lab2(ctr - d)|^2) * inv_gc)
//     tad = min(40, sum_c |BGR1(win) - BGR2(win - d)|)
//     num += e1 * e2 * tad;   den += e1 * e2
// with squared distances and the SAD summed over channels in order 0, 1, 2,
// IEEE sqrtf and full-precision expf (no fast math: the argmin is
// sensitive to ulps). The planes are padded (1e6 Lab sentinel, zero BGR)
// wide enough that every read of an active pixel is in bounds and an
// out-of-image window pixel weighs exactly 0. The cost is inf where the
// matched column x - d leaves [0, W-1]; den >= 1 for every valid
// candidate (the centre weighs exp(0) * exp(0)), so the division is safe.
//
// What bounds it on this card, and the design. Per (pixel, offset, d)
// triple the function needs e2 and tad, but neither depends on all three:
// e2 is a function of the target centre x - d and the offset, tad of the
// window pixel and d. The first version recomputed both per triple (an
// expf, a sqrtf and six cached loads each: 41 ms at 720p on an H100 SXM
// at 700 W, 38x its bound). asw_cost_tile_kernel factors them as the TPU
// kernel did (asw_pallas.py:195-217 and its wide strip, :228-285):
//   - A block owns a 32 x 8 tile of output pixels, one thread each, and a
//     chunk of ND = 4, 8 or 12 disparities (num, den in registers; the
//     kernel is compiled for each, so the inner loops carry no predicates;
//     a grid's last chunk computes its missing disparities on zeros and
//     never writes them). Chunks and frames ride the grid's z.
//   - It walks the lattice's window rows i in order. The 8 source rows
//     that row i covers sit in a ring of 8 row slots in shared memory:
//     Lab1 and Lab2 rows and the tad row band tad[col][d]. Each source row
//     is staged once per block (step 1: one new row per window row) with
//     cp.async, every word of it in flight at once, and its tad is computed
//     from its BGR rows in shared memory: once per (window pixel, d) for
//     the tile, not once per (output pixel, offset, d).
//   - For a group of window columns it evaluates e2 once per (target
//     centre, offset) over the tile's 32 + ND - 1 target columns into
//     shared memory: 1 + (32 + ND - 1) / 32 ~= 2.3 expf/sqrtf pairs per
//     (pixel, offset), against D + 1 = 12 before. A task (row, target
//     centre, half of the columns) keeps its centre in registers.
//   - e1 * prox stays once per (pixel, offset).
//   - The innermost step per triple is then one shared-memory load of e2,
//     a quarter of a 16-byte load of tad (tad[col][0..ND) is one run of
//     16-byte words, its row stride 4 x an odd number of words so a
//     quarter-warp's loads hit distinct banks), one multiply and two adds.
// What bounds it now (asw_variants.py, 720p win 35 D = 11, H100 SXM at
// 700 W: about 7.4 ms, 7x the 1.08 ms bound): the per-(pixel, offset) work,
// not the triples. Without the d loop the kernel still takes ~5.6 ms;
// staging alone ~0.9 ms; the IEEE sqrtf and expf sequences of e1 and e2
// (2.3 pairs per (pixel, offset), each a MUFU op and a range reduction)
// ~1.4 ms. Three or four blocks an SM, the e2 group size and unrolling
// change the time by less than the noise or make it worse.
// The launch plan (chunk, group of columns, bytes of shared memory) is
// chosen by the Python wrapper (asw_cuda._plan) so that three blocks of 8
// warps fit an SM where the window allows (70 KB at win 35, D = 11), else
// two, else one. Registers are capped at 80 for three blocks.
//
// asw_cost_l1_kernel: the first version, kept for a window too wide for
// any tile (win above ~700): one thread per pixel reading device memory
// through L1, 16 disparities per walk of the window.
//
// asw_select_kernel: one thread per (frame, y, x) over that volume. Left
// map = first argmin over d (strict <, from index 0, so an all-inf column
// gives index 0); optional csub = (c[best-1], c[best], c[best+1]), 0 where
// the neighbour does not exist; optional right map from the same volume,
// cost_R(x, d) = cost(x + d, d), inf where x + d leaves [0, W-1]. This is
// the cross-column step the TPU kernel did on a row band in VMEM; here
// the volume lives in device memory between the two launches (about 0.03
// ms of traffic at 720p).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTW = 32;  // output tile: kTW x kTH pixels, one per thread
constexpr int kTH = 8;   // a power of two: ring slot = tile row & (kTH - 1)
constexpr int kThreads = kTW * kTH;
constexpr int kSplit = 2;      // e2 tasks per (row, target centre)
constexpr int kChunkL1 = 16;   // disparities per window walk, L1 path
constexpr float kTadCap = 40.0f;

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

// ND disparities a block, in registers; a grid's last chunk may hold
// fewer real ones (nd): the rest are computed on zeros and never written.
template <int ND>
__global__ void __launch_bounds__(kThreads, 3) asw_cost_tile_kernel(
    const float* __restrict__ planes, const float* __restrict__ prox,
    float* __restrict__ cost, int H, int W, int Hp, int Wp, int x0, int win,
    int step, int min_disp, int D, int jg, int nchunks, float inv_gc) {
  // Floats of one window pixel's tad row: 4, or 12 = 4 x an odd number,
  // so that a quarter-warp's 16-byte loads at that stride hit distinct banks.
  constexpr int kDcp = ND <= 4 ? 4 : 12;
  constexpr int SW = kTW + ND - 1;  // target centres of the tile (strip)
  extern __shared__ float4 smem4[];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int cz = blockIdx.z % nchunks;
  const int b = blockIdx.z / nchunks;
  const int d0 = cz * ND;
  const int nd = min(ND, D - d0);
  const int dlo = min_disp + d0;
  const int dhi = dlo + ND - 1;
  const int X0 = blockIdx.x * kTW;
  const int Y0 = blockIdx.y * kTH;
  const int x = X0 + tx;
  const int y = Y0 + ty;
  const bool active = x < W && y < H;
  const int pad = win / 2;
  const int half = pad / step;
  const int nl = 2 * half + 1;  // lattice offsets per axis
  const int i0 = pad - half * step;

  // Tile column col <-> image column X0 - pad + col; strip column sc <->
  // target centre X0 - dhi + sc; Lab2 ring column col <-> image column
  // X0 - dhi - pad + col. Tile row r <-> plane row Y0 + r.
  const int CW = kTW + 2 * pad;
  const int CW2 = SW + 2 * pad;
  float* tad = reinterpret_cast<float*>(smem4);  // [slot][CW][kDcp]
  float* lab1 = tad + kTH * CW * kDcp;           // [slot][3][CW]
  float* lab2 = lab1 + 3 * kTH * CW;             // [slot][3][CW2]
  float* lab2c = lab2 + 3 * kTH * CW2;           // [3][kTH][SW]
  float* bgr1s = lab2c + 3 * kTH * SW;           // [3][CW]: the new row
  float* bgr2s = bgr1s + 3 * CW;                 // [3][CWb]
  float* proxs = bgr2s + 3 * (CW + ND - 1);      // [nl]: window row i
  float* e2s = proxs + nl;                       // [jg][kTH][SW]

  const long long P = (long long)Hp * Wp;
  const float* lab1g = planes + (long long)b * 12 * P;
  const float* lab2g = lab1g + 3 * P;
  const float* bgr1g = lab1g + 6 * P;
  const float* bgr2g = lab1g + 9 * P;
  const int c1o = X0 + x0 - pad;        // plane column of tile column 0
  const int c2o = X0 - dhi + x0 - pad;  // plane column of Lab2 ring column 0

  // Lab2 at the tile's target centres (rows Y0 .. Y0 + kTH - 1), 0 off
  // the planes.
  for (int e = tid; e < 3 * kTH * SW; e += kThreads) {
    const int c = e / (kTH * SW);
    const int rem = e - c * kTH * SW;
    const int r = rem / SW;
    const int prow = Y0 + r + pad;
    const int pcol = c2o + pad + rem - r * SW;
    lab2c[e] = (prow < Hp && pcol >= 0 && pcol < Wp)
                   ? __ldg(lab2g + c * P + (long long)prow * Wp + pcol)
                   : 0.0f;
  }
  float c1[3] = {0.0f, 0.0f, 0.0f};
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      c1[c] = __ldg(lab1g + c * P + (long long)(y + pad) * Wp + x0 + x);
  }

  float num[ND], den[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    num[k] = 0.0f;
    den[k] = 0.0f;
  }

  int staged_to = 0;  // tile rows [.., staged_to) are in the ring
  for (int li = 0; li < nl; ++li) {
    const int i = i0 + li * step;
    const int rlo = li == 0 ? i : max(i, staged_to);
    const int rhi = i + kTH;
    staged_to = rhi;
    __syncthreads();  // the previous window row's reads are done

    // Stage tile rows [rlo, rhi) into their ring slots, and prox of row
    // i: every word of a row is copied asynchronously, all in flight at
    // once; a read outside the planes (a ragged tile's inactive pixels, or
    // a disparity past the last) stages 0. Then tad of the row from its
    // BGR rows in shared memory: tad(col, k) pairs BGR1 at tile column col
    // with BGR2 at plane column c1o + col - (dlo + k), which is bgr2s
    // column col + ND - 1 - k.
    const int CWb = CW + ND - 1;
    for (int m = tid; m < nl; m += kThreads)
      copy_async(proxs + m, prox + i * win + (m - half) * step + pad, true);
    for (int r = rlo; r < rhi; ++r) {
      const int prow = Y0 + r;
      const int slot = r & (kTH - 1);
      const bool rok = prow < Hp;
      const long long roff = (long long)(rok ? prow : 0) * Wp;
      for (int e = tid; e < 3 * CW; e += kThreads) {
        const int c = e / CW;
        const int pcol = c1o + e - c * CW;
        const bool ok = rok && pcol < Wp;
        const long long g = c * P + roff + (ok ? pcol : 0);
        copy_async(lab1 + slot * 3 * CW + e, lab1g + g, ok);
        copy_async(bgr1s + e, bgr1g + g, ok);
      }
      for (int e = tid; e < 3 * CW2; e += kThreads) {
        const int c = e / CW2;
        const int pcol = c2o + e - c * CW2;
        const bool ok = rok && pcol >= 0 && pcol < Wp;
        copy_async(lab2 + slot * 3 * CW2 + e, lab2g + c * P + roff + (ok ? pcol : 0), ok);
      }
      for (int e = tid; e < 3 * CWb; e += kThreads) {
        const int c = e / CWb;
        const int pcol = c1o - dhi + e - c * CWb;
        const bool ok = rok && pcol >= 0 && pcol < Wp;
        copy_async(bgr2s + e, bgr2g + c * P + roff + (ok ? pcol : 0), ok);
      }
      copy_wait();
      __syncthreads();
      float* trow = tad + slot * CW * kDcp;
      for (int e = tid; e < CW * ND; e += kThreads) {
        const int col = e / ND;
        const int k = e - col * ND;
        float sad = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          sad += fabsf(bgr1s[c * CW + col] - bgr2s[c * CWb + col + ND - 1 - k]);
        trow[col * kDcp + k] = fminf(sad, kTadCap);
      }
      __syncthreads();  // the BGR rows are free again; the ring is staged
    }

    for (int m0 = 0; m0 < nl; m0 += jg) {
      const int gn = min(jg, nl - m0);
      if (m0 > 0) __syncthreads();  // the previous group's e2 reads are done

      // e2 of window columns m0 .. m0 + gn - 1 at every target centre:
      // task (h, r, sc) takes the columns m0 + h, m0 + h + kSplit, ...
      for (int t = tid; t < kSplit * kTH * SW; t += kThreads) {
        const int h = t / (kTH * SW);
        const int p = t - h * kTH * SW;
        const int r = p / SW;
        const int sc = p - r * SW;
        float cc[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) cc[c] = lab2c[(c * kTH + r) * SW + sc];
        const float* w2 = lab2 + ((r + i) & (kTH - 1)) * 3 * CW2 + sc +
                          (m0 + h - half) * step + pad;
        float* dst = e2s + h * kTH * SW + p;
        for (int jj = h; jj < gn; jj += kSplit) {
          float dsq = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float dl = w2[c * CW2] - cc[c];
            dsq += dl * dl;
          }
          *dst = expf(-sqrtf(dsq) * inv_gc);
          w2 += kSplit * step;
          dst += kSplit * kTH * SW;
        }
      }
      __syncthreads();

      if (active) {
        const int slot = (ty + i) & (kTH - 1);
        const int j0 = (m0 - half) * step + pad;
        const float* l1 = lab1 + slot * 3 * CW + tx + j0;
        const float4* t4 =
            reinterpret_cast<const float4*>(tad + (slot * CW + tx + j0) * kDcp);
        // e2 of disparity index k (target centre x - dlo - k) at e2p[-k].
        const float* e2p = e2s + ty * SW + tx + ND - 1;
        for (int jj = 0; jj < gn; ++jj) {
          float dsq = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float dl = l1[c * CW] - c1[c];
            dsq += dl * dl;
          }
          const float e1 = expf(-sqrtf(dsq) * inv_gc) * proxs[m0 + jj];
#pragma unroll
          for (int q = 0; q < ND / 4; ++q) {
            const float4 t = t4[q];
            const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const float w = e1 * e2p[-(4 * q + s)];
              num[4 * q + s] += w * tv[s];
              den[4 * q + s] += w;
            }
          }
          l1 += step;
          t4 += step * (kDcp / 4);
          e2p += kTH * SW;
        }
      }
    }
  }

  if (active) {
    const long long hw = (long long)H * W;
    float* out = cost + ((long long)b * D + d0) * hw + (long long)y * W + x;
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      if (k < nd) {
        const int t = x - (dlo + k);
        out[k * hw] = (t >= 0 && t < W) ? num[k] / den[k] : INFINITY;
      }
    }
  }
}

// Two blocks per SM: caps registers at 128 (from 160 uncapped, which
// left one block of 8 warps per SM); 1.4-1.5x faster, bit-equal results.
__global__ void __launch_bounds__(256, 2) asw_cost_l1_kernel(
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

  for (int d0 = 0; d0 < D; d0 += kChunkL1) {
    const int nd = min(kChunkL1, D - d0);
    const int dbase = min_disp + d0;
    float num[kChunkL1], den[kChunkL1], c2[kChunkL1][3];
#pragma unroll
    for (int k = 0; k < kChunkL1; ++k) {
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
        for (int k = 0; k < kChunkL1; ++k) {
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
    for (int k = 0; k < kChunkL1; ++k) {
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

// Dynamic shared memory above the 48 KB default, and the SM's unified
// L1/shared storage carved out for shared memory.
template <int ND>
cudaError_t prepare_tile(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      asw_cost_tile_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(asw_cost_tile_kernel<ND>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int ND>
cudaError_t launch_tile(dim3 grid, int smem, cudaStream_t s, const float* p,
                        const float* w, float* c, int H, int W, int Hp, int Wp,
                        int x0, int win, int step, int min_disp, int D, int jg,
                        int nchunks, float inv_gc) {
  const cudaError_t err = prepare_tile<ND>(smem);
  if (err != cudaSuccess) return err;
  asw_cost_tile_kernel<ND><<<grid, dim3(kTW, kTH), smem, s>>>(
      p, w, c, H, W, Hp, Wp, x0, win, step, min_disp, D, jg, nchunks, inv_gc);
  return cudaGetLastError();
}

template <int ND>
cudaError_t tile_occupancy(int smem, cudaFuncAttributes* attr, int* blocks) {
  cudaError_t err = prepare_tile<ND>(smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(attr, asw_cost_tile_kernel<ND>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, asw_cost_tile_kernel<ND>, kThreads, smem);
  return err;
}

}  // namespace

// The launch plan comes from the caller (asw_cuda._plan): smem > 0 runs
// the tile kernel with `chunk` (4, 8 or 12) disparities a block and e2
// groups of `jg` window columns; smem == 0 the L1 kernel.
extern "C" int asw_pass(const void* planes, const void* prox, void* cost,
                        void* dispL, void* dispR, void* csub, int B, int H,
                        int W, int Hp, int Wp, int x0, int win, int step,
                        int min_disp, int D, float inv_gc, int chunk, int jg,
                        int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kTW, kTH);
  const float* p = static_cast<const float*>(planes);
  const float* w = static_cast<const float*>(prox);
  float* c = static_cast<float*>(cost);
  if (smem > 0) {
    if (jg < 1) return (int)cudaErrorInvalidValue;
    const int nchunks = (D + chunk - 1) / chunk;
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B * nchunks);
    auto launch = chunk == 4 ? &launch_tile<4>
                  : chunk == 8 ? &launch_tile<8>
                  : chunk == 12 ? &launch_tile<12>
                  : nullptr;
    if (launch == nullptr) return (int)cudaErrorInvalidValue;
    err = launch(grid, smem, s, p, w, c, H, W, Hp, Wp, x0, win, step,
                 min_disp, D, jg, nchunks, inv_gc);
  } else {
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    asw_cost_l1_kernel<<<grid, block, 0, s>>>(p, w, c, H, W, Hp, Wp, x0, win,
                                              step, min_disp, D, inv_gc);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  asw_select_kernel<<<grid, block, 0, s>>>(
      c, static_cast<int*>(dispL), static_cast<int*>(dispR),
      static_cast<float*>(csub), H, W, min_disp, D);
  return (int)cudaGetLastError();
}

// Occupancy inputs of the cost kernel that a plan launches (smem > 0: the
// tile kernel of `chunk` disparities with that much dynamic shared
// memory; 0: the L1 kernel): info = {registers a thread, local (spill)
// bytes a thread, blocks resident per SM}.
extern "C" int asw_occupancy(int chunk, int smem, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  int blocks = 0;
  if (smem > 0) {
    auto query = chunk == 4 ? &tile_occupancy<4>
                 : chunk == 8 ? &tile_occupancy<8>
                 : chunk == 12 ? &tile_occupancy<12>
                 : nullptr;
    if (query == nullptr) return (int)cudaErrorInvalidValue;
    err = query(smem, &attr, &blocks);
  } else {
    err = cudaFuncGetAttributes(&attr, asw_cost_l1_kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, asw_cost_l1_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = blocks;
  return 0;
}

extern "C" const char* asw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

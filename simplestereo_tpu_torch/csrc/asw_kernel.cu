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
// asw_cost_tile_kernel_wide: D above one chunk of 12. The tile kernel's
// chunks share nothing, so at D = 90 (example 009: win 35, step 2, 720p)
// eight of them redo the staging, the tad ring, e1 and e2: 17.4 ms
// (asw_variants.py, H100 SXM at 700 W), 11x the 1.54 ms bound. The wide
// kernel walks the window once for a chunk of 32, 64 or 96 disparities
// (8 groups of NG = 4, 8 or 12):
//   - A block owns a 32 x 4 tile: the tad ring of 96 disparities fills
//     ~107 KB at win 35, so one block of 16 warps an SM. A warp holds one
//     group and two tile rows, a thread the pixels xa and xa + step of a
//     row: xa + step's tad column is xa's at the next lattice column, so
//     one 16-byte tad load a column serves both, and their e2 runs overlap
//     but for `step` values. Shared-memory traffic per (pixel, offset, d)
//     falls from 2 wavefronts (a pixel a thread) to ~1.2.
//   - e2 once per (target centre, offset) over the 32 + DP - 1 centres
//     (~4 expf/sqrtf pairs per (pixel, offset) at DP = 96, against ~10.8
//     for eight chunks), e1 x prox once per (pixel, offset); a task keeps
//     its centre in registers over every kWSplit-th column.
//   - tad is built by warps of 32 disparities of one column (BGR1 read as
//     one word, BGR2 as consecutive words), 4 columns at once, in the same
//     phase as the first group's e1 and e2; the next window row's source
//     rows are copied in while the last group is summed. Two barriers a
//     window row.
//   - tad rows are 4 step floats longer every 2 step columns and e1 and e2
//     rows = step mod 2 step floats long, so each load of a warp's pairs
//     hits distinct banks. It is compiled for steps 1 and 2 (pairs tile 32
//     columns for a step that divides 16, and a pair's e2 run is indexed at
//     compile time); other steps take the tile kernel's chunks.
// Every disparity sums the same terms in the same order with the same
// float expressions as in asw_cost_tile_kernel, so the volume, the maps
// and csub equal the chunks' bit for bit. At the cell's shape it takes
// ~11.2 ms: the sums ~3.9 ms, e1 and e2 ~2.8 (their expf/sqrtf ~1.4), tad
// ~1.7, the rest (staging, barriers, writes) ~2.8. Building the next
// group's e1 and e2 inside the sums' loop was slower (15.6 ms: the sums'
// code got worse), as were 32 x 2 tiles at two blocks an SM (13.4 ms).
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
constexpr int kWTH = 4;        // wide tile: kTW x kWTH pixels, a power of two
constexpr int kGroups = 8;     // disparity groups of a wide block
constexpr int kWThreads = kTW * kWTH * kGroups / 2;  // a thread: 2 pixels
constexpr int kWBlocks = 1;    // wide blocks an SM
constexpr int kWSplit = 4;     // e1/e2 tasks per (row, pixel or centre)
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

// DP = 8 x NG disparities a block on the lattice of step S (see the notes
// at the head of this file): a thread the pixels xa and xa + S of one
// tile row and a group of NG disparities, num and den in registers.
template <int NG, int S>
__global__ void __launch_bounds__(kWThreads, kWBlocks) asw_cost_tile_kernel_wide(
    const float* __restrict__ planes, const float* __restrict__ prox,
    float* __restrict__ cost, int H, int W, int Hp, int Wp, int x0, int win,
    int step, int min_disp, int D, int jg, int nchunks, float inv_gc) {
  constexpr int DP = kGroups * NG;
  // Floats of one window pixel's tad row: 4 x an odd number >= DP; every
  // 2S columns 4S floats more, so a quarter-warp's 16-byte loads of its 8
  // pairs' columns hit distinct banks.
  constexpr int kDcp = (DP / 4) % 2 ? DP : DP + 4;
  constexpr int SW = kTW + DP - 1;  // target centres of the tile
  // Row strides of e1 and e2, = S mod 2S: a warp's two rows of pairs hit
  // distinct banks.
  constexpr int kE1 = kTW + S;
  constexpr int kE2 = SW + (S - SW % (2 * S) + 2 * S) % (2 * S);
  constexpr int kTasks = kWTH * (SW + kTW);  // e2 and e1 of one column
  constexpr int kTadCols = kWThreads / DP;   // tad columns built at once
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.y * kTW + threadIdx.x;
  const int g = threadIdx.y / (kWTH / 2);
  const int ty = threadIdx.y % (kWTH / 2) * 2 + (threadIdx.x >> 4);
  const int pa = threadIdx.x & 15;
  const int bx = pa / S * 2 * S + pa % S;  // tile column of xa
  const int cz = blockIdx.z % nchunks;
  const int b = blockIdx.z / nchunks;
  const int d0 = cz * DP;
  const int dhi = min_disp + d0 + DP - 1;
  const int X0 = blockIdx.x * kTW;
  const int Y0 = blockIdx.y * kWTH;
  const int xa = X0 + bx;
  const int y = Y0 + ty;
  const int pad = win / 2;
  const int half = pad / S;
  const int nl = 2 * half + 1;
  const int i0 = pad - half * S;

  // Columns as in asw_cost_tile_kernel; tile row r <-> plane row Y0 + r.
  const int CW = kTW + 2 * pad;
  const int CW2 = SW + 2 * pad;
  const int CWb = CW + DP - 1;
  const int TS = CW * kDcp + (CW - 1) / (2 * S) * 4 * S;  // floats a slot
  float* tad = reinterpret_cast<float*>(smem4);  // [slot][TS]
  float* lab1 = tad + kWTH * TS;                 // [slot][3][CW]
  float* lab2 = lab1 + 3 * kWTH * CW;            // [slot][3][CW2]
  float* lab1c = lab2 + 3 * kWTH * CW2;          // [3][kWTH][kTW]
  float* lab2c = lab1c + 3 * kWTH * kTW;         // [3][kWTH][SW]
  float* bgr1s = lab2c + 3 * kWTH * SW;          // [new row][3][CW]
  float* bgr2s = bgr1s + 3 * kWTH * CW;          // [new row][3][CWb]
  float* proxs = bgr2s + 3 * kWTH * CWb;         // [nl]: window row i
  float* e1s = proxs + nl;                       // [jg][kWTH][kE1]
  float* e2s = e1s + jg * kWTH * kE1;            // [jg][kWTH][kE2]
  // Offset in a tad slot of tile column col's row.
  auto tcol = [](int col) { return col * kDcp + col / (2 * S) * (4 * S); };

  const long long P = (long long)Hp * Wp;
  const float* lab1g = planes + (long long)b * 12 * P;
  const float* lab2g = lab1g + 3 * P;
  const float* bgr1g = lab1g + 6 * P;
  const float* bgr2g = lab1g + 9 * P;
  const int c1o = X0 + x0 - pad;
  const int c2o = X0 - dhi + x0 - pad;

  // Lab1 at the tile's pixels and Lab2 at its target centres, 0 off the
  // planes.
  for (int e = tid; e < 3 * kWTH * kTW; e += kWThreads) {
    const int c = e / (kWTH * kTW);
    const int rem = e - c * kWTH * kTW;
    const int r = rem / kTW;
    const int prow = Y0 + r + pad;
    const int pcol = c1o + pad + rem - r * kTW;
    lab1c[e] = (prow < Hp && pcol < Wp)
                   ? __ldg(lab1g + c * P + (long long)prow * Wp + pcol)
                   : 0.0f;
  }
  for (int e = tid; e < 3 * kWTH * SW; e += kWThreads) {
    const int c = e / (kWTH * SW);
    const int rem = e - c * kWTH * SW;
    const int r = rem / SW;
    const int prow = Y0 + r + pad;
    const int pcol = c2o + pad + rem - r * SW;
    lab2c[e] = (prow < Hp && pcol >= 0 && pcol < Wp)
                   ? __ldg(lab2g + c * P + (long long)prow * Wp + pcol)
                   : 0.0f;
  }

  // Copy tile rows [rlo, rhi) into their ring slots and the BGR rows, and
  // prox of window row i; a read outside the planes stages 0. Element e
  // of a row of 3 channels of n columns is in channel (e >= n) + (e >= 2n).
  auto stage = [&](int i, int rlo, int rhi) {
    for (int m = tid; m < nl; m += kWThreads)
      copy_async(proxs + m, prox + i * win + (m - half) * S + pad, true);
    for (int r = rlo; r < rhi; ++r) {
      const int nr = r - rlo;
      const int slot = r & (kWTH - 1);
      const bool rok = Y0 + r < Hp;
      const long long roff = (long long)(rok ? Y0 + r : 0) * Wp;
      for (int e = tid; e < 3 * CW; e += kWThreads) {
        const int c = (e >= CW) + (e >= 2 * CW);
        const int pcol = c1o + e - c * CW;
        const bool ok = rok && pcol < Wp;
        const long long gi = c * P + roff + (ok ? pcol : 0);
        copy_async(lab1 + slot * 3 * CW + e, lab1g + gi, ok);
        copy_async(bgr1s + nr * 3 * CW + e, bgr1g + gi, ok);
      }
      for (int e = tid; e < 3 * CW2; e += kWThreads) {
        const int c = (e >= CW2) + (e >= 2 * CW2);
        const int pcol = c2o + e - c * CW2;
        const bool ok = rok && pcol >= 0 && pcol < Wp;
        copy_async(lab2 + slot * 3 * CW2 + e,
                   lab2g + c * P + roff + (ok ? pcol : 0), ok);
      }
      for (int e = tid; e < 3 * CWb; e += kWThreads) {
        const int c = (e >= CWb) + (e >= 2 * CWb);
        const int pcol = c1o - dhi + e - c * CWb;
        const bool ok = rok && pcol >= 0 && pcol < Wp;
        copy_async(bgr2s + nr * 3 * CWb + e,
                   bgr2g + c * P + roff + (ok ? pcol : 0), ok);
      }
    }
  };

  float num[2][NG], den[2][NG];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      num[p][k] = 0.0f;
      den[p][k] = 0.0f;
    }
  }

  int rlo = i0, rhi = i0 + kWTH;  // the rows staged for the next window row
  stage(i0, rlo, rhi);
  for (int li = 0; li < nl; ++li) {
    const int i = i0 + li * S;
    copy_wait();
    __syncthreads();  // the rows are in; the previous row's sums are done

    // tad of the new rows: tad(col, k) pairs BGR1 at tile column col with
    // BGR2 at bgr2s column col + DP - 1 - k. Thread (k, c0) takes the
    // columns c0, c0 + kTadCols, ...: a warp holds one column and 32
    // disparities.
    if (tid < kTadCols * DP) {
      const int k = tid % DP;
      const int c0 = tid / DP;
      for (int r = rlo; r < rhi; ++r) {
        const float* b1 = bgr1s + (r - rlo) * 3 * CW;
        const float* b2 = bgr2s + (r - rlo) * 3 * CWb + DP - 1 - k;
        float* trow = tad + (r & (kWTH - 1)) * TS + k;
#pragma unroll 4
        for (int col = c0; col < CW; col += kTadCols) {
          float sad = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            sad += fabsf(b1[c * CW + col] - b2[c * CWb + col]);
          trow[tcol(col)] = fminf(sad, kTadCap);
        }
      }
    }

    for (int mg = 0; mg < nl; mg += jg) {
      const int gn = min(jg, nl - mg);
      // The first group's e1 and e2 are built beside tad (neither reads
      // the other); a later group's wait for the previous group's reads.
      if (mg > 0) __syncthreads();

      // e2 of window columns mg .. mg + gn - 1 at every target centre
      // (s < SW) and e1 x prox at every pixel (s >= SW): task (h, r, s)
      // takes the columns mg + h, mg + h + kWSplit, ... with its centre in
      // registers.
      for (int t = tid; t < kWSplit * kTasks; t += kWThreads) {
        const int h = t / kTasks;
        const int p = t - h * kTasks;
        const int r = p / (SW + kTW);
        const int s = p - r * (SW + kTW);
        const int slot = (r + i) & (kWTH - 1);
        const bool is2 = s < SW;
        const float* wp = (is2 ? lab2 + slot * 3 * CW2 + s
                               : lab1 + slot * 3 * CW + s - SW) +
                          (mg + h - half) * S + pad;
        const float* cp = is2 ? lab2c + r * SW + s : lab1c + r * kTW + s - SW;
        const int ws = is2 ? CW2 : CW;
        const int cs = is2 ? kWTH * SW : kWTH * kTW;
        float* dst = is2 ? e2s + r * kE2 + s : e1s + r * kE1 + s - SW;
        const int dstep = kWSplit * kWTH * (is2 ? kE2 : kE1);
        dst += h * kWTH * (is2 ? kE2 : kE1);
        float cc[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) cc[c] = cp[c * cs];
        for (int jj = h; jj < gn; jj += kWSplit) {
          float dsq = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float dl = wp[c * ws] - cc[c];
            dsq += dl * dl;
          }
          const float ew = expf(-sqrtf(dsq) * inv_gc);
          *dst = is2 ? ew : ew * proxs[mg + jj];
          wp += kWSplit * S;
          dst += dstep;
        }
      }
      __syncthreads();

      if (mg + gn == nl && li + 1 < nl) {
        // The rings, the BGR rows and prox are read no more for row i.
        rlo = max(i + S, rhi);
        rhi = i + S + kWTH;
        stage(i + S, rlo, rhi);
      }

      if (y < H && xa < W) {
        const float* trow = tad + ((ty + i) & (kWTH - 1)) * TS + g * NG;
        int col = bx + (mg - half) * S + pad;  // xa's window column
        const float* e1p = e1s + ty * kE1 + bx;
        // e2 of the group's disparity k at xa + S's target centre is
        // e2p[-k], at xa's e2p[-S - k].
        const float* e2p = e2s + ty * kE2 + bx + S + DP - 1 - g * NG;
        float4 ta[NG / 4];  // tad of xa's window column
#pragma unroll
        for (int q = 0; q < NG / 4; ++q)
          ta[q] = reinterpret_cast<const float4*>(trow + tcol(col))[q];
        for (int jj = 0; jj < gn; ++jj) {
          col += S;
          float4 tb[NG / 4];  // of xa + S's: xa's at the next column
#pragma unroll
          for (int q = 0; q < NG / 4; ++q)
            tb[q] = reinterpret_cast<const float4*>(trow + tcol(col))[q];
          const float e1a = e1p[0];
          const float e1b = e1p[S];
          float e2v[NG + S];
#pragma unroll
          for (int m = 0; m < NG + S; ++m) e2v[m] = e2p[-m];
#pragma unroll
          for (int q = 0; q < NG / 4; ++q) {
            const float va[4] = {ta[q].x, ta[q].y, ta[q].z, ta[q].w};
            const float vb[4] = {tb[q].x, tb[q].y, tb[q].z, tb[q].w};
#pragma unroll
            for (int s4 = 0; s4 < 4; ++s4) {
              const int k = 4 * q + s4;
              const float wa = e1a * e2v[k + S];
              num[0][k] += wa * va[s4];
              den[0][k] += wa;
              const float wb = e1b * e2v[k];
              num[1][k] += wb * vb[s4];
              den[1][k] += wb;
            }
            ta[q] = tb[q];
          }
          e1p += kWTH * kE1;
          e2p += kWTH * kE2;
        }
      }
    }
  }

  if (y < H) {
    const long long hw = (long long)H * W;
    const int kg = d0 + g * NG;  // the group's first disparity index
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int x = xa + p * S;
      if (x < W) {
        float* out = cost + ((long long)b * D + kg) * hw + (long long)y * W + x;
#pragma unroll
        for (int k = 0; k < NG; ++k) {
          if (kg + k < D) {
            const int t = x - (min_disp + kg + k);
            out[k * hw] = (t >= 0 && t < W) ? num[p][k] / den[p][k] : INFINITY;
          }
        }
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

using CostFn = void (*)(const float*, const float*, float*, int, int, int,
                       int, int, int, int, int, int, int, int, float);

// A tile kernel, its block and the output rows of its tile.
struct TileKernel {
  CostFn fn;
  dim3 block;
  int rows;
};

// The wide kernel of NG disparities a group on the lattice of `step`:
// null but at step 1 or 2.
template <int NG>
CostFn wide_kernel(int step) {
  if (step == 1) return &asw_cost_tile_kernel_wide<NG, 1>;
  if (step == 2) return &asw_cost_tile_kernel_wide<NG, 2>;
  return nullptr;
}

// The tile kernel that keeps `chunk` disparities a block: 4, 8 or 12 on a
// 32 x 8 tile, or 32, 64 or 96 in 8 groups on a 32 x 4 tile (wide_kernel);
// fn is null for any other.
TileKernel tile_kernel(int chunk, int step) {
  const dim3 tile(kTW, kTH), wide(kTW, kWThreads / kTW);
  switch (chunk) {
    case 4: return {asw_cost_tile_kernel<4>, tile, kTH};
    case 8: return {asw_cost_tile_kernel<8>, tile, kTH};
    case 12: return {asw_cost_tile_kernel<12>, tile, kTH};
    case 32: return {wide_kernel<4>(step), wide, kWTH};
    case 64: return {wide_kernel<8>(step), wide, kWTH};
    case 96: return {wide_kernel<12>(step), wide, kWTH};
    default: return {nullptr, tile, kTH};
  }
}

// Dynamic shared memory above the 48 KB default, and the SM's unified
// L1/shared storage carved out for shared memory.
cudaError_t prepare_tile(CostFn fn, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// The launch plan comes from the caller (asw_cuda._plan): smem > 0 runs
// the tile kernel of `chunk` disparities a block at `step` (tile_kernel)
// with e2 groups of `jg` window columns; smem == 0 the L1 kernel.
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
    const TileKernel k = tile_kernel(chunk, step);
    if (jg < 1 || k.fn == nullptr) return (int)cudaErrorInvalidValue;
    const int nchunks = (D + chunk - 1) / chunk;
    const dim3 grid((W + kTW - 1) / kTW, (H + k.rows - 1) / k.rows,
                    B * nchunks);
    err = prepare_tile(k.fn, smem);
    if (err != cudaSuccess) return (int)err;
    k.fn<<<grid, k.block, smem, s>>>(p, w, c, H, W, Hp, Wp, x0, win, step,
                                     min_disp, D, jg, nchunks, inv_gc);
  } else {
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    asw_cost_l1_kernel<<<grid, block, 0, s>>>(p, w, c, H, W, Hp, Wp, x0, win,
                                              step, min_disp, D, inv_gc);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  asw_select_kernel<<<grid, block, 0, s>>>(
      c, static_cast<int*>(dispL), static_cast<int*>(dispR),
      static_cast<float*>(csub), H, W, min_disp, D);
  return (int)cudaGetLastError();
}

// Occupancy inputs of the cost kernel that a plan launches (smem > 0: the
// tile kernel of `chunk` disparities, at `step` for a wide chunk, with
// that much dynamic shared memory; 0: the L1 kernel): info = {registers a
// thread, local (spill) bytes a thread, blocks resident per SM}.
extern "C" int asw_occupancy(int chunk, int step, int smem, int device,
                             int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  int blocks = 0;
  if (smem > 0) {
    const TileKernel k = tile_kernel(chunk, step);
    if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
    err = prepare_tile(k.fn, smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k.fn);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, k.fn, (int)(k.block.x * k.block.y * k.block.z), smem);
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

// Per-plane dynamic roll kernel (K4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of benchmarks/probe_dynamic_rotate.py
// (make(mode).run): a hardware probe that rolls each d-plane of a
// (D, TH, W) float32 block along W by an amount known only at run time.
// ASW's consistent mode rests on that roll: the right-reference cost is
// cost_R(x, d) = cost(x + d, d), the left volume's plane d rolled by -d.
// On the TPU a negative amount tied to the loop variable mis-rotated by a
// lane tile; the probe pins which amount forms are exact.
//
// rotate_planes_kernel computes, for an (N, R, W) float32 volume,
//     out[n, r, c] = x[n, r, (c - s[n]) mod W],   result in [0, W),
// which is torch.roll(x[n], s[n], dims=-1). The amounts s are int32 in
// device memory, read at run time, so the compiler cannot fold them. C's
// `%` truncates toward zero: (c - s) % W is negative whenever s > c, the
// counterpart here of the TPU's negative-amount trap. The kernel reduces
// each row's amount once, s % W into (-W, W) and then into [0, W), so
// c - s lies in (-W, W) and one conditional add of W brings it into
// [0, W): every amount, negative or larger than W, INT_MIN and INT_MAX
// included, is exact, and the index arithmetic stays in 32 bits (c - s
// itself could overflow for s near INT_MIN). Only a row's base offset is
// 64-bit.
//
// What bounds it on this card: it moves bytes and computes nothing. Each
// input element is read once and each output written once, so the bound
// is 2 * 4 * N * R * W bytes over the memory rate: 0.125 us for the
// probe's (17, 8, 384) block, about 24 us for an 11 x 720 x 1280 volume.
// What reaches that rate is bytes in flight: 16-byte accesses and several
// KB outstanding per SM, with no per-element division. The design:
//   - A block owns `rb` whole consecutive rows (about 32 KB, fewer when
//     the volume has too few rows to give each SM two blocks). It reads
//     each row's amount once and reduces it once, into shared memory.
//   - Vector path (W a multiple of 4, both pointers 16-byte aligned, a row
//     of at most 12,288 floats): the block's rows, one contiguous span,
//     are loaded into shared memory with 16-byte loads, all issued before
//     one barrier. Each thread then writes 4 consecutive output columns
//     with one 16-byte store. Their source columns k .. k+3 (mod W) start
//     at k = (4c - s) mod W; since 4 divides W the misalignment k & 3 is
//     the same for the whole row, so the thread reads the two aligned
//     16-byte words around k from shared memory and picks 4 floats with a
//     switch on which every thread of the row agrees; the word after the
//     row's last is its first, which is the single wrap.
//   - Scalar path (a ragged W, so rows are not 16-byte aligned; or a row
//     too wide to stage): the same kernel reads each source element from
//     device memory, neighbouring threads on neighbouring addresses
//     except at the one wrap of each row. No fallback leaves the kernel.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kStageBytes = 32 * 1024;  // rows a block stages, ~bytes
constexpr int kMaxRows = 64;                  // rows a block owns, at most
constexpr int kMaxVecW = 12288;               // 48 KB: one row staged
constexpr long long kMinBlocks = 2 * 132;     // two blocks per SM, if rows allow

__device__ __forceinline__ int reduce_shift(int s, int W) {
  const int k = s % W;  // in (-W, W), exact for INT_MIN as well
  return k < 0 ? k + W : k;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) rotate_planes_kernel(
    const float* __restrict__ x, const int* __restrict__ shifts,
    float* __restrict__ out, int rows, int R, int W, int rb) {
  extern __shared__ float4 stage[];
  __shared__ int shift[kMaxRows];
  const int row0 = blockIdx.x * rb;
  const int nr = min(rb, rows - row0);
  if (threadIdx.x < nr)
    shift[threadIdx.x] = reduce_shift(__ldg(shifts + (row0 + threadIdx.x) / R), W);
  const long long base = (long long)row0 * W;

  if constexpr (kVec) {
    const int W4 = W >> 2;
    const int n4 = nr * W4;
    const float4* src = reinterpret_cast<const float4*>(x + base);
    for (int v = threadIdx.x; v < n4; v += kThreads) stage[v] = __ldg(src + v);
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(out + base);
    for (int v = threadIdx.x; v < n4; v += kThreads) {
      const int rr = v / W4;
      const int c4 = v - rr * W4;
      int k = 4 * c4 - shift[rr];  // in (-W, W)
      if (k < 0) k += W;
      const float4* row = stage + rr * W4;
      const int a4 = k >> 2;
      const float4 a = row[a4];
      float4 r = a;
      const int m = k & 3;  // the same for every thread of the row
      if (m != 0) {
        const float4 b = row[a4 + 1 == W4 ? 0 : a4 + 1];
        if (m == 1)
          r = make_float4(a.y, a.z, a.w, b.x);
        else if (m == 2)
          r = make_float4(a.z, a.w, b.x, b.y);
        else
          r = make_float4(a.w, b.x, b.y, b.z);
      }
      dst[v] = r;
    }
  } else {
    __syncthreads();
    const float* src = x + base;
    float* dst = out + base;
    const int n = nr * W;  // nr * W <= kMaxRows * W, or W alone
#pragma unroll 4
    for (int v = threadIdx.x; v < n; v += kThreads) {
      const int rr = v / W;
      const int c = v - rr * W;
      int k = c - shift[rr];
      if (k < 0) k += W;
      dst[v] = __ldg(src + rr * W + k);
    }
  }
}

}  // namespace

extern "C" int rotate_planes(const void* x, const void* shifts, void* out,
                             int N, int R, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)N * R;
  if (rows == 0 || W == 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec = W % 4 == 0 && W <= kMaxVecW &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  long long rb = kStageBytes / (4LL * W);
  const long long spread = (rows + kMinBlocks - 1) / kMinBlocks;
  rb = rb < spread ? rb : spread;
  rb = rb < kMaxRows ? rb : kMaxRows;
  rb = rb < 1 ? 1 : rb;
  // The scalar path indexes a block's rows with 32-bit ints.
  if (!vec && rb * W > 0x7fffffffLL) rb = 1;
  const unsigned grid = (unsigned)((rows + rb - 1) / rb);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int* sp = static_cast<const int*>(shifts);
  float* op = static_cast<float*>(out);
  if (vec)
    rotate_planes_kernel<true><<<grid, kThreads, rb * W * sizeof(float), s>>>(
        xp, sp, op, (int)rows, R, W, (int)rb);
  else
    rotate_planes_kernel<false><<<grid, kThreads, 0, s>>>(xp, sp, op, (int)rows,
                                                          R, W, (int)rb);
  return (int)cudaGetLastError();
}

extern "C" const char* rotate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

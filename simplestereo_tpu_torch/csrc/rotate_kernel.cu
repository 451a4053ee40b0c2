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
// rotate_planes_kernel: one thread per element of an (N, R, W) volume, the
// grid's x over the N * R rows and its y (with the threads) over columns,
//     out[n, r, c] = x[n, r, (c - s[n]) mod W],   result in [0, W),
// which is torch.roll(x[n], s[n], dims=-1). The amounts s are int32 in
// device memory, read at run time, so the compiler cannot fold them. C's
// `%` truncates toward zero: (c - s) % W is negative whenever s > c, the
// counterpart here of the TPU's negative-amount trap. The kernel reduces
// s into (-W, W) first, so c - s lies in (-W, 2W) and one conditional add
// or subtract of W brings it into [0, W): every amount, negative or larger
// than W, is exact, in 32-bit arithmetic (c - s itself could overflow for
// s near INT_MIN).
//
// What bounds it on this card: it moves bytes and computes nothing. Each
// input element is read once and each output written once, neighbouring
// threads on neighbouring addresses (the read wraps once per row), so
// the bound is 2 * 4 * N * R * W bytes over the memory rate: 0.125 us for
// the probe's (17, 8, 384) block, about 24 us for an 11 x 720 x 1280
// volume. At the probe's size the launch itself dominates. The 2-D grid
// leaves one 32-bit division per thread (the row's plane) in place of the
// 64-bit divisions by W and R that a flat index would need.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) rotate_planes_kernel(
    const float* __restrict__ x, const int* __restrict__ shifts,
    float* __restrict__ out, int R, int W) {
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= W) return;
  const unsigned row = blockIdx.x;  // n * R + r
  int k = c - shifts[row / R] % W;
  if (k < 0) k += W;
  if (k >= W) k -= W;
  const long long base = (long long)row * W;
  out[base + c] = x[base + k];
}

}  // namespace

extern "C" int rotate_planes(const void* x, const void* shifts, void* out,
                             int N, int R, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)N * R;
  if (rows == 0 || W == 0) return 0;
  if (rows > 0x7fffffffLL || (W + kThreads - 1) / kThreads > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)rows, (W + kThreads - 1) / kThreads);
  rotate_planes_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(shifts),
      static_cast<float*>(out), R, W);
  return (int)cudaGetLastError();
}

extern "C" const char* rotate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

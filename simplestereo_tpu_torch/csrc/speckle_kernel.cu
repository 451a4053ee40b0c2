// Speckle filter kernels for Hopper (sm_90a): connected components of an
// int16 disparity map by union-find, then the small ones invalidated.
//
// Replaces no TPU kernel. The JAX package (and the port's host twin,
// simplestereo_tpu_torch/passive/sgm.py::filter_speckles) runs the filter
// on the host, in numpy with one scipy.ndimage.label a quantised value, on
// every StereoSGM call with speckleWindowSize > 0; the port's call would
// otherwise read the map back, label it in scipy and send it up again.
//
// What it computes, for every frame of a (B, H, W) int16 stack d, given
// m >= 1, a size and a new value (sgm.filter_speckles' semantics):
//     q(p) = floor(d(p) / m)                (numpy's floor_divide)
// the 4-connected components of equal q, and
//     out(p) = size of p's component < size ? new value : d(p).
// (cv2.filterSpeckles chains |d1 - d2| <= m instead; the port keeps the JAX
// package's quantised version, whose components do not depend on order.)
//
// What bounds it on this card: bytes, and the launches. The map is read
// once and written once (3.69 MB a 1280x720 frame, 1.10 us at 3.35 TB/s);
// the labels and counts (int32, 7.4 MB a frame) stay in the 50 MB L2. The
// union-find in the manner of Playne and Hawick (2018) and Allegretti,
// Bolelli and Grana (2019), in four launches:
//   - speckle_local_kernel: a block a 32 x 16 tile, a warp a tile row.
//     Labels in shared memory: a pixel starts at the first pixel of its
//     row's run of equal q (one ballot, no atomics); two runs that touch
//     across rows unite once, at the first pixel where they do (atomicMin
//     linking, the smaller index the root; finds halve the path as they
//     go); then each pixel finds its root. It writes its label, the frame
//     index of its tile's root, and its count: the tile component's size
//     at a root (a warp's pixels of one root add once, __match_any_sync),
//     0 elsewhere.
//   - speckle_border_kernel: a thread a pair of pixels across a tile
//     border (the vertical borders, then the horizontal ones); a pair of
//     equal q unites the tile roots in device memory by the same linking.
//     Only roots are relinked (a halving find points a root's path at an
//     ancestor), so a pixel that is no tile root keeps its tile root as
//     its label.
//   - speckle_roots_kernel: a thread a pixel; a tile root (count > 0)
//     finds its final root R, points its label at R, and adds its tile
//     component's size to R's count (atomicAdd: one a tile component, not
//     one a pixel, so the background's ~1,800 tiles make ~1,800 adds).
//     Halving finds racing with those stores may leave a tile root on an
//     ancestor short of R, so:
//   - speckle_write_kernel: a thread a pixel walks its labels to R (a hop
//     or two: its tile root, or an ancestor a find left it on, then R),
//     and out = count(R) < size ? new value : d.
// The frames of a stack lie on the grid's z (tiles) or y (the others): a
// stack of more than 65,535 frames is cut into launches by the wrapper
// (_build.frame_pieces). Labels are indices inside a frame (H * W < 2^31).

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;  // a warp a tile row
constexpr int kTileH = 16;
constexpr int kTile = kTileW * kTileH;
constexpr int kFlat = 256;  // threads a block of the flat kernels

__device__ __forceinline__ int quantise(int d, int m) {
  const int q = d / m;  // truncates toward zero
  return (d % m != 0 && d < 0) ? q - 1 : q;
}

// The root of x, halving the path on the way: each label passed is pointed
// at its grandparent (an ancestor, in the same set; a plain store, as in
// ECL-CC's pointer jumping). Labels only fall (a label is never above its
// index), so the walk ends.
__device__ __forceinline__ int find_root(volatile int* label, int x) {
  int p = label[x];
  while (p != x) {
    const int g = label[p];
    if (g == p) return p;
    label[x] = g;
    x = g;
    p = label[x];
  }
  return x;
}

// Join the trees of a and b: the larger root is linked to the smaller one
// by atomicMin. Where another thread relinked that root first, atomicMin
// returns its new label, and the join goes on from there.
__device__ __forceinline__ void unite(int* label, int a, int b) {
  bool done;
  do {
    a = find_root(label, a);
    b = find_root(label, b);
    if (a < b) {
      const int old = atomicMin(&label[b], a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(&label[a], b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void __launch_bounds__(kTile) speckle_local_kernel(
    const short* __restrict__ disp, int* __restrict__ label,
    int* __restrict__ count, int H, int W, int m) {
  __shared__ int s_label[kTile];
  __shared__ int s_q[kTile];
  __shared__ int s_count[kTile];
  const long long frame = (long long)H * W;
  disp += blockIdx.z * frame;
  label += blockIdx.z * frame;
  count += blockIdx.z * frame;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kTileW + tx;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + tx, y = y0 + ty;
  const bool in = x < W && y < H;
  const int p = y * W + x;
  const int q = in ? quantise(disp[p], m) : 0;
  s_q[t] = q;
  s_count[t] = 0;
  __syncthreads();
  // a warp is one tile row: a pixel's first label is the first lane of its
  // run of equal q (the lanes left of an in-image lane are in the image)
  const bool joins_left = in && tx > 0 && s_q[t - 1] == q;
  const unsigned starts = ~__ballot_sync(0xffffffffu, joins_left);
  s_label[t] = ty * kTileW + 31 - __clz(starts & (0xffffffffu >> (31 - tx)));
  __syncthreads();
  // two runs that touch across rows unite once, at the overlap's first
  // pixel: where the left pixel and the one above it share q, the left
  // pixel joined the same two runs
  if (in && ty > 0 && s_q[t - kTileW] == q &&
      !(joins_left && s_q[t - kTileW - 1] == q))
    unite(s_label, t, t - kTileW);
  __syncthreads();
  const int r = in ? find_root(s_label, t) : -1;
  // a warp is one tile row: the lanes of one root add their count once
  const unsigned same = __match_any_sync(0xffffffffu, r);
  if (r >= 0 && tx == __ffs(same) - 1) atomicAdd(&s_count[r], __popc(same));
  __syncthreads();
  if (in) {
    label[p] = (y0 + r / kTileW) * W + x0 + r % kTileW;
    count[p] = s_count[t];  // 0 where p is no tile root
  }
}

__global__ void __launch_bounds__(kFlat) speckle_border_kernel(
    const short* __restrict__ disp, int* __restrict__ label, int H, int W,
    int m, int nv, int n) {
  const int i = blockIdx.x * kFlat + threadIdx.x;
  if (i >= n) return;
  const long long frame = (long long)H * W;
  disp += blockIdx.y * frame;
  label += blockIdx.y * frame;
  int a, b;  // the pair
  if (i < nv) {  // column x = kTileW * (k + 1) and the column before it
    const int k = i / H, y = i - k * H;
    a = y * W + kTileW * (k + 1);
    b = a - 1;
  } else {  // row y = kTileH * (k + 1) and the row above it
    const int j = i - nv, k = j / W, x = j - k * W;
    a = kTileH * (k + 1) * W + x;
    b = a - W;
  }
  if (quantise(disp[a], m) == quantise(disp[b], m)) unite(label, a, b);
}

__global__ void __launch_bounds__(kFlat) speckle_roots_kernel(
    int* __restrict__ label, int* __restrict__ count, int frame) {
  const int p = blockIdx.x * kFlat + threadIdx.x;
  if (p >= frame) return;
  label += blockIdx.y * (long long)frame;
  count += blockIdx.y * (long long)frame;
  const int c = count[p];  // a tile root's tile component, else 0
  if (c == 0) return;
  const int root = find_root(label, p);
  if (root != p) {
    label[p] = root;
    atomicAdd(&count[root], c);
  }
}

__global__ void __launch_bounds__(kFlat) speckle_write_kernel(
    const short* __restrict__ disp, const int* __restrict__ label,
    const int* __restrict__ count, short* __restrict__ out, int frame,
    int size, short new_val) {
  const int p = blockIdx.x * kFlat + threadIdx.x;
  if (p >= frame) return;
  const long long f = blockIdx.y * (long long)frame;
  label += f;
  int root = label[p];
  for (int up = label[root]; up != root; up = label[root]) root = up;
  out[f + p] = count[f + root] < size ? new_val : disp[f + p];
}

}  // namespace

// disp, out: (B, H, W) int16; label, count: (B, H, W) int32 workspace.
// m >= 1 the quantum, size the least component that stays, new_val what
// the smaller ones become. B <= 65,535; H * W < 2^31.
extern "C" int speckle_filter(const void* disp, void* out, void* label,
                              void* count, int B, int H, int W, int m,
                              int size, int new_val, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || m <= 0 ||
      (long long)H * W >= (1LL << 31) || new_val < -32768 || new_val > 32767)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto d = static_cast<const short*>(disp);
  const auto lab = static_cast<int*>(label);
  const auto cnt = static_cast<int*>(count);
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  speckle_local_kernel<<<dim3(tiles_x, tiles_y, B), dim3(kTileW, kTileH), 0,
                         s>>>(d, lab, cnt, H, W, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nv = (tiles_x - 1) * H, n = nv + (tiles_y - 1) * W;
  if (n > 0) {
    speckle_border_kernel<<<dim3((n + kFlat - 1) / kFlat, B), kFlat, 0, s>>>(
        d, lab, H, W, m, nv, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int frame = H * W;
  const dim3 flat((frame + kFlat - 1) / kFlat, B);
  speckle_roots_kernel<<<flat, kFlat, 0, s>>>(lab, cnt, frame);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  speckle_write_kernel<<<flat, kFlat, 0, s>>>(
      d, lab, cnt, static_cast<short*>(out), frame, size, (short)new_val);
  return (int)cudaGetLastError();
}

extern "C" const char* speckle_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

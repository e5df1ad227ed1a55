// knn3_exact: each point's mean squared distance to its 3 nearest other
// points, from exact coordinate differences.
//
// Not a TPU kernel: the counterpart of the JAX package's host C++
// extension, luciddreamer_tpu/native/knn_native.cpp::mean_sq_dist_3nn (a
// KD-tree on the CPU, the package's exact oracle of the knn; the
// reference's simple-knn is a CUDA extension).  Per query i and candidate
// j != i it computes, as knn_native.cpp:96-97 does,
//
//   dx = p_j.x - p_i.x, dy = ..., dz = ...;  v = dx*dx + dy*dy + dz*dz
//
// keeps the 3 smallest v with the KD-tree's insertion (Best::push,
// knn_native.cpp:70-81: strict <, the empty slot 1e30), and writes
// ((d0 + d1) + d2) / 3 over the slots below 1e29, missing neighbours
// counting as 0 (knn_native.cpp:122-128).  Built with -fmad=false, so no
// product is fused into a sum: the result is bit-equal to the plain
// version (points/knn_exact.py), which does the same operations in the
// same order.  The KD-tree visits candidates in another order, but the 3
// smallest values do not depend on it; its g++ -O3 -march=native build may
// fuse the sum of squares, so it agrees to rounding only.
//
// What bounds it.  The function needs its 16 n bytes of input and output
// (6.4 MB, ~2 us at 400k points) and the 3 distances each point returns.
// This brute force does n (n - 1) pairs of 8 fp32 operations (3
// subtractions, 3 products, 2 sums): 1.3e12 at 400k points, ~19 ms at the
// published 67 TFLOP/s, the bound of this algorithm and not of the
// function.  The KD-tree it replaces does O(n log n) work, so it wins
// once n is large enough.  The design is the simple one that is right:
//
//   * One thread per query, its point and its top 3 in registers.
//   * The candidates streamed through shared memory in tiles of kTile
//     points, stored as float4 so that a candidate is one 16-byte
//     broadcast load (every lane of a warp reads the same candidate).
//   * The self test sits inside the rare branch that admits a value into
//     the top 3, out of the hot loop.
//   * int32 indices (n < 2^31 - kThreads, checked by the wrapper); the
//     offsets into the points are 64-bit.
//
// Not done, for a later PR: several queries per thread to cut the shared
// loads per pair, and a spatial cut (Morton-sorted cells) that skips most
// candidates, which would change the work from n^2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;           // candidates staged per pass, 16 KB
constexpr float kEmpty = 1e30f;       // Best's empty slot
constexpr float kPresent = 1e29f;     // a slot below it holds a neighbour

__global__ void __launch_bounds__(kThreads)
knn3_exact_kernel(const float* __restrict__ points, int n,
                  float* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const long long o = 3LL * i;
    qx = points[o];
    qy = points[o + 1];
    qz = points[o + 2];
  }
  float d0 = kEmpty, d1 = kEmpty, d2 = kEmpty;
  for (int base = 0; base < n; base += kTile) {
    const int m = min(kTile, n - base);
    __syncthreads();                   // the previous tile is read
    for (int k = threadIdx.x; k < m; k += kThreads) {
      const long long o = 3LL * (base + k);
      tile[k] = make_float4(points[o], points[o + 1], points[o + 2], 0.f);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      const float4 c = tile[k];
      const float dx = c.x - qx, dy = c.y - qy, dz = c.z - qz;
      const float v = dx * dx + dy * dy + dz * dz;
      if (v < d2 && base + k != i) {
        if (v < d0) {
          d2 = d1; d1 = d0; d0 = v;
        } else if (v < d1) {
          d2 = d1; d1 = v;
        } else {
          d2 = v;
        }
      }
    }
  }
  if (live) {
    float s = 0.f;
    if (d0 < kPresent) s += d0;
    if (d1 < kPresent) s += d1;
    if (d2 < kPresent) s += d2;
    out[i] = s / 3.f;                  // 0 when no neighbour is present
  }
}

}  // namespace

// points (n, 3) f32, contiguous; out (n,) f32; 0 < n < 2^31 - 256.
// Enqueues the kernel on ``stream``; returns cudaGetLastError().
extern "C" int knn3_exact(const float* points, int n, float* out,
                          void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    knn3_exact_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        points, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

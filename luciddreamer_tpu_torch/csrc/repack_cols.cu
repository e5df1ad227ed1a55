// K3: the blend cotangent's gradient columns, in slot order.
//
// Replaces the inner kernel of luciddreamer_tpu/render/binning.py::
// _repack_cols, which splits the (pair_cap, 16) cotangent into 10
// contiguous (pair_cap,) columns in one pass so that the slot-order re-sort
// of _expand_sort_bwd can take them as sort operands.  The port keeps the
// pair sort's permutation ``order`` (sorted row i came from slot order[i]),
// so this kernel fuses the column split with the inverse permutation and
// replaces the re-sort: row i's 10 used channels land at column position
// order[i] of a (10, pair_cap) array.  Rows at or past the live pair count,
// read from device memory (no host sync), are not read and write zeros.
//
// One thread per sorted row: reads its 40 bytes (two 16-byte and one
// 8-byte load) and its 8-byte slot index, writes 10 scattered floats.  What
// bounds it on the card is bytes: 40 B read per live row, 8 B of order and
// 40 B written per slot.  The writes of live rows scatter across slot
// order, so each 4-byte store fills its own 32-byte sector; the dead tail of
// the buffer sorts to the end in slot order and writes coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kAttrDim = 16;
constexpr int kGradCh = 10;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
repack_cols_kernel(const float* __restrict__ x,
                   const long long* __restrict__ order,
                   const long long* __restrict__ num_pairs,
                   float* __restrict__ cols,
                   long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long slot = order[i];
  float v[kGradCh];
#pragma unroll
  for (int c = 0; c < kGradCh; ++c) v[c] = 0.0f;
  if (i < *num_pairs) {
    const float* row = x + i * kAttrDim;
    const float4 a0 = reinterpret_cast<const float4*>(row)[0];
    const float4 a1 = reinterpret_cast<const float4*>(row)[1];
    const float2 a2 = reinterpret_cast<const float2*>(row)[4];
    v[0] = a0.x; v[1] = a0.y; v[2] = a0.z; v[3] = a0.w;
    v[4] = a1.x; v[5] = a1.y; v[6] = a1.z; v[7] = a1.w;
    v[8] = a2.x; v[9] = a2.y;
  }
#pragma unroll
  for (int c = 0; c < kGradCh; ++c) cols[c * n + slot] = v[c];
}

}  // namespace

// x (n, 16) f32; order (n,) int64, a permutation of [0, n); num_pairs a
// device int64 scalar; cols (10, n) f32.  Launches on ``stream``; returns
// cudaGetLastError().
extern "C" int repack_cols(const float* x, const long long* order,
                           const long long* num_pairs, float* cols,
                           long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    repack_cols_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, order, num_pairs, cols, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3: the blend cotangent's gradient columns, in slot order.
//
// Replaces the inner kernel of luciddreamer_tpu/render/binning.py::
// _repack_cols, which splits the (pair_cap, 16) cotangent into 10
// contiguous (pair_cap,) columns in one pass so that the slot-order re-sort
// of _expand_sort_bwd can take them as sort operands.  The port keeps the
// pair sort's permutation ``order`` (sorted row i came from slot order[i]),
// so K3 fuses the column split with the inverse permutation and replaces the
// re-sort: row i's 10 used channels land at column position order[i] of a
// (10, pair_cap) array.  Rows at or past the live pair count, read from
// device memory (no host sync), are not read and give zeros.
//
// What bounds it on the card is bytes: 8 B of order and 40 B written per
// slot, 40 B read per live row.  A permutation has to scatter or gather
// somewhere; what the design chooses is which side.  Writing row i's 10
// floats straight to cols[c][order[i]] scatters on the wide side: ten 4-byte
// stores per live row, each dirtying a 32-byte sector of its own.  So K3 is a
// gather through the inverse permutation, in two passes on one stream:
//
//   A. one thread per sorted row i: inv[order[i]] = i, or -1 at or past the
//      live count.  One scattered 4-byte store per row; the dead tail of the
//      sort keeps slot order (order[i] == i there) and writes coalesced.
//   B. one thread per slot s, neighbouring threads on neighbouring slots:
//      r = inv[s]; a live slot loads row r's 40 bytes (two 16-byte loads and
//      one 8-byte load: the two 32-byte sectors of a 64-byte-aligned row), a
//      dead one takes zeros; then 10 stores, each warp writing 128
//      contiguous bytes per channel.
//
// ``inv`` is int32 scratch of pair_cap entries that the wrapper allocates
// uninitialised: pass A writes all of it only if ``order`` is a permutation
// of [0, pair_cap), which is the caller's to keep.  Pass B takes an entry
// outside [0, pair_cap) as dead, so that a slot which a bad ``order`` left
// unwritten gives zeros or some row of x and never a read outside x.
// Pure copies, so the result is bit-equal to the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kAttrDim = 16;
constexpr int kGradCh = 10;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
invert_order_kernel(const long long* __restrict__ order,
                    const long long* __restrict__ num_pairs,
                    int* __restrict__ inv,
                    long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  inv[order[i]] = i < *num_pairs ? static_cast<int>(i) : -1;
}

__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const float* __restrict__ x,
                   const int* __restrict__ inv,
                   float* __restrict__ cols,
                   long long n) {
  const long long s = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  const int r = inv[s];
  float v[kGradCh];
#pragma unroll
  for (int c = 0; c < kGradCh; ++c) v[c] = 0.0f;
  if (static_cast<unsigned>(r) < n) {      // n < 2^31; -1 and garbage are dead
    const float* row = x + static_cast<long long>(r) * kAttrDim;
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(row));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
    const float2 a2 = __ldg(reinterpret_cast<const float2*>(row) + 4);
    v[0] = a0.x; v[1] = a0.y; v[2] = a0.z; v[3] = a0.w;
    v[4] = a1.x; v[5] = a1.y; v[6] = a1.z; v[7] = a1.w;
    v[8] = a2.x; v[9] = a2.y;
  }
#pragma unroll
  for (int c = 0; c < kGradCh; ++c) cols[c * n + s] = v[c];
}

}  // namespace

// x (n, 16) f32; order (n,) int64, a permutation of [0, n); num_pairs a
// device int64 scalar; inv (n,) int32 scratch; cols (10, n) f32; n < 2^31.
// Enqueues both passes on ``stream``; returns cudaGetLastError().
extern "C" int repack_cols(const float* x, const long long* order,
                           const long long* num_pairs, int* inv, float* cols,
                           long long n, void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    invert_order_kernel<<<blocks, kThreads, 0, s>>>(order, num_pairs, inv, n);
    gather_cols_kernel<<<blocks, kThreads, 0, s>>>(x, inv, cols, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

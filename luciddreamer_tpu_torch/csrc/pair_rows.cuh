// Staging of the sorted pair stream's rows into shared memory, shared by K1
// (blend_fwd.cu) and K2 (blend_bwd.cu).
//
// Row i of the stream is table[src[i]]: binning keeps the (P+1, 16)
// attribute table and the pair sort's owner index src, and builds no
// stream-order copy of the rows.  A block stages a tile's range [start, end)
// in batches of kBatch rows.  Thread p copies piece p % 3 of row p / 3 of
// each batch: it reads src[row] (a warp reads consecutive entries) and issues
// one 16-byte cp.async from table + src * 16; a row's 11 used channels are
// its first 48 bytes, three pieces.  The caller loads the src entries of a
// batch one batch before it stages it, so that both hops of the indirection
// overlap the walk of the batch before.  A src entry outside [0, n_rows)
// reads the last table row (the zero sentinel, which is invalid), never
// outside the table.

#pragma once

#include <cuda_runtime.h>

namespace pair_rows {

constexpr int kAttrDim = 16;
constexpr int kRowVec = 3;   // 16-byte pieces staged per row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int kBatch, int kThreads>
struct Stager {
  static_assert(kBatch * kRowVec <= kThreads, "one piece of a batch per thread");

  const float* table;
  const int* src;
  int n_rows, start, end, row, piece;

  __device__ Stager(const float* table_, const int* src_, int n_rows_,
                    int start_, int end_, int thread)
      : table(table_), src(src_), n_rows(n_rows_), start(start_), end(end_),
        row(thread / kRowVec), piece(thread % kRowVec) {}

  // The table row that this thread copies from in batch k, or -1 where it
  // copies nothing (past the range, or no piece of its own).
  __device__ __forceinline__ int row_of(int k) const {
    const int i = start + k * kBatch + row;
    if (row >= kBatch || i >= end) return -1;
    const int s = src[i];
    return static_cast<unsigned>(s) < static_cast<unsigned>(n_rows) ? s
                                                                     : n_rows - 1;
  }

  // Issues this thread's copy, from table row s (row_of's value for the
  // batch), into dst[kBatch][kRowVec], and commits it as one cp.async
  // group.
  __device__ __forceinline__ void stage(float4 (*dst)[kRowVec], int s) const {
    if (s >= 0) {
      cp_async16(&dst[row][piece],
                 table + static_cast<size_t>(s) * kAttrDim + piece * 4);
    }
    cp_async_commit();
  }
};

}  // namespace pair_rows

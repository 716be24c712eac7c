// Block-wide scans shared by sort.cu, join.cu and window.cu: CUB's
// BlockScan under any associative operator, and the one-block scan of a
// row of tile sums (the carry across tiles).  BLOCK is the block size of
// the calling kernel.  Include this before defining macros: CUB's headers
// use names such as WARPS.

#pragma once

#include <cub/block/block_scan.cuh>

namespace {

template <typename T>
struct Add {
  __device__ T operator()(T a, T b) const { return a + b; }
};

// the exclusive scan over the block's threads of `v` under `op` (op(a, b):
// a before b) with identity `id`; *total gets the whole block's value.
// Every thread of the block calls it; it syncs before returning, so calls
// may follow each other.
template <int BLOCK, typename T, typename Op>
__device__ __forceinline__ T block_exclusive_scan(T v, Op op, T id,
                                                  T* total) {
  typedef cub::BlockScan<T, BLOCK> Scan;
  __shared__ typename Scan::TempStorage tmp;
  T excl;
  Scan(tmp).ExclusiveScan(v, excl, id, op, *total);
  __syncthreads();
  return excl;
}

// one block: the exclusive sum of row[0, n) in place, chunk by chunk;
// returns the row's total to every thread
template <int BLOCK, typename T>
__device__ T block_scan_row(T* row, long long n) {
  T carry = 0;
  for (long long base = 0; base < n; base += BLOCK) {
    const long long t = base + threadIdx.x;
    const T v = t < n ? row[t] : T(0);
    T tot;
    const T excl = block_exclusive_scan<BLOCK>(v, Add<T>(), T(0), &tot);
    if (t < n) row[t] = carry + excl;
    carry += tot;
  }
  return carry;
}

// one block: the exclusive sum of the tile sums in place (each tile's
// carry), and their total when `total` is not null
template <int BLOCK, typename T>
__global__ void __launch_bounds__(BLOCK)
    tile_carry_kernel(T* sums, long long n_tiles, T* total) {
  const T all = block_scan_row<BLOCK>(sums, n_tiles);
  if (total != nullptr && threadIdx.x == 0) *total = all;
}

}  // namespace

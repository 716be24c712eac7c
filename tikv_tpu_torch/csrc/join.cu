// The probe of a device hash join for Hopper (join_probe): each probe row
// that passes its predicate finds its run of equal keys in the build
// side's sorted dictionary, and the matches expand into (probe, build)
// row pairs in probe order, then build order.
//
// Replaces the XLA kernel of tikv_tpu/device/join.py:
//   join_probe <- _probe_kernel (:276): the fused probe predicate (here a
//                 bool mask written by sel_pred, or by the torch route for
//                 a predicate sel_pred does not cover), the searchsorted
//                 lo/hi of each probe key in sk, the match count
//                 prefix[hi] - prefix[lo] (valid build rows only: the
//                 dictionary keeps valid rows first within equal keys, so
//                 a run's first `count` entries are its valid ones), their
//                 cumsum, and the expansion into at most k_cap int32 pairs
//                 with -1 fill past the total; the total is exact (int64)
//                 even when it exceeds k_cap, so the caller re-dispatches
//                 at the exact power of two and never truncates.
//
// Four kernels: a count pass (one probe row a thread: two binary searches
// into sk, 20 steps each at config 7's 2^20 build keys, with sk, 8 MB, in
// L2; lo and the count kept as int32, a tile's sum of counts as int64); a
// one-block exclusive scan of the tile sums (the carry across tiles) that
// also writes the total (scan.cuh, as are the block scans); the emit pass
// (a tile's rows re-read as 16 consecutive rows a thread, a block scan of
// the thread sums plus the tile's carry, so each row knows where its pairs
// start, and writes them while below k_cap: probe row, perm[lo + j]); and
// the -1 fill of [total, k_cap).
//
// Bound: bytes.  The probe key, its validity and the mask are read once
// (10 B a row), the build dictionary once (sk, perm and prefix: 20 B a
// build row), and 8 B a pair written; at config 7 (10,485,760 probe rows,
// 2^20 build rows, about 5.2 M pairs) that is about 0.17 GB, 0.05 ms at
// 3.35 TB/s.  The kernel also writes and re-reads lo and the count (8 B a
// row) and fills the pairs past the total (8 B a slot up to k_cap).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define THREADS 256
#define ITEMS 16
#define TILE (THREADS * ITEMS)


// join_probe's launch parameters (device/join_probe.py mirrors them); lo
// and cnt int32[n_probe] and tile_sums int64[n_tiles] are scratch.
struct ProbeParams {
  long long n_probe;
  long long n_build;
  const long long* sk;
  const int* perm;
  const long long* prefix;
  const long long* pkeys;
  const unsigned char* pvalid;  // null: every key valid
  const unsigned char* mask;    // null: no predicate
  long long k_cap;
  int* pairs;                   // int32[k_cap][2]
  long long* total;             // int64[1]
  int* lo;
  int* cnt;
  long long* tile_sums;
};

namespace {

// first index in sk[0, n) whose key is >= k (strict: > k)
template <bool STRICT>
__device__ __forceinline__ long long bound(const long long* sk, long long n,
                                           long long k) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long v = sk[mid];
    if (STRICT ? v <= k : v < k)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS) count_kernel(ProbeParams p) {
  const long long start = (long long)blockIdx.x * TILE;
  long long s = 0;
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = start + j * THREADS + threadIdx.x;
    if (i >= p.n_probe) break;
    int c = 0, l = 0;
    if ((p.pvalid == nullptr || p.pvalid[i]) &&
        (p.mask == nullptr || p.mask[i])) {
      const long long k = p.pkeys[i];
      const long long a = bound<false>(p.sk, p.n_build, k);
      const long long b = bound<true>(p.sk, p.n_build, k);
      c = (int)(p.prefix[b] - p.prefix[a]);
      l = (int)a;
    }
    p.lo[i] = l;
    p.cnt[i] = c;
    s += c;
  }
  long long tot;
  block_exclusive_scan<THREADS>(s, Add<long long>(), 0ll, &tot);
  if (threadIdx.x == 0) p.tile_sums[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(THREADS) emit_kernel(ProbeParams p) {
  const long long start = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  long long s = 0;
  for (int j = 0; j < ITEMS; ++j)
    if (start + j < p.n_probe) s += p.cnt[start + j];
  long long tot;
  long long at = p.tile_sums[blockIdx.x] +
                 block_exclusive_scan<THREADS>(s, Add<long long>(), 0ll, &tot);
  for (int j = 0; j < ITEMS && at < p.k_cap; ++j) {
    const long long i = start + j;
    if (i >= p.n_probe) break;
    const int c = p.cnt[i];
    const int l = p.lo[i];
    for (int m = 0; m < c && at + m < p.k_cap; ++m) {
      p.pairs[2 * (at + m)] = (int)i;
      p.pairs[2 * (at + m) + 1] = p.perm[l + m];
    }
    at += c;
  }
}

__global__ void __launch_bounds__(THREADS)
    fill_kernel(int* pairs, const long long* total, long long k_cap) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = *total + (long long)blockIdx.x * THREADS + threadIdx.x;
       i < k_cap; i += stride) {
    pairs[2 * i] = -1;
    pairs[2 * i + 1] = -1;
  }
}

}  // namespace

extern "C" {

// n_probe >= 1, n_build >= 1, k_cap >= 1
int join_probe_launch(int device, const ProbeParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p->n_probe < 1 || p->n_build < 1 || p->k_cap < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (int)((p->n_probe + TILE - 1) / TILE);
  count_kernel<<<n_tiles, THREADS, 0, s>>>(*p);
  tile_carry_kernel<THREADS, long long>
      <<<1, THREADS, 0, s>>>(p->tile_sums, n_tiles, p->total);
  emit_kernel<<<n_tiles, THREADS, 0, s>>>(*p);
  long long blocks = (p->k_cap + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  fill_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(p->pairs, p->total,
                                                   p->k_cap);
  return cudaGetLastError();
}

int probe_params_bytes() { return (int)sizeof(ProbeParams); }
int probe_tile_rows() { return TILE; }

const char* join_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

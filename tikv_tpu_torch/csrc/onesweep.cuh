// One stable LSD radix pass over an 8-bit digit with decoupled look-back
// (Adinets and Merrill, "Onesweep: A Faster Least Significant Digit Radix
// Sort for GPUs", 2022), and the shared-memory digit counts that feed it:
// shared by sort.cu (keys with a row payload: sort_perm, join_build) and
// analyze.cu (keys only: ANALYZE's column sort).
//
// A sort first counts every pass's digits over all rows (digit_counts_*
// in the kernel that writes the keys), then runs one onesweep_kernel per
// digit, least significant first.  Each block takes a tile index from an
// atomic counter, so it waits only on tiles that are already running;
// loads its rows (a warp's rows consecutive); ranks them by digit in
// shared memory (a warp's lanes of one digit by __match_any_sync, per-warp
// counts, then a scan over warps and digits), so rows of one digit keep
// their order; publishes its digit counts by decoupled look-back (one
// 64-bit status word per tile and digit: a flag and a count, the flag
// either the tile's own count or the inclusive count of every tile up to
// it); and writes its rows out of shared memory in digit order, so
// consecutive threads write each digit's run.
//
// Include after scan.cuh and before any #define of the including file
// (the names here are SWEEP_*).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

typedef unsigned long long sweep_u64;

constexpr int SWEEP_THREADS = 256;
constexpr int SWEEP_WARPS = SWEEP_THREADS / 32;
constexpr int SWEEP_RADIX = 256;
constexpr int SWEEP_DIGIT_BITS = 8;
constexpr int SWEEP_MAX_PASSES = 64 / SWEEP_DIGIT_BITS;

constexpr unsigned FULL = 0xffffffffu;
constexpr sweep_u64 FLAG_AGG = 1ull << 62;     // the tile's own digit count
constexpr sweep_u64 FLAG_PREFIX = 2ull << 62;  // the count of tiles [0, tile]
constexpr sweep_u64 COUNT_MASK = (1ull << 62) - 1;

// A block's counts of each pass's digits (thread t owns digit t when the
// block zeroes and flushes them; the block is SWEEP_THREADS wide).
struct DigitCounts {
  unsigned c[SWEEP_MAX_PASSES][SWEEP_RADIX];
};

__device__ __forceinline__ void digit_counts_zero(DigitCounts& s,
                                                  int passes) {
  for (int q = 0; q < passes; ++q) s.c[q][threadIdx.x] = 0;
}

__device__ __forceinline__ void digit_counts_add(DigitCounts& s, sweep_u64 x,
                                                 int passes) {
  for (int q = 0; q < passes; ++q)
    atomicAdd(
        &s.c[q][(x >> (SWEEP_DIGIT_BITS * q)) & (SWEEP_RADIX - 1)], 1u);
}

// the block's counts into hist[q * stride + digit] (after a __syncthreads)
__device__ __forceinline__ void digit_counts_flush(const DigitCounts& s,
                                                   int passes,
                                                   sweep_u64* hist,
                                                   long long stride) {
  for (int q = 0; q < passes; ++q) {
    const unsigned c = s.c[q][threadIdx.x];
    if (c) atomicAdd(&hist[q * stride + threadIdx.x], (sweep_u64)c);
  }
}

// the rows of the tiles before `tile` whose digit is `d` (thread d spins on
// each earlier tile's word until it holds a count; tile 0's is inclusive)
__device__ __forceinline__ sweep_u64 look_back(const sweep_u64* status,
                                               long long tile, int d) {
  sweep_u64 excl = 0;
  for (long long j = tile - 1;;) {
    const sweep_u64 s = *reinterpret_cast<const volatile sweep_u64*>(
        status + j * SWEEP_RADIX + d);
    if ((s & ~COUNT_MASK) == 0) continue;
    excl += s & COUNT_MASK;
    if ((s & ~COUNT_MASK) == FLAG_PREFIX) return excl;
    --j;
  }
}

__device__ __forceinline__ void publish(sweep_u64* word, sweep_u64 v) {
  *reinterpret_cast<volatile sweep_u64*>(word) = v;
}

// One stable pass over the digit at `shift`: (kin, vin) → (kout, vout).
// PAYLOAD: each row carries an int32 (vin null for row indices), and kout
// is null on the last pass; without it only the keys move (kout is always
// written; vin and vout are not read).  hist: the pass's digit counts over
// all rows; status: n_tiles x SWEEP_RADIX zeroed words; counter: the
// zeroed tile counter.  Launch n_tiles blocks of SWEEP_THREADS.
template <typename K, int ITEMS, bool PAYLOAD>
__global__ void __launch_bounds__(SWEEP_THREADS)
    onesweep_kernel(const K* __restrict__ kin, K* kout,
                    const int* __restrict__ vin, int* vout, long long n,
                    int shift, const sweep_u64* hist, sweep_u64* status,
                    sweep_u64* counter) {
  constexpr int TILE = SWEEP_THREADS * ITEMS;
  constexpr int RADIX = SWEEP_RADIX;
  __shared__ long long s_tile;
  __shared__ int whist[SWEEP_WARPS][RADIX];  // per warp: counts, then offsets
  __shared__ int s_start[RADIX];       // a digit's first slot in the tile
  __shared__ long long s_base[RADIX];  // its output row, less s_start
  __shared__ K s_key[TILE];
  __shared__ int s_val[PAYLOAD ? TILE : 1];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = (long long)atomicAdd(counter, 1ull);
  for (int w = 0; w < SWEEP_WARPS; ++w) whist[w][t] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long start = tile * TILE;
  const int rows = (int)(n - start < TILE ? n - start : TILE);
  // a warp's rows are consecutive: item j of lane l is row j * 32 + l
  const int wrow = warp * 32 * ITEMS;
  K key[ITEMS];
  int val[ITEMS], rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int r = wrow + j * 32 + lane;
    const long long i = start + r;
    const bool live = r < rows;
    key[j] = live ? kin[i] : (K)0;
    if (PAYLOAD) val[j] = live ? (vin != nullptr ? vin[i] : (int)i) : 0;
  }
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool live = wrow + j * 32 + lane < rows;
    // rows past n share a digit no row has
    const unsigned d =
        live ? (unsigned)(key[j] >> shift) & (RADIX - 1) : RADIX;
    const unsigned peers = __match_any_sync(FULL, d);
    const int pre = live ? whist[warp][d] : 0;
    rank[j] = pre + __popc(peers & below);
    __syncwarp();
    if (live && (peers & below) == 0) whist[warp][d] = pre + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread t owns digit t: the warps' offsets, the tile's count
  int cnt = 0;
  for (int w = 0; w < SWEEP_WARPS; ++w) {
    const int c = whist[w][t];
    whist[w][t] = cnt;
    cnt += c;
  }
  sweep_u64* mine = status + tile * RADIX + t;
  if (tile == 0)
    publish(mine, FLAG_PREFIX | (sweep_u64)cnt);
  else
    publish(mine, FLAG_AGG | (sweep_u64)cnt);
  int tile_rows;
  const int lstart =
      block_exclusive_scan<SWEEP_THREADS>(cnt, Add<int>(), 0, &tile_rows);
  sweep_u64 all;
  const sweep_u64 gstart = block_exclusive_scan<SWEEP_THREADS>(
      hist[t], Add<sweep_u64>(), 0ull, &all);
  sweep_u64 excl = 0;
  if (tile > 0) {
    excl = look_back(status, tile, t);
    publish(mine, FLAG_PREFIX | (excl + (sweep_u64)cnt));
  }
  s_start[t] = lstart;
  s_base[t] = (long long)(gstart + excl) - lstart;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (wrow + j * 32 + lane >= rows) continue;
    const unsigned d = (unsigned)(key[j] >> shift) & (RADIX - 1);
    const int at = s_start[d] + whist[warp][d] + rank[j];
    s_key[at] = key[j];
    if (PAYLOAD) s_val[at] = val[j];
  }
  __syncthreads();
  for (int s = t; s < rows; s += SWEEP_THREADS) {
    const K k = s_key[s];
    const long long dst = s_base[(k >> shift) & (RADIX - 1)] + s;
    if (!PAYLOAD || kout != nullptr) kout[dst] = k;
    if (PAYLOAD) vout[dst] = s_val[s];
  }
}

}  // namespace

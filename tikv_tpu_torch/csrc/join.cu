// The probe of a device hash join for Hopper (join_probe): each probe row
// that passes its predicate finds its run of equal keys in the build
// side's sorted dictionary, and the matches expand into (probe, build)
// row pairs in probe order, then build order.  Beside it, the direct index
// of a dense build dictionary (join_index), built once per dictionary.
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
//   join_index <- the searchsorted half of the same kernel, done once per
//                 build dictionary where its valid keys are dense.
//
// Two routes to a row's run [lo, hi), one pass for both:
//   dense   the valid build keys sk[0, n_valid) span key_lo .. key_lo +
//           span - 1 with span <= 2 * n_valid + 1024 (device/join_probe.py
//           index_span): off[x] = lower_bound(sk, key_lo + x) for x in
//           [0, span], int32, so a key in range reads lo = off[k - key_lo]
//           and hi = off[k - key_lo + 1], two adjacent loads from a table
//           that stays in L2 (4 MB at config 7), and every row of the run
//           is valid (count = hi - lo).  k - key_lo is compared unsigned,
//           so keys at the int64 extremes fall out of range, not in.
//   sparse  one search for lo: its top 11 levels in a shared copy of 2048
//           samples of sk (sample_kernel writes them, a tile copies them),
//           the rest in sk; a key that is not at sk[lo] counts 0; else hi
//           from the row after lo for a unique key (read in the same step
//           as lo's), by a galloping search past a longer run; count =
//           prefix[hi] - prefix[lo].  Every item of a thread takes each
//           step of its search together, so their loads overlap.
//
// probe_kernel: one pass with decoupled look-back.  A block takes its tile
// index (1024 probe rows) from an atomic counter, so it waits only on
// tiles already running; loads its rows striped over the threads (a
// warp's loads coalesce), every load of an item before any is used; finds
// each row's lo and count, kept in registers; scans the counts in row
// order (CUB, through shared memory); publishes its total (one 64-bit
// word a tile: a flag and a count, the flag either the tile's own total or
// the inclusive total of every tile up to it), looks back for its offset
// with one warp (32 predecessors a step) while every thread loads the
// first build row of each of its runs, and publishes its inclusive total;
// then each row writes its pairs from the tile's offset plus its own: a
// warp's rows are consecutive, so are its pairs, and its stores coalesce;
// a run of more than 8 pairs is written by the whole warp.  Slots past
// k_cap are not written.  The last tile writes the total.  Then
// pair_fill_kernel writes -1 over [total, k_cap) with 16-byte stores.  lo
// and the count never reach device memory.  The probe keys, the mask and
// the pairs stream through L2 marked evict-first, so the dictionary (sk,
// prefix, perm; the index) stays in it.
//
// index_kernel: thread i (one per boundary 0..n_valid) owns the keys
// (sk[i - 1], sk[i]] and writes i into their entries; a run longer than 32
// entries (a gap in the keys) is written by its whole warp.  n_valid,
// key_lo and the span come from the host, which read them in join_build's
// one wait for the card (sort.cu build_prep_kernel), so the index is
// launched at once and a dictionary with its index waits for the card
// once.
//
// Bound: bytes.  The probe key and the mask read once (9 B a row; 10 with
// a validity plane), the build dictionary once (sk, perm and prefix: 20 B
// a build row), 8 B written a pair slot up to k_cap (the pairs, then the
// -1 fill) and the total; at config 7 (10,485,760 probe rows with a mask,
// 2^20 build rows, 5,237,669 pairs, k_cap 2^24) 0.25 GB, 0.0745 ms at
// 3.35 TB/s.  The index: sk read once and 4 B an entry written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define THREADS 256
#define ITEMS 4
#define TILE (THREADS * ITEMS)  // probe rows of a tile
#define LIGHT 8  // a run of more pairs is written by its whole warp
#define SAMPLES 2048  // sorted keys a sparse search starts from, in smem
#define SOFF(r) ((r) + ((r) >> 4))  // padded slot of row r's offset

typedef unsigned long long u64;

// join_probe's launch parameters (device/join_probe.py mirrors them).
// work: n_tiles status words, the tile counter and the total, zeroed by
// the launcher, then (the sparse route) SAMPLES words of samples of sk.
struct ProbeParams {
  long long n_probe;
  long long n_build;
  const long long* sk;
  const int* perm;
  const long long* prefix;
  const long long* pkeys;
  const unsigned char* pvalid;  // null: every key valid
  const unsigned char* mask;    // null: no predicate
  const int* off;               // the direct index; null: the sparse route
  long long key_lo;             // the index's least key
  long long span;               // keys the index covers (off: span + 1)
  long long k_cap;
  int* pairs;                   // int32[k_cap][2]
  u64* work;
  long long n_tiles;
};

// join_index's: off int32[span + 1] (out)
struct IndexParams {
  const long long* sk;
  long long n_valid;
  long long key_lo;
  long long span;
  int* off;
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr u64 FLAG_AGG = 1ull << 62;     // the tile's own total
constexpr u64 FLAG_PREFIX = 2ull << 62;  // the total of tiles [0, tile]
constexpr u64 COUNT_MASK = (1ull << 62) - 1;

// the end of k's run in sk[0, n), which starts at `at` (sk[at] == k):
// doubling steps past the run, then a binary search inside the last step
__device__ __forceinline__ long long run_end(const long long* sk,
                                             long long n, long long at,
                                             long long k) {
  long long lo = at + 1, step = 1, hi;  // sk[lo - 1] == k
  for (;;) {
    hi = lo + step - 1;
    if (hi >= n) {
      hi = n;
      break;
    }
    if (sk[hi] != k) break;  // sk[hi] > k
    lo = hi + 1;
    step <<= 1;
  }
  while (lo < hi) {  // sk[lo, hi) >= k: the first > k
    const long long mid = lo + ((hi - lo) >> 1);
    if (sk[mid] == k)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// each item's run of matches (its first sorted row lo and its count), for
// live keys; every item's loads of one step are issued before any is used
// (no step waits on another item's)
__device__ __forceinline__ void dense_runs(const ProbeParams& p,
                                           const long long* key,
                                           const bool* live, int* lo,
                                           int* cnt) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const u64 d = (u64)key[j] - (u64)p.key_lo;
    const bool in = live[j] && d < (u64)p.span;
    lo[j] = in ? p.off[d] : 0;
    cnt[j] = in ? p.off[d + 1] : 0;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) cnt[j] -= lo[j];
}

// s_sample[i] = sk[min(i * step, n - 1)], step = ceil(n / SAMPLES): the
// top of every search, in shared memory
__device__ __forceinline__ void sparse_runs(const ProbeParams& p,
                                            const long long* key,
                                            const bool* live, int* lo,
                                            int* cnt,
                                            const long long* s_sample) {
  const long long n = p.n_build;
  const long long step = (n + SAMPLES - 1) / SAMPLES;
  // g: the samples below each key, so its first row at or above it lies
  // in ((g - 1) * step, g * step] (0 when g = 0)
  int g[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) g[j] = 0;
  for (int len = SAMPLES; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (s_sample[g[j] + half] < key[j]) g[j] += half;
    len -= half;
  }
  // b: then the last row below each key within its step, all items in
  // step (rows past n count as above every key)
  long long b[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    g[j] += s_sample[g[j]] < key[j];
    b[j] = g[j] == 0 ? 0 : (g[j] - 1) * step + 1;
  }
  for (long long len = step; len > 1;) {
    const long long half = len >> 1;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long x = b[j] + half;
      if (live[j] && g[j] > 0 && x < n && p.sk[x] < key[j]) b[j] = x;
    }
    len -= half;
  }
  // rows b, b + 1 and b + 2 in one step: the first row at or above the
  // key (a = b or b + 1) and the one after it, which ends a unique key's run
  long long a[ITEMS], end[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long x = b[j];
    const long long k0 = live[j] && x < n ? p.sk[x] : 0;
    const long long k1 = live[j] && x + 1 < n ? p.sk[x + 1] : 0;
    const long long k2 = live[j] && x + 2 < n ? p.sk[x + 2] : 0;
    const bool up = x < n && k0 < key[j];
    a[j] = !live[j] ? n : x + up;
    const bool at = a[j] < n && (up ? k1 : k0) == key[j];
    const bool more = a[j] + 1 < n && (up ? k2 : k1) == key[j];
    end[j] = !at ? a[j] : more ? -1 : a[j] + 1;  // -1: a longer run
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (end[j] < 0) end[j] = run_end(p.sk, n, a[j] + 1, key[j]);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    lo[j] = (int)a[j];
    cnt[j] = end[j] > a[j] ? (int)(p.prefix[end[j]] - p.prefix[a[j]]) : 0;
  }
}

__device__ __forceinline__ void publish(u64* word, u64 v) {
  *reinterpret_cast<volatile u64*>(word) = v;
}

// the total of the tiles before `tile` (every lane of one warp calls it):
// each step reads the 32 nearest unread predecessors' words, waiting for
// each to be published, and stops at the nearest inclusive one
__device__ __forceinline__ long long look_back(const u64* status,
                                               long long tile) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (long long j = tile - 1;; j -= 32) {
    const long long at = j - lane;
    u64 s = FLAG_PREFIX;  // before tile 0: an inclusive 0
    if (at >= 0) do {
        s = *reinterpret_cast<const volatile u64*>(status + at);
      } while ((s & ~COUNT_MASK) == 0);
    const unsigned pre =
        __ballot_sync(FULL, (s & ~COUNT_MASK) == FLAG_PREFIX);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    long long v = lane <= stop ? (long long)(s & COUNT_MASK) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    excl += v;
    if (pre) return excl;
  }
}

template <bool DENSE>
__global__ void __launch_bounds__(THREADS)
    probe_kernel(const __grid_constant__ ProbeParams p) {
  __shared__ long long s_off[SOFF(TILE)];  // row's count, then first slot
  __shared__ long long s_tile, s_base;
  const int t = threadIdx.x, lane = t & 31;
  u64* status = p.work;
  if (t == 0) s_tile = (long long)atomicAdd(p.work + p.n_tiles, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const long long start = tile * TILE;
  const int rows =
      (int)(p.n_probe - start < TILE ? p.n_probe - start : TILE);
  // item j of thread t is row j * THREADS + t
  long long key[ITEMS];
  bool live[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int r = j * THREADS + t;
    const long long i = start + r;
    const bool in = r < rows;
    key[j] = in ? __ldcs(p.pkeys + i) : 0;
    const bool ok = !in || p.pvalid == nullptr || __ldcs(p.pvalid + i) != 0;
    const bool sel = !in || p.mask == nullptr || __ldcs(p.mask + i) != 0;
    live[j] = in && ok && sel;
  }
  int lo[ITEMS], cnt[ITEMS];
  if constexpr (DENSE) {
    dense_runs(p, key, live, lo, cnt);
  } else {
    __shared__ long long s_sample[SAMPLES];
    const long long* sample =
        reinterpret_cast<const long long*>(p.work + p.n_tiles + 2);
    long long sv[SAMPLES / THREADS];
#pragma unroll
    for (int u = 0; u < SAMPLES / THREADS; ++u)
      sv[u] = sample[t + u * THREADS];
#pragma unroll
    for (int u = 0; u < SAMPLES / THREADS; ++u)
      s_sample[t + u * THREADS] = sv[u];
    __syncthreads();
    sparse_runs(p, key, live, lo, cnt, s_sample);
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) s_off[SOFF(j * THREADS + t)] = cnt[j];
  __syncthreads();
  // the counts in row order: thread t scans rows [t * ITEMS, + ITEMS)
  long long c[ITEMS], sum = 0;
#pragma unroll
  for (int m = 0; m < ITEMS; ++m) {
    c[m] = s_off[SOFF(t * ITEMS + m)];
    sum += c[m];
  }
  long long tile_total;
  long long at = block_exclusive_scan<THREADS>(sum, Add<long long>(), 0ll,
                                               &tile_total);
#pragma unroll
  for (int m = 0; m < ITEMS; ++m) {
    s_off[SOFF(t * ITEMS + m)] = at;
    at += c[m];
  }
  // each run's first build row, loaded while warp 0 looks back
  int first[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) first[j] = cnt[j] > 0 ? p.perm[lo[j]] : 0;
  if (t < 32) {
    u64* mine = status + tile;
    if (t == 0)
      publish(mine, (tile == 0 ? FLAG_PREFIX : FLAG_AGG) | (u64)tile_total);
    const long long excl = tile > 0 ? look_back(status, tile) : 0;
    if (t == 0) {
      if (tile > 0) publish(mine, FLAG_PREFIX | (u64)(excl + tile_total));
      s_base = excl;
      if (tile == p.n_tiles - 1)
        *reinterpret_cast<long long*>(p.work + p.n_tiles + 1) =
            excl + tile_total;
    }
  }
  __syncthreads();
  // each row's pairs from slot base + its offset, below k_cap: a warp's
  // rows are consecutive, so its stores are too; a run of more than
  // LIGHT pairs is written by the whole warp
  const long long base = s_base;
  int2* out = reinterpret_cast<int2*>(p.pairs);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int r = j * THREADS + t;
    const int row = (int)(start + r);
    const long long slot = base + s_off[SOFF(r)];
    if (cnt[j] > 0 && slot < p.k_cap)
      __stcs(out + slot, make_int2(row, first[j]));
    if (cnt[j] <= LIGHT)
      for (int m = 1; m < cnt[j] && slot + m < p.k_cap; ++m)
        __stcs(out + slot + m, make_int2(row, p.perm[lo[j] + m]));
    for (unsigned heavy = __ballot_sync(FULL, cnt[j] > LIGHT); heavy;
         heavy &= heavy - 1) {
      const int l = __ffs(heavy) - 1;
      const long long hs = __shfl_sync(FULL, slot, l);
      const int hc = __shfl_sync(FULL, cnt[j], l);
      const int hlo = __shfl_sync(FULL, lo[j], l);
      const int hrow = __shfl_sync(FULL, row, l);
      for (int m = 1 + lane; m < hc && hs + m < p.k_cap; m += 32)
        __stcs(out + hs + m, make_int2(hrow, p.perm[hlo + m]));
    }
  }
}

// the sparse route's samples of sk (sparse_runs), after the work words
__global__ void __launch_bounds__(THREADS)
    sample_kernel(const long long* sk, long long n, long long* sample) {
  const long long step = (n + SAMPLES - 1) / SAMPLES;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const long long at = (long long)i * step;
  if (i < SAMPLES) sample[i] = sk[at < n ? at : n - 1];
}

// -1 over the pair slots [*total, k_cap), two slots (16 bytes) a store
__global__ void __launch_bounds__(THREADS)
    pair_fill_kernel(long long* slots, const long long* total,
                     long long k_cap) {
  const long long from = *total;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long c = (from >> 1) + (long long)blockIdx.x * THREADS +
                     threadIdx.x;
       2 * c < k_cap; c += stride) {
    const long long s = 2 * c;
    if (s >= from && s + 1 < k_cap) {
      __stcs(reinterpret_cast<longlong2*>(slots) + c, make_longlong2(-1, -1));
    } else {
      if (s >= from) __stcs(slots + s, -1ll);
      if (s + 1 >= from && s + 1 < k_cap) __stcs(slots + s + 1, -1ll);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    index_kernel(const __grid_constant__ IndexParams p) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * THREADS;
  // a warp's boundaries are i0 + lane, so its loop stays uniform
  for (long long i0 = (long long)blockIdx.x * THREADS + threadIdx.x - lane;
       i0 <= p.n_valid; i0 += stride) {
    const long long i = i0 + lane;
    long long a = 0, b = -1;  // the entries [a, b] that take i
    if (i <= p.n_valid) {
      a = i == 0 ? 0 : p.sk[i - 1] - p.key_lo + 1;
      b = i == p.n_valid ? p.span : p.sk[i] - p.key_lo;
    }
    if (b - a < 32)
      for (long long x = a; x <= b; ++x) p.off[x] = (int)i;
    for (unsigned longs = __ballot_sync(FULL, b - a >= 32); longs;
         longs &= longs - 1) {
      const int l = __ffs(longs) - 1;
      const long long la = __shfl_sync(FULL, a, l);
      const long long lb = __shfl_sync(FULL, b, l);
      for (long long x = la + lane; x <= lb; x += 32)
        p.off[x] = (int)(i0 + l);
    }
  }
}

}  // namespace

extern "C" {

// n_probe >= 1, n_build >= 1, k_cap >= 1, n_tiles = ceil(n_probe / TILE);
// a probe pass (dense with an index, else sparse), then the -1 fill
int join_probe_launch(int device, const ProbeParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p->n_probe < 1 || p->n_build < 1 || p->k_cap < 1 ||
      p->n_tiles != (p->n_probe + TILE - 1) / TILE ||
      (p->off != nullptr && p->span < 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(p->work, 0, (size_t)(p->n_tiles + 2) * sizeof(u64), s);
  if (e != cudaSuccess) return e;
  if (p->off != nullptr) {
    probe_kernel<true><<<(unsigned)p->n_tiles, THREADS, 0, s>>>(*p);
  } else {
    sample_kernel<<<SAMPLES / THREADS, THREADS, 0, s>>>(
        p->sk, p->n_build,
        reinterpret_cast<long long*>(p->work + p->n_tiles + 2));
    probe_kernel<false><<<(unsigned)p->n_tiles, THREADS, 0, s>>>(*p);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  long long blocks = (p->k_cap / 2 + THREADS) / THREADS;
  if (blocks > 4096) blocks = 4096;
  pair_fill_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      reinterpret_cast<long long*>(p->pairs),
      reinterpret_cast<const long long*>(p->work + p->n_tiles + 1),
      p->k_cap);
  return cudaGetLastError();
}

// n_valid >= 1, span >= 1 (off: span + 1 entries)
int join_index_launch(int device, const IndexParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p->n_valid < 1 || p->span < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (p->n_valid + THREADS) / THREADS;
  if (blocks > 4096) blocks = 4096;
  index_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(*p);
  return cudaGetLastError();
}

int probe_params_bytes() { return (int)sizeof(ProbeParams); }
int index_params_bytes() { return (int)sizeof(IndexParams); }
int probe_tile_rows() { return TILE; }
int probe_samples() { return SAMPLES; }

const char* join_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

// Column statistics of an ANALYZE request for Hopper: one column's sorted
// valid values summarised into the packed vector of the reference.
//
// Replaces the XLA kernel of tikv_tpu/device/runner.py:
//   _AnalyzeKernels._build (:4478): a sort of the column in its native
//   dtype with NULL and padding rows sentineled past every value, then
//   from the sorted array the valid count, the distinct count (adjacent
//   values that differ under !=) and the equi-depth bucket bounds at ranks
//   max((b * n_valid) / B - 1, 0), b = 1..B, packed into one int64 vector
//   [B bounds (int64, or float64 bits), B ranks + 1, n_valid, distinct].
//
// Order images (as sort.cu's): an int32 or int64 with its sign bit
// flipped, a uint32 or uint64 as itself, a float64 with -0.0 as +0.0,
// every NaN one image above +inf, then all bits of a negative flipped and
// the sign bit of a positive set.  A bound is the image at its rank turned
// back into a value, so a float bound of -0.0 comes back as +0.0 and a NaN
// as the canonical NaN 0x7fff...f (the reference gathers the original
// value: they are equal by value).  Every NaN counts distinct, as NaN !=
// NaN in the reference.  A valid row's key is its image less the least
// valid image (lo); NULL rows have no key.
//
// The answer needs no full sort: only the distinct count and B order
// statistics.  The design, per column:
//   1. range_kernel reads each value and validity byte once and folds the
//      valid count, lo and the complement of the greatest image into 24
//      bytes.  The host reads every column's range of a request in one
//      copy (the one wait of the request) and picks the route.
//   2. Counting route, keys spanning at most COUNT_SPAN = 2^15 values (a
//      block's table of 32-bit counters fills 128 KB of its 227 KB of
//      shared memory; 2^16 would need 16-bit counters and a spill):
//      count_kernel adds one to the key's counter of a block-private
//      table (a warp's lanes of one key in one shared atomic), then adds
//      the table's non-zero counters into one table of 64-bit counters;
//      count_stats_kernel (one block) reads that table once: the distinct
//      count is the non-zero counters (a NaN counter counts each row), and
//      a prefix sum over the counters places every rank.  About 10 B a
//      row with the range.
//   3. Partition route, wider spans: the keys are cut into buckets whose
//      key ranges do not overlap, chosen from the data:
//      - sample_kernel takes S = 16 x n_split keys at stratified random
//        rows (an invalid row gives the NULL key, which sorts last) and
//        counts their digits; onesweep.cuh's passes sort them;
//      - splitter_kernel (one block) takes every (S / n_split)-th sorted
//        valid sample as a splitter, drops repeats (D distinct splitters),
//        and tabulates for each value of the key's top 12 bits the first
//        splitter at or above it, so a lookup searches only the splitters
//        under one top-bit prefix;
//      - bucket 2i + 1 holds the keys equal to splitter i, bucket 2i the
//        keys strictly between splitters i - 1 and i: a value that repeats
//        more than a bucket holds is a splitter (it spans a run of the
//        sorted sample) and gets its own bucket, one distinct value that is
//        never read again;
//      - classify_kernel counts each block's rows a bucket (block-private
//        counters in shared memory); offsets_kernel and bucket_scan_kernel
//        turn the counts into each bucket's first rank and each block's
//        first slot a bucket; scatter_kernel reads the rows again and
//        writes every key of a between bucket once to its slot.  Where
//        the sample's neighbours descend (unsorted rows, whose keys would
//        land one at a time in scattered lines), group_kernel and
//        fine_kernel do that instead in two staged passes that write
//        runs: by groups of buckets, then by bucket (8 B more a key);
//      - bucket_kernel (a thread a bucket, then a block a bucket): an
//        equality bucket adds one distinct value (or its rows when it is
//        the NaN key) and writes the bounds of the ranks inside it; a
//        between bucket counts its distinct keys in a shared bitmap (a
//        narrow key range, many small blocks an SM) or, in
//        big_bucket_kernel, a shared hash table; one that holds a rank, or
//        more keys than the big table takes (3/4 of its slots: the bucket
//        past the shared budget), goes to
//      - sort_kernel: one block sorts such a bucket in device memory
//        (8-bit stable LSD passes over the key less the bucket's least
//        possible key, a warp's lanes ranked by __match_any_sync), then
//        counts adjacent keys that differ and writes the bounds of the
//        ranks inside it.  It is correct at any bucket size; the oversized
//        ones are counted (state[4]).
//      About 5 (range) + 5 (classify) + 5 + 4 (scatter) + 4 (bucket) = 23
//      B a row of 32-bit keys, 31 of 64-bit keys (16 more with the staged
//      scatter).
// Counters: a block counts fewer than 2^31 rows (the wrapper keeps n
// below 2^31), so its counters are 32-bit; where tables merge across
// blocks the sums are 64-bit.
//
// Bound: bytes.  Each value and validity byte read once and the packed
// vector written once: at config 4's table (104,857,600 rows) 0.52 GB for
// an int32 column, 0.157 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "scan.cuh"
#include "onesweep.cuh"

#define THREADS 256
#define UNROLL 4        // rows a thread loads before it uses any
#define PART_UNROLL 8   // the same in the one-block-an-SM streaming kernels
#define ITEMS32 16
#define ITEMS64 8
#define TILE32 (THREADS * ITEMS32)  // rows of a sample-sort tile, 32-bit keys
#define TILE64 (THREADS * ITEMS64)  // the same, 64-bit keys
#define RANGE_GRID 1024
#define BIG 1024        // threads of the partition and statistics kernels
#define COUNT_THREADS 512
#define COUNT_SPAN (1 << 15)
#define OVERSAMPLE 16
#define TAB_BITS 12
#define HASH_BYTES (128 * 1024)     // a between bucket's hash table
#define PART_GRID_MAX 512           // classify / scatter blocks at most
#define BATCH 8         // keys a thread of the bucket passes loads at once
#define SMALL_T 256     // threads of bucket_kernel
#define SMALL_TABLE (32 * 1024)     // its bitmap or hash table
#define GROUPS 256      // the staged scatter's groups of buckets
#define STAGE_ROWS (BIG * PART_UNROLL)  // its tile

typedef unsigned long long u64;

static_assert(THREADS == SWEEP_THREADS, "analyze.cu's blocks are onesweep's");

enum { KIND_I32 = 0, KIND_I64 = 1, KIND_U32 = 2, KIND_U64 = 3, KIND_F64 = 4 };
enum { ROUTE_EMPTY = 0, ROUTE_COUNT = 1, ROUTE_PARTITION = 2 };

// One column's launch parameters (device/analyze.py mirrors the layout
// and plans the route and the scratch).  range_launch fills range; the
// host then sets the key (n_valid, lo, top, bits, has_nan, nan_key), the
// route and the scratch pointers.  `zeroed` (zeroed_bytes) is cleared
// before the route's kernels: state, counters, table, sample_work.
struct AnalyzeParams {
  const void* values;          // n rows (or more) of the kind
  const unsigned char* valid;  // bool, the same rows
  long long n;                 // rows read: the live rows
  int kind;
  int n_buckets;               // B >= 1
  u64* range;                  // out: valid count, least, ~greatest image
  long long n_valid;
  u64 lo;                      // least image of a valid row
  u64 top;                     // greatest key: greatest image - lo
  int bits;                    // the NULL key's width, 0..64
  int has_nan;                 // a valid NaN (float64): its key is
  u64 nan_key;                 // nan_key (= top)
  u64 null_key;                // a sampled NULL row's key
  int route;                   // ROUTE_*
  int key_bytes;               // 4 or 8 (partition route)
  long long span;              // counting route: top + 1 counters
  int n_split;                 // splitters asked of the sample (0: one bucket)
  int n_sample;                // S = OVERSAMPLE * n_split
  void* zeroed;
  long long zeroed_bytes;
  u64* state;      // [0] valid samples, [1] D, [2] sort jobs, [3] next
                   // job, [4] oversized buckets, [5] adjacent samples
                   // that descend, [6] adjacent valid samples, [7]
                   // buckets left to big_bucket_kernel
  u64* counters;   // counting route: span 64-bit counters
  unsigned* table; // 2^TAB_BITS + 1 words: the first splitter per prefix
  u64* sample_work;            // the sample sort's zeroed words
  long long sample_work_words;
  void* sample[2];             // S keys each
  void* splitters;             // n_split keys
  unsigned* block_counts;      // PART_GRID_MAX x P (P = 2 n_split + 1)
  u64* totals;                 // P: keys a bucket
  u64* rank_start;             // P: a bucket's first rank
  u64* store_start;            // P: a between bucket's first slot
  u64* cursors;                // GROUPS + P: staged scatter's next slots
  unsigned* jobs;              // P: the buckets sort_kernel takes
  void* keys[2];               // n_valid keys each: buckets, sort scratch
  long long* out;              // int64[2B + 2]
};

namespace {

constexpr u64 SIGN = 0x8000000000000000ull;

template <int KIND>
__device__ __forceinline__ u64 image(const void* v, long long i) {
  if (KIND == KIND_I32)
    return (u64)(long long)static_cast<const int*>(v)[i] ^ SIGN;
  if (KIND == KIND_I64)
    return (u64)static_cast<const long long*>(v)[i] ^ SIGN;
  if (KIND == KIND_U32) return (u64)static_cast<const unsigned*>(v)[i];
  if (KIND == KIND_U64) return static_cast<const u64*>(v)[i];
  const double d = static_cast<const double*>(v)[i];
  if (d != d) return ~0ull;  // NaN: after +inf
  const u64 b = d == 0.0 ? 0ull : (u64)__double_as_longlong(d);
  return (b & SIGN) ? ~b : (b | SIGN);
}

// the packed word of an image: the int64 value, or the float64's bits
__device__ __forceinline__ long long word_of(int kind, u64 img) {
  if (kind == KIND_I32 || kind == KIND_I64) return (long long)(img ^ SIGN);
  if (kind == KIND_U32 || kind == KIND_U64) return (long long)img;
  return (long long)((img & SIGN) ? (img ^ SIGN) : ~img);
}

__device__ __forceinline__ u64 warp_min(u64 x) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 y = __shfl_xor_sync(FULL, x, o);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ u64 warp_sum(u64 x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// sum of v over the block, to every thread (BLOCK threads)
template <int BLOCK>
__device__ __forceinline__ u64 block_sum(u64 v) {
  u64 total;
  block_exclusive_scan<BLOCK>(v, Add<u64>(), 0ull, &total);
  return total;
}

// the images and validity of R rows from b, STEP apart (rows past end:
// invalid), every load issued before the first use
template <int KIND, int STEP, int R>
__device__ __forceinline__ void load_rows(const AnalyzeParams& p, long long b,
                                          long long end, u64 (&img)[R],
                                          bool (&ok)[R]) {
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const long long i = b + u * STEP;
    const bool in = i < end;
    ok[u] = in ? p.valid[i] != 0 : false;
    img[u] = in ? image<KIND>(p.values, i) : 0ull;
  }
}

// rank of bucket bound b: max((b + 1) * n_valid / B - 1, 0)
__device__ __forceinline__ long long rank_of(int b, long long nv, int nb) {
  const long long r = (long long)(b + 1) * nv / nb - 1;
  return r < 0 ? 0 : r;
}

// the first b in [0, B] whose rank is at least x
__device__ __forceinline__ int first_rank_at(long long x, long long nv,
                                             int nb) {
  int a = 0, z = nb;
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (rank_of(mid, nv, nb) < x)
      a = mid + 1;
    else
      z = mid;
  }
  return a;
}

// One add to c[b] for each lane where ok; returns the lane's slot: the
// counter before the warp's add plus the lane's rank among the warp's
// lanes of the same b.  Lanes of one b share one atomic when the warp is
// of one b, or when two neighbouring lanes share theirs (then
// __match_any_sync groups them); else each lane adds alone.
__device__ __forceinline__ unsigned warp_add(unsigned* c, unsigned b,
                                             bool ok) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned vm = __ballot_sync(FULL, ok);
  if (vm == 0) return 0;
  const unsigned b0 = __shfl_sync(FULL, b, __ffs(vm) - 1);
  unsigned peers;
  if (__all_sync(FULL, !ok || b == b0)) {
    peers = vm;
  } else {
    const unsigned up = __shfl_up_sync(FULL, b, 1);
    const bool dup = ok && lane > 0 && ((vm >> (lane - 1)) & 1u) && up == b;
    if (__any_sync(FULL, dup))
      peers = __match_any_sync(FULL, ok ? b : ~0u) & vm;
    else
      peers = 1u << lane;
  }
  const unsigned below = peers & ((1u << lane) - 1u);
  unsigned old = 0;
  if (ok && below == 0) old = atomicAdd(&c[b], (unsigned)__popc(peers));
  old = __shfl_sync(FULL, old, ok ? __ffs(peers) - 1 : lane);
  return old + __popc(below);
}

__device__ __forceinline__ int bit_length(u64 x) {
  return x == 0 ? 0 : 64 - __clzll(x);
}

// ---------------------------------------------------------------- range

template <int KIND>
__global__ void __launch_bounds__(THREADS)
    range_kernel(const __grid_constant__ AnalyzeParams p) {
  u64 cnt = 0, lo = ~0ull, nhi = ~0ull;
  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long b = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
       b < p.n; b += step) {
    u64 img[UNROLL];
    bool ok[UNROLL];
    load_rows<KIND, THREADS, UNROLL>(p, b, p.n, img, ok);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      ++cnt;
      lo = img[u] < lo ? img[u] : lo;
      nhi = ~img[u] < nhi ? ~img[u] : nhi;
    }
  }
  cnt = warp_sum(cnt);
  lo = warp_min(lo);
  nhi = warp_min(nhi);
  if ((threadIdx.x & 31) == 0) {
    if (cnt) atomicAdd(&p.range[0], cnt);
    atomicMin(&p.range[1], lo);
    atomicMin(&p.range[2], nhi);
  }
}

// the packed vector's rank words and n_valid, distinct 0, bounds 0 (the
// route overwrites every bound when a row is valid)
__global__ void head_kernel(const __grid_constant__ AnalyzeParams p) {
  const int nb = p.n_buckets;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    p.out[b] = 0;
    p.out[nb + b] = rank_of(b, p.n_valid, nb) + 1;
  }
  if (threadIdx.x == 0) {
    p.out[2 * nb] = p.n_valid;
    p.out[2 * nb + 1] = 0;
  }
}

// ------------------------------------------------------ counting route

template <int KIND>
__global__ void __launch_bounds__(COUNT_THREADS)
    count_kernel(const __grid_constant__ AnalyzeParams p) {
  extern __shared__ unsigned tab[];
  const int span = (int)p.span;
  for (int k = threadIdx.x; k < span; k += COUNT_THREADS) tab[k] = 0;
  __syncthreads();
  // the loop is uniform over the block: warp_add is warp-collective
  const long long step = (long long)gridDim.x * COUNT_THREADS * PART_UNROLL;
  for (long long b0 = (long long)blockIdx.x * COUNT_THREADS * PART_UNROLL;
       b0 < p.n; b0 += step) {
    u64 img[PART_UNROLL];
    bool ok[PART_UNROLL];
    load_rows<KIND, COUNT_THREADS, PART_UNROLL>(p, b0 + threadIdx.x, p.n,
                                                img, ok);
#pragma unroll
    for (int u = 0; u < PART_UNROLL; ++u)
      warp_add(tab, (unsigned)(img[u] - p.lo), ok[u]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < span; k += COUNT_THREADS)
    if (tab[k]) atomicAdd(&p.counters[k], (u64)tab[k]);
}

// one block: the distinct count and every bound from the counters
__global__ void __launch_bounds__(BIG)
    count_stats_kernel(const __grid_constant__ AnalyzeParams p) {
  const long long span = p.span, nv = p.n_valid;
  const int nb = p.n_buckets;
  const long long per = (span + BIG - 1) / BIG;
  const long long k0 = (long long)threadIdx.x * per;
  const long long k1 = k0 + per < span ? k0 + per : span;
  u64 sum = 0, nz = 0;
  for (long long k = k0; k < k1; ++k) {
    const u64 c = p.counters[k];
    sum += c;
    nz += c != 0;
  }
  u64 total;
  const u64 c0 = block_exclusive_scan<BIG>(sum, Add<u64>(), 0ull, &total);
  const u64 distinct = block_sum<BIG>(nz);
  // the ranks inside [c0, c0 + sum): walk the thread's counters
  u64 cum = c0;
  long long k = k0;
  for (int b = first_rank_at((long long)c0, nv, nb); b < nb; ++b) {
    const long long r = rank_of(b, nv, nb);
    if (r >= (long long)(c0 + sum)) break;
    while (cum + p.counters[k] <= (u64)r) cum += p.counters[k++];
    p.out[b] = word_of(p.kind, (u64)k + p.lo);
  }
  if (threadIdx.x == 0) {
    const u64 nan = p.has_nan ? p.counters[p.nan_key] : 0;
    p.out[2 * nb + 1] = (long long)(distinct + (nan > 1 ? nan - 1 : 0));
  }
}

// ----------------------------------------------------- partition route

__device__ __forceinline__ u64 mix64(u64 z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// sample j of S over n rows: a random row of the j-th of S equal strata
__device__ __forceinline__ long long sample_row(long long j, long long n,
                                                long long s) {
  const long long a = j * n / s, w = (j + 1) * n / s - a;
  if (w <= 1) return a < n ? a : n - 1;
  return a + (long long)(mix64((u64)j) % (u64)w);
}

template <int KIND, typename K>
__global__ void __launch_bounds__(THREADS)
    sample_kernel(const __grid_constant__ AnalyzeParams p, int passes) {
  __shared__ DigitCounts cnt;
  digit_counts_zero(cnt, passes);
  __syncthreads();
  K* out = static_cast<K*>(p.sample[0]);
  u64 good = 0, pairs = 0, down = 0;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
       j < p.n_sample; j += (long long)gridDim.x * THREADS) {
    const long long i = sample_row(j, p.n, p.n_sample);
    const bool ok = p.valid[i] != 0;
    const u64 key = ok ? image<KIND>(p.values, i) - p.lo : p.null_key;
    out[j] = (K)key;
    good += ok;
    digit_counts_add(cnt, key, passes);
    if (j > 0 && ok) {  // the sample before it, a stratum earlier
      const long long h = sample_row(j - 1, p.n, p.n_sample);
      if (p.valid[h]) {
        ++pairs;
        down += image<KIND>(p.values, h) - p.lo > key;
      }
    }
  }
  good = warp_sum(good);
  pairs = warp_sum(pairs);
  down = warp_sum(down);
  if ((threadIdx.x & 31) == 0 && good) atomicAdd(&p.state[0], good);
  if ((threadIdx.x & 31) == 0 && pairs) atomicAdd(&p.state[6], pairs);
  if ((threadIdx.x & 31) == 0 && down) atomicAdd(&p.state[5], down);
  __syncthreads();
  digit_counts_flush(cnt, passes, p.sample_work, SWEEP_RADIX);
}

// the first of d sorted splitters at or above x
template <typename K>
__device__ __forceinline__ unsigned lower_bound(const K* s, unsigned a,
                                                unsigned z, u64 x) {
  while (a < z) {
    const unsigned mid = (a + z) >> 1;
    if ((u64)s[mid] < x)
      a = mid + 1;
    else
      z = mid;
  }
  return a;
}

// one block: the distinct splitters of the sorted sample and the table
template <typename K>
__global__ void __launch_bounds__(BIG)
    splitter_kernel(const __grid_constant__ AnalyzeParams p,
                    const K* sorted) {
  const long long vs = (long long)p.state[0];
  const long long ps = p.n_split;
  K* spl = static_cast<K*>(p.splitters);
  unsigned carry = 0;
  for (long long base = 0; base < ps; base += BIG) {
    const long long j = base + threadIdx.x;
    const bool live = j < ps && vs > 0;
    K c = 0;
    bool keep = false;
    if (live) {
      c = sorted[(j + 1) * vs / (ps + 1)];
      keep = j == 0 || sorted[j * vs / (ps + 1)] != c;
    }
    unsigned tot;
    const unsigned at = block_exclusive_scan<BIG>(
        keep ? 1u : 0u, Add<unsigned>(), 0u, &tot);
    if (keep) spl[carry + at] = c;
    carry += tot;
  }
  if (threadIdx.x == 0) p.state[1] = carry;
  __syncthreads();
  const int sh = p.bits - TAB_BITS;
  for (int t = threadIdx.x; t <= (1 << TAB_BITS); t += BIG)
    p.table[t] = t == (1 << TAB_BITS)
                     ? carry
                     : lower_bound(spl, 0u, carry, (u64)t << sh);
}

// shared memory of classify and scatter: counters or slots a bucket,
// then the splitters and the table
template <typename K>
struct PartShared {
  unsigned* slot;
  K* spl;
  unsigned* tab;
};

template <typename K>
__device__ __forceinline__ PartShared<K> part_shared(unsigned char* smem,
                                                     int n_buckets,
                                                     int n_split) {
  PartShared<K> s;
  s.slot = reinterpret_cast<unsigned*>(smem);
  const long long off = ((long long)n_buckets * 4 + 15) / 16 * 16;
  s.spl = reinterpret_cast<K*>(smem + off);
  s.tab = reinterpret_cast<unsigned*>(smem + off +
                                      (long long)n_split * sizeof(K));
  return s;
}

long long part_smem(int n_buckets, int n_split, int key_bytes) {
  return ((long long)n_buckets * 4 + 15) / 16 * 16 +
         (long long)n_split * key_bytes + ((1 << TAB_BITS) + 1) * 4;
}

// the bucket of key k: 2i + 1 when k is splitter i, else 2i with i the
// first splitter above k
template <typename K>
__device__ __forceinline__ unsigned bucket_of(const PartShared<K>& s,
                                              unsigned d, int sh, u64 k) {
  const unsigned t = sh >= 0 ? (unsigned)(k >> sh) : 0u;
  const unsigned i = lower_bound(s.spl, s.tab[t], s.tab[t + 1], k);
  return 2 * i + (i < d && (u64)s.spl[i] == k ? 1u : 0u);
}

// the rows of block g of the partition kernels
__device__ __forceinline__ void block_rows(long long n, long long* a,
                                           long long* z) {
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  *a = per * blockIdx.x;
  *z = *a + per < n ? *a + per : n;
}

template <typename K>
__device__ __forceinline__ unsigned load_splitters(const AnalyzeParams& p,
                                                   const PartShared<K>& s) {
  const unsigned d = (unsigned)p.state[1];
  const K* spl = static_cast<const K*>(p.splitters);
  for (unsigned i = threadIdx.x; i < d; i += BIG) s.spl[i] = spl[i];
  for (int t = threadIdx.x; t <= (1 << TAB_BITS); t += BIG)
    s.tab[t] = p.table[t];
  return d;
}

template <int KIND, typename K>
__global__ void __launch_bounds__(BIG)
    classify_kernel(const __grid_constant__ AnalyzeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbk = 2 * p.n_split + 1;
  const PartShared<K> s = part_shared<K>(smem, nbk, p.n_split);
  const unsigned d = load_splitters(p, s);
  for (int q = threadIdx.x; q < nbk; q += BIG) s.slot[q] = 0;
  __syncthreads();
  const int sh = p.n_split ? p.bits - TAB_BITS : -1;
  long long a, z;
  block_rows(p.n, &a, &z);
  for (long long b0 = a; b0 < z; b0 += BIG * PART_UNROLL) {  // uniform
    u64 img[PART_UNROLL];
    bool ok[PART_UNROLL];
    load_rows<KIND, BIG, PART_UNROLL>(p, b0 + threadIdx.x, z, img, ok);
#pragma unroll
    for (int u = 0; u < PART_UNROLL; ++u)
      warp_add(s.slot, ok[u] ? bucket_of(s, d, sh, img[u] - p.lo) : 0u,
               ok[u]);
  }
  __syncthreads();
  unsigned* row = p.block_counts + (long long)blockIdx.x * nbk;
  for (int q = threadIdx.x; q < nbk; q += BIG) row[q] = s.slot[q];
}

// per bucket: the blocks' counts into their exclusive prefix, the total
__global__ void offsets_kernel(const __grid_constant__ AnalyzeParams p,
                               int grid) {
  const long long nbk = 2 * p.n_split + 1;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nbk) return;
  u64 run = 0;
  unsigned* c = p.block_counts + q;
  for (int g0 = 0; g0 < grid; g0 += 8) {  // 8 loads in flight, then stores
    unsigned v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = g0 + u < grid ? c[(g0 + u) * nbk] : 0u;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (g0 + u < grid) c[(g0 + u) * nbk] = (unsigned)run;
      run += v[u];
    }
  }
  p.totals[q] = run;
}

// one block: each bucket's first rank, and each between bucket's first
// slot in keys[0]
__global__ void __launch_bounds__(BIG)
    bucket_scan_kernel(const __grid_constant__ AnalyzeParams p) {
  const long long nbk = 2 * p.n_split + 1;
  const long long per = (nbk + BIG - 1) / BIG;
  const long long q0 = threadIdx.x * per;
  const long long q1 = q0 + per < nbk ? q0 + per : nbk;
  u64 all = 0, between = 0, total;
  for (long long q = q0; q < q1; ++q) {
    const u64 c = p.totals[q];
    all += c;
    between += (q & 1) ? 0ull : c;
  }
  u64 rank = block_exclusive_scan<BIG>(all, Add<u64>(), 0ull, &total);
  u64 store = block_exclusive_scan<BIG>(between, Add<u64>(), 0ull, &total);
  for (long long q = q0; q < q1; ++q) {
    const u64 c = p.totals[q];
    p.rank_start[q] = rank;
    p.store_start[q] = store;
    p.cursors[GROUPS + q] = store;
    rank += c;
    store += (q & 1) ? 0ull : c;
  }
  __syncthreads();
  // the staged scatter's groups: f consecutive buckets each
  const long long f = (nbk + GROUPS - 1) / GROUPS;
  for (int g = threadIdx.x; g < GROUPS; g += BIG)
    p.cursors[g] = g * f < nbk ? p.store_start[g * f] : store;
}

// whether the staged scatter (group_kernel, fine_kernel) writes the
// bucket keys: more than 1% of adjacent sampled valid rows descend, so a
// warp's keys land in many buckets (scatter_kernel writes sorted data)
__device__ __forceinline__ bool staged(const AnalyzeParams& p) {
  return p.n_split > 0 && p.state[5] * 100 > p.state[6];
}

template <int KIND, typename K>
__global__ void __launch_bounds__(BIG)
    scatter_kernel(const __grid_constant__ AnalyzeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (staged(p)) return;
  const int nbk = 2 * p.n_split + 1;
  const PartShared<K> s = part_shared<K>(smem, nbk, p.n_split);
  const unsigned d = load_splitters(p, s);
  const unsigned* row = p.block_counts + (long long)blockIdx.x * nbk;
  for (int q = threadIdx.x; q < nbk; q += BIG)
    s.slot[q] = (unsigned)p.store_start[q] + row[q];
  __syncthreads();
  const int sh = p.n_split ? p.bits - TAB_BITS : -1;
  K* keys = static_cast<K*>(p.keys[0]);
  long long a, z;
  block_rows(p.n, &a, &z);
  for (long long b0 = a; b0 < z; b0 += BIG * PART_UNROLL) {  // uniform
    u64 img[PART_UNROLL];
    bool ok[PART_UNROLL];
    load_rows<KIND, BIG, PART_UNROLL>(p, b0 + threadIdx.x, z, img, ok);
#pragma unroll
    for (int u = 0; u < PART_UNROLL; ++u) {
      const u64 key = img[u] - p.lo;
      const unsigned q = ok[u] ? bucket_of(s, d, sh, key) : 0u;
      const bool take = ok[u] && (q & 1u) == 0;  // equality buckets: none
      const unsigned at = warp_add(s.slot, q, take);
      if (take) keys[at] = (K)key;
    }
  }
}

// The staged scatter of unsorted data, in two passes that write only
// runs: group_kernel sorts each tile of STAGE_ROWS rows by group (GROUPS
// groups of consecutive buckets) in shared memory and writes each group's
// run to its next slots of keys[1] (a group's slots are its buckets' in
// order); fine_kernel reads each group's keys back tile by tile, sorts
// them by bucket the same way and writes each bucket's run to keys[0].
// Slots come from atomic cursors, so a bucket's keys land in any order.
template <typename K>
struct StageShared {
  K* key;            // STAGE_ROWS staged keys
  unsigned char* id; // their group or bucket within the group
  unsigned* cnt;     // BIG: keys of the tile a group / bucket
  unsigned* off;     // BIG: its first staged slot
  u64* base;         // BIG: its first output slot
};

template <typename K>
__device__ __forceinline__ StageShared<K> stage_shared(unsigned char* smem) {
  StageShared<K> s;
  s.key = reinterpret_cast<K*>(smem);
  s.base = reinterpret_cast<u64*>(smem + STAGE_ROWS * sizeof(K));
  s.cnt = reinterpret_cast<unsigned*>(s.base + BIG);
  s.off = s.cnt + BIG;
  s.id = reinterpret_cast<unsigned char*>(s.off + BIG);
  return s;
}

// shared bytes of StageShared
#define STAGE_SMEM_OF(key_bytes) \
  ((long long)STAGE_ROWS * (key_bytes) + BIG * 16 + STAGE_ROWS)

// The tile's keys (key[u] with id[u] where take[u], slot[u] from
// warp_add on s.cnt) staged by id, then written as runs: the run of id i
// from cursors[i] on (reserved with one atomic).  n_ids <= BIG.
template <typename K>
__device__ __forceinline__ void write_runs(
    const StageShared<K>& s, int n_ids, const K (&key)[PART_UNROLL],
    const unsigned (&id)[PART_UNROLL], const unsigned (&slot)[PART_UNROLL],
    const bool (&take)[PART_UNROLL], u64* cursors, K* out) {
  __syncthreads();
  unsigned total;
  const unsigned c = (int)threadIdx.x < n_ids ? s.cnt[threadIdx.x] : 0u;
  const unsigned ex = block_exclusive_scan<BIG>(c, Add<unsigned>(), 0u,
                                                &total);
  if ((int)threadIdx.x < n_ids) {
    s.off[threadIdx.x] = ex;
    s.base[threadIdx.x] = c ? atomicAdd(&cursors[threadIdx.x], (u64)c) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < PART_UNROLL; ++u)
    if (take[u]) {
      const unsigned at = s.off[id[u]] + slot[u];
      s.key[at] = key[u];
      s.id[at] = (unsigned char)id[u];
    }
  __syncthreads();
  for (unsigned i = threadIdx.x; i < total; i += BIG) {
    const unsigned g = s.id[i];
    out[s.base[g] + (i - s.off[g])] = s.key[i];
  }
  for (int i = threadIdx.x; i < n_ids; i += BIG) s.cnt[i] = 0;
  __syncthreads();
}

template <int KIND, typename K>
__global__ void __launch_bounds__(BIG)
    group_kernel(const __grid_constant__ AnalyzeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (!staged(p)) return;
  const int nbk = 2 * p.n_split + 1;
  const unsigned f = (unsigned)((nbk + GROUPS - 1) / GROUPS);
  const StageShared<K> st = stage_shared<K>(smem);
  const PartShared<K> s = part_shared<K>(
      smem + STAGE_SMEM_OF(sizeof(K)), 0, p.n_split);
  const unsigned d = load_splitters(p, s);
  for (int i = threadIdx.x; i < GROUPS; i += BIG) st.cnt[i] = 0;
  __syncthreads();
  const int sh = p.bits - TAB_BITS;
  K* out = static_cast<K*>(p.keys[1]);
  const long long step = (long long)gridDim.x * STAGE_ROWS;
  for (long long b0 = (long long)blockIdx.x * STAGE_ROWS; b0 < p.n;
       b0 += step) {  // uniform over the block
    u64 img[PART_UNROLL];
    bool ok[PART_UNROLL];
    load_rows<KIND, BIG, PART_UNROLL>(p, b0 + threadIdx.x, p.n, img, ok);
    K key[PART_UNROLL];
    unsigned id[PART_UNROLL], slot[PART_UNROLL];
    bool take[PART_UNROLL];
#pragma unroll
    for (int u = 0; u < PART_UNROLL; ++u) {
      const u64 k = img[u] - p.lo;
      const unsigned q = ok[u] ? bucket_of(s, d, sh, k) : 0u;
      take[u] = ok[u] && (q & 1u) == 0;  // equality buckets: none
      key[u] = (K)k;
      id[u] = q / f;
      slot[u] = warp_add(st.cnt, id[u], take[u]);
    }
    write_runs(st, GROUPS, key, id, slot, take, p.cursors, out);
  }
}

template <typename K>
__global__ void __launch_bounds__(BIG)
    fine_kernel(const __grid_constant__ AnalyzeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (!staged(p)) return;
  const long long nbk = 2 * p.n_split + 1;
  const unsigned f = (unsigned)((nbk + GROUPS - 1) / GROUPS);
  const StageShared<K> st = stage_shared<K>(smem);
  const K* spl = static_cast<const K*>(p.splitters);
  const unsigned d = (unsigned)p.state[1];
  const K* in = static_cast<const K*>(p.keys[1]);
  K* out = static_cast<K*>(p.keys[0]);
  for (int i = threadIdx.x; i < BIG; i += BIG) st.cnt[i] = 0;
  __syncthreads();
  for (long long g = blockIdx.x; g < GROUPS; g += gridDim.x) {
    const long long q_lo = g * f;
    if (q_lo >= nbk) break;
    // a key of the group's bucket 2i has its splitter i in [i_lo, i_hi]
    const unsigned i_lo = (unsigned)(q_lo / 2);
    unsigned i_hi = (unsigned)((q_lo + f - 1) / 2);
    i_hi = i_hi < d ? i_hi : d;
    const long long a = (long long)p.store_start[q_lo];
    const long long z = (long long)p.cursors[g];  // its end, after groups
    for (long long x0 = a; x0 < z; x0 += STAGE_ROWS) {  // uniform
      K key[PART_UNROLL];
      unsigned id[PART_UNROLL], slot[PART_UNROLL];
      bool take[PART_UNROLL];
#pragma unroll
      for (int u = 0; u < PART_UNROLL; ++u) {
        const long long x = x0 + (long long)u * BIG + threadIdx.x;
        take[u] = x < z;
        key[u] = take[u] ? in[x] : (K)0;
      }
#pragma unroll
      for (int u = 0; u < PART_UNROLL; ++u) {
        const unsigned i = take[u] ? lower_bound(spl, i_lo, i_hi, key[u])
                                   : i_lo;
        id[u] = 2 * i - (unsigned)q_lo;  // the bucket within the group
        slot[u] = warp_add(st.cnt, id[u], take[u]);
      }
      write_runs(st, (int)f, key, id, slot, take,
                 p.cursors + GROUPS + q_lo, out);
    }
  }
}

// the least and greatest key a between bucket 2i can hold
template <typename K>
__device__ __forceinline__ void between_range(const AnalyzeParams& p,
                                              unsigned i, unsigned d, u64* a,
                                              u64* z) {
  const K* spl = static_cast<const K*>(p.splitters);
  *a = i > 0 ? (u64)spl[i - 1] + 1 : 0ull;
  *z = i < d ? (u64)spl[i] - 1 : p.top;
}

template <typename K>
__device__ __forceinline__ unsigned hash_slot(K k, int hbits) {
  if (sizeof(K) == 4)
    return ((unsigned)k * 2654435761u) >> (32 - hbits);
  return (unsigned)(((u64)k * 0x9E3779B97F4A7C15ull) >> (64 - hbits));
}

// Sets bit `rel` of the bitmap for each lane where ok: one atomicOr a
// warp when its lanes share a word (keys of a dense column arrive in
// order), else one a lane.
__device__ __forceinline__ void bitmap_add(unsigned* bits, u64 rel, bool ok) {
  const unsigned vm = __ballot_sync(FULL, ok);
  if (vm == 0) return;
  const unsigned w = (unsigned)(rel >> 5), bit = 1u << (rel & 31);
  const unsigned w0 = __shfl_sync(FULL, w, __ffs(vm) - 1);
  if (__all_sync(FULL, !ok || w == w0)) {
    const unsigned all = __reduce_or_sync(FULL, ok ? bit : 0u);
    if ((threadIdx.x & 31) == (unsigned)(__ffs(vm) - 1)) atomicOr(&bits[w0], all);
  } else if (ok) {
    atomicOr(&bits[w], bit);
  }
}

// Distinct keys of a between bucket: its m keys at src, its key range
// [lo_key, hi_key] (the NaN key, every one distinct, not inserted).  In a
// shared bitmap where the range has at most 8 * TABLE values, else in a
// shared hash table of TABLE bytes (the caller keeps m at most 3/4 of its
// slots).  Every thread of the T-thread block calls it; thread 0 gets the
// count.
template <typename K, int T, int TABLE>
__device__ unsigned count_bucket(const AnalyzeParams& p, const K* src,
                                 long long m, u64 lo_key, u64 hi_key,
                                 unsigned char* smem, unsigned* s_found,
                                 unsigned* s_empty) {
  constexpr int SLOTS = TABLE / sizeof(K);
  constexpr K EMPTY = (K)~0ull;
  K* tab = reinterpret_cast<K*>(smem);
  unsigned* bits = reinterpret_cast<unsigned*>(smem);
  const bool dense = hi_key - lo_key < (u64)TABLE * 8;
  const bool nan = p.has_nan && p.nan_key >= lo_key && p.nan_key <= hi_key;
  int hbits = 5;  // at least twice the keys, at most SLOTS slots
  while ((1ll << hbits) < 2 * m && (1 << hbits) < SLOTS) ++hbits;
  const unsigned mask = (1u << hbits) - 1u;
  const unsigned words =
      dense ? (unsigned)((hi_key - lo_key) >> 5) + 1u : 0u;
  if (dense)
    for (unsigned w = threadIdx.x; w < words; w += T) bits[w] = 0;
  else
    for (unsigned h = threadIdx.x; h <= mask; h += T) tab[h] = EMPTY;
  if (threadIdx.x == 0) *s_found = *s_empty = 0;
  __syncthreads();
  unsigned found = 0;
  // BATCH keys a thread loaded before any is used; the loop is uniform
  // over the block (the bitmap's adds are warp-collective)
  for (long long x0 = 0; x0 < m; x0 += (long long)T * BATCH) {
    K k[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const long long x = x0 + (long long)u * T + threadIdx.x;
      k[u] = x < m ? src[x] : (K)0;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const bool live = x0 + (long long)u * T + threadIdx.x < m;
      const bool is_nan = live && nan && (u64)k[u] == p.nan_key;
      found += is_nan;  // every NaN is distinct
      if (dense) {
        bitmap_add(bits, (u64)k[u] - lo_key, live && !is_nan);
      } else if (live && !is_nan) {
        if (k[u] == EMPTY) {
          *s_empty = 1;
          continue;
        }
        for (unsigned h = hash_slot(k[u], hbits);; h = (h + 1) & mask) {
          const K old = atomicCAS(&tab[h], EMPTY, k[u]);
          if (old == EMPTY) {
            ++found;
            break;
          }
          if (old == k[u]) break;
        }
      }
    }
  }
  if (dense) {
    __syncthreads();
    for (unsigned w = threadIdx.x; w < words; w += T)
      found += __popc(bits[w]);
  }
  found = __reduce_add_sync(FULL, found);
  if ((threadIdx.x & 31) == 0 && found) atomicAdd(s_found, found);
  __syncthreads();
  const unsigned all = *s_found + *s_empty;
  __syncthreads();
  return all;
}

// The first pass over the buckets, SMALL_T threads a block with a
// SMALL_TABLE-byte table, many blocks an SM; each block takes up to
// SMALL_T buckets at a time.  First a thread a bucket: an equality bucket
// adds one distinct value (or its rows when it is the NaN key) and writes
// the bounds of the ranks inside it; a between bucket that holds a rank,
// or more keys than HASH_BYTES' table takes (the bucket past the shared
// budget), is queued for sort_kernel; one whose key range has at most 8 *
// SMALL_TABLE values is listed, and the block then counts each listed
// bucket's distinct keys in a bitmap; the rest wait for big_bucket_kernel
// (listed from the end of jobs, counted in state[7]), with four times the
// table and threads (hashing in 32 KB tables by 256 threads measured
// slower on an H100).
struct Listed {
  unsigned n;
  unsigned m[SMALL_T];
  long long at[SMALL_T];
  u64 lo[SMALL_T];
  u64 hi[SMALL_T];
};

template <typename K>
__global__ void __launch_bounds__(SMALL_T)
    bucket_kernel(const __grid_constant__ AnalyzeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Listed s_list;
  __shared__ unsigned s_found, s_empty;
  constexpr int BIG_KEYS = HASH_BYTES / sizeof(K) * 3 / 4;
  const long long nv = p.n_valid;
  const int nb = p.n_buckets;
  const unsigned d = (unsigned)p.state[1];
  const long long nbk = 2 * (long long)d + 1;
  const long long last = 2 * (long long)p.n_split;  // jobs' last entry
  const K* spl = static_cast<const K*>(p.splitters);
  const K* keys = static_cast<const K*>(p.keys[0]);
  // a block's buckets at a time: an even share of them, at most SMALL_T
  long long chunk = (nbk + gridDim.x - 1) / gridDim.x;
  chunk = chunk < SMALL_T ? chunk : SMALL_T;
  u64 distinct = 0;  // the thread's
  for (long long q0 = blockIdx.x * chunk; q0 < nbk;
       q0 += (long long)gridDim.x * chunk) {
    if (threadIdx.x == 0) s_list.n = 0;
    __syncthreads();
    const long long q = q0 + threadIdx.x;
    const long long m =
        threadIdx.x < chunk && q < nbk ? (long long)p.totals[q] : 0;
    if (m > 0) {
      const long long rs = (long long)p.rank_start[q];
      const int b0 = first_rank_at(rs, nv, nb);
      const bool ranked = b0 < nb && rank_of(b0, nv, nb) < rs + m;
      if (q & 1) {  // equality bucket: one value
        const u64 v = (u64)spl[q >> 1];
        distinct += p.has_nan && v == p.nan_key ? (u64)m : 1ull;
        if (ranked) {
          const int b1 = first_rank_at(rs + m, nv, nb);
          for (int b = b0; b < b1; ++b) p.out[b] = word_of(p.kind, v + p.lo);
        }
      } else if (ranked || m > BIG_KEYS) {
        p.jobs[atomicAdd(&p.state[2], 1ull)] = (unsigned)q;
        if (m > BIG_KEYS) atomicAdd(&p.state[4], 1ull);
      } else {
        u64 lo_key, hi_key;
        between_range<K>(p, (unsigned)(q >> 1), d, &lo_key, &hi_key);
        if (hi_key - lo_key < (u64)SMALL_TABLE * 8) {  // its bitmap fits
          const unsigned i = atomicAdd(&s_list.n, 1u);
          s_list.m[i] = (unsigned)m;
          s_list.at[i] = (long long)p.store_start[q];
          s_list.lo[i] = lo_key;
          s_list.hi[i] = hi_key;
        } else {
          p.jobs[last - (long long)atomicAdd(&p.state[7], 1ull)] =
              (unsigned)q;
        }
      }
    }
    __syncthreads();
    const unsigned listed = s_list.n;
    for (unsigned li = 0; li < listed; ++li) {
      const unsigned c = count_bucket<K, SMALL_T, SMALL_TABLE>(
          p, keys + s_list.at[li], s_list.m[li], s_list.lo[li],
          s_list.hi[li], smem, &s_found, &s_empty);
      if (threadIdx.x == 0) distinct += c;
    }
    __syncthreads();  // every thread has read s_list.n
  }
  distinct = block_sum<SMALL_T>(distinct);
  if (threadIdx.x == 0 && distinct)
    atomicAdd(reinterpret_cast<u64*>(&p.out[2 * nb + 1]), distinct);
}

// The second pass: a BIG-thread block with a HASH_BYTES table a bucket
// that bucket_kernel left (state[7] of them, from the end of jobs).
template <typename K>
__global__ void __launch_bounds__(BIG)
    big_bucket_kernel(const __grid_constant__ AnalyzeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_found, s_empty;
  const unsigned d = (unsigned)p.state[1];
  const unsigned n_big = (unsigned)p.state[7];
  const long long last = 2 * (long long)p.n_split;
  const K* keys = static_cast<const K*>(p.keys[0]);
  u64 distinct = 0;  // thread 0's
  for (unsigned k = blockIdx.x; k < n_big; k += gridDim.x) {
    const unsigned q = p.jobs[last - k];
    u64 lo_key, hi_key;
    between_range<K>(p, q >> 1, d, &lo_key, &hi_key);
    const unsigned c = count_bucket<K, BIG, HASH_BYTES>(
        p, keys + p.store_start[q], (long long)p.totals[q], lo_key, hi_key,
        smem, &s_found, &s_empty);
    if (threadIdx.x == 0) distinct += c;
  }
  if (threadIdx.x == 0 && distinct)
    atomicAdd(reinterpret_cast<u64*>(&p.out[2 * p.n_buckets + 1]), distinct);
}

// One block sorts a[0, m) (keys of `bits` bits) by stable 8-bit LSD
// passes between a and b; returns the sorted copy.  Each pass counts its
// digits, then takes the keys in tiles of BIG: a warp's lanes of one
// digit ranked by __match_any_sync, per-warp counts scanned over warps in
// digit order, each key written to its slot.
struct SortShared {
  unsigned base[SWEEP_RADIX];
  unsigned whist[BIG / 32][SWEEP_RADIX];
};

template <typename K>
__device__ K* block_sort(K* a, K* b, long long m, int bits, SortShared& s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int shift = 0; shift < bits; shift += SWEEP_DIGIT_BITS) {
    if (t < SWEEP_RADIX) s.base[t] = 0;
    __syncthreads();
    for (long long x0 = 0; x0 < m; x0 += BIG) {
      const long long x = x0 + t;
      const bool live = x < m;
      warp_add(s.base,
               live ? (unsigned)(a[x] >> shift) & (SWEEP_RADIX - 1) : 0u,
               live);
    }
    __syncthreads();
    unsigned tot;
    const unsigned c = t < SWEEP_RADIX ? s.base[t] : 0u;
    const unsigned ex =
        block_exclusive_scan<BIG>(c, Add<unsigned>(), 0u, &tot);
    if (t < SWEEP_RADIX) s.base[t] = ex;
    for (long long x0 = 0; x0 < m; x0 += BIG) {
      const long long x = x0 + t;
      const bool live = x < m;
      const K k = live ? a[x] : (K)0;
      const unsigned dg =
          live ? (unsigned)(k >> shift) & (SWEEP_RADIX - 1) : SWEEP_RADIX;
      for (int w = t; w < (BIG / 32) * SWEEP_RADIX; w += BIG)
        (&s.whist[0][0])[w] = 0;
      __syncthreads();
      const unsigned peers = __match_any_sync(FULL, dg);
      if (live && (peers & below) == 0) s.whist[warp][dg] = __popc(peers);
      __syncthreads();
      if (t < SWEEP_RADIX) {
        unsigned run = s.base[t];
        for (int w = 0; w < BIG / 32; ++w) {
          const unsigned v = s.whist[w][t];
          s.whist[w][t] = run;
          run += v;
        }
        s.base[t] = run;
      }
      __syncthreads();
      if (live) b[s.whist[warp][dg] + __popc(peers & below)] = k;
      __syncthreads();
    }
    K* sw = a;
    a = b;
    b = sw;
  }
  return a;
}

// a block a queued bucket: its keys less its least possible key, sorted in
// device memory; the adjacent keys that differ and the bounds of its ranks
template <typename K>
__global__ void __launch_bounds__(BIG)
    sort_kernel(const __grid_constant__ AnalyzeParams p) {
  __shared__ SortShared s;
  __shared__ unsigned s_job;
  const long long nv = p.n_valid;
  const int nb = p.n_buckets;
  const unsigned d = (unsigned)p.state[1];
  const unsigned n_jobs = (unsigned)p.state[2];
  u64 distinct = 0;  // thread 0's
  for (;;) {
    if (threadIdx.x == 0) s_job = (unsigned)atomicAdd(&p.state[3], 1ull);
    __syncthreads();
    const unsigned job = s_job;
    __syncthreads();
    if (job >= n_jobs) break;
    const unsigned q = p.jobs[job];
    const long long m = (long long)p.totals[q];
    const long long rs = (long long)p.rank_start[q];
    const long long at = (long long)p.store_start[q];
    u64 lo_key, hi_key;
    between_range<K>(p, q >> 1, d, &lo_key, &hi_key);
    K* a = static_cast<K*>(p.keys[0]) + at;
    K* b = static_cast<K*>(p.keys[1]) + at;
    for (long long x = threadIdx.x; x < m; x += BIG) a[x] -= (K)lo_key;
    __syncthreads();
    const K* sorted = block_sort(a, b, m, bit_length(hi_key - lo_key), s);
    const bool nan = p.has_nan && p.nan_key >= lo_key && p.nan_key <= hi_key;
    const K nan_rel = (K)(p.nan_key - lo_key);
    u64 c = 0;
    for (long long x = threadIdx.x; x < m; x += BIG)
      c += x == 0 || sorted[x] != sorted[x - 1] ||
           (nan && sorted[x - 1] == nan_rel);
    c = block_sum<BIG>(c);
    if (threadIdx.x == 0) distinct += c;
    const int b0 = first_rank_at(rs, nv, nb);
    const int b1 = first_rank_at(rs + m, nv, nb);
    for (int bb = b0 + threadIdx.x; bb < b1; bb += BIG)
      p.out[bb] = word_of(
          p.kind, (u64)sorted[rank_of(bb, nv, nb) - rs] + lo_key + p.lo);
    __syncthreads();
  }
  if (threadIdx.x == 0 && distinct)
    atomicAdd(reinterpret_cast<u64*>(&p.out[2 * nb + 1]), distinct);
}

// ------------------------------------------------------------ launchers

unsigned grid_of(long long n, unsigned cap) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > cap) b = cap;
  return (unsigned)(b < 1 ? 1 : b);
}

int passes_of(int bits) {
  return (bits + SWEEP_DIGIT_BITS - 1) / SWEEP_DIGIT_BITS;
}

// blocks of `threads` with `smem` dynamic bytes the card keeps resident,
// remembered per device, kernel and size (a column's launch asks once); a
// kernel's dynamic shared limit only ever grows
cudaError_t resident(const void* fn, int threads, long long smem, int* grid) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, long long>, int> seen;
  static std::map<std::pair<int, const void*>, long long> limit;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(mu);
  const auto key = std::make_tuple(dev, fn, threads, smem);
  const auto hit = seen.find(key);
  if (hit != seen.end()) {
    *grid = hit->second;
    return cudaSuccess;
  }
  long long& lim = limit[std::make_pair(dev, fn)];
  if (smem > 48 * 1024 && smem > lim) {
    if ((e = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return e;
    lim = smem;
  }
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, threads, (size_t)smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = seen[key] = sms * per_sm;
  return cudaSuccess;
}

cudaError_t launch(const void* fn, int grid, int threads, long long smem,
                   const AnalyzeParams& p, cudaStream_t s) {
  void* args[] = {const_cast<AnalyzeParams*>(&p)};
  cudaError_t e = cudaLaunchKernel(fn, dim3(grid), dim3(threads), args,
                                   (size_t)smem, s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Each run_* launches its route's kernels in order; `stages` > 0 stops
// after that many stages (the chip smoke times each kernel as the
// difference of two prefixes), 0 runs them all.
#define STAGE()                                        \
  do {                                                 \
    if (stages > 0 && ++stage > stages) return cudaSuccess; \
  } while (0)

template <int KIND>
cudaError_t run_count(const AnalyzeParams& p, int stages, int stage,
                      cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(&count_kernel<KIND>);
  const long long smem = p.span * 4;
  int grid;
  cudaError_t e = resident(fn, COUNT_THREADS, smem, &grid);
  if (e != cudaSuccess) return e;
  const long long need = (p.n + COUNT_THREADS * PART_UNROLL - 1) /
                         (COUNT_THREADS * PART_UNROLL);
  if (grid > need) grid = (int)(need < 1 ? 1 : need);
  STAGE();
  if ((e = launch(fn, grid, COUNT_THREADS, smem, p, s)) != cudaSuccess)
    return e;
  STAGE();
  return launch(reinterpret_cast<const void*>(&count_stats_kernel), 1, BIG,
                0, p, s);
}

template <int KIND, typename K, int ITEMS>
cudaError_t run_partition(const AnalyzeParams& p, int stages, int stage,
                          cudaStream_t s) {
  cudaError_t e;
  const int nbk = 2 * p.n_split + 1;
  if (p.n_split > 0) {
    // the sample and its sort (onesweep.cuh's passes)
    const int passes = passes_of(p.bits);
    const long long S = p.n_sample;
    const long long n_tiles = (S + THREADS * ITEMS - 1) / (THREADS * ITEMS);
    u64* hist = p.sample_work;                      // passes x RADIX
    u64* counters = hist + passes * SWEEP_RADIX;    // passes
    u64* status = counters + passes;                // passes x tiles x RADIX
    if (passes * (n_tiles * SWEEP_RADIX + SWEEP_RADIX + 1) >
        p.sample_work_words)
      return cudaErrorInvalidValue;
    STAGE();
    sample_kernel<KIND, K><<<grid_of(S, RANGE_GRID), THREADS, 0, s>>>(
        p, passes);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    K* sk[2] = {static_cast<K*>(p.sample[0]), static_cast<K*>(p.sample[1])};
    STAGE();
    for (int q = 0; q < passes; ++q)
      onesweep_kernel<K, ITEMS, false>
          <<<(unsigned)n_tiles, SWEEP_THREADS, 0, s>>>(
              sk[q & 1], sk[(q + 1) & 1], nullptr, nullptr, S,
              SWEEP_DIGIT_BITS * q, hist + q * SWEEP_RADIX,
              status + (long long)q * n_tiles * SWEEP_RADIX, counters + q);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    STAGE();
    splitter_kernel<K><<<1, BIG, 0, s>>>(p, sk[passes & 1]);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  } else {
    stage += 3;  // no sample: its three stages take no time
  }
  const long long smem = part_smem(nbk, p.n_split, sizeof(K));
  const void* cls = reinterpret_cast<const void*>(&classify_kernel<KIND, K>);
  const void* sct = reinterpret_cast<const void*>(&scatter_kernel<KIND, K>);
  int grid, g2;
  if ((e = resident(cls, BIG, smem, &grid)) != cudaSuccess) return e;
  if ((e = resident(sct, BIG, smem, &g2)) != cudaSuccess) return e;
  if (g2 < grid) grid = g2;
  if (grid > PART_GRID_MAX) grid = PART_GRID_MAX;
  const long long need = (p.n + BIG * PART_UNROLL - 1) / (BIG * PART_UNROLL);
  if (grid > need) grid = (int)(need < 1 ? 1 : need);
  STAGE();
  if ((e = launch(cls, grid, BIG, smem, p, s)) != cudaSuccess) return e;
  STAGE();
  offsets_kernel<<<(nbk + 255) / 256, 256, 0, s>>>(p, grid);
  bucket_scan_kernel<<<1, BIG, 0, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  STAGE();
  if ((e = launch(sct, grid, BIG, smem, p, s)) != cudaSuccess) return e;
  // the staged scatter (each kernel returns at once unless the sample
  // found the rows unsorted)
  const long long gsmem = STAGE_SMEM_OF(sizeof(K)) + part_smem(0, p.n_split,
                                                             sizeof(K));
  const void* grp = reinterpret_cast<const void*>(&group_kernel<KIND, K>);
  int ggrid;
  if ((e = resident(grp, BIG, gsmem, &ggrid)) != cudaSuccess) return e;
  const long long tiles = (p.n + STAGE_ROWS - 1) / STAGE_ROWS;
  if (ggrid > tiles) ggrid = (int)(tiles < 1 ? 1 : tiles);
  STAGE();
  if ((e = launch(grp, ggrid, BIG, gsmem, p, s)) != cudaSuccess) return e;
  const void* fin = reinterpret_cast<const void*>(&fine_kernel<K>);
  int fgrid;
  if ((e = resident(fin, BIG, STAGE_SMEM_OF(sizeof(K)), &fgrid)) !=
      cudaSuccess)
    return e;
  if (fgrid > GROUPS) fgrid = GROUPS;
  STAGE();
  if ((e = launch(fin, fgrid, BIG, STAGE_SMEM_OF(sizeof(K)), p, s)) !=
      cudaSuccess)
    return e;
  const void* bk = reinterpret_cast<const void*>(&bucket_kernel<K>);
  int bgrid;
  if ((e = resident(bk, SMALL_T, SMALL_TABLE, &bgrid)) != cudaSuccess)
    return e;
  if (bgrid > nbk) bgrid = nbk;
  const void* bb = reinterpret_cast<const void*>(&big_bucket_kernel<K>);
  int bbgrid;
  if ((e = resident(bb, BIG, HASH_BYTES, &bbgrid)) != cudaSuccess) return e;
  if (bbgrid > nbk) bbgrid = nbk;
  STAGE();
  if ((e = launch(bk, bgrid, SMALL_T, SMALL_TABLE, p, s)) != cudaSuccess ||
      (e = launch(bb, bbgrid, BIG, HASH_BYTES, p, s)) != cudaSuccess)
    return e;
  const void* st = reinterpret_cast<const void*>(&sort_kernel<K>);
  int sgrid;
  if ((e = resident(st, BIG, 0, &sgrid)) != cudaSuccess) return e;
  if (sgrid > nbk) sgrid = nbk;
  STAGE();
  return launch(st, sgrid, BIG, 0, p, s);
}

template <int KIND>
cudaError_t run_route(const AnalyzeParams& p, int stages, cudaStream_t s) {
  if (p.route == ROUTE_COUNT) return run_count<KIND>(p, stages, 1, s);
  return p.key_bytes == 4
             ? run_partition<KIND, unsigned, ITEMS32>(p, stages, 1, s)
             : run_partition<KIND, u64, ITEMS64>(p, stages, 1, s);
}

cudaError_t check_params(const AnalyzeParams* p) {
  if (p->n < 0 || p->kind < KIND_I32 || p->kind > KIND_F64 ||
      p->n_buckets < 1)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// the valid count and the least and greatest image into p->range (the
// wrapper reads them, plans the route and calls analyze_run_launch)
int analyze_range_launch(int device, const AnalyzeParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if ((e = check_params(p)) != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(p->range, 0, sizeof(u64), s)) != cudaSuccess)
    return e;
  if ((e = cudaMemsetAsync(p->range + 1, 0xff, 2 * sizeof(u64), s)) !=
      cudaSuccess)
    return e;
  const unsigned grid = grid_of(p->n, RANGE_GRID);
  switch (p->kind) {
    case KIND_I32: range_kernel<KIND_I32><<<grid, THREADS, 0, s>>>(*p); break;
    case KIND_I64: range_kernel<KIND_I64><<<grid, THREADS, 0, s>>>(*p); break;
    case KIND_U32: range_kernel<KIND_U32><<<grid, THREADS, 0, s>>>(*p); break;
    case KIND_U64: range_kernel<KIND_U64><<<grid, THREADS, 0, s>>>(*p); break;
    default: range_kernel<KIND_F64><<<grid, THREADS, 0, s>>>(*p); break;
  }
  return cudaGetLastError();
}

// the route's kernels and the packed vector into p->out: every stage
// (stages 0), or the first `stages` (stage 1: the zeroing and head_kernel)
int analyze_run_launch(int device, const AnalyzeParams* p, int stages,
                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if ((e = check_params(p)) != cudaSuccess) return e;
  if (p->bits < 0 || p->bits > 64 || p->n_valid > p->n ||
      p->route < ROUTE_EMPTY || p->route > ROUTE_PARTITION ||
      (p->route == ROUTE_EMPTY) != (p->n_valid == 0) ||
      (p->route == ROUTE_COUNT && (p->span < 1 || p->span > COUNT_SPAN)) ||
      (p->route == ROUTE_PARTITION &&
       ((p->key_bytes != 4 && p->key_bytes != 8) || p->n_split < 0 ||
        (p->n_split > 0 && p->bits < TAB_BITS) ||
        part_smem(2 * p->n_split + 1, p->n_split, p->key_bytes) >
            227 * 1024 ||
        STAGE_SMEM_OF(p->key_bytes) + part_smem(0, p->n_split, p->key_bytes) >
            227 * 1024 ||
        (long long)p->n_sample != (long long)OVERSAMPLE * p->n_split)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->zeroed_bytes > 0 &&
      (e = cudaMemsetAsync(p->zeroed, 0, (size_t)p->zeroed_bytes, s)) !=
          cudaSuccess)
    return e;
  head_kernel<<<1, THREADS, 0, s>>>(*p);
  if ((e = cudaGetLastError()) != cudaSuccess || p->route == ROUTE_EMPTY ||
      stages == 1)
    return e;
  switch (p->kind) {
    case KIND_I32: return run_route<KIND_I32>(*p, stages, s);
    case KIND_I64: return run_route<KIND_I64>(*p, stages, s);
    case KIND_U32: return run_route<KIND_U32>(*p, stages, s);
    case KIND_U64: return run_route<KIND_U64>(*p, stages, s);
    default: return run_route<KIND_F64>(*p, stages, s);
  }
}

int analyze_params_bytes() { return (int)sizeof(AnalyzeParams); }
int analyze_tile_rows32() { return TILE32; }
int analyze_tile_rows64() { return TILE64; }
int analyze_count_span() { return COUNT_SPAN; }
int analyze_hash_bytes() { return HASH_BYTES; }
int analyze_grid_max() { return PART_GRID_MAX; }
int analyze_tab_bits() { return TAB_BITS; }
int analyze_oversample() { return OVERSAMPLE; }
int analyze_groups() { return GROUPS; }

const char* analyze_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

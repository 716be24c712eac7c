// Stable radix argsort for Hopper: the permutation that orders rows by
// several keys (sort_perm), and the sorted build-side dictionary of a
// device join (join_build).
//
// Replaces the XLA kernels of tikv_tpu/device/join.py:
//   sort_perm  <- sort_perm (:479): composed stable argsorts, the last key
//                 least significant (lexsort order), into an int32
//                 permutation; also the sort inside window (:508);
//   join_build <- _build_kernel (:257): the build keys ordered by (key,
//                 not valid, position) with NULL keys (and rows at or past
//                 n_live) sentineled to int64.max, so a valid key equal to
//                 the sentinel still comes before every invalid row; out:
//                 the sorted keys sk, the permutation and prefix[n + 1],
//                 the running count of valid rows in sorted order.
//
// Order images: each key becomes a 64-bit unsigned image that sorts as the
// key does: int64 with its sign bit flipped; float64 with -0.0 as +0.0,
// every NaN one image above +inf, then all bits of a negative flipped and
// the sign bit of a positive set; a byte key (0/1) as itself.
//
// Design (Adinets and Merrill, "Onesweep: A Faster Least Significant
// Digit Radix Sort for GPUs", 2022), per sort:
//   1. sort_range: one kernel reads every key once, in source order, and
//      keeps each key's least and greatest image; the host copies those
//      16 bytes a key and synchronizes once.  join_build's first kernel,
//      which writes its keys, also counts the valid rows and keeps their
//      greatest key, 16 bytes more in the same copy: the wrapper hands
//      the dictionary's key range on, so its direct index (join.cu) is
//      launched with no wait of its own.
//   2. The host (device/sort.py pack_groups) gives key k the width w_k =
//      bits(greatest - least) and packs consecutive keys, from the least
//      significant, into one unsigned image sum((img_k - least_k) <<
//      off_k) while the widths sum to at most 64 (a constant key has width
//      0 and drops out).  A stable LSD sort of the packed image is the
//      composed stable sorts of its keys, since the fields' lexicographic
//      order is the numeric order of their concatenation.  A group of at
//      most 32 bits sorts a 32-bit image.  Keys that do not fit form groups
//      of their own, sorted least significant group first, each later one
//      read through the permutation so far.
//   3. Per group, pack_kernel reads its keys (through the permutation for a
//      later group) once, writes the packed image and, in the same read,
//      the histogram of every 8-bit digit of it.
//   4. Then one kernel per 8-bit digit (onesweep_kernel, onesweep.cuh:
//      tiles taken in order from an atomic counter, ranked by digit in
//      shared memory, their digit counts published by decoupled
//      look-back, written out in digit order).  The first pass of the
//      first group reads no permutation (row i is source row i); the last
//      pass writes no image; the permutation alternates so that every
//      group's last pass writes the output.
// Block scans are CUB's (scan.cuh).
//
// Bound: bytes.  Reading each key once and writing the permutation once:
// at config 7s (10,485,760 rows; -k, 2^20 values, and v, 2000 values: 20 +
// 11 = 31 bits, one 32-bit group, four passes) 0.21 GB, 0.063 ms.  This
// design moves about 16 B a row for the range, 20 for the pack, 12 + 16 +
// 16 + 12 for the passes: about 1 GB.  On an H100 the four passes take
// about 0.59 ms there and the pack 0.08 (PERF.md); a pass's tiles spend
// most of their time loading and ranking.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"
#include "onesweep.cuh"

#define THREADS 256
#define RADIX 256
#define DIGIT_BITS 8
#define ITEMS32 16
#define ITEMS64 8
#define TILE32 (THREADS * ITEMS32)  // rows of a pass tile, 32-bit images
#define TILE64 (THREADS * ITEMS64)  // the same, 64-bit images
#define MAX_KEYS 8

typedef unsigned long long u64;

static_assert(THREADS == SWEEP_THREADS && RADIX == SWEEP_RADIX &&
                  DIGIT_BITS == SWEEP_DIGIT_BITS,
              "sort.cu's tiles are onesweep.cuh's");

enum { KIND_I64 = 0, KIND_F64 = 1, KIND_U8 = 2 };

// A sort's launch parameters (device/sort.py mirrors the layout).
// sort_range fills range; the host then sets lo and the groups.  The
// scratch is the wrapper's: img[2] (n rows of 8 bytes each), tmp int32[n],
// work (work_words u64, zeroed here: per group and pass the tiles' status
// words, the digit histogram and the tile counter).
struct SortParams {
  long long n;
  int n_keys;
  const void* keys[MAX_KEYS];  // most significant first
  int kinds[MAX_KEYS];
  u64 lo[MAX_KEYS];            // each key's least image
  int n_groups;                // least significant group first
  int g_count[MAX_KEYS];       // keys in each group
  int g_key[MAX_KEYS][MAX_KEYS];
  int g_off[MAX_KEYS][MAX_KEYS];  // each key's bit offset in its group
  int g_bits[MAX_KEYS];        // a group's width, 1..64
  int* perm;                   // out: int32[n]
  void* img[2];
  int* tmp;
  u64* range;                  // per key: least image, ~greatest image;
                               // join_build: 2 words more
  u64* work;
  long long work_words;
};

// join_build's extra buffers: keys int64[n], valid uint8[n] (rows at or
// past n_live are invalid), skey int64[n] and nsv uint8[n] (scratch), sk
// int64[n] and prefix int64[n + 1] (out), tile_sums int64[n_tiles]
// (scratch).
struct BuildParams {
  const long long* keys;
  const unsigned char* valid;
  long long n_live;
  long long* skey;
  unsigned char* nsv;
  long long* sk;
  long long* prefix;
  long long* tile_sums;
};

namespace {

template <int KIND>
__device__ __forceinline__ u64 key_image(const void* key, long long i) {
  if (KIND == KIND_I64)
    return (u64)(static_cast<const long long*>(key)[i]) ^
           0x8000000000000000ull;
  if (KIND == KIND_F64) {
    const double d = static_cast<const double*>(key)[i];
    if (d != d) return 0xffffffffffffffffull;  // NaN: after +inf
    const u64 b = d == 0.0 ? 0ull : (u64)__double_as_longlong(d);
    return (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
  }
  return static_cast<const unsigned char*>(key)[i];
}

#define UNROLL 4  // rows a thread loads before it uses any (range, pack)

// x[u] |= (image of row src[u] - lo) << off for the live rows u of a
// chunk: every load issued before the first use
template <int KIND>
__device__ __forceinline__ void or_images(u64 (&x)[UNROLL], const void* key,
                                          const long long (&src)[UNROLL],
                                          unsigned live, u64 lo, int off) {
  u64 img[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    img[u] = (live >> u) & 1u ? key_image<KIND>(key, src[u]) : lo;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) x[u] |= (img[u] - lo) << off;
}

template <int KIND>
__device__ __forceinline__ void range_rows(const void* key, long long n,
                                           u64& lo, u64& nhi) {
  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long b = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
       b < n; b += step) {
    u64 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = b + u * THREADS;
      v[u] = i < n ? key_image<KIND>(key, i) : key_image<KIND>(key, b);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      lo = v[u] < lo ? v[u] : lo;
      nhi = ~v[u] < nhi ? ~v[u] : nhi;
    }
  }
}

__device__ __forceinline__ u64 warp_min(u64 x) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 y = __shfl_xor_sync(FULL, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// blockIdx.y: the key; each block folds its rows' least image and the
// complement of the greatest (so both fold by minimum) into range
__global__ void __launch_bounds__(THREADS)
    range_kernel(const __grid_constant__ SortParams p) {
  const int k = blockIdx.y;
  u64 lo = ~0ull, nhi = ~0ull;
  if (p.kinds[k] == KIND_I64)
    range_rows<KIND_I64>(p.keys[k], p.n, lo, nhi);
  else if (p.kinds[k] == KIND_F64)
    range_rows<KIND_F64>(p.keys[k], p.n, lo, nhi);
  else
    range_rows<KIND_U8>(p.keys[k], p.n, lo, nhi);
  lo = warp_min(lo);
  nhi = warp_min(nhi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&p.range[2 * k], lo);
    atomicMin(&p.range[2 * k + 1], nhi);
  }
}

__global__ void __launch_bounds__(THREADS)
    iota_kernel(int* perm, long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride)
    perm[i] = (int)i;
}

// group g's packed image of each row (source row i, or perm[i] for a later
// group; perm_copy, when set, gets perm), and the counts of each of its
// passes' digits into hist[q * hist_stride + digit]
template <typename K>
__global__ void __launch_bounds__(THREADS)
    pack_kernel(const __grid_constant__ SortParams p, int g, const int* perm,
                int* perm_copy, K* img, int passes, u64* hist,
                long long hist_stride) {
  __shared__ DigitCounts cnt;
  digit_counts_zero(cnt, passes);
  __syncthreads();
  const int nk = p.g_count[g];
  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long b = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
       b < p.n; b += step) {
    long long src[UNROLL];
    unsigned live = 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = b + u * THREADS;
      src[u] = i;
      if (i < p.n) live |= 1u << u;
    }
    if (perm != nullptr) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if ((live >> u) & 1u) src[u] = perm[src[u]];
      if (perm_copy != nullptr) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if ((live >> u) & 1u) perm_copy[b + u * THREADS] = (int)src[u];
      }
    }
    u64 x[UNROLL] = {};
    for (int j = 0; j < nk; ++j) {
      const int k = p.g_key[g][j];
      const void* key = p.keys[k];
      const u64 lo = p.lo[k];
      const int off = p.g_off[g][j];
      if (p.kinds[k] == KIND_I64)
        or_images<KIND_I64>(x, key, src, live, lo, off);
      else if (p.kinds[k] == KIND_F64)
        or_images<KIND_F64>(x, key, src, live, lo, off);
      else
        or_images<KIND_U8>(x, key, src, live, lo, off);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!((live >> u) & 1u)) continue;
      img[b + u * THREADS] = (K)x[u];
      digit_counts_add(cnt, x[u], passes);
    }
  }
  __syncthreads();
  digit_counts_flush(cnt, passes, hist, hist_stride);
}

unsigned grid_of(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 2048) b = 2048;
  return (unsigned)(b < 1 ? 1 : b);
}

int passes_of(int bits) { return (bits + DIGIT_BITS - 1) / DIGIT_BITS; }

long long tiles_of(long long n, int bits) {
  const long long tile = bits <= 32 ? TILE32 : TILE64;
  return (n + tile - 1) / tile;
}

// the words of work one group takes: per pass its tiles' status words,
// RADIX histogram counts and one tile counter
long long group_words(long long n, int bits) {
  return passes_of(bits) * (tiles_of(n, bits) * RADIX + RADIX + 1);
}

template <typename K, int ITEMS>
cudaError_t sort_group(const SortParams& p, int g, int first, u64* work,
                       cudaStream_t s) {
  const long long n = p.n;
  const int bits = p.g_bits[g];
  const int passes = passes_of(bits);
  const long long n_tiles = (n + THREADS * ITEMS - 1) / (THREADS * ITEMS);
  u64* hist = work;                        // passes x RADIX
  u64* counters = hist + passes * RADIX;   // passes
  u64* status = counters + passes;         // passes x n_tiles x RADIX
  // the pass outputs alternate so that the last one is perm; a later
  // group's first pass reads perm unless it writes it, then a copy
  int* out0 = (passes - 1) % 2 == 0 ? p.perm : p.tmp;
  const int* in0 = nullptr;
  int* copy = nullptr;
  if (!first) {
    if (out0 == p.perm) {
      copy = p.tmp;
      in0 = p.tmp;
    } else {
      in0 = p.perm;
    }
  }
  K* img[2] = {static_cast<K*>(p.img[0]), static_cast<K*>(p.img[1])};
  // a few blocks an SM, so few global histogram adds
  const unsigned pack_grid = grid_of(n) < 512 ? grid_of(n) : 512;
  pack_kernel<K><<<pack_grid, THREADS, 0, s>>>(
      p, g, first ? nullptr : p.perm, copy, img[0], passes, hist, RADIX);
  const int* vin = in0;
  for (int q = 0; q < passes; ++q) {
    int* vout = (passes - 1 - q) % 2 == 0 ? p.perm : p.tmp;
    onesweep_kernel<K, ITEMS, true><<<(unsigned)n_tiles, THREADS, 0, s>>>(
        img[q & 1], q == passes - 1 ? nullptr : img[(q + 1) & 1], vin, vout,
        n, DIGIT_BITS * q, hist + q * RADIX,
        status + (long long)q * n_tiles * RADIX, counters + q);
    vin = vout;
  }
  return cudaGetLastError();
}

cudaError_t run_groups(const SortParams* p, cudaStream_t s) {
  const long long n = p->n;
  long long words = 0;
  for (int g = 0; g < p->n_groups; ++g) {
    if (p->g_bits[g] < 1 || p->g_bits[g] > 64 || p->g_count[g] < 1)
      return cudaErrorInvalidValue;
    words += group_words(n, p->g_bits[g]);
  }
  if (words > p->work_words) return cudaErrorInvalidValue;
  cudaError_t e;
  if (p->n_groups == 0) {
    iota_kernel<<<grid_of(n), THREADS, 0, s>>>(p->perm, n);
    return cudaGetLastError();
  }
  if ((e = cudaMemsetAsync(p->work, 0, sizeof(u64) * words, s)) !=
      cudaSuccess)
    return e;
  u64* work = p->work;
  for (int g = 0; g < p->n_groups; ++g) {
    e = p->g_bits[g] <= 32
            ? sort_group<unsigned, ITEMS32>(*p, g, g == 0, work, s)
            : sort_group<u64, ITEMS64>(*p, g, g == 0, work, s);
    if (e != cudaSuccess) return e;
    work += group_words(n, p->g_bits[g]);
  }
  return cudaSuccess;
}

// range's 2 words a key, and `extra` words after them, set to ~0; then
// the keys' ranges into them (a kernel queued in between may fold into
// the extra words)
cudaError_t clear_range(const SortParams* p, int extra, cudaStream_t s) {
  return cudaMemsetAsync(p->range, 0xff, sizeof(u64) * (2 * p->n_keys + extra),
                         s);
}

cudaError_t launch_range(const SortParams* p, cudaStream_t s) {
  const dim3 grid(grid_of(p->n) < 512 ? grid_of(p->n) : 512, p->n_keys);
  range_kernel<<<grid, THREADS, 0, s>>>(*p);
  return cudaGetLastError();
}

// skey and nsv; and, into stats, the complement of the valid rows' count
// and of their greatest key's image (stats starts as ~0 from clear_range's
// fill: no valid row, and int64.min's image): one block reduction, then
// one atomic a block for each
__global__ void __launch_bounds__(THREADS)
    build_prep_kernel(const long long* keys, const unsigned char* valid,
                      long long n_live, long long n, long long* skey,
                      unsigned char* nsv, u64* stats) {
  __shared__ long long s_count[THREADS / 32];
  __shared__ u64 s_nhi[THREADS / 32];
  long long count = 0;
  u64 nhi = ~0ull;  // the complement of the greatest valid image so far
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const bool sv = valid[i] && i < n_live;
    const long long k = keys[i];
    skey[i] = sv ? k : 0x7fffffffffffffffll;
    nsv[i] = sv ? 0 : 1;
    if (sv) {
      ++count;
      const u64 nimg = ~((u64)k ^ 0x8000000000000000ull);
      nhi = nimg < nhi ? nimg : nhi;
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    count += __shfl_xor_sync(FULL, count, o);
  nhi = warp_min(nhi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_count[warp] = count;
    s_nhi[warp] = nhi;
  }
  __syncthreads();
  if (warp == 0) {
    count = lane < THREADS / 32 ? s_count[lane] : 0;
    nhi = lane < THREADS / 32 ? s_nhi[lane] : ~0ull;
    for (int o = 16; o > 0; o >>= 1)
      count += __shfl_xor_sync(FULL, count, o);
    nhi = warp_min(nhi);
    if (lane == 0 && count != 0) {
      atomicAdd(&stats[0], (u64)-count);  // ~c - count = ~(c + count)
      atomicMin(&stats[1], nhi);
    }
  }
}

#define BUILD_ITEMS 16
#define BUILD_TILE (THREADS * BUILD_ITEMS)

// sk = skey[perm]; each tile's count of valid rows (thread t takes rows
// [start + t * BUILD_ITEMS, + BUILD_ITEMS), the layout of
// build_prefix_kernel)
__global__ void __launch_bounds__(THREADS)
    build_gather_kernel(const long long* skey, const unsigned char* nsv,
                        const int* perm, long long n, long long* sk,
                        long long* tile_sums) {
  const long long start =
      (long long)blockIdx.x * BUILD_TILE + threadIdx.x * BUILD_ITEMS;
  long long c = 0;
  for (int j = 0; j < BUILD_ITEMS; ++j) {
    const long long i = start + j;
    if (i < n) {
      const int p = perm[i];
      sk[i] = skey[p];
      c += 1 - nsv[p];
    }
  }
  long long tot;
  block_exclusive_scan<THREADS>(c, Add<long long>(), 0ll, &tot);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(THREADS)
    build_prefix_kernel(const unsigned char* nsv, const int* perm,
                        long long n, const long long* tile_off,
                        long long* prefix) {
  const long long start =
      (long long)blockIdx.x * BUILD_TILE + threadIdx.x * BUILD_ITEMS;
  long long c = 0;
  for (int j = 0; j < BUILD_ITEMS; ++j)
    if (start + j < n) c += 1 - nsv[perm[start + j]];
  long long tot;
  long long run = tile_off[blockIdx.x] +
                  block_exclusive_scan<THREADS>(c, Add<long long>(), 0ll, &tot);
  if (blockIdx.x == 0 && threadIdx.x == 0) prefix[0] = 0;
  for (int j = 0; j < BUILD_ITEMS; ++j) {
    const long long i = start + j;
    if (i < n) {
      run += 1 - nsv[perm[i]];
      prefix[i + 1] = run;
    }
  }
}

cudaError_t check_keys(const SortParams* p) {
  if (p->n < 1 || p->n_keys < 1 || p->n_keys > MAX_KEYS ||
      p->n_groups < 0 || p->n_groups > MAX_KEYS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// each key's least and greatest image into p->range (the wrapper reads
// them, picks the groups and calls sort_groups_launch); n >= 1
int sort_range_launch(int device, const SortParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if ((e = check_keys(p)) != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = clear_range(p, 0, s)) != cudaSuccess) return e;
  return launch_range(p, s);
}

// the permutation by p's groups (none: the identity)
int sort_groups_launch(int device, const SortParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if ((e = check_keys(p)) != cudaSuccess) return e;
  return run_groups(p, static_cast<cudaStream_t>(stream));
}

// join_build, before its sort: skey and nsv, and their ranges; `p` sorts
// by (skey, nsv) and names them as its keys.  p->range holds 2 more words:
// the complements of the valid rows' count and of their greatest key's
// image (the least valid key is the least skey, the first word), so the
// wrapper's one read of the range gives the dictionary's key range too
int join_build_prep_launch(int device, const SortParams* p,
                           const BuildParams* b, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if ((e = check_keys(p)) != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = clear_range(p, 2, s)) != cudaSuccess) return e;
  build_prep_kernel<<<grid_of(p->n), THREADS, 0, s>>>(
      b->keys, b->valid, b->n_live, p->n, b->skey, b->nsv,
      p->range + 2 * p->n_keys);
  return launch_range(p, s);
}

// join_build, after its sort: sk and prefix from the permutation
int join_build_finish_launch(int device, const SortParams* p,
                             const BuildParams* b, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const long long n = p->n;
  if (n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (int)((n + BUILD_TILE - 1) / BUILD_TILE);
  build_gather_kernel<<<n_tiles, THREADS, 0, s>>>(b->skey, b->nsv, p->perm,
                                                  n, b->sk, b->tile_sums);
  tile_carry_kernel<THREADS, long long>
      <<<1, THREADS, 0, s>>>(b->tile_sums, n_tiles, nullptr);
  build_prefix_kernel<<<n_tiles, THREADS, 0, s>>>(b->nsv, p->perm, n,
                                                  b->tile_sums, b->prefix);
  return cudaGetLastError();
}

int sort_params_bytes() { return (int)sizeof(SortParams); }
int build_params_bytes() { return (int)sizeof(BuildParams); }
int sort_tile_rows32() { return TILE32; }
int sort_tile_rows64() { return TILE64; }
int sort_build_tile_rows() { return BUILD_TILE; }
int sort_max_keys() { return MAX_KEYS; }

const char* sort_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

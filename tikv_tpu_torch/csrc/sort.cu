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
// The sort is LSD radix over 8-bit digits of a 64-bit unsigned image of
// each key, keys taken from the least significant to the most, each key
// read through the permutation the keys after it left (a gather), so the
// composition is one stable sort by all keys.  Images: int64 with its sign
// bit flipped; float64 with -0.0 as +0.0, every NaN one image above +inf,
// then all bits of a negative flipped and the sign bit of a positive set;
// a byte key (0/1) as itself.  Per key, one pass finds the least and
// greatest image; the digits are those of (image - least), and a pass whose
// digit is zero for every row (at or above the top byte of the range) is
// not launched, so keys of a narrow range take few passes: config 7's k (2^20
// values) three, v (2000 values) two.  A pass is three kernels: a 256-bin
// histogram per tile of 4096 rows (shared-memory atomics); an exclusive
// scan of the (digit, tile) counts, one block per digit; a stable scatter:
// each tile walks its rows in rounds of 256 in row order, a warp ranks its
// lanes of equal digit with __match_any_sync, the warps before it in the
// round add their counts of that digit, and the rounds before add theirs,
// so rows of one digit keep their input order (stability is the contract:
// np.argsort(kind="stable") and jnp.argsort compose the same way).
// The host reads each key's range (16 bytes and one stream sync a key)
// and launches only its live passes; the permutation alternates between
// the output and a scratch buffer, and one copy moves it back when it
// ends in the scratch.  Block scans are CUB's (scan.cuh).
//
// Bound: bytes.  A live pass reads the images and the permutation (12 B a
// row) for its histogram and scatter and writes them once (12 B); config
// 7s (10,485,760 rows, two int64 keys, 3 + 2 live passes) is about 1.3 GB
// of traffic against the 0.21 GB a one-read-one-write sort would move.
// The scatter's writes are scattered by digit (256 runs per tile); rows
// of one digit in one round land in consecutive slots.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define THREADS 256
#define ITEMS 16
#define TILE (THREADS * ITEMS)  // rows of one histogram / scatter tile
#define RADIX 256
#define WARPS (THREADS / 32)
#define MAX_KEYS 8


typedef unsigned long long u64;

enum { KIND_I64 = 0, KIND_F64 = 1, KIND_U8 = 2 };

// sort_perm's launch parameters (device/sort.py mirrors the layout).  The
// scratch is the wrapper's: img[2] u64[n], tmp int32[n], hist int32[256 x
// n_tiles], totals int32[256], minmax u64[2] (a key's least and greatest
// image).
struct SortParams {
  long long n;
  int n_keys;
  const void* keys[MAX_KEYS];  // most significant first
  int kinds[MAX_KEYS];
  int* perm;                   // out: int32[n]
  u64* img[2];
  int* tmp;
  int* hist;
  int* totals;
  u64* minmax;
};

// join_build's extra buffers: keys int64[n], valid uint8[n] (rows at or
// past n_live are invalid), skey int64[n] and nsv uint8[n] (scratch), sk
// int64[n] and prefix int64[n + 1] (out), tile_sums int64[n_tiles] and
// total int64[1] (scratch).
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

__device__ __forceinline__ u64 key_image(const void* key, int kind,
                                         long long i) {
  if (kind == KIND_I64)
    return (u64)(static_cast<const long long*>(key)[i]) ^
           0x8000000000000000ull;
  if (kind == KIND_F64) {
    const double d = static_cast<const double*>(key)[i];
    if (d != d) return 0xffffffffffffffffull;  // NaN: after +inf
    const u64 b = d == 0.0 ? 0ull : (u64)__double_as_longlong(d);
    return (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
  }
  return static_cast<const unsigned char*>(key)[i];
}

// the images of one key in the permutation's order, and their range; the
// first key processed also writes the identity permutation
__global__ void __launch_bounds__(THREADS)
    image_kernel(const void* key, int kind, int* perm, int first, u64* img,
                 long long n, u64* minmax) {
  u64 lo = ~0ull, hi = 0;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    long long src = i;
    if (first)
      perm[i] = (int)i;
    else
      src = perm[i];
    const u64 v = key_image(key, kind, src);
    img[i] = v;
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const u64 a = __shfl_down_sync(0xffffffffu, lo, o);
    const u64 b = __shfl_down_sync(0xffffffffu, hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
  __shared__ u64 wl[WARPS], wh[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wl[warp] = lo;
    wh[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      lo = wl[w] < lo ? wl[w] : lo;
      hi = wh[w] > hi ? wh[w] : hi;
    }
    atomicMin(&minmax[0], lo);
    atomicMax(&minmax[1], hi);
  }
}

__global__ void __launch_bounds__(THREADS)
    hist_kernel(const u64* img, long long n, int shift, u64 mn, int* hist,
                int n_tiles) {
  __shared__ int cnt[RADIX];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long start = (long long)blockIdx.x * TILE;
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = start + j * THREADS + threadIdx.x;
    if (i < n) atomicAdd(&cnt[((img[i] - mn) >> shift) & 0xff], 1);
  }
  __syncthreads();
  hist[(long long)threadIdx.x * n_tiles + blockIdx.x] = cnt[threadIdx.x];
}

// block d: the exclusive scan of digit d's counts over the tiles, in place;
// totals[d] = all rows of digit d
__global__ void __launch_bounds__(THREADS)
    scan_tiles_kernel(int* hist, int n_tiles, int* totals) {
  const int all =
      block_scan_row<THREADS>(hist + (long long)blockIdx.x * n_tiles, n_tiles);
  if (threadIdx.x == 0) totals[blockIdx.x] = all;
}

__global__ void __launch_bounds__(THREADS)
    scatter_kernel(const u64* img_in, const int* perm_in, u64* img_out,
                   int* perm_out, long long n, int shift, u64 mn,
                   const int* hist, const int* totals, int n_tiles) {
  __shared__ int base[RADIX];
  __shared__ int wcnt[WARPS][RADIX];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int all;
  const int excl =
      block_exclusive_scan<THREADS>(totals[t], Add<int>(), 0, &all);
  base[t] = excl + hist[(long long)t * n_tiles + blockIdx.x];
  for (int w = 0; w < WARPS; ++w) wcnt[w][t] = 0;
  __syncthreads();
  const long long start = (long long)blockIdx.x * TILE;
  const unsigned below = (1u << lane) - 1;
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = start + r * THREADS + t;
    const bool live = i < n;
    u64 v = 0;
    int p = 0;
    unsigned d = RADIX;  // rows past n share a digit no row has
    if (live) {
      v = img_in[i];
      p = perm_in[i];
      d = (unsigned)(((v - mn) >> shift) & 0xff);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & below);
    if (live && rank == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    if (live) {
      int pre = 0;
      for (int w = 0; w < warp; ++w) pre += wcnt[w][d];
      const int dst = base[d] + pre + rank;
      img_out[dst] = v;
      perm_out[dst] = p;
    }
    __syncthreads();
    int s = 0;
    for (int w = 0; w < WARPS; ++w) {
      s += wcnt[w][t];
      wcnt[w][t] = 0;
    }
    base[t] += s;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
    build_prep_kernel(const long long* keys, const unsigned char* valid,
                      long long n_live, long long n, long long* skey,
                      unsigned char* nsv) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const bool sv = valid[i] && i < n_live;
    skey[i] = sv ? keys[i] : 0x7fffffffffffffffll;
    nsv[i] = sv ? 0 : 1;
  }
}

// sk = skey[perm]; each tile's count of valid rows (thread t takes rows
// [start + t * ITEMS, + ITEMS), the layout of build_prefix_kernel)
__global__ void __launch_bounds__(THREADS)
    build_gather_kernel(const long long* skey, const unsigned char* nsv,
                        const int* perm, long long n, long long* sk,
                        long long* tile_sums) {
  const long long start = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  long long c = 0;
  for (int j = 0; j < ITEMS; ++j) {
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
  const long long start = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  long long c = 0;
  for (int j = 0; j < ITEMS; ++j)
    if (start + j < n) c += 1 - nsv[perm[start + j]];
  long long tot;
  long long run = tile_off[blockIdx.x] +
                  block_exclusive_scan<THREADS>(c, Add<long long>(), 0ll, &tot);
  if (blockIdx.x == 0 && threadIdx.x == 0) prefix[0] = 0;
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = start + j;
    if (i < n) {
      run += 1 - nsv[perm[i]];
      prefix[i + 1] = run;
    }
  }
}

unsigned grid_of(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 4096) b = 4096;
  return (unsigned)(b < 1 ? 1 : b);
}

// the live passes of a key: the bytes of its range of images
int live_passes(u64 range) {
  int q = 0;
  for (; range != 0; range >>= 8) ++q;
  return q;
}

cudaError_t run_sort(const SortParams* p, cudaStream_t s) {
  const long long n = p->n;
  const int n_tiles = (int)((n + TILE - 1) / TILE);
  int* cur = p->perm;  // the permutation so far
  int* alt = p->tmp;
  cudaError_t e;
  for (int k = p->n_keys - 1; k >= 0; --k) {
    u64 mm[2];
    if ((e = cudaMemsetAsync(p->minmax, 0xff, 8, s)) != cudaSuccess ||
        (e = cudaMemsetAsync(p->minmax + 1, 0, 8, s)) != cudaSuccess)
      return e;
    image_kernel<<<grid_of(n), THREADS, 0, s>>>(
        p->keys[k], p->kinds[k], cur, k == p->n_keys - 1, p->img[0], n,
        p->minmax);
    if ((e = cudaMemcpyAsync(mm, p->minmax, sizeof mm,
                             cudaMemcpyDeviceToHost, s)) != cudaSuccess ||
        (e = cudaStreamSynchronize(s)) != cudaSuccess)
      return e;
    const int passes = live_passes(mm[1] - mm[0]);
    for (int q = 0; q < passes; ++q) {
      const int shift = 8 * q;
      hist_kernel<<<n_tiles, THREADS, 0, s>>>(p->img[q & 1], n, shift, mm[0],
                                              p->hist, n_tiles);
      scan_tiles_kernel<<<RADIX, THREADS, 0, s>>>(p->hist, n_tiles,
                                                  p->totals);
      scatter_kernel<<<n_tiles, THREADS, 0, s>>>(
          p->img[q & 1], cur, p->img[(q + 1) & 1], alt, n, shift, mm[0],
          p->hist, p->totals, n_tiles);
      int* t = cur;
      cur = alt;
      alt = t;
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (cur != p->perm)
    return cudaMemcpyAsync(p->perm, cur, sizeof(int) * n,
                           cudaMemcpyDeviceToDevice, s);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// n >= 1; 1 <= n_keys <= MAX_KEYS
int sort_perm_launch(int device, const SortParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p->n < 1 || p->n_keys < 1 || p->n_keys > MAX_KEYS)
    return cudaErrorInvalidValue;
  return run_sort(p, static_cast<cudaStream_t>(stream));
}

// `p` sorts by (skey, nsv): its keys, kinds and n are set here
int join_build_launch(int device, SortParams* p, const BuildParams* b,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const long long n = p->n;
  if (n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  build_prep_kernel<<<grid_of(n), THREADS, 0, s>>>(
      b->keys, b->valid, b->n_live, n, b->skey, b->nsv);
  p->n_keys = 2;
  p->keys[0] = b->skey;
  p->kinds[0] = KIND_I64;
  p->keys[1] = b->nsv;
  p->kinds[1] = KIND_U8;
  if ((e = run_sort(p, s)) != cudaSuccess) return e;
  const int n_tiles = (int)((n + TILE - 1) / TILE);
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
int sort_tile_rows() { return TILE; }
int sort_max_keys() { return MAX_KEYS; }

const char* sort_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

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
// NaN in the reference.
//
// Design, per column (no row payload: only the keys move):
//   1. range_kernel reads each value and validity byte once and folds the
//      valid count, the least image and the complement of the greatest;
//      the host copies those 24 bytes back and synchronizes once.
//   2. The host sets the key of a valid row to image - least and of a NULL
//      row to greatest - least + 1 (all ones when the valid images span all
//      64 bits: equal keys are the same value, and only the first n_valid
//      sorted keys are read), so NULLs sort after every valid row whatever
//      the values; the key width is the bits of the NULL key: 32-bit keys
//      when it fits, else 64-bit.
//   3. pack_kernel reads the column a second time, writes each row's key
//      and counts every pass's 8-bit digits (onesweep.cuh's DigitCounts).
//   4. One onesweep_kernel a digit, keys only (onesweep.cuh).
//   5. stats_kernel reads the first n_valid sorted keys once: each block
//      counts adjacent keys that differ (two NaN keys differ) into one
//      64-bit atomic; block 0 gathers the B ranks, turns each key back into
//      its value and writes the packed vector.
//
// Bound: bytes.  Each value and validity byte read once and the packed
// vector written once: at config 4's table (104,857,600 rows) 0.52 GB for
// an int32 column, 0.157 ms at 3.35 TB/s.  This design moves about 5 B a
// row for the range, 9 for the pack, 8 a pass (2 passes for config 4's k,
// 4 for id) and 4 for the stats: the sort is most of the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"
#include "onesweep.cuh"

#define THREADS 256
#define UNROLL 4        // rows a thread loads before it uses any
#define ITEMS32 16
#define ITEMS64 8
#define TILE32 (THREADS * ITEMS32)  // rows of a pass tile, 32-bit keys
#define TILE64 (THREADS * ITEMS64)  // the same, 64-bit keys
#define RANGE_GRID 1024
#define PACK_GRID 512   // few blocks an SM, so few global histogram adds
#define STATS_GRID 1024

typedef unsigned long long u64;

static_assert(THREADS == SWEEP_THREADS, "analyze.cu's blocks are onesweep's");

enum { KIND_I32 = 0, KIND_I64 = 1, KIND_U32 = 2, KIND_U64 = 3, KIND_F64 = 4 };

// One column's launch parameters (device/analyze.py mirrors the layout).
// range_launch fills range; the host then sets n_valid, lo, null_key,
// bits, has_nan and the scratch: keys[2] (n rows of 4 bytes when bits <=
// 32, else 8), work (work_words u64, zeroed here: per pass the tiles'
// status words, the digit histogram and the tile counter); out int64[2B +
// 2].
struct AnalyzeParams {
  const void* values;          // n rows (or more) of the kind
  const unsigned char* valid;  // bool, the same rows
  long long n;                 // rows read: the live rows
  int kind;
  int n_buckets;               // B >= 1
  u64* range;                  // out: valid count, least, ~greatest image
  long long n_valid;
  u64 lo;                      // least image of a valid row
  u64 null_key;                // the key of a NULL row
  int bits;                    // key width, 1..64; 0: no valid row
  int has_nan;                 // a valid NaN (float64): its key is
  u64 nan_key;                 // nan_key
  void* keys[2];
  u64* work;
  long long work_words;
  long long* out;
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
template <int KIND>
__device__ __forceinline__ long long word_of(u64 img) {
  if (KIND == KIND_I32 || KIND == KIND_I64) return (long long)(img ^ SIGN);
  if (KIND == KIND_U32 || KIND == KIND_U64) return (long long)img;
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

// the images and validity of UNROLL rows from b (rows past n: invalid),
// every load issued before the first use
template <int KIND>
__device__ __forceinline__ void load_rows(const AnalyzeParams& p, long long b,
                                          u64 (&img)[UNROLL],
                                          bool (&ok)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = b + u * THREADS;
    const bool in = i < p.n;
    ok[u] = in ? p.valid[i] != 0 : false;
    img[u] = in ? image<KIND>(p.values, i) : 0ull;
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
    range_kernel(const __grid_constant__ AnalyzeParams p) {
  u64 cnt = 0, lo = ~0ull, nhi = ~0ull;
  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long b = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
       b < p.n; b += step) {
    u64 img[UNROLL];
    bool ok[UNROLL];
    load_rows<KIND>(p, b, img, ok);
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

// each row's key into keys, and the counts of each pass's digits
template <int KIND, typename K>
__global__ void __launch_bounds__(THREADS)
    pack_kernel(const __grid_constant__ AnalyzeParams p, K* keys, int passes,
                u64* hist) {
  __shared__ DigitCounts cnt;
  digit_counts_zero(cnt, passes);
  __syncthreads();
  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long b = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
       b < p.n; b += step) {
    u64 img[UNROLL];
    bool ok[UNROLL];
    load_rows<KIND>(p, b, img, ok);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = b + u * THREADS;
      if (i >= p.n) continue;
      const u64 key = ok[u] ? img[u] - p.lo : p.null_key;
      keys[i] = (K)key;
      digit_counts_add(cnt, key, passes);
    }
  }
  __syncthreads();
  digit_counts_flush(cnt, passes, hist, SWEEP_RADIX);
}

// the distinct count over the sorted keys sk[0, n_valid) into out[2B + 1]
// (zeroed), and block 0 the bounds, ranks and n_valid
template <int KIND, typename K>
__global__ void __launch_bounds__(THREADS)
    stats_kernel(const __grid_constant__ AnalyzeParams p, const K* sk) {
  __shared__ u64 s_warp[THREADS / 32];
  const long long nv = p.n_valid;
  const int nb = p.n_buckets;
  const bool nan = KIND == KIND_F64 && p.has_nan;
  const K nan_key = (K)p.nan_key;
  u64 c = 0;
  const long long step = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x + 1;
       i < nv; i += step) {
    const K a = sk[i - 1], b = sk[i];
    c += (a != b || (nan && a == nan_key)) ? 1 : 0;
  }
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 all = blockIdx.x == 0 && nv > 0 ? 1 : 0;  // the first value
    for (int w = 0; w < THREADS / 32; ++w) all += s_warp[w];
    if (all) atomicAdd(reinterpret_cast<u64*>(&p.out[2 * nb + 1]), all);
  }
  if (blockIdx.x != 0) return;
  for (int b = threadIdx.x; b < nb; b += THREADS) {
    long long r = (long long)(b + 1) * nv / nb - 1;
    if (r < 0) r = 0;
    p.out[b] = nv > 0 ? word_of<KIND>((u64)sk[r] + p.lo) : 0;
    p.out[nb + b] = r + 1;
  }
  if (threadIdx.x == 0) p.out[2 * nb] = nv;
}

unsigned grid_of(long long n, unsigned cap) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > cap) b = cap;
  return (unsigned)(b < 1 ? 1 : b);
}

int passes_of(int bits) {
  return (bits + SWEEP_DIGIT_BITS - 1) / SWEEP_DIGIT_BITS;
}

long long sort_words(long long n, int bits) {
  if (bits == 0) return 0;
  const long long tile = bits <= 32 ? TILE32 : TILE64;
  return passes_of(bits) *
         (((n + tile - 1) / tile) * SWEEP_RADIX + SWEEP_RADIX + 1);
}

template <int KIND, typename K, int ITEMS>
cudaError_t sort_and_stats(const AnalyzeParams& p, cudaStream_t s) {
  const K* sorted = nullptr;
  if (p.bits > 0) {
    const long long n = p.n;
    const int passes = passes_of(p.bits);
    const long long n_tiles = (n + THREADS * ITEMS - 1) / (THREADS * ITEMS);
    u64* hist = p.work;                       // passes x RADIX
    u64* counters = hist + passes * SWEEP_RADIX;  // passes
    u64* status = counters + passes;          // passes x n_tiles x RADIX
    cudaError_t e = cudaMemsetAsync(p.work, 0, sizeof(u64) * p.work_words, s);
    if (e != cudaSuccess) return e;
    K* keys[2] = {static_cast<K*>(p.keys[0]), static_cast<K*>(p.keys[1])};
    pack_kernel<KIND, K><<<grid_of(n, PACK_GRID), THREADS, 0, s>>>(
        p, keys[0], passes, hist);
    for (int q = 0; q < passes; ++q)
      onesweep_kernel<K, ITEMS, false>
          <<<(unsigned)n_tiles, SWEEP_THREADS, 0, s>>>(
              keys[q & 1], keys[(q + 1) & 1], nullptr, nullptr, n,
              SWEEP_DIGIT_BITS * q, hist + q * SWEEP_RADIX,
              status + (long long)q * n_tiles * SWEEP_RADIX, counters + q);
    sorted = keys[passes & 1];
  }
  cudaError_t e = cudaMemsetAsync(p.out + 2 * p.n_buckets + 1, 0,
                                  sizeof(long long), s);
  if (e != cudaSuccess) return e;
  stats_kernel<KIND, K><<<grid_of(p.n_valid, STATS_GRID), THREADS, 0, s>>>(
      p, sorted);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t run_sort(const AnalyzeParams& p, cudaStream_t s) {
  return p.bits <= 32 ? sort_and_stats<KIND, unsigned, ITEMS32>(p, s)
                      : sort_and_stats<KIND, u64, ITEMS64>(p, s);
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
// wrapper reads them, sets the keys and calls analyze_sort_launch)
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

// the keys, their sort and the packed vector into p->out
int analyze_sort_launch(int device, const AnalyzeParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if ((e = check_params(p)) != cudaSuccess) return e;
  if (p->bits < 0 || p->bits > 64 || (p->bits == 0) != (p->n_valid == 0) ||
      p->n_valid > p->n || sort_words(p->n, p->bits) > p->work_words)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->kind) {
    case KIND_I32: return run_sort<KIND_I32>(*p, s);
    case KIND_I64: return run_sort<KIND_I64>(*p, s);
    case KIND_U32: return run_sort<KIND_U32>(*p, s);
    case KIND_U64: return run_sort<KIND_U64>(*p, s);
    default: return run_sort<KIND_F64>(*p, s);
  }
}

int analyze_params_bytes() { return (int)sizeof(AnalyzeParams); }
int analyze_tile_rows32() { return TILE32; }
int analyze_tile_rows64() { return TILE64; }

const char* analyze_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

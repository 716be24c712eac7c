// MVCC version resolution for Hopper: the newest committed version of
// every key at a read timestamp, compacted and gathered straight into the
// runner's feed layout (mvcc_resolve).
//
// Replaces the XLA kernel of tikv_tpu/device/mvcc.py:
//   DeviceMvccResolver._kernel (:531), its jitted `resolve` (:548-580):
//   eligibility (commit_ts <= read_ts, as int64, and a PUT or DELETE),
//   a segmented max of the eligible commit_ts per key, the winners
//   (score == the key's max and score > 0; a DELETE winner hides the
//   key), a cumsum compaction and a gather of the visible winners into
//   the _build_flat layout: per output plane the handle, a value plane
//   cast to its feed dtype, or a validity plane; rows at or past the
//   visible count hold 0 / false up to n_pad.
//
// The version planes keep a key's versions contiguous (the CF_WRITE
// order), so a key's segment is [seg_start[k], seg_start[k + 1]) and a
// thread can own a key: no segmented reduction across threads.  Three
// launches:
//   mvcc_count   a block owns KEYS_PER_BLOCK = 4096 consecutive keys, in
//                16 rounds of 256 (a thread one key a round); each thread
//                finds its key's eligible max and counts its visible
//                winners; the block writes its count;
//   mvcc_scan    one block: the exclusive prefix over the block counts and
//                the visible count;
//   mvcc_gather  the same rounds as mvcc_count, again: each thread
//                recounts its key's winners, a block scan gives each key
//                its first output row, and the thread writes its winners'
//                rows (a key with two PUTs at one commit_ts has two, as
//                the reference gives); then the grid zero-fills the rows
//                from the visible count to n_pad.
// Bound: bytes.  commit_ts (8 B) and wtype (1 B) per version, seg_start
// (8 B) per key, and at each visible winner its handle and the source
// elements its output planes take, read once; each output plane written
// once over n_pad rows.  This design reads commit_ts, wtype and seg_start
// twice (the count and the gather), so it moves about 17 B a version more
// than the bound counts.

#include <cuda_runtime.h>
#include <stdint.h>

// the launch parameters (outside the unnamed namespace: the C entry point
// takes a pointer to them)
constexpr int MVCC_MAX_OUT = 64;

struct ResolveParams {
  const long long* commit_ts;  // [n_ver], the uint64 commit_ts as int64
  const unsigned char* wtype;  // [n_ver]: 0 PUT, 1 DELETE, 2 LOCK, 3 ROLLBACK
  const long long* seg_start;  // [n_keys + 1]
  const long long* handles;    // [n_keys]
  long long n_keys;
  long long read_ts;
  long long n_pad;              // rows of every output plane
  long long n_blocks;
  int* block_counts;            // [n_blocks]
  long long* block_offsets;     // [n_blocks]
  long long* count;             // the visible count
  int n_out;
  int op[MVCC_MAX_OUT];
  int src_kind[MVCC_MAX_OUT];
  int dst_kind[MVCC_MAX_OUT];
  const void* src[MVCC_MAX_OUT];
  void* dst[MVCC_MAX_OUT];
};

namespace {

constexpr int THREADS = 256;
constexpr int ROUNDS = 16;
constexpr long long KEYS_PER_BLOCK = (long long)THREADS * ROUNDS;
constexpr int MAX_OUT = MVCC_MAX_OUT;
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// output plane ops
constexpr int OP_HANDLE = 0, OP_VALUE = 1, OP_VALID = 2;
// source kinds (the version planes' kind codes): int64, float64, uint64,
// and bool for a validity plane
constexpr int SRC_I64 = 0, SRC_F64 = 1, SRC_U64 = 3, SRC_BOOL = 4;
// output dtypes
constexpr int DST_I32 = 0, DST_I64 = 1, DST_F32 = 2, DST_F64 = 3,
              DST_BOOL = 4;


// The eligible max commit_ts of key k's versions (0 when none is
// eligible: the score of an ineligible version), and its visible winners.
struct KeyScan {
  long long lo, hi, best;
  int visible;
};

__device__ __forceinline__ KeyScan scan_key(const ResolveParams& p,
                                            long long k) {
  KeyScan r{0, 0, 0, 0};
  if (k >= p.n_keys) return r;
  r.lo = p.seg_start[k];
  r.hi = p.seg_start[k + 1];
  for (long long v = r.lo; v < r.hi; ++v) {
    const long long ts = p.commit_ts[v];
    if (ts <= p.read_ts && p.wtype[v] <= 1 && ts > r.best) r.best = ts;
  }
  if (r.best > 0)
    for (long long v = r.lo; v < r.hi; ++v)
      r.visible += (p.commit_ts[v] == r.best && p.wtype[v] == 0) ? 1 : 0;
  return r;
}

// the value of output plane q at version v of key k, stored at row `row`
__device__ __forceinline__ void put(const ResolveParams& p, int q,
                                    long long v, long long k, long long row) {
  long long i = 0;
  double f = 0.0;
  bool is_float = false;
  switch (p.op[q]) {
    case OP_HANDLE:
      i = p.handles[k];
      break;
    case OP_VALID:
      static_cast<unsigned char*>(p.dst[q])[row] =
          static_cast<const unsigned char*>(p.src[q])[v] != 0;
      return;
    default:
      switch (p.src_kind[q]) {
        case SRC_F64:
          f = static_cast<const double*>(p.src[q])[v];
          is_float = true;
          break;
        case SRC_U64: {
          // an unsigned source converts as an unsigned value
          const unsigned long long u =
              static_cast<const unsigned long long*>(p.src[q])[v];
          switch (p.dst_kind[q]) {
            case DST_F32:
              static_cast<float*>(p.dst[q])[row] = __ull2float_rn(u);
              return;
            case DST_F64:
              static_cast<double*>(p.dst[q])[row] = __ull2double_rn(u);
              return;
            default:
              i = (long long)u;
          }
          break;
        }
        default:
          i = static_cast<const long long*>(p.src[q])[v];
      }
  }
  switch (p.dst_kind[q]) {
    case DST_I32:
      static_cast<int*>(p.dst[q])[row] = (int)(unsigned)(unsigned long long)i;
      break;
    case DST_I64:
      static_cast<long long*>(p.dst[q])[row] = i;
      break;
    case DST_F32:
      static_cast<float*>(p.dst[q])[row] =
          is_float ? __double2float_rn(f) : __ll2float_rn(i);
      break;
    default:  // DST_F64
      static_cast<double*>(p.dst[q])[row] = is_float ? f : __ll2double_rn(i);
  }
}

__device__ __forceinline__ void zero(const ResolveParams& p, int q,
                                     long long row) {
  switch (p.dst_kind[q]) {
    case DST_I32:
    case DST_F32:
      static_cast<int*>(p.dst[q])[row] = 0;
      break;
    case DST_BOOL:
      static_cast<unsigned char*>(p.dst[q])[row] = 0;
      break;
    default:
      static_cast<long long*>(p.dst[q])[row] = 0;
  }
}

__device__ __forceinline__ long long block_total(long long v,
                                                 long long* part) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) part[warp] = v;
  __syncthreads();
  long long t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += part[w];
  return t;
}

__global__ void __launch_bounds__(THREADS)
    mvcc_count(const __grid_constant__ ResolveParams p) {
  __shared__ long long part[THREADS / 32];
  const long long k0 = (long long)blockIdx.x * KEYS_PER_BLOCK;
  long long mine = 0;
  for (int r = 0; r < ROUNDS; ++r)
    mine += scan_key(p, k0 + (long long)r * THREADS + threadIdx.x).visible;
  const long long total = block_total(mine, part);
  if (threadIdx.x == 0) p.block_counts[blockIdx.x] = (int)total;
}

// one block: thread t sums a contiguous run of block counts, a block scan
// of those sums, then each thread writes its run's exclusive prefixes
__global__ void __launch_bounds__(SCAN_THREADS)
    mvcc_scan(const __grid_constant__ ResolveParams p) {
  __shared__ long long sums[SCAN_THREADS];
  const long long per = (p.n_blocks + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long b0 = (long long)threadIdx.x * per;
  const long long b1 = b0 + per < p.n_blocks ? b0 + per : p.n_blocks;
  long long s = 0;
  for (long long b = b0; b < b1; ++b) s += p.block_counts[b];
  sums[threadIdx.x] = s;
  __syncthreads();
  // Hillis-Steele inclusive scan over the 1024 run sums
  for (int o = 1; o < SCAN_THREADS; o <<= 1) {
    const long long add = threadIdx.x >= o ? sums[threadIdx.x - o] : 0;
    __syncthreads();
    sums[threadIdx.x] += add;
    __syncthreads();
  }
  long long at = sums[threadIdx.x] - s;
  for (long long b = b0; b < b1; ++b) {
    p.block_offsets[b] = at;
    at += p.block_counts[b];
  }
  if (threadIdx.x == SCAN_THREADS - 1) *p.count = sums[SCAN_THREADS - 1];
}

__global__ void __launch_bounds__(THREADS)
    mvcc_gather(const __grid_constant__ ResolveParams p) {
  __shared__ int warp_total[THREADS / 32];
  const long long k0 = (long long)blockIdx.x * KEYS_PER_BLOCK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long base = p.block_offsets[blockIdx.x];
  for (int r = 0; r < ROUNDS; ++r) {
    const long long k = k0 + (long long)r * THREADS + threadIdx.x;
    const KeyScan s = scan_key(p, k);
    // block exclusive scan of the visible counts, in key order
    int incl = s.visible;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    __syncthreads();
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    long long row = base + incl - s.visible;
    long long round_total = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      if (w < warp) row += warp_total[w];
      round_total += warp_total[w];
    }
    if (s.visible > 0)
      for (long long v = s.lo; v < s.hi; ++v)
        if (p.commit_ts[v] == s.best && p.wtype[v] == 0) {
          if (row < p.n_pad)
            for (int q = 0; q < p.n_out; ++q) put(p, q, v, k, row);
          ++row;
        }
    base += round_total;
  }
  // rows [count, n_pad): the padding of the feed layout
  const long long from = *p.count;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long row = from + (long long)blockIdx.x * THREADS + threadIdx.x;
       row < p.n_pad; row += stride)
    for (int q = 0; q < p.n_out; ++q) zero(p, q, row);
}

}  // namespace

extern "C" {

// Three launches on `stream`: count, scan, gather.  `n_blocks` is
// ceil(n_keys / 4096) (at least 1); block_counts and block_offsets hold
// n_blocks entries each, `count` 8 bytes.
int mvcc_resolve_launch(int device, const ResolveParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p->n_out > MAX_OUT || p->n_blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)p->n_blocks;
  mvcc_count<<<grid, THREADS, 0, s>>>(*p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mvcc_scan<<<1, SCAN_THREADS, 0, s>>>(*p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mvcc_gather<<<grid, THREADS, 0, s>>>(*p);
  return cudaGetLastError();
}

int mvcc_params_bytes() { return (int)sizeof(ResolveParams); }

int mvcc_max_out() { return MAX_OUT; }

long long mvcc_keys_per_block() { return KEYS_PER_BLOCK; }

const char* mvcc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

// Segmented top-k for Hopper: ORDER BY one key LIMIT k over the feed.
//
// Replaces the XLA kernel of tikv_tpu/device/runner.py `_build_topn_kernel`
// (:2825) with its sort key `_topn_sort_key` (:2783): a top-k per segment
// of `seglen` rows (lax.top_k over a (nseg, seglen) view), then a global
// top-k over the nseg * kk candidates.
//
// Order: rows rank by a 64-bit key, larger first, ties by row position
// (lower first).  The key is built in registers from the order plane and
// never stored for all n rows:
//   excluded (masked out, or row >= n)  0
//   NULL, DESC (NULLs last)             1
//   NULL, ASC (NULLs first)             2^64 - 1
//   a value                             its order-preserving image (int32
//       and int64 as they are, float64 by its bits with the sign folded;
//       -0.0 is +0.0), bit-inverted for ASC, in [2, 2^64 - 1) for DESC and
//       [1, 2^64 - 1) for ASC.  An int64 value within 2 of the int64
//       extremes is clamped there (the reference's clamp, runner.py:2808).
// float64 keys are exact, unlike the reference's float32 key (ROADMAP
// queue 3, fault 6), so the candidates are the true top k.
//
// Design (simple first): one CUDA block of 1024 threads per segment finds
// the kk-th key by a most-significant-digit radix select -- per pass a
// 256-bin histogram in shared memory of the digit of the rows whose higher
// digits match the prefix found so far (warp-aggregated with
// __match_any_sync, so runs of equal keys cost one atomic per warp), up to
// 8 passes, stopping early once the crossing bucket is taken whole -- then
// one collect pass writes, in row order, every row above the threshold and
// the lowest-positioned rows equal to it (a block-wide scan per tile of
// 4096 rows).  Each pass re-reads the segment's planes.  The global stage
// runs the same block over the candidates (their keys and positions),
// 131072 at a time, until one block's worth is left, whose top k is the
// result: positions and flags (bit 0: the row passed the selection, bit 1:
// its value is not NULL), in row order.
//
// Bound: bytes.  The order plane read once (8 B/row for float64: 0.250 ms
// for config 5's 104,857,600 rows at 3.35 TB/s) plus validity and
// selection bytes.  With a pass per digit the planes are read up to 9
// times; keeping the crossing bucket's rows in shared memory after the
// first pass is the next step.

#include <climits>
#include <cuda_runtime.h>

#define THREADS 1024
#define RADIX 256
#define COLLECT_ROWS 4
#define CHUNK (1 << 17)

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long SIGN = 0x8000000000000000ULL;

enum { DT_INT32 = 0, DT_INT64 = 1, DT_FLOAT64 = 2 };

// stage 1: keys built in registers from the order plane
struct RowSource {
  const void* values;
  const unsigned char* ok;    // nullptr: no NULLs
  const unsigned char* mask;  // nullptr: no selection
  long long n;
  int dtype;
  int desc;

  __device__ __forceinline__ unsigned long long key(long long row) const {
    if (row >= n || (mask != nullptr && !mask[row])) return 0ULL;
    if (ok != nullptr && !ok[row]) return desc ? 1ULL : ~0ULL;
    long long s;
    if (dtype == DT_INT32) {
      s = static_cast<const int*>(values)[row];
    } else if (dtype == DT_INT64) {
      s = static_cast<const long long*>(values)[row];
    } else {
      const long long b = __double_as_longlong(
          static_cast<const double*>(values)[row] + 0.0);
      s = b >= 0 ? b : b ^ LLONG_MAX;
    }
    if (desc) {
      s = s < LLONG_MIN + 2 ? LLONG_MIN + 2 : s;
    } else {
      s = s < LLONG_MIN + 1 ? LLONG_MIN + 1 : (s > LLONG_MAX - 1 ? LLONG_MAX - 1 : s);
      s = ~s;
    }
    return static_cast<unsigned long long>(s) ^ SIGN;
  }
  __device__ __forceinline__ long long pos(long long row) const { return row; }
};

// the global stage: an earlier stage's candidates
struct CandSource {
  const unsigned long long* keys;
  const long long* at;

  __device__ __forceinline__ unsigned long long key(long long i) const {
    return keys[i];
  }
  __device__ __forceinline__ long long pos(long long i) const { return at[i]; }
};

struct PairOut {
  unsigned long long* keys;
  long long* at;

  __device__ __forceinline__ void emit(long long slot, long long pos,
                                       unsigned long long k) const {
    keys[slot] = k;
    at[slot] = pos;
  }
};

struct FinalOut {
  long long* gidx;
  long long* flags;
  unsigned long long null_key;

  __device__ __forceinline__ void emit(long long slot, long long pos,
                                       unsigned long long k) const {
    gidx[slot] = pos;
    flags[slot] = (k != 0ULL ? 1 : 0) | (k != 0ULL && k != null_key ? 2 : 0);
  }
};

// The `take` best of rows [base, base + len) of `src` by (key desc,
// position asc), written in row order to out slots [out_base, +take).
template <class Src, class Out>
__device__ void top_rows(const Src& src, long long base, long long len,
                         long long take, const Out& out, long long out_base,
                         unsigned long long* passes) {
  __shared__ unsigned hist[RADIX];
  __shared__ unsigned long long s_prefix, s_mask;
  __shared__ long long s_need, s_above, s_ties;
  __shared__ int s_done;
  __shared__ unsigned long long warp_total[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_need = take;
    s_done = take >= len;
  }
  __syncthreads();
  for (int shift = 56; shift >= 0 && !s_done; shift -= 8) {
    for (int i = threadIdx.x; i < RADIX; i += THREADS) hist[i] = 0;
    __syncthreads();
    const unsigned long long prefix = s_prefix, pmask = s_mask;
    for (long long r0 = 0; r0 < len; r0 += THREADS) {
      const long long i = r0 + threadIdx.x;
      int digit = -1;
      if (i < len) {
        const unsigned long long k = src.key(base + i);
        if ((k & pmask) == prefix) digit = (int)((k >> shift) & 0xff);
      }
      const unsigned peers = __match_any_sync(FULL, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long need = s_need;
      long long above = 0;
      int d = RADIX - 1;
      for (; d > 0; --d) {
        if (above + hist[d] >= need) break;
        above += hist[d];
      }
      s_need = need - above;
      s_prefix = prefix | ((unsigned long long)d << shift);
      s_mask = pmask | (0xffULL << shift);
      s_done = (long long)hist[d] == s_need;
    }
    __syncthreads();
  }

  // collect: rows above the threshold, and the first s_need rows equal to
  // it, in row order
  const unsigned long long prefix = s_prefix, pmask = s_mask;
  if (passes != nullptr && threadIdx.x == 0) {
    // the passes over the rows: one per digit resolved, and this one
    int digits = 0;
    for (unsigned long long m = pmask; m != 0; m <<= 8) ++digits;
    atomicAdd(passes, (unsigned long long)(digits + 1));
  }
  const long long need = s_need;
  if (threadIdx.x == 0) {
    s_above = 0;
    s_ties = 0;
  }
  __syncthreads();
  for (long long t0 = 0; t0 < len; t0 += (long long)THREADS * COLLECT_ROWS) {
    unsigned long long keys[COLLECT_ROWS];
    int cls[COLLECT_ROWS];  // 0: out, 1: above, 2: equal
    unsigned na = 0, nt = 0;
    const long long first = t0 + (long long)threadIdx.x * COLLECT_ROWS;
#pragma unroll
    for (int j = 0; j < COLLECT_ROWS; ++j) {
      cls[j] = 0;
      if (first + j < len) {
        keys[j] = src.key(base + first + j);
        const unsigned long long hi = keys[j] & pmask;
        if (hi > prefix) {
          cls[j] = 1;
          ++na;
        } else if (hi == prefix) {
          cls[j] = 2;
          ++nt;
        }
      }
    }
    // exclusive block scan of (above, equal) counts, packed in one word
    const unsigned long long mine = ((unsigned long long)na << 32) | nt;
    unsigned long long incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    unsigned long long ex = incl - mine;
    for (int w = 0; w < warp; ++w) ex += warp_total[w];
    long long a_before = s_above + (long long)(ex >> 32);
    long long t_before = s_ties + (long long)(ex & 0xffffffffULL);
#pragma unroll
    for (int j = 0; j < COLLECT_ROWS; ++j) {
      if (cls[j] == 1) {
        out.emit(out_base + a_before + (t_before < need ? t_before : need),
                 src.pos(base + first + j), keys[j]);
        ++a_before;
      } else if (cls[j] == 2) {
        if (t_before < need)
          out.emit(out_base + a_before + t_before, src.pos(base + first + j),
                   keys[j]);
        ++t_before;
      }
    }
    __syncthreads();
    if (threadIdx.x == THREADS - 1) {
      s_above = a_before;
      s_ties = t_before;
    }
    __syncthreads();
  }
}

// block b: chunk [b * chunk, min((b + 1) * chunk, len)) of `src`; its best
// min(take, chunk length) rows go to slots b * take onward
template <class Src, class Out>
__global__ void __launch_bounds__(THREADS)
    topn_chunks(const Src src, long long len, long long chunk, long long take,
                const Out out, unsigned long long* passes) {
  const long long base = (long long)blockIdx.x * chunk;
  const long long here = len - base < chunk ? len - base : chunk;
  top_rows(src, base, here, take < here ? take : here, out,
           (long long)blockIdx.x * take, passes);
}

}  // namespace

extern "C" {

// values: int32 / int64 / float64 (dtype 0 / 1 / 2), rows [0, n) read;
// ok, mask: bool or null.  Segments of `seglen` rows over [0, n_used);
// `a_keys`/`a_pos` and `b_keys`/`b_pos` hold nseg * kk candidates each.
// out: int64 [2][k2], k2 = min(k, n_used): positions, then flags.
// passes (or null): the first stage's blocks add how many times each read
// its segment.  Returns the first failing launch's error; *launched
// counts launches.
int topn_launch(int device, const void* values, int dtype, const void* ok,
                const void* mask, long long n, int desc, long long n_used,
                long long seglen, long long k, void* a_keys, void* a_pos,
                void* b_keys, void* b_pos, void* out, void* passes,
                int* launched, void* stream) {
  *launched = 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nseg = n_used / seglen;
  const long long kk = k < seglen ? k : seglen;
  RowSource rows{values, static_cast<const unsigned char*>(ok),
                 static_cast<const unsigned char*>(mask), n, dtype, desc};
  PairOut pa{static_cast<unsigned long long*>(a_keys),
             static_cast<long long*>(a_pos)};
  PairOut pb{static_cast<unsigned long long*>(b_keys),
             static_cast<long long*>(b_pos)};
  topn_chunks<<<(unsigned)nseg, THREADS, 0, s>>>(
      rows, n_used, seglen, kk, pa,
      static_cast<unsigned long long*>(passes));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  long long m = nseg * kk;
  const long long chunk = CHUNK > 4 * k ? CHUNK : 4 * k;
  while (m > chunk) {
    const long long blocks = (m + chunk - 1) / chunk;
    topn_chunks<<<(unsigned)blocks, THREADS, 0, s>>>(
        CandSource{pa.keys, pa.at}, m, chunk, k, pb, nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ++*launched;
    const long long last = m - (blocks - 1) * chunk;
    m = (blocks - 1) * k + (last < k ? last : k);
    const PairOut t = pa;
    pa = pb;
    pb = t;
  }
  const long long k2 = k < m ? k : m;
  long long* o = static_cast<long long*>(out);
  topn_chunks<<<1, THREADS, 0, s>>>(CandSource{pa.keys, pa.at}, m, m, k2,
                                    FinalOut{o, o + k2, desc ? 1ULL : ~0ULL},
                                    nullptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  return cudaSuccess;
}

const char* topn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

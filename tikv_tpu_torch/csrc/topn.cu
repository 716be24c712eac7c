// Top-k for Hopper: ORDER BY one key LIMIT k over the feed.
//
// Replaces the XLA kernel of tikv_tpu/device/runner.py `_build_topn_kernel`
// (:2825) with its sort key `_topn_sort_key` (:2783): a top-k per segment
// of `seglen` rows (lax.top_k over a (nseg, seglen) view), then a global
// top-k over the nseg * kk candidates.  The result is the same set of rows
// however it is computed: the best min(k, n_used) rows of [0, n_used) by
// (key desc, position asc), in row order, so this kernel need not keep the
// reference's segments.
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
// queue 3, fault 6), so the result is the true top k.
//
// Bound: bytes.  The order plane read once (8 B/row for float64: 0.250 ms
// for config 5's 104,857,600 rows at 3.35 TB/s) plus validity and
// selection bytes.  The common route reads the planes twice:
//   1. topn_hist: every SM, grid-stride, four rows a thread per step (16-
//      byte loads), counts each row's bin: one wide digit of BINS bins
//      placed by the caller (`lo`, `shift`) where this feed's keys differ
//      -- bin 0 below the window, BINS - 1 above it, so the bins are
//      monotone in the key whatever the placement.  Per-block shared
//      histograms (COPIES of them, by lane, against same-bin conflicts;
//      a thread's equal neighbours add as one), merged into one global
//      histogram.
//   2. topn_cross: one warp finds the bin c that holds the k-th key and
//      the rows in bins >= c (the candidates); when they exceed the
//      candidate buffer (`cap` >= max(4k, 2^16) rows) the request takes
//      the overflow route instead.
//   3. topn_fill: the second read; every row in a bin >= c is appended to
//      the buffer as (key, position), one atomic per warp and step.
//   4. topn_pick: one block selects exactly over the buffer -- an MSB
//      radix select on the 128-bit (key, ~position), so ties go by
//      position although the buffer holds the rows in no order -- and
//      sorts the k winners by position (bitonic, in shared memory).
// The overflow route (many ties, NULL keys or excluded rows at the k-th
// place, or a placement that does not spread the keys) is the exact
// per-segment select: one block of 1024 threads per segment radix-selects
// the kk-th key (8-bit digits, warp-aggregated shared histograms, early
// exit) and writes, in row order, every row above it and the lowest-
// positioned rows equal to it; the same block then runs over the
// candidates until one block's worth is left.  Every kernel of both routes
// is enqueued; each reads the route from the device and the other route's
// kernels return at once, so the host never waits.

#include <climits>
#include <cuda_runtime.h>

#define THREADS 1024
#define RADIX 256
#define COLLECT_ROWS 4
#define CHUNK (1 << 17)

#define BINS 4096            // bins of the common route's digit
#define COPIES 2             // shared histograms per block (by lane)
#define HIST_THREADS 512
#define ROWS 4               // rows per thread per step (one 16-byte load)
#define MAX_PICK (1 << 14)   // winners the pick block sorts (MAX_LIMIT)

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long SIGN = 0x8000000000000000ULL;

enum { DT_INT32 = 0, DT_INT64 = 1, DT_FLOAT64 = 2 };

// state[]: the common route's bookkeeping, written by topn_cross
enum { ST_BIN = 0, ST_CANDS = 1, ST_ROUTE = 2, ST_FILLED = 3, ST_WORDS = 4 };
enum { ROUTE_COMMON = 0, ROUTE_OVERFLOW = 1 };

// keys built in registers from the order plane
struct RowSource {
  const void* values;
  const unsigned char* ok;    // nullptr: no NULLs
  const unsigned char* mask;  // nullptr: no selection
  long long n;
  int dtype;
  int desc;

  // the key of a non-NULL value from its signed image
  __device__ __forceinline__ unsigned long long value_key(long long s) const {
    if (desc) {
      s = s < LLONG_MIN + 2 ? LLONG_MIN + 2 : s;
    } else {
      s = s < LLONG_MIN + 1 ? LLONG_MIN + 1 : (s > LLONG_MAX - 1 ? LLONG_MAX - 1 : s);
      s = ~s;
    }
    return static_cast<unsigned long long>(s) ^ SIGN;
  }
  __device__ __forceinline__ static long long f64_image(long long bits) {
    const long long b = __double_as_longlong(__longlong_as_double(bits) + 0.0);
    return b >= 0 ? b : b ^ LLONG_MAX;
  }
  __device__ __forceinline__ unsigned long long key(long long row) const {
    if (row >= n || (mask != nullptr && !mask[row])) return 0ULL;
    if (ok != nullptr && !ok[row]) return desc ? 1ULL : ~0ULL;
    long long s;
    if (dtype == DT_INT32) {
      s = static_cast<const int*>(values)[row];
    } else {
      s = static_cast<const long long*>(values)[row];
      if (dtype == DT_FLOAT64) s = f64_image(s);
    }
    return value_key(s);
  }
  // rows [r0, r0 + ROWS); `vec`: the planes are aligned for 16-byte value
  // loads and 4-byte flag loads and r0 is a multiple of ROWS
  __device__ __forceinline__ void keys(long long r0, int vec,
                                       unsigned long long* k) const {
    if (!vec || r0 + ROWS > n) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j) k[j] = key(r0 + j);
      return;
    }
    long long s[ROWS];
    if (dtype == DT_INT32) {
      const int4 q = *reinterpret_cast<const int4*>(
          static_cast<const int*>(values) + r0);
      s[0] = q.x; s[1] = q.y; s[2] = q.z; s[3] = q.w;
    } else {
      const longlong2* p = reinterpret_cast<const longlong2*>(
          static_cast<const long long*>(values) + r0);
      const longlong2 a = p[0], b = p[1];
      s[0] = a.x; s[1] = a.y; s[2] = b.x; s[3] = b.y;
      if (dtype == DT_FLOAT64) {
#pragma unroll
        for (int j = 0; j < ROWS; ++j) s[j] = f64_image(s[j]);
      }
    }
    const unsigned okb = ok != nullptr
        ? *reinterpret_cast<const unsigned*>(ok + r0) : 0x01010101u;
    const unsigned mb = mask != nullptr
        ? *reinterpret_cast<const unsigned*>(mask + r0) : 0x01010101u;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      k[j] = !((mb >> (8 * j)) & 0xff) ? 0ULL
           : !((okb >> (8 * j)) & 0xff) ? (desc ? 1ULL : ~0ULL)
           : value_key(s[j]);
    }
  }
  __device__ __forceinline__ long long pos(long long row) const { return row; }
};

// the common route's bin of a key: 0 below `lo`, then one bin per 2^shift
// keys, BINS - 1 for everything past the window (monotone in the key)
__device__ __forceinline__ int bin_of(unsigned long long key,
                                      unsigned long long lo, int shift) {
  if (key < lo) return 0;
  const unsigned long long d = (key - lo) >> shift;
  return d >= BINS - 2 ? BINS - 1 : static_cast<int>(d) + 1;
}

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
    // the rows read: one pass per digit resolved, and this one
    int digits = 0;
    for (unsigned long long m = pmask; m != 0; m <<= 8) ++digits;
    atomicAdd(passes, (unsigned long long)(digits + 1) * len);
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
// min(take, chunk length) rows go to slots b * take onward.  Runs only on
// the overflow route (`state` null: always).
template <class Src, class Out>
__global__ void __launch_bounds__(THREADS)
    topn_chunks(const Src src, long long len, long long chunk, long long take,
                const Out out, unsigned long long* passes,
                const long long* state) {
  if (state != nullptr && state[ST_ROUTE] != ROUTE_OVERFLOW) return;
  const long long base = (long long)blockIdx.x * chunk;
  const long long here = len - base < chunk ? len - base : chunk;
  top_rows(src, base, here, take < here ? take : here, out,
           (long long)blockIdx.x * take, passes);
}

// ---------------------------------------------------------------- common
// route

// read 1: the histogram of the bins over rows [0, n_used) (rows at or past
// n are excluded rows, key 0, and are not read)
__global__ void __launch_bounds__(HIST_THREADS)
    topn_hist(const RowSource src, long long n_used, unsigned long long lo,
              int shift, int vec, unsigned long long* hist,
              unsigned long long* passes) {
  __shared__ unsigned h[COPIES * BINS];
  for (int i = threadIdx.x; i < COPIES * BINS; i += HIST_THREADS) h[i] = 0;
  __syncthreads();
  unsigned* mine = h + (threadIdx.x & (COPIES - 1)) * BINS;
  const long long step = (long long)gridDim.x * HIST_THREADS * ROWS;
  for (long long r0 = ((long long)blockIdx.x * HIST_THREADS + threadIdx.x) *
                      ROWS;
       r0 < n_used; r0 += step) {
    unsigned long long k[ROWS];
    src.keys(r0, vec, k);
    const long long left = n_used - r0;
    int prev = bin_of(k[0], lo, shift);
    unsigned run = 1;
#pragma unroll
    for (int j = 1; j < ROWS; ++j) {
      if (j >= left) break;
      const int b = bin_of(k[j], lo, shift);
      if (b == prev) {
        ++run;
      } else {
        atomicAdd(&mine[prev], run);
        prev = b;
        run = 1;
      }
    }
    atomicAdd(&mine[prev], run);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BINS; i += HIST_THREADS) {
    unsigned t = 0;
#pragma unroll
    for (int c = 0; c < COPIES; ++c) t += h[c * BINS + i];
    if (t != 0) atomicAdd(&hist[i], (unsigned long long)t);
  }
  if (passes != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(passes, (unsigned long long)src.n);
}

// one warp: the bin c holding the k-th key (the lowest bin when fewer than
// k rows), the rows in bins >= c, and the route
__global__ void topn_cross(const unsigned long long* hist, long long k,
                           long long cap, long long* state,
                           long long* passes) {
  constexpr int PER = BINS / 32;
  const int lane = threadIdx.x;
  unsigned long long mine = 0;
  for (int j = 0; j < PER; ++j) mine += hist[lane * PER + j];
  // inclusive suffix sums over the lanes: the rows in bins >= lane * PER
  unsigned long long incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long t = __shfl_down_sync(FULL, incl, o);
    if (lane + o < 32) incl += t;
  }
  const unsigned reach = __ballot_sync(FULL, incl >= (unsigned long long)k);
  const int at = reach ? 31 - __clz(reach) : 0;
  if (lane == at) {
    unsigned long long acc = incl - mine;
    int c = at * PER;
    for (int b = at * PER + PER - 1; b >= at * PER; --b) {
      acc += hist[b];
      if (acc >= (unsigned long long)k) {
        c = b;
        break;
      }
    }
    const int route = acc <= (unsigned long long)cap ? ROUTE_COMMON
                                                     : ROUTE_OVERFLOW;
    state[ST_BIN] = c;
    state[ST_CANDS] = (long long)acc;
    state[ST_ROUTE] = route;
    state[ST_FILLED] = 0;
    if (passes != nullptr) passes[1] = route;
  }
}

// read 2: append every row in a bin >= c to the candidate buffer
__global__ void __launch_bounds__(HIST_THREADS)
    topn_fill(const RowSource src, long long n_used, unsigned long long lo,
              int shift, int vec, long long* state,
              unsigned long long* ckeys, long long* cpos,
              unsigned long long* passes) {
  if (state[ST_ROUTE] != ROUTE_COMMON) return;
  const int c = static_cast<int>(state[ST_BIN]);
  unsigned long long* filled =
      reinterpret_cast<unsigned long long*>(state + ST_FILLED);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const long long step = (long long)gridDim.x * HIST_THREADS * ROWS;
  // a warp's lanes step together, so the ballots see every lane
  for (long long w0 = ((long long)blockIdx.x * HIST_THREADS +
                       (threadIdx.x & ~31)) * ROWS;
       w0 < n_used; w0 += step) {
    const long long r0 = w0 + (long long)lane * ROWS;
    unsigned long long k[ROWS];
    bool take[ROWS], any = false;
    if (r0 < n_used) src.keys(r0, vec, k);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      take[j] = r0 + j < n_used && bin_of(k[j], lo, shift) >= c;
      any = any || take[j];
    }
    // most steps take no row: one vote skips them
    if (__ballot_sync(FULL, any) == 0) continue;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const unsigned who = __ballot_sync(FULL, take[j]);
      if (who == 0) continue;
      unsigned long long at = 0;
      if (lane == __ffs(who) - 1) at = atomicAdd(filled, (unsigned long long)__popc(who));
      at = __shfl_sync(FULL, at, __ffs(who) - 1) + __popc(who & below);
      if (take[j]) {
        ckeys[at] = k[j];
        cpos[at] = r0 + j;
      }
    }
  }
  if (passes != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(passes, (unsigned long long)src.n);
}

// one block: the k2 best candidates by (key desc, position asc), found by
// an MSB radix select on the 128-bit (key, ~position) -- every candidate's
// is distinct -- then sorted by position and written with their flags
__global__ void __launch_bounds__(THREADS)
    topn_pick(const unsigned long long* ckeys, const long long* cpos,
              const long long* state, long long k2, long long* out,
              unsigned long long null_key) {
  if (state[ST_ROUTE] != ROUTE_COMMON) return;
  extern __shared__ unsigned long long win[];  // next_pow2(k2) entries
  __shared__ unsigned hist[RADIX];
  __shared__ unsigned long long s_hi, s_lo, s_mhi, s_mlo;
  __shared__ long long s_need;
  __shared__ int s_done;
  __shared__ unsigned s_count;
  const long long m = state[ST_CANDS];
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    s_hi = s_lo = s_mhi = s_mlo = 0;
    s_need = k2;
    s_done = k2 >= m;
    s_count = 0;
  }
  __syncthreads();
  for (int d = 0; d < 16 && !s_done; ++d) {
    const int shift = 56 - 8 * (d & 7);
    for (int i = threadIdx.x; i < RADIX; i += THREADS) hist[i] = 0;
    __syncthreads();
    const unsigned long long phi = s_hi, plo = s_lo, mhi = s_mhi,
                             mlo = s_mlo;
    for (long long r0 = 0; r0 < m; r0 += THREADS) {
      const long long i = r0 + threadIdx.x;
      int digit = -1;
      if (i < m) {
        const unsigned long long kh = ckeys[i];
        const unsigned long long kl = ~static_cast<unsigned long long>(cpos[i]);
        if ((kh & mhi) == phi && (kl & mlo) == plo)
          digit = (int)(((d < 8 ? kh : kl) >> shift) & 0xff);
      }
      const unsigned peers = __match_any_sync(FULL, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long need = s_need;
      long long above = 0;
      int b = RADIX - 1;
      for (; b > 0; --b) {
        if (above + hist[b] >= need) break;
        above += hist[b];
      }
      s_need = need - above;
      if (d < 8) {
        s_hi = phi | ((unsigned long long)b << shift);
        s_mhi = mhi | (0xffULL << shift);
      } else {
        s_lo = plo | ((unsigned long long)b << shift);
        s_mlo = mlo | (0xffULL << shift);
      }
      s_done = (long long)hist[b] == s_need;
    }
    __syncthreads();
  }
  // the winners: every candidate at or above the threshold
  const unsigned long long phi = s_hi, plo = s_lo, mhi = s_mhi, mlo = s_mlo;
  for (long long i = threadIdx.x; i < m; i += THREADS) {
    const unsigned long long kh = ckeys[i];
    const unsigned long long kl = ~static_cast<unsigned long long>(cpos[i]);
    const unsigned long long h = kh & mhi, l = kl & mlo;
    if (h > phi || (h == phi && l >= plo)) {
      const unsigned at = atomicAdd(&s_count, 1u);
      win[at] = (static_cast<unsigned long long>(cpos[i]) << 2) |
                (kh != 0ULL ? 1 : 0) | (kh != 0ULL && kh != null_key ? 2 : 0);
    }
  }
  __syncthreads();
  int size = 1;
  while (size < k2) size <<= 1;
  for (int i = (int)k2 + threadIdx.x; i < size; i += THREADS) win[i] = ~0ULL;
  __syncthreads();
  for (int span = 2; span <= size; span <<= 1) {
    for (int stride = span >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < size; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = win[i], b = win[j];
          if ((a > b) == ((i & span) == 0)) {
            win[i] = b;
            win[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < k2; i += THREADS) {
    out[i] = static_cast<long long>(win[i] >> 2);
    out[k2 + i] = static_cast<long long>(win[i] & 3);
  }
}

}  // namespace

extern "C" {

// values: int32 / int64 / float64 (dtype 0 / 1 / 2), rows [0, n) read;
// ok, mask: bool or null.  k2 = min(k, n_used) results.
// Common route: `lo`, `shift` place the digit (bin_of); `hist` holds BINS
// uint64, `state` ST_WORDS int64, `c_keys`/`c_pos` `cap` candidates each.
// Overflow route: segments of `seglen` rows over [0, n_used);
// `a_keys`/`a_pos` and `b_keys`/`b_pos` hold nseg * kk candidates each.
// hist and state are zeroed here.  out: int64 [2][k2]: positions, then
// flags.  passes (or null): int64 [2]; [0] gains the rows read, [1] is the
// route taken (0 common, 1 overflow).  Returns the first failing call's
// error; *launched counts kernel launches.
int topn_launch(int device, const void* values, int dtype, const void* ok,
                const void* mask, long long n, int desc, long long n_used,
                long long seglen, long long k, unsigned long long lo,
                int shift, long long cap, void* hist, void* state,
                void* c_keys, void* c_pos, void* a_keys, void* a_pos,
                void* b_keys, void* b_pos, void* out, void* passes,
                int* launched, void* stream) {
  *launched = 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int grid_per_sm = 0, sms = 0, pick_smem_set = -1;
  if (grid_per_sm == 0) {
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &grid_per_sm, topn_hist, HIST_THREADS, 0)) != cudaSuccess)
      return e;
    if (grid_per_sm < 1) grid_per_sm = 1;
  }
  if (pick_smem_set != device) {
    if ((e = cudaFuncSetAttribute(topn_pick,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  MAX_PICK * 8)) != cudaSuccess)
      return e;
    pick_smem_set = device;
  }
  const long long nseg = n_used / seglen;
  const long long kk = k < seglen ? k : seglen;
  const long long k2 = k < n_used ? k : n_used;
  RowSource rows{values, static_cast<const unsigned char*>(ok),
                 static_cast<const unsigned char*>(mask), n, dtype, desc};
  const int vec = reinterpret_cast<unsigned long long>(values) % 16 == 0 &&
                  reinterpret_cast<unsigned long long>(ok) % 4 == 0 &&
                  reinterpret_cast<unsigned long long>(mask) % 4 == 0;
  long long* st = static_cast<long long*>(state);
  unsigned long long* pass = static_cast<unsigned long long*>(passes);
  long long* o = static_cast<long long*>(out);
  const unsigned long long null_key = desc ? 1ULL : ~0ULL;

  // the common route
  if ((e = cudaMemsetAsync(hist, 0, BINS * sizeof(unsigned long long), s)) !=
      cudaSuccess)
    return e;
  const long long steps = (n_used + (long long)HIST_THREADS * ROWS - 1) /
                          ((long long)HIST_THREADS * ROWS);
  const long long most = (long long)grid_per_sm * sms;
  const unsigned grid = (unsigned)(steps < most ? steps : most);
  topn_hist<<<grid, HIST_THREADS, 0, s>>>(
      rows, n_used, lo, shift, vec, static_cast<unsigned long long*>(hist),
      pass);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  topn_cross<<<1, 32, 0, s>>>(static_cast<unsigned long long*>(hist), k, cap,
                              st, static_cast<long long*>(passes));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  topn_fill<<<grid, HIST_THREADS, 0, s>>>(
      rows, n_used, lo, shift, vec, st,
      static_cast<unsigned long long*>(c_keys), static_cast<long long*>(c_pos),
      pass);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  int size = 1;
  while (size < k2) size <<= 1;
  topn_pick<<<1, THREADS, size * sizeof(unsigned long long), s>>>(
      static_cast<unsigned long long*>(c_keys), static_cast<long long*>(c_pos),
      st, k2, o, null_key);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;

  // the overflow route: per segment, candidate levels, a final block
  PairOut pa{static_cast<unsigned long long*>(a_keys),
             static_cast<long long*>(a_pos)};
  PairOut pb{static_cast<unsigned long long*>(b_keys),
             static_cast<long long*>(b_pos)};
  topn_chunks<<<(unsigned)nseg, THREADS, 0, s>>>(rows, n_used, seglen, kk, pa,
                                                 pass, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  long long m = nseg * kk;
  const long long chunk = CHUNK > 4 * k ? CHUNK : 4 * k;
  while (m > chunk) {
    const long long blocks = (m + chunk - 1) / chunk;
    topn_chunks<<<(unsigned)blocks, THREADS, 0, s>>>(
        CandSource{pa.keys, pa.at}, m, chunk, k, pb, nullptr, st);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ++*launched;
    const long long last = m - (blocks - 1) * chunk;
    m = (blocks - 1) * k + (last < k ? last : k);
    const PairOut t = pa;
    pa = pb;
    pb = t;
  }
  topn_chunks<<<1, THREADS, 0, s>>>(CandSource{pa.keys, pa.at}, m, m, k2,
                                    FinalOut{o, o + k2, null_key}, nullptr,
                                    st);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  return cudaSuccess;
}

const char* topn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

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
// order), so key k's segment is [seg_start[k], seg_start[k + 1]) and a
// tile of consecutive keys owns one contiguous range of versions.
//
// resolve_kernel: one pass with decoupled look-back over tiles of 1024
// keys.  A block takes its tile index from an atomic counter (so it waits
// only on tiles already running) and reads its keys' seg_start.  When the
// tile's versions fit its shared budget (2048, the common case: about
// 1.15 a key at 4h) it copies their commit_ts and wtype into shared memory
// with 16-byte loads, once (every copy loads all of a thread's elements
// into registers before it stores any, so no load waits on a store); each
// thread resolves four consecutive keys from there in one pass each (the
// eligible max, its PUTs and the first of them); a block scan of the
// winners gives each key its first row in the tile; the tile publishes
// its count (one 64-bit word a tile: a flag and a count, the flag either
// the tile's own count or the inclusive count of every tile up to it) and
// stages its winners (version, key) in shared memory; one warp looks back
// for its offset (32 predecessors a step) while every thread fetches its
// rows' first source elements; the tile publishes its inclusive count and
// writes its output rows, one contiguous run, striped over the threads,
// plane by plane, so consecutive threads store consecutive rows.  A larger
// tile (a hot key of 10^5 versions, keys of hundreds each) resolves a key
// a warp straight from device memory, its lanes striding over the
// versions (a warp max, then a warp count), and after the look-back
// writes its winners in order by a ballot, without the staging: exact at
// any length.  The last tile writes the visible count.  zero_kernel then
// zero-fills rows [count, n_pad).
//
// Bound: bytes.  commit_ts (8 B) and wtype (1 B) per version, seg_start
// (8 B) per key, and at each visible winner its handle and the source
// elements its output planes take, read once; each output plane written
// once over n_pad rows.  This design reads each of those once (a tile
// past its budget reads its versions twice).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

typedef unsigned long long u64;

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
  long long n_tiles;            // ceil(n_keys / TILE_KEYS)
  u64* work;  // n_tiles status words, the tile counter, the visible count
  int n_out;
  int op[MVCC_MAX_OUT];
  int src_kind[MVCC_MAX_OUT];
  int dst_kind[MVCC_MAX_OUT];
  const void* src[MVCC_MAX_OUT];
  void* dst[MVCC_MAX_OUT];
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KEYS_PER_THREAD = 4;
constexpr int TILE_KEYS = THREADS * KEYS_PER_THREAD;
constexpr int BUDGET = 2048;  // versions of a tile held in shared memory
constexpr int ROWS = BUDGET / THREADS;  // a thread's output rows, at most
// a thread's 16-byte chunks of seg_start, commit_ts and wtype, at most
constexpr int SEG_ITEMS = TILE_KEYS / THREADS + 1;
constexpr int TS_ITEMS = (BUDGET / 2 + 1 + THREADS - 1) / THREADS;
constexpr int WT_ITEMS = (BUDGET / 16 + 2 + THREADS - 1) / THREADS;
constexpr int MAX_OUT = MVCC_MAX_OUT;
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 FLAG_AGG = 1ull << 62;     // the tile's own count
constexpr u64 FLAG_PREFIX = 2ull << 62;  // the count of tiles [0, tile]
constexpr u64 COUNT_MASK = (1ull << 62) - 1;

// output plane ops
constexpr int OP_HANDLE = 0, OP_VALUE = 1, OP_VALID = 2;
// source kinds (the version planes' kind codes): int64, float64, uint64,
// and bool for a validity plane
constexpr int SRC_I64 = 0, SRC_F64 = 1, SRC_U64 = 3, SRC_BOOL = 4;
// output dtypes
constexpr int DST_I32 = 0, DST_I64 = 1, DST_F32 = 2, DST_F64 = 3,
              DST_BOOL = 4;

// a version's score: its commit_ts when eligible, else 0 (as the
// reference's segmented max sees it, a winner needs a score above 0)
__device__ __forceinline__ long long score(long long ts, unsigned char wt,
                                           long long read_ts) {
  return ts <= read_ts && wt <= 1 ? ts : 0;
}

// the source element of output plane q at version v of key k, as bits
__device__ __forceinline__ u64 fetch(const ResolveParams& p, int q,
                                     long long v, long long k) {
  switch (p.op[q]) {
    case OP_HANDLE:
      return (u64)p.handles[k];
    case OP_VALID:
      return static_cast<const unsigned char*>(p.src[q])[v];
    default:
      return static_cast<const u64*>(p.src[q])[v];
  }
}

// row `row` of output plane q from its source element's bits (`fetch`),
// cast to the plane's dtype: integers wrap, an unsigned source converts
// as an unsigned value, floats round to nearest
__device__ __forceinline__ void store(const ResolveParams& p, int q,
                                      long long row, u64 bits) {
  if (p.op[q] == OP_VALID) {
    static_cast<unsigned char*>(p.dst[q])[row] = bits != 0;
    return;
  }
  const int src = p.op[q] == OP_HANDLE ? SRC_I64 : p.src_kind[q];
  const double f = __longlong_as_double((long long)bits);
  switch (p.dst_kind[q]) {
    case DST_I32:
      static_cast<int*>(p.dst[q])[row] = (int)(unsigned)bits;
      break;
    case DST_I64:
      static_cast<long long*>(p.dst[q])[row] = (long long)bits;
      break;
    case DST_F32:
      static_cast<float*>(p.dst[q])[row] =
          src == SRC_F64   ? __double2float_rn(f)
          : src == SRC_U64 ? __ull2float_rn(bits)
                           : __ll2float_rn((long long)bits);
      break;
    default:  // DST_F64
      static_cast<double*>(p.dst[q])[row] =
          src == SRC_F64   ? f
          : src == SRC_U64 ? __ull2double_rn(bits)
                           : __ll2double_rn((long long)bits);
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

__device__ __forceinline__ void publish(u64* word, u64 v) {
  *reinterpret_cast<volatile u64*>(word) = v;
}

// the count of the tiles before `tile` (every lane of one warp calls it):
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

// thread 0: publish the tile's own count (inclusive for tile 0)
__device__ __forceinline__ void publish_count(const ResolveParams& p,
                                              long long tile,
                                              long long total) {
  if (threadIdx.x == 0)
    publish(p.work + tile, (tile == 0 ? FLAG_PREFIX : FLAG_AGG) | (u64)total);
}

// warp 0, after publish_count: look back, publish the inclusive count →
// the tile's first output row in *base; the last tile writes the visible
// count.  The caller syncs before reading *base.
__device__ __forceinline__ void tile_offset(const ResolveParams& p,
                                            long long tile, long long total,
                                            long long* base) {
  if (threadIdx.x >= 32) return;
  const long long excl = tile > 0 ? look_back(p.work, tile) : 0;
  if (threadIdx.x == 0) {
    if (tile > 0) publish(p.work + tile, FLAG_PREFIX | (u64)(excl + total));
    *base = excl;
    if (tile == p.n_tiles - 1)
      *reinterpret_cast<long long*>(p.work + p.n_tiles + 1) = excl + total;
  }
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(FULL, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// Every copy into shared memory below loads all of a thread's elements
// into registers before it stores any, so no load waits on a store.
__global__ void __launch_bounds__(THREADS)
    resolve_kernel(const __grid_constant__ ResolveParams p) {
  __shared__ long long s_seg[TILE_KEYS + 1];
  // the tile's commit_ts from an even row (16-byte loads); past the
  // budget, each key's eligible max and its winners' first row
  __shared__ __align__(16) long long s_ts[BUDGET + 2];
  __shared__ __align__(16) unsigned char s_wt[BUDGET + 32];
  __shared__ unsigned short s_wv[BUDGET];  // a winner's version - v0
  __shared__ unsigned short s_wk[BUDGET];  // its key - k0
  __shared__ long long s_tile, s_base;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = (long long)atomicAdd(p.work + p.n_tiles, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const long long k0 = tile * TILE_KEYS;
  const int nk = (int)(p.n_keys - k0 < TILE_KEYS ? p.n_keys - k0 : TILE_KEYS);
  {
    long long seg[SEG_ITEMS];
#pragma unroll
    for (int u = 0; u < SEG_ITEMS; ++u) {
      const int i = t + u * THREADS;
      seg[u] = i <= nk ? p.seg_start[k0 + i] : 0;
    }
#pragma unroll
    for (int u = 0; u < SEG_ITEMS; ++u)
      if (t + u * THREADS <= nk) s_seg[t + u * THREADS] = seg[u];
  }
  __syncthreads();
  const long long v0 = s_seg[0], v1 = s_seg[nk];
  long long total;
  if (v1 - v0 <= BUDGET) {
    // versions [v0, v1) into shared memory: s_ts[x] is row a8 + x, s_wt[x]
    // row a1 + x
    const long long a8 = v0 & ~1ll, a1 = v0 & ~15ll;
    const int n8 = (int)((v1 - a8 + 1) >> 1), n1 = (int)((v1 - a1 + 15) >> 4);
    if ((reinterpret_cast<uintptr_t>(p.commit_ts) & 15) == 0 &&
        (reinterpret_cast<uintptr_t>(p.wtype) & 15) == 0) {
      const longlong2* ts = reinterpret_cast<const longlong2*>(p.commit_ts);
      const uint4* wt = reinterpret_cast<const uint4*>(p.wtype);
      longlong2 tv[TS_ITEMS];
      uint4 wv[WT_ITEMS];
#pragma unroll
      for (int u = 0; u < TS_ITEMS; ++u)
        if (t + u * THREADS < n8) tv[u] = ts[(a8 >> 1) + t + u * THREADS];
#pragma unroll
      for (int u = 0; u < WT_ITEMS; ++u)
        if (t + u * THREADS < n1) wv[u] = wt[(a1 >> 4) + t + u * THREADS];
#pragma unroll
      for (int u = 0; u < TS_ITEMS; ++u)
        if (t + u * THREADS < n8)
          reinterpret_cast<longlong2*>(s_ts)[t + u * THREADS] = tv[u];
#pragma unroll
      for (int u = 0; u < WT_ITEMS; ++u)
        if (t + u * THREADS < n1)
          reinterpret_cast<uint4*>(s_wt)[t + u * THREADS] = wv[u];
    } else {  // planes off a 16-byte boundary: element by element
      for (long long x = v0 - a8 + t; x < v1 - a8; x += THREADS)
        s_ts[x] = p.commit_ts[a8 + x];
      for (long long x = v0 - a1 + t; x < v1 - a1; x += THREADS)
        s_wt[x] = p.wtype[a1 + x];
    }
    __syncthreads();
    const int dw = (int)(a8 - a1);  // s_wt's index of s_ts[x] is x + dw
    // thread t's keys [t * 4, t * 4 + 4), one pass each: the eligible max,
    // the PUTs at it and the first of them
    long long best[KEYS_PER_THREAD];
    int vis[KEYS_PER_THREAD], first[KEYS_PER_THREAD], mine = 0;
#pragma unroll
    for (int m = 0; m < KEYS_PER_THREAD; ++m) {
      const int kk = t * KEYS_PER_THREAD + m;
      best[m] = 0;
      vis[m] = first[m] = 0;
      if (kk >= nk) continue;
      const int lo = (int)(s_seg[kk] - a8), hi = (int)(s_seg[kk + 1] - a8);
      for (int x = lo; x < hi; ++x) {
        const long long ts = s_ts[x];
        const unsigned char w = s_wt[x + dw];
        const long long sc = score(ts, w, p.read_ts);
        if (sc > best[m]) {
          best[m] = sc;
          vis[m] = w == 0;
          first[m] = x;
        } else if (sc == best[m] && sc > 0 && w == 0) {
          if (vis[m] == 0) first[m] = x;
          ++vis[m];
        }
      }
      mine += vis[m];
    }
    int tile_rows;
    int row = block_exclusive_scan<THREADS>(mine, Add<int>(), 0, &tile_rows);
    total = tile_rows;
    publish_count(p, tile, total);
    // stage the winners in row order (at most one a version: fits)
#pragma unroll
    for (int m = 0; m < KEYS_PER_THREAD; ++m) {
      const int kk = t * KEYS_PER_THREAD + m;
      const int hi = vis[m] > 1 ? (int)(s_seg[kk + 1] - a8) : first[m] + 1;
      for (int x = first[m]; x < hi && vis[m] > 0; ++x)
        if (s_ts[x] == best[m] && s_wt[x + dw] == 0) {
          s_wv[row] = (unsigned short)(x - (int)(v0 - a8));
          s_wk[row] = (unsigned short)kk;
          ++row;
        }
    }
    __syncthreads();
    // a thread's rows are t + j * THREADS, its plane's source elements
    // fetched before any row is stored, the first plane's while warp 0
    // looks back (on an H100 faster at 4h than by (plane, row) cell)
    const int rows = (int)total;
    u64 bits[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int i = t + j * THREADS;
      if (i < rows) bits[j] = fetch(p, 0, v0 + s_wv[i], k0 + s_wk[i]);
    }
    tile_offset(p, tile, total, &s_base);
    __syncthreads();
    const long long base = s_base;
    const long long room = p.n_pad - base;
    const int lim = room <= 0 ? 0 : room < total ? (int)room : rows;
    for (int q = 0;;) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int i = t + j * THREADS;
        if (i < lim) store(p, q, base + i, bits[j]);
      }
      if (++q >= p.n_out) break;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int i = t + j * THREADS;
        if (i < lim) bits[j] = fetch(p, q, v0 + s_wv[i], k0 + s_wk[i]);
      }
    }
    return;
  }
  // past the budget: a key a warp, straight from device memory
  long long* s_best = s_ts;             // a key's eligible max
  long long* s_row = s_ts + TILE_KEYS;  // its winners, then its first row
  for (int kk = warp; kk < nk; kk += WARPS) {
    const long long lo = s_seg[kk], hi = s_seg[kk + 1];
    long long b = 0;
    for (long long v = lo + lane; v < hi; v += 32) {
      const long long sc = score(p.commit_ts[v], p.wtype[v], p.read_ts);
      b = sc > b ? sc : b;
    }
    b = warp_max(b);
    long long c = 0;
    if (b > 0)
      for (long long v = lo + lane; v < hi; v += 32)
        c += p.commit_ts[v] == b && p.wtype[v] == 0;
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
    if (lane == 0) {
      s_best[kk] = b;
      s_row[kk] = c;
    }
  }
  __syncthreads();
  long long cnt[KEYS_PER_THREAD], mine = 0;
#pragma unroll
  for (int m = 0; m < KEYS_PER_THREAD; ++m) {
    const int kk = t * KEYS_PER_THREAD + m;
    cnt[m] = kk < nk ? s_row[kk] : 0;
    mine += cnt[m];
  }
  long long at =
      block_exclusive_scan<THREADS>(mine, Add<long long>(), 0ll, &total);
#pragma unroll
  for (int m = 0; m < KEYS_PER_THREAD; ++m) {
    const int kk = t * KEYS_PER_THREAD + m;
    if (kk < nk) s_row[kk] = at;
    at += cnt[m];
  }
  publish_count(p, tile, total);
  tile_offset(p, tile, total, &s_base);
  __syncthreads();
  const long long base = s_base;
  const unsigned below = (1u << lane) - 1;
  for (int kk = warp; kk < nk; kk += WARPS) {
    const long long b = s_best[kk];
    if (b <= 0) continue;
    const long long lo = s_seg[kk], hi = s_seg[kk + 1];
    long long row = base + s_row[kk];
    for (long long c0 = lo; c0 < hi; c0 += 32) {
      const long long v = c0 + lane;
      const bool win = v < hi && p.commit_ts[v] == b && p.wtype[v] == 0;
      const unsigned bal = __ballot_sync(FULL, win);
      const long long r = row + __popc(bal & below);
      if (win && r < p.n_pad)
        for (int q = 0; q < p.n_out; ++q)
          store(p, q, r, fetch(p, q, v, k0 + kk));
      row += __popc(bal);
    }
  }
}

// rows [count, n_pad): the padding of the feed layout
__global__ void __launch_bounds__(THREADS)
    zero_kernel(const __grid_constant__ ResolveParams p) {
  const long long from =
      *reinterpret_cast<const long long*>(p.work + p.n_tiles + 1);
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long row = from + (long long)blockIdx.x * THREADS + threadIdx.x;
       row < p.n_pad; row += stride)
    for (int q = 0; q < p.n_out; ++q) zero(p, q, row);
}

}  // namespace

extern "C" {

// The resolve pass (when there are keys), then the zero fill, on
// `stream`; work holds n_tiles + 2 words, zeroed here.
int mvcc_resolve_launch(int device, const ResolveParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p->n_out < 1 || p->n_out > MAX_OUT || p->n_keys < 0 ||
      p->n_tiles != (p->n_keys + TILE_KEYS - 1) / TILE_KEYS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(p->work, 0, (size_t)(p->n_tiles + 2) * sizeof(u64), s);
  if (e != cudaSuccess) return e;
  if (p->n_tiles > 0) {
    resolve_kernel<<<(unsigned)p->n_tiles, THREADS, 0, s>>>(*p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  long long blocks = (p->n_pad + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  zero_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(*p);
  return cudaGetLastError();
}

int mvcc_params_bytes() { return (int)sizeof(ResolveParams); }

int mvcc_max_out() { return MAX_OUT; }

long long mvcc_tile_keys() { return TILE_KEYS; }

const char* mvcc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

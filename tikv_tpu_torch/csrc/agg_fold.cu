// The aggregation fold for Hopper: COUNT, SUM, AVG, MIN, MAX, FIRST and
// the variance moments per slot, in one pass over the feed.
//
// Replaces the XLA kernels of tikv_tpu/device/runner.py
// `_build_hash_scatter_body` (:2701) and `_build_simple_body` (:2668),
// which fold their tiles (tikv_tpu/ops/agg.py `hash_agg_tile` :303,
// `simple_agg_tile` :153) in one dispatch.  Each row finds its slot in
// registers by `hash_slots`' rules (dense: key - base, a NULL key to slot
// `capacity`, a live key out of range to the scrap slot capacity + 1 and
// the overflow flag; sparse: the host's slot ids; simple: slot 0); rows the
// selection drops are skipped.  Per slot and per distinct argument (a
// "lane": one values plane and its validity) it folds the states the plan
// asks for into one int64 buffer (`out`: [0] the overflow flag, then one
// row of `n_slots` cells per state):
//   rows / nonnull   counts (a lane without a validity plane shares rows)
//   isum             the exact int64 sum of an integer lane (wraps as
//                    torch's int64 sum does)
//   fsum, sumsq      float64 sum and sum of squares (bits of a double)
//   min, max         the order-preserving int64 image of the value (the
//                    value for integers; a float's float64 bits with the
//                    sign folded, -0.0 as +0.0)
//   first, firstval  the least valid row position (no GROUP BY: the
//                    registers route) and, by fold_first after the pass,
//                    the value there
//
// Bound: bytes.  The key (or slot ids), the selection and each lane's
// values and validity read once: 8 B/row at config 4m (int32 key and
// value; 0.040 ms for 2^24 rows at 3.35 TB/s), 5 B/row at config 3n.  The
// work per row is a handful of atomics, so the design is about where they
// land:
//   - the shared route (every lane 4 bytes wide, the table fits shared
//     memory): each block folds a chunk of at most CHUNK rows into 32-bit
//     shared cells with native shared atomics -- counts; an integer sum
//     split into its low 16 bits (unsigned) and the rest (signed), which
//     cannot wrap within a chunk; MIN/MAX on the 32-bit order image --
//     and float64 cells for a float lane's sum
//     and every sum of squares (a shared float64 add is a compare-and-swap
//     loop on sm_90).  An integer lane's float64 sum is its exact sum,
//     converted once per chunk.  At the end of its chunk the block adds
//     each touched slot's cells into the buffer with native 64-bit global
//     atomics.
//   - the global route (8-byte lanes, or a table too large for shared
//     memory: up to 2^20 + 2 slots): native 64-bit global atomics on the
//     buffer's cells, per row.
//   - the registers route (no GROUP BY, one slot): each thread folds its
//     rows in 64-bit registers over a grid-stride loop, one pass per lane
//     and four rows in flight; each warp reduces them with shuffles and
//     one lane adds them into the buffer.
// On the shared and global routes a warp whose live rows all fall into one
// slot (a hot group) first reduces them with warp intrinsics and lets one
// lane add the sums.

#include <climits>
#include <cuda_runtime.h>

#define THREADS 256
#define CHUNK (1 << 15)      // rows per block on the shared route
#define UNROLL 4             // rows per thread and step, registers route
#define MAX_LANES 8
#define MAX_ROWS 72          // state rows of the buffer
#define MAX_CELLS 64         // 32-bit shared cells per slot

enum { MODE_SIMPLE = 0, MODE_DENSE = 1, MODE_SPARSE = 2 };
enum { DT_INT32 = 0, DT_INT64 = 1, DT_FLOAT32 = 2, DT_FLOAT64 = 3 };

// one launch: the planes, the lanes, where each state goes.  -1: absent.
struct FoldParams {
  const void* key;              // dense: int32 / int64 keys; sparse: int32
                                // slot ids; simple: null
  const unsigned char* key_ok;  // dense: null = no NULL key
  const unsigned char* mask;    // null = every row
  long long n;
  long long base;
  long long* out;               // 1 + n_rows * n_slots int64
  int mode;
  int key64;
  int capacity;
  int n_slots;
  int n_lanes;
  int n_rows;                   // state rows of the buffer (fold_init)
  int n32;                      // shared route: 32-bit cells per slot
  int n64;                      // shared route: 64-bit cells per slot
  const void* values[MAX_LANES];
  const unsigned char* ok[MAX_LANES];
  int dtype[MAX_LANES];
  // buffer rows
  int o_rows;
  int o_nonnull[MAX_LANES], o_isum[MAX_LANES], o_fsum[MAX_LANES],
      o_sumsq[MAX_LANES], o_min[MAX_LANES], o_max[MAX_LANES],
      o_first[MAX_LANES], o_firstval[MAX_LANES];
  // shared route cells: 32-bit (cell 0 is the row count), then float64
  int c_nonnull[MAX_LANES], c_lo[MAX_LANES], c_hi[MAX_LANES],
      c_min[MAX_LANES], c_max[MAX_LANES], d_fsum[MAX_LANES],
      d_sumsq[MAX_LANES];
  int init32[MAX_CELLS];
  long long init[MAX_ROWS];     // each buffer row's first value
};

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ long long* cell(const FoldParams& p, int row,
                                           int slot) {
  return p.out + 1 + (long long)row * p.n_slots + slot;
}

// the slot of live row i (and whether it raised the overflow flag)
__device__ __forceinline__ int slot_of(const FoldParams& p, long long i,
                                       bool* ovf) {
  if (p.mode == MODE_SIMPLE) return 0;
  if (p.mode == MODE_SPARSE) {
    const int s = static_cast<const int*>(p.key)[i];
    return (unsigned)s < (unsigned)p.n_slots ? s : p.capacity + 1;
  }
  if (p.key_ok != nullptr && !p.key_ok[i]) return p.capacity;
  const long long k = p.key64 ? static_cast<const long long*>(p.key)[i]
                              : static_cast<const int*>(p.key)[i];
  const long long d = static_cast<long long>(
      static_cast<unsigned long long>(k) -
      static_cast<unsigned long long>(p.base));
  if (d >= 0 && d < p.capacity) return static_cast<int>(d);
  *ovf = true;
  return p.capacity + 1;
}

// a float's order-preserving images (-0.0 as +0.0)
__device__ __forceinline__ int f32_image(float x) {
  const int b = __float_as_int(x + 0.0f);
  return b >= 0 ? b : b ^ INT_MAX;
}
__device__ __forceinline__ float f32_of_image(int s) {
  return __int_as_float(s >= 0 ? s : s ^ INT_MAX);
}
__device__ __forceinline__ long long f64_image(double x) {
  const long long b = __double_as_longlong(x + 0.0);
  return b >= 0 ? b : b ^ LLONG_MAX;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}
__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}
__device__ __forceinline__ long long warp_min(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(FULL, x, o);
    x = y < x ? y : x;
  }
  return x;
}
__device__ __forceinline__ long long warp_max(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(FULL, x, o);
    x = y > x ? y : x;
  }
  return x;
}

__device__ __forceinline__ void add_u64(long long* at, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(at),
            static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void add_f64(long long* at, double v) {
  atomicAdd(reinterpret_cast<double*>(at), v);
}

// one lane's value at row i, as (int64 value, float64 value, int64 image)
struct Value {
  long long iv;
  double dv;
  long long img;
};
__device__ __forceinline__ Value load(const FoldParams& p, int j,
                                      long long i) {
  Value v;
  switch (p.dtype[j]) {
    case DT_INT32:
      v.iv = static_cast<const int*>(p.values[j])[i];
      v.dv = (double)v.iv;
      v.img = v.iv;
      break;
    case DT_INT64:
      v.iv = static_cast<const long long*>(p.values[j])[i];
      v.dv = (double)v.iv;
      v.img = v.iv;
      break;
    case DT_FLOAT32:
      v.dv = static_cast<const float*>(p.values[j])[i];
      v.iv = 0;
      v.img = f64_image(v.dv);
      break;
    default:
      v.dv = static_cast<const double*>(p.values[j])[i];
      v.iv = 0;
      v.img = f64_image(v.dv);
  }
  return v;
}

// ----------------------------------------------------------- shared route

__global__ void __launch_bounds__(THREADS) fold_shared(const FoldParams p) {
  extern __shared__ double smem[];
  const int S = p.n_slots;
  double* d64 = smem;
  unsigned* c32 = reinterpret_cast<unsigned*>(smem + (long long)p.n64 * S);
  for (int i = threadIdx.x; i < p.n64 * S; i += THREADS) d64[i] = 0.0;
  for (int i = threadIdx.x; i < p.n32 * S; i += THREADS)
    c32[i] = (unsigned)p.init32[i / S];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long r_begin = (long long)blockIdx.x * CHUNK;
  const long long r_end = p.n - r_begin < CHUNK ? p.n : r_begin + CHUNK;
  bool ovf = false;
  for (long long w0 = r_begin + (threadIdx.x & ~31); w0 < r_end;
       w0 += THREADS) {
    const long long i = w0 + lane;
    const bool live = i < r_end && (p.mask == nullptr || p.mask[i]);
    const int slot = live ? slot_of(p, i, &ovf) : -1;
    const unsigned lv = __ballot_sync(FULL, live);
    if (lv == 0) continue;
    const int leader = __ffs(lv) - 1;
    const int s0 = __shfl_sync(FULL, slot, leader);
    const bool uniform = __all_sync(FULL, !live || slot == s0);
    const bool lead = lane == leader;
    if (uniform) {
      if (lead) atomicAdd(&c32[s0], (unsigned)__popc(lv));
    } else if (live) {
      atomicAdd(&c32[slot], 1u);
    }
    for (int j = 0; j < p.n_lanes; ++j) {
      // the value's load waits on no other load
      const unsigned loaded =
          i < r_end ? static_cast<const unsigned*>(p.values[j])[i] : 0u;
      const bool v_ok = live && (p.ok[j] == nullptr || p.ok[j][i]);
      const unsigned raw = v_ok ? loaded : 0u;
      const bool is_f = p.dtype[j] == DT_FLOAT32;
      const int img = is_f ? f32_image(__uint_as_float(raw)) : (int)raw;
      const double x = is_f ? (double)__uint_as_float(raw) : (double)(int)raw;
      if (uniform) {
        const unsigned nn = __popc(__ballot_sync(FULL, v_ok));
        if (nn == 0) continue;
        unsigned lo = 0;
        int hi = 0, mn = INT_MAX, mx = INT_MIN;
        double fs = 0.0, sq = 0.0;
        if (p.c_lo[j] >= 0) {
          lo = __reduce_add_sync(FULL, raw & 0xffffu);
          hi = __reduce_add_sync(FULL, v_ok ? (int)raw >> 16 : 0);
        }
        if (p.c_min[j] >= 0) mn = __reduce_min_sync(FULL, v_ok ? img : INT_MAX);
        if (p.c_max[j] >= 0) mx = __reduce_max_sync(FULL, v_ok ? img : INT_MIN);
        if (p.d_fsum[j] >= 0) fs = warp_sum(v_ok ? x : 0.0);
        if (p.d_sumsq[j] >= 0) sq = warp_sum(v_ok ? x * x : 0.0);
        if (!lead) continue;
        if (p.c_nonnull[j] >= 0) atomicAdd(&c32[p.c_nonnull[j] * S + s0], nn);
        if (p.c_lo[j] >= 0) {
          atomicAdd(&c32[p.c_lo[j] * S + s0], lo);
          atomicAdd(reinterpret_cast<int*>(&c32[p.c_hi[j] * S + s0]), hi);
        }
        if (p.c_min[j] >= 0)
          atomicMin(reinterpret_cast<int*>(&c32[p.c_min[j] * S + s0]), mn);
        if (p.c_max[j] >= 0)
          atomicMax(reinterpret_cast<int*>(&c32[p.c_max[j] * S + s0]), mx);
        if (p.d_fsum[j] >= 0) atomicAdd(&d64[p.d_fsum[j] * S + s0], fs);
        if (p.d_sumsq[j] >= 0) atomicAdd(&d64[p.d_sumsq[j] * S + s0], sq);
      } else if (v_ok) {
        if (p.c_nonnull[j] >= 0) atomicAdd(&c32[p.c_nonnull[j] * S + slot], 1u);
        if (p.c_lo[j] >= 0) {
          atomicAdd(&c32[p.c_lo[j] * S + slot], raw & 0xffffu);
          atomicAdd(reinterpret_cast<int*>(&c32[p.c_hi[j] * S + slot]),
                    (int)raw >> 16);
        }
        if (p.c_min[j] >= 0)
          atomicMin(reinterpret_cast<int*>(&c32[p.c_min[j] * S + slot]), img);
        if (p.c_max[j] >= 0)
          atomicMax(reinterpret_cast<int*>(&c32[p.c_max[j] * S + slot]), img);
        if (p.d_fsum[j] >= 0) atomicAdd(&d64[p.d_fsum[j] * S + slot], x);
        if (p.d_sumsq[j] >= 0) atomicAdd(&d64[p.d_sumsq[j] * S + slot], x * x);
      }
    }
  }
  if (ovf) p.out[0] = 1;
  __syncthreads();

  // the chunk's cells into the buffer, for every slot a row reached
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const unsigned rows = c32[s];
    if (rows == 0) continue;
    if (p.o_rows >= 0) add_u64(cell(p, p.o_rows, s), rows);
    for (int j = 0; j < p.n_lanes; ++j) {
      const bool is_f = p.dtype[j] == DT_FLOAT32;
      if (p.c_nonnull[j] >= 0 && p.o_nonnull[j] >= 0)
        add_u64(cell(p, p.o_nonnull[j], s), c32[p.c_nonnull[j] * S + s]);
      if (p.c_lo[j] >= 0) {
        const long long exact =
            (static_cast<long long>((int)c32[p.c_hi[j] * S + s]) << 16) +
            (long long)c32[p.c_lo[j] * S + s];
        if (p.o_isum[j] >= 0) add_u64(cell(p, p.o_isum[j], s), exact);
        if (p.o_fsum[j] >= 0) add_f64(cell(p, p.o_fsum[j], s), (double)exact);
      }
      if (p.d_fsum[j] >= 0)
        add_f64(cell(p, p.o_fsum[j], s), d64[p.d_fsum[j] * S + s]);
      if (p.d_sumsq[j] >= 0)
        add_f64(cell(p, p.o_sumsq[j], s), d64[p.d_sumsq[j] * S + s]);
      if (p.c_min[j] >= 0) {
        const int m = (int)c32[p.c_min[j] * S + s];
        if (m != INT_MAX)
          atomicMin(cell(p, p.o_min[j], s),
                    is_f ? f64_image((double)f32_of_image(m)) : (long long)m);
      }
      if (p.c_max[j] >= 0) {
        const int m = (int)c32[p.c_max[j] * S + s];
        if (m != INT_MIN)
          atomicMax(cell(p, p.o_max[j], s),
                    is_f ? f64_image((double)f32_of_image(m)) : (long long)m);
      }
    }
  }
}

// ----------------------------------------------------------- global route

__global__ void __launch_bounds__(THREADS) fold_global(const FoldParams p) {
  const int lane = threadIdx.x & 31;
  bool ovf = false;
  const long long step = (long long)gridDim.x * THREADS;
  for (long long w0 = (long long)blockIdx.x * THREADS + (threadIdx.x & ~31);
       w0 < p.n; w0 += step) {
    const long long i = w0 + lane;
    const bool live = i < p.n && (p.mask == nullptr || p.mask[i]);
    const int slot = live ? slot_of(p, i, &ovf) : -1;
    const unsigned lv = __ballot_sync(FULL, live);
    if (lv == 0) continue;
    const int leader = __ffs(lv) - 1;
    const int s0 = __shfl_sync(FULL, slot, leader);
    const bool uniform = __all_sync(FULL, !live || slot == s0);
    const bool lead = lane == leader;
    if (p.o_rows >= 0) {
      if (uniform) {
        if (lead) add_u64(cell(p, p.o_rows, s0), __popc(lv));
      } else if (live) {
        add_u64(cell(p, p.o_rows, slot), 1);
      }
    }
    for (int j = 0; j < p.n_lanes; ++j) {
      const bool v_ok = live && (p.ok[j] == nullptr || p.ok[j][i]);
      Value v{0, 0.0, 0};
      if (v_ok) v = load(p, j, i);
      if (uniform) {
        const unsigned nn = __popc(__ballot_sync(FULL, v_ok));
        if (nn == 0) continue;
        long long is = 0, mn = LLONG_MAX, mx = LLONG_MIN;
        double fs = 0.0, sq = 0.0;
        if (p.o_isum[j] >= 0) is = warp_sum(v.iv);
        if (p.o_fsum[j] >= 0) fs = warp_sum(v.dv);
        if (p.o_sumsq[j] >= 0) sq = warp_sum(v.dv * v.dv);
        if (p.o_min[j] >= 0) mn = warp_min(v_ok ? v.img : LLONG_MAX);
        if (p.o_max[j] >= 0) mx = warp_max(v_ok ? v.img : LLONG_MIN);
        if (!lead) continue;
        if (p.o_nonnull[j] >= 0) add_u64(cell(p, p.o_nonnull[j], s0), nn);
        if (p.o_isum[j] >= 0) add_u64(cell(p, p.o_isum[j], s0), is);
        if (p.o_fsum[j] >= 0) add_f64(cell(p, p.o_fsum[j], s0), fs);
        if (p.o_sumsq[j] >= 0) add_f64(cell(p, p.o_sumsq[j], s0), sq);
        if (p.o_min[j] >= 0) atomicMin(cell(p, p.o_min[j], s0), mn);
        if (p.o_max[j] >= 0) atomicMax(cell(p, p.o_max[j], s0), mx);
      } else if (v_ok) {
        if (p.o_nonnull[j] >= 0) add_u64(cell(p, p.o_nonnull[j], slot), 1);
        if (p.o_isum[j] >= 0) add_u64(cell(p, p.o_isum[j], slot), v.iv);
        if (p.o_fsum[j] >= 0) add_f64(cell(p, p.o_fsum[j], slot), v.dv);
        if (p.o_sumsq[j] >= 0)
          add_f64(cell(p, p.o_sumsq[j], slot), v.dv * v.dv);
        if (p.o_min[j] >= 0) atomicMin(cell(p, p.o_min[j], slot), v.img);
        if (p.o_max[j] >= 0) atomicMax(cell(p, p.o_max[j], slot), v.img);
      }
    }
  }
  if (ovf) p.out[0] = 1;
}

// --------------------------------------------------------- registers route

// no GROUP BY: every live row is slot 0, so each thread folds its rows in
// 64-bit registers (nothing to split), and each warp adds its reduced
// states once.  One pass per lane keeps a thread's accumulators few (and
// its occupancy high); the first pass also counts the rows.
__global__ void __launch_bounds__(THREADS, 4)
    fold_simple(const FoldParams p) {
  const bool lead = (threadIdx.x & 31) == 0;
  const long long step = (long long)gridDim.x * THREADS;
  const int passes = p.n_lanes > 0 ? p.n_lanes : 1;
  for (int j = 0; j < passes; ++j) {
    const bool has_lane = j < p.n_lanes;
    const unsigned char* ok = has_lane ? p.ok[j] : nullptr;
    unsigned long long rows = 0, nn = 0;
    long long is = 0, mn = LLONG_MAX, mx = LLONG_MIN, first = LLONG_MAX;
    double fs = 0.0, sq = 0.0;
    // UNROLL rows a thread per step, their loads issued together
    for (long long i0 = (long long)blockIdx.x * THREADS + threadIdx.x;
         i0 < p.n; i0 += step * UNROLL) {
      bool v_ok[UNROLL];
      Value v[UNROLL];
      // the selection, validity and value loads depend on nothing read,
      // so all of them are in flight at once
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = i0 + u * step;
        const bool in = i < p.n;
        const bool live = in && (p.mask == nullptr || p.mask[i]);
        const bool valid = in && (ok == nullptr || ok[i]);
        v[u] = in && has_lane ? load(p, j, i) : Value{0, 0.0, 0};
        rows += live;
        v_ok[u] = has_lane && live && valid;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!v_ok[u]) continue;
        ++nn;
        is += v[u].iv;
        fs += v[u].dv;
        sq += v[u].dv * v[u].dv;
        mn = v[u].img < mn ? v[u].img : mn;
        mx = v[u].img > mx ? v[u].img : mx;
        const long long i = i0 + u * step;
        first = i < first ? i : first;
      }
    }
    if (j == 0 && p.o_rows >= 0) {
      const long long total = warp_sum(static_cast<long long>(rows));
      if (lead && total) add_u64(cell(p, p.o_rows, 0), total);
    }
    if (!has_lane) break;
    const long long c = warp_sum(static_cast<long long>(nn));
    if (c == 0) continue;
    if (p.o_nonnull[j] >= 0 && lead) add_u64(cell(p, p.o_nonnull[j], 0), c);
    if (p.o_isum[j] >= 0) {
      const long long t = warp_sum(is);
      if (lead) add_u64(cell(p, p.o_isum[j], 0), t);
    }
    if (p.o_fsum[j] >= 0) {
      const double t = warp_sum(fs);
      if (lead) add_f64(cell(p, p.o_fsum[j], 0), t);
    }
    if (p.o_sumsq[j] >= 0) {
      const double t = warp_sum(sq);
      if (lead) add_f64(cell(p, p.o_sumsq[j], 0), t);
    }
    if (p.o_min[j] >= 0) {
      const long long t = warp_min(mn);
      if (lead) atomicMin(cell(p, p.o_min[j], 0), t);
    }
    if (p.o_max[j] >= 0) {
      const long long t = warp_max(mx);
      if (lead) atomicMax(cell(p, p.o_max[j], 0), t);
    }
    if (p.o_first[j] >= 0) {
      const long long t = warp_min(first);
      if (lead) atomicMin(cell(p, p.o_first[j], 0), t);
    }
  }
}

// ------------------------------------------------------------- bookends

// the overflow flag 0, every state row its first value
__global__ void fold_init(const FoldParams p) {
  const long long words = 1 + (long long)p.n_rows * p.n_slots;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < words; w += (long long)gridDim.x * blockDim.x)
    p.out[w] = w == 0 ? 0 : p.init[(w - 1) / p.n_slots];
}

// FIRST's value: the lane's value at its first position (at row n - 1
// when there is none, as the plain version indexes), int64 for integers,
// float64 bits for floats
__global__ void fold_first(const FoldParams p) {
  const int j = threadIdx.x;
  if (j >= p.n_lanes || p.o_first[j] < 0 || p.n < 1) return;
  long long at = *cell(p, p.o_first[j], 0);
  at = at < p.n - 1 ? at : p.n - 1;
  const Value v = load(p, j, at);
  *cell(p, p.o_firstval[j], 0) =
      p.dtype[j] <= DT_INT64 ? v.iv : __double_as_longlong(v.dv);
}

}  // namespace

extern "C" {

// Fold rows [0, n) with one FoldParams per group of at most MAX_LANES
// lanes (`groups[0]` carries the init values and the row count), on
// `route` 0 (shared), 1 (global) or 2 (registers: no GROUP BY); `smem`:
// the shared route's dynamic
// bytes (`n_slots` * (8 * n64 + 4 * n32) of the largest group).
// Asynchronous on `stream`.  Returns the first failing call's error;
// *launched counts kernel launches.
int agg_fold_launch(int device, const FoldParams* groups, int n_groups,
                    int route, int smem, void* stream, int* launched) {
  *launched = 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int sms = 0, per_sm = 0, per_sm_simple = 0, optin_set = -1;
  if (sms == 0) {
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fold_global, THREADS, 0)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm_simple, fold_simple, THREADS, 0)) != cudaSuccess)
      return e;
  }
  if (optin_set != device) {
    int optin = 0;
    if ((e = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
        cudaSuccess)
      return e;
    if ((e = cudaFuncSetAttribute(fold_shared,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin)) != cudaSuccess)
      return e;
    optin_set = device;
  }
  const FoldParams& g0 = groups[0];
  const long long words = 1 + (long long)g0.n_rows * g0.n_slots;
  const long long ib = (words + THREADS - 1) / THREADS;
  fold_init<<<(unsigned)(ib < 4096 ? ib : 4096), THREADS, 0, s>>>(g0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  if (g0.n > 0) {
    for (int g = 0; g < n_groups; ++g) {
      if (route == 0) {
        const long long grid = (g0.n + CHUNK - 1) / CHUNK;
        fold_shared<<<(unsigned)grid, THREADS, (size_t)smem, s>>>(groups[g]);
      } else {
        const int fit = route == 1 ? per_sm : per_sm_simple;
        const long long want = (g0.n + THREADS - 1) / THREADS;
        const long long most = (long long)sms * (fit > 0 ? fit : 1);
        const unsigned grid = (unsigned)(want < most ? want : most);
        if (route == 1)
          fold_global<<<grid, THREADS, 0, s>>>(groups[g]);
        else
          fold_simple<<<grid, THREADS, 0, s>>>(groups[g]);
      }
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      ++*launched;
    }
    for (int g = 0; g < n_groups; ++g) {
      bool any = false;
      for (int j = 0; j < groups[g].n_lanes; ++j)
        any = any || groups[g].o_first[j] >= 0;
      if (!any) continue;
      fold_first<<<1, 32, 0, s>>>(groups[g]);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      ++*launched;
    }
  }
  return cudaSuccess;
}

// Largest dynamic shared memory one block may opt into on `device`.
int agg_fold_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

const char* agg_fold_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

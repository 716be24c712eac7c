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
//   first, firstval, firstok  the first selected row position, NULL or
//                    not (no GROUP BY: the registers route), the value
//                    there and its validity (a NULL first row makes
//                    FIRST NULL, as TiKV's AggrFnFirst)
//
// Bound: bytes.  The key (or slot ids), the selection and each lane's
// values and validity read once: 8 B/row at config 4m (int32 key and
// value; 0.040 ms for 2^24 rows at 3.35 TB/s), 5 B/row at config 3n.
//
// Design.  Every plane is read in groups of 4 rows: one 16-byte load of a
// 4-byte plane (two of an 8-byte one), one 4-byte load of a bool plane;
// a thread loads all of its groups of a tile (the key, the selection, the
// values and their validity) before it adds any, so 8 or more rows a
// thread are in flight.  Where a plane is off its boundary at row 0, every
// row is read with scalar loads (`vec` 0).
//   - the shared route (every lane 4 bytes wide, the table fits shared
//     memory): a persistent grid (SMs x resident blocks); each block walks
//     many tiles and adds each row into 32-bit shared cells with native
//     shared atomics (ATOMS.ADD / MIN / MAX): the row and non-NULL counts;
//     an integer sum as one signed cell when the lane's value bound keeps
//     it inside int32 over a fold interval, else as its low 16 bits and
//     the rest; an integer sum of squares as 16-bit limbs of v^2 (1, 2 or
//     4 cells by the value bound; no limb wraps within the interval); MIN
//     and MAX on the 32-bit order image, with an atomic only where the
//     value beats the cell as read.  Every `fold_every` tiles the
//     block folds those cells, without atomics, into 64-bit twins in
//     shared memory (each thread owns a stripe of slots), and it adds the
//     twins into the buffer once, at its end.  Only a REAL lane keeps a
//     float64 shared add (a compare-and-swap loop on sm_90).
//   - the global route (8-byte lanes, or a table too large for shared
//     memory: up to 2^20 + 2 slots): native 64-bit global atomics on the
//     buffer's cells, per row.
//   - the registers route (no GROUP BY, one slot): each thread folds its
//     rows in registers over the tiles, one pass per lane and four groups
//     in flight: a 4-byte lane's MIN/MAX on 32-bit images, an integer
//     lane's exact sum (its float sum is that sum) and, for int32, its sum
//     of squares in a 128-bit (two uint64) accumulator; FIRST is the first
//     selected row a thread meets, since it visits its rows in ascending
//     order.  Each warp reduces with shuffles and one lane adds into the
//     buffer; the last block to finish (one atomic ticket) reads FIRST's
//     value, so the fold is one launch after `fold_init`.
// On the shared and global routes a warp whose live rows all fall into one
// slot (a hot group) first reduces them with warp intrinsics and lets one
// lane add the sums.

#include <climits>
#include <type_traits>

#include <cuda_runtime.h>

#define THREADS 256
#define UNROLL_S 2           // 4-row groups a thread loads a tile, shared
#define UNROLL_R 4           // the same, registers route
#define TILE_S (THREADS * 4 * UNROLL_S)
#define TILE_R (THREADS * 4 * UNROLL_R)
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
  unsigned long long* ticket;   // registers route: blocks finished (0)
  int mode;
  int key64;
  int capacity;
  int n_slots;
  int n_lanes;
  int n_rows;                   // state rows of the buffer (fold_init)
  int vec;                      // 1: 4-row loads (every plane aligned)
  int n32;                      // shared route: 32-bit cells per slot
  int n_wide;                   // ... of which [0, n_wide) have twins
  int n64;                      // shared route: float64 cells per slot
  int fold_every;               // shared route: tiles between folds
  unsigned long long signed_cells;  // bit c: 32-bit cell c is signed
  const void* values[MAX_LANES];
  const unsigned char* ok[MAX_LANES];
  int dtype[MAX_LANES];
  // buffer rows
  int o_rows;
  int o_nonnull[MAX_LANES], o_isum[MAX_LANES], o_fsum[MAX_LANES],
      o_sumsq[MAX_LANES], o_min[MAX_LANES], o_max[MAX_LANES],
      o_first[MAX_LANES], o_firstval[MAX_LANES], o_firstok[MAX_LANES];
  // shared route cells: 32-bit (cell 0 is the row count; the sum's n_sum
  // cells and the square's n_sq limbs from c_sum / c_sq), then float64
  int c_nonnull[MAX_LANES], c_sum[MAX_LANES], n_sum[MAX_LANES],
      c_sq[MAX_LANES], n_sq[MAX_LANES], c_min[MAX_LANES], c_max[MAX_LANES],
      d_fsum[MAX_LANES], d_sumsq[MAX_LANES];
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
// a 4-byte lane's 32-bit MIN/MAX image as the buffer's int64 image
__device__ __forceinline__ long long wide_image(int m, bool is_float) {
  return is_float ? f64_image((double)f32_of_image(m)) : (long long)m;
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

// the uint64 pair (hi, lo) as a double
__device__ __forceinline__ double u128_to_double(unsigned long long hi,
                                                 unsigned long long lo) {
  return (double)hi * 18446744073709551616.0 + (double)lo;
}

// ------------------------------------------------------------ 4-row loads

// bit r set where bool byte i + r is true (rows at or past `end`: 0)
__device__ __forceinline__ unsigned bits4(const unsigned char* p, long long i,
                                          bool full, long long end) {
  unsigned b = 0;
  if (full) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p + i));
#pragma unroll
    for (int r = 0; r < 4; ++r) b |= ((w >> (8 * r)) & 0xFFu) ? 1u << r : 0u;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      b |= (i + r < end && __ldg(p + i + r)) ? 1u << r : 0u;
  }
  return b;
}

// the live rows of the group at i: in range and selected
__device__ __forceinline__ unsigned live4(const FoldParams& p, long long i,
                                          bool full) {
  const long long left = p.n - i;
  unsigned live = left >= 4 ? 0xFu : left > 0 ? (1u << left) - 1u : 0u;
  if (p.mask != nullptr) live &= bits4(p.mask, i, full, p.n);
  return live;
}

__device__ __forceinline__ void load4_32(const void* p, long long i,
                                         bool full, long long end,
                                         unsigned v[4]) {
  const unsigned* q = static_cast<const unsigned*>(p);
  if (full) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(q + i));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = i + r < end ? __ldg(q + i + r) : 0u;
  }
}

__device__ __forceinline__ void load4_64(const void* p, long long i,
                                         bool full, long long end,
                                         unsigned long long v[4]) {
  const unsigned long long* q = static_cast<const unsigned long long*>(p);
  if (full) {
    const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(q + i));
    const ulonglong2 b =
        __ldg(reinterpret_cast<const ulonglong2*>(q + i) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = i + r < end ? __ldg(q + i + r) : 0ull;
  }
}

// ----------------------------------------------------------- shared route

// four rows' inputs: the live rows (with a slot), their slots, per lane
// its 32-bit values and valid rows
template <int NL>
struct Group {
  unsigned live;
  int slot[4];
  unsigned v[NL][4];
  unsigned ok[NL];
};

template <int NL>
__device__ __forceinline__ void load_group(const FoldParams& p, long long i,
                                           bool full, Group<NL>& g,
                                           bool* ovf) {
  unsigned live = live4(p, i, full);
  if (p.mode == MODE_SPARSE) {
    unsigned k[4];
    load4_32(p.key, i, full, p.n, k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      g.slot[r] = k[r] < (unsigned)p.n_slots ? (int)k[r] : p.capacity + 1;
  } else {
    long long k[4];
    if (p.key64) {
      unsigned long long w[4];
      load4_64(p.key, i, full, p.n, w);
#pragma unroll
      for (int r = 0; r < 4; ++r) k[r] = (long long)w[r];
    } else {
      unsigned w[4];
      load4_32(p.key, i, full, p.n, w);
#pragma unroll
      for (int r = 0; r < 4; ++r) k[r] = (int)w[r];
    }
    const unsigned kok =
        p.key_ok != nullptr ? bits4(p.key_ok, i, full, p.n) : 0xFu;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long d = static_cast<long long>(
          static_cast<unsigned long long>(k[r]) -
          static_cast<unsigned long long>(p.base));
      if (!((kok >> r) & 1u)) {
        g.slot[r] = p.capacity;
      } else if (d >= 0 && d < p.capacity) {
        g.slot[r] = (int)d;
      } else {
        g.slot[r] = p.capacity + 1;
        if ((live >> r) & 1u) *ovf = true;
      }
    }
  }
  g.live = live;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (l >= p.n_lanes) break;
    load4_32(p.values[l], i, full, p.n, g.v[l]);
    g.ok[l] = p.ok[l] != nullptr ? live & bits4(p.ok[l], i, full, p.n) : live;
  }
}

// the n-th 16-bit limb of v^2 out of `limbs` (the last takes the rest)
__device__ __forceinline__ unsigned limb(unsigned long long sq, int k,
                                         int limbs) {
  const unsigned long long x = sq >> (16 * k);
  return k == limbs - 1 ? (unsigned)x : (unsigned)(x & 0xffffu);
}

// one row's adds into slot s (every lane's valid row)
template <int NL, bool REAL>
__device__ __forceinline__ void add_row(const FoldParams& p, unsigned* c32,
                                        double* d64, const Group<NL>& g,
                                        int r) {
  const int S = p.n_slots;
  const int s = g.slot[r];
  atomicAdd(&c32[s], 1u);
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (l >= p.n_lanes) break;
    if (!((g.ok[l] >> r) & 1u)) continue;
    const unsigned raw = g.v[l][r];
    const bool is_f = p.dtype[l] == DT_FLOAT32;
    if (p.c_nonnull[l] >= 0) atomicAdd(&c32[p.c_nonnull[l] * S + s], 1u);
    if (p.n_sum[l] == 1) {
      if (raw != 0) atomicAdd(&c32[p.c_sum[l] * S + s], raw);
    } else if (p.n_sum[l] == 2) {
      if (raw & 0xffffu) atomicAdd(&c32[p.c_sum[l] * S + s], raw & 0xffffu);
      if ((int)raw >> 16)
        atomicAdd(&c32[(p.c_sum[l] + 1) * S + s],
                  (unsigned)((int)raw >> 16));
    }
    if (p.n_sq[l] > 0) {
      const long long x = (int)raw;
      const unsigned long long sq = (unsigned long long)(x * x);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k >= p.n_sq[l]) break;
        const unsigned m = limb(sq, k, p.n_sq[l]);
        if (m) atomicAdd(&c32[(p.c_sq[l] + k) * S + s], m);
      }
    }
    // MIN/MAX: an atomic only where the value beats the cell as read (a
    // cell only moves one way, so a value that does not beat an earlier
    // reading cannot beat the final one)
    const int img = is_f ? f32_image(__uint_as_float(raw)) : (int)raw;
    if (p.c_min[l] >= 0) {
      int* at = reinterpret_cast<int*>(&c32[p.c_min[l] * S + s]);
      if (img < *reinterpret_cast<volatile int*>(at)) atomicMin(at, img);
    }
    if (p.c_max[l] >= 0) {
      int* at = reinterpret_cast<int*>(&c32[p.c_max[l] * S + s]);
      if (img > *reinterpret_cast<volatile int*>(at)) atomicMax(at, img);
    }
    if (REAL && (p.d_fsum[l] >= 0 || p.d_sumsq[l] >= 0)) {
      const double f = (double)__uint_as_float(raw);
      if (p.d_fsum[l] >= 0) atomicAdd(&d64[p.d_fsum[l] * S + s], f);
      if (p.d_sumsq[l] >= 0) atomicAdd(&d64[p.d_sumsq[l] * S + s], f * f);
    }
  }
}

// a warp whose live rows all fall into slot s: its sums reduced first,
// one lane adds them
template <int NL, bool REAL>
__device__ __forceinline__ void add_uniform(const FoldParams& p,
                                            unsigned* c32, double* d64,
                                            const Group<NL>& g, int s,
                                            bool lead) {
  const int S = p.n_slots;
  const unsigned rows = __reduce_add_sync(FULL, __popc(g.live));
  if (lead) atomicAdd(&c32[s], rows);
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (l >= p.n_lanes) break;
    const unsigned okb = g.ok[l];
    const unsigned nn = __reduce_add_sync(FULL, __popc(okb));
    if (nn == 0) continue;
    const bool is_f = p.dtype[l] == DT_FLOAT32;
    unsigned part[2] = {0u, 0u};
    unsigned sq[4] = {0u, 0u, 0u, 0u};
    int mn = INT_MAX, mx = INT_MIN;
    double fs = 0.0, fq = 0.0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!((okb >> r) & 1u)) continue;
      const unsigned raw = g.v[l][r];
      if (p.n_sum[l] == 1) {
        part[0] += raw;
      } else {
        part[0] += raw & 0xffffu;
        part[1] += (unsigned)((int)raw >> 16);
      }
      if (p.n_sq[l] > 0) {
        const long long x = (int)raw;
        const unsigned long long q = (unsigned long long)(x * x);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < p.n_sq[l]) sq[k] += limb(q, k, p.n_sq[l]);
      }
      const int img = is_f ? f32_image(__uint_as_float(raw)) : (int)raw;
      mn = img < mn ? img : mn;
      mx = img > mx ? img : mx;
      const double f = (double)__uint_as_float(raw);
      fs += f;
      fq += f * f;
    }
    if (p.c_nonnull[l] >= 0 && lead)
      atomicAdd(&c32[p.c_nonnull[l] * S + s], nn);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c >= p.n_sum[l]) break;
      const unsigned t = __reduce_add_sync(FULL, part[c]);
      if (lead && t) atomicAdd(&c32[(p.c_sum[l] + c) * S + s], t);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= p.n_sq[l]) break;
      const unsigned t = __reduce_add_sync(FULL, sq[k]);
      if (lead && t) atomicAdd(&c32[(p.c_sq[l] + k) * S + s], t);
    }
    if (p.c_min[l] >= 0) {
      const int t = __reduce_min_sync(FULL, mn);
      if (lead) atomicMin(reinterpret_cast<int*>(&c32[p.c_min[l] * S + s]), t);
    }
    if (p.c_max[l] >= 0) {
      const int t = __reduce_max_sync(FULL, mx);
      if (lead) atomicMax(reinterpret_cast<int*>(&c32[p.c_max[l] * S + s]), t);
    }
    if (REAL && p.d_fsum[l] >= 0) {
      const double t = warp_sum(fs);
      if (lead) atomicAdd(&d64[p.d_fsum[l] * S + s], t);
    }
    if (REAL && p.d_sumsq[l] >= 0) {
      const double t = warp_sum(fq);
      if (lead) atomicAdd(&d64[p.d_sumsq[l] * S + s], t);
    }
  }
}

template <int NL, bool REAL>
__device__ __forceinline__ void add_group(const FoldParams& p, unsigned* c32,
                                          double* d64, const Group<NL>& g) {
  const unsigned any = __ballot_sync(FULL, g.live != 0);
  if (any == 0) return;
  const int leader = __ffs(any) - 1;
  int mine = 0;                 // the slot of this thread's first live row
#pragma unroll
  for (int r = 3; r >= 0; --r)
    if ((g.live >> r) & 1u) mine = g.slot[r];
  const int s0 = __shfl_sync(FULL, mine, leader);
  bool same = true;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    same = same && (!((g.live >> r) & 1u) || g.slot[r] == s0);
  if (__all_sync(FULL, same)) {
    add_uniform<NL, REAL>(p, c32, d64, g, s0,
                          (int)(threadIdx.x & 31) == leader);
    return;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if ((g.live >> r) & 1u) add_row<NL, REAL>(p, c32, d64, g, r);
}

// Each thread moves the 32-bit cells of the slots it owns into their
// 64-bit twins (signed cells sign-extended) and zeroes them.
__device__ __forceinline__ void fold_cells(const FoldParams& p,
                                           unsigned long long* wide,
                                           unsigned* c32) {
  const int S = p.n_slots;
  for (int c = 0; c < p.n_wide; ++c) {
    const bool sgn = (p.signed_cells >> c) & 1ull;
    for (int s = threadIdx.x; s < S; s += THREADS) {
      const unsigned x = c32[c * S + s];
      if (x == 0) continue;
      c32[c * S + s] = 0u;
      wide[c * S + s] += sgn ? (unsigned long long)(long long)(int)x
                             : (unsigned long long)x;
    }
  }
}

// a slot's integer sum of squares from its limbs' twins: exact in 128
// bits, then one rounding to float64
__device__ __forceinline__ double limbs_to_double(
    const unsigned long long* wide, int c0, int limbs, int S, int s) {
  unsigned long long hi = 0, lo = 0;
  for (int k = 0; k < limbs; ++k) {
    const unsigned long long t = wide[(c0 + k) * S + s];
    const int sh = 16 * k;
    const unsigned long long add_lo = sh ? t << sh : t;
    const unsigned long long add_hi = sh ? t >> (64 - sh) : 0ull;
    lo += add_lo;
    hi += add_hi + (lo < add_lo ? 1ull : 0ull);
  }
  return u128_to_double(hi, lo);
}

// REAL: some lane is float32, so the float64 shared cells exist (an
// all-integer launch compiles without a float64 shared atomic)
template <int NL, bool REAL>
__global__ void __launch_bounds__(THREADS)
    fold_shared(const __grid_constant__ FoldParams p) {
  extern __shared__ unsigned long long smem[];
  const int S = p.n_slots;
  unsigned long long* wide = smem;
  double* d64 = reinterpret_cast<double*>(smem + (long long)p.n_wide * S);
  unsigned* c32 = reinterpret_cast<unsigned*>(d64 + (long long)p.n64 * S);
  for (int i = threadIdx.x; i < p.n_wide * S; i += THREADS) wide[i] = 0ull;
  for (int i = threadIdx.x; i < p.n64 * S; i += THREADS) d64[i] = 0.0;
  for (int i = threadIdx.x; i < p.n32 * S; i += THREADS)
    c32[i] = (unsigned)p.init32[i / S];
  __syncthreads();

  bool ovf = false;
  int since = 0;
  const long long tiles = (p.n + TILE_S - 1) / TILE_S;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    Group<NL> g[UNROLL_S];
    // every plane's loads of the tile are issued before any add
#pragma unroll
    for (int u = 0; u < UNROLL_S; ++u) {
      const long long i = t * TILE_S + 4LL * (u * THREADS + threadIdx.x);
      load_group<NL>(p, i, p.vec && i + 4 <= p.n, g[u], &ovf);
    }
#pragma unroll
    for (int u = 0; u < UNROLL_S; ++u) add_group<NL, REAL>(p, c32, d64, g[u]);
    if (++since == p.fold_every) {
      since = 0;
      __syncthreads();
      fold_cells(p, wide, c32);
      __syncthreads();
    }
  }
  if (ovf) p.out[0] = 1;
  __syncthreads();
  fold_cells(p, wide, c32);   // each thread its own slots: no barrier after

  // the twins into the buffer, for every slot a row reached
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const unsigned long long rows = wide[s];
    if (rows == 0) continue;
    if (p.o_rows >= 0) add_u64(cell(p, p.o_rows, s), (long long)rows);
    for (int j = 0; j < p.n_lanes; ++j) {
      const bool is_f = p.dtype[j] == DT_FLOAT32;
      if (p.c_nonnull[j] >= 0 && p.o_nonnull[j] >= 0)
        add_u64(cell(p, p.o_nonnull[j], s),
                (long long)wide[p.c_nonnull[j] * S + s]);
      if (p.n_sum[j] > 0) {
        unsigned long long exact = wide[p.c_sum[j] * S + s];
        if (p.n_sum[j] == 2) exact += wide[(p.c_sum[j] + 1) * S + s] << 16;
        if (p.o_isum[j] >= 0)
          add_u64(cell(p, p.o_isum[j], s), (long long)exact);
        if (p.o_fsum[j] >= 0)
          add_f64(cell(p, p.o_fsum[j], s), (double)(long long)exact);
      }
      if (p.n_sq[j] > 0)
        add_f64(cell(p, p.o_sumsq[j], s),
                limbs_to_double(wide, p.c_sq[j], p.n_sq[j], S, s));
      if (REAL && p.d_fsum[j] >= 0)
        add_f64(cell(p, p.o_fsum[j], s), d64[p.d_fsum[j] * S + s]);
      if (REAL && p.d_sumsq[j] >= 0)
        add_f64(cell(p, p.o_sumsq[j], s), d64[p.d_sumsq[j] * S + s]);
      if (p.c_min[j] >= 0) {
        const int m = (int)c32[p.c_min[j] * S + s];
        if (m != INT_MAX)
          atomicMin(cell(p, p.o_min[j], s), wide_image(m, is_f));
      }
      if (p.c_max[j] >= 0) {
        const int m = (int)c32[p.c_max[j] * S + s];
        if (m != INT_MIN)
          atomicMax(cell(p, p.o_max[j], s), wide_image(m, is_f));
      }
    }
  }
}

// ----------------------------------------------------------- global route

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

// One pass over lane j (DT its dtype; `has_lane` false: the row count
// alone), its states added into slot 0 once per warp.  A 4-byte lane's
// MIN/MAX ride 32-bit images; an int32 lane's sum of squares is exact in
// (q_hi, q_lo); an integer lane's float sum is its exact sum.
template <int DT>
__device__ __forceinline__ void simple_pass(const FoldParams& p, int j,
                                            bool has_lane, bool count_rows) {
  constexpr bool NARROW = DT == DT_INT32 || DT == DT_FLOAT32;
  constexpr bool FLOAT = DT == DT_FLOAT32 || DT == DT_FLOAT64;
  using Img = typename std::conditional<NARROW, int, long long>::type;
  const Img IMG_MAX = NARROW ? (Img)INT_MAX : (Img)LLONG_MAX;
  const Img IMG_MIN = NARROW ? (Img)INT_MIN : (Img)LLONG_MIN;
  const bool lead = (threadIdx.x & 31) == 0;
  const unsigned char* ok = has_lane ? p.ok[j] : nullptr;
  unsigned long long rows = 0, nn = 0, q_lo = 0, q_hi = 0;
  long long is = 0, first = LLONG_MAX;
  double fs = 0.0, sq = 0.0;
  Img mn = IMG_MAX, mx = IMG_MIN;
  const long long tiles = (p.n + TILE_R - 1) / TILE_R;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    using Raw = typename std::conditional<NARROW, unsigned,
                                          unsigned long long>::type;
    unsigned live[UNROLL_R], vok[UNROLL_R];
    Raw raw[UNROLL_R][4];
    // the selection, validity and values of all groups in flight at once
#pragma unroll
    for (int u = 0; u < UNROLL_R; ++u) {
      const long long i = t * TILE_R + 4LL * (u * THREADS + threadIdx.x);
      const bool full = p.vec && i + 4 <= p.n;
      live[u] = live4(p, i, full);
      vok[u] = ok != nullptr ? live[u] & bits4(ok, i, full, p.n) : live[u];
      if (!has_lane) continue;
      if constexpr (NARROW)
        load4_32(p.values[j], i, full, p.n, raw[u]);
      else
        load4_64(p.values[j], i, full, p.n, raw[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL_R; ++u) {
      rows += __popc(live[u]);
      const long long i = t * TILE_R + 4LL * (u * THREADS + threadIdx.x);
      if (has_lane && first == LLONG_MAX && live[u] != 0)
        first = i + __ffs(live[u]) - 1;
      if (!has_lane || vok[u] == 0) continue;
      nn += __popc(vok[u]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (!((vok[u] >> r) & 1u)) continue;
        Img img;
        if (DT == DT_INT32) {
          const long long x = (int)(unsigned)raw[u][r];
          is += x;
          const unsigned long long q = (unsigned long long)(x * x);
          q_lo += q;
          q_hi += q_lo < q ? 1ull : 0ull;
          img = (Img)x;
        } else if (DT == DT_INT64) {
          const long long x = (long long)raw[u][r];
          is += x;
          fs += (double)x;
          sq += (double)x * (double)x;
          img = (Img)x;
        } else if (DT == DT_FLOAT32) {
          const float x = __uint_as_float((unsigned)raw[u][r]);
          fs += (double)x;
          sq += (double)x * (double)x;
          img = (Img)f32_image(x);
        } else {
          const double x = __longlong_as_double((long long)raw[u][r]);
          fs += x;
          sq += x * x;
          img = (Img)f64_image(x);
        }
        mn = img < mn ? img : mn;
        mx = img > mx ? img : mx;
      }
    }
  }
  if (count_rows && p.o_rows >= 0) {
    const long long total = warp_sum(static_cast<long long>(rows));
    if (lead && total) add_u64(cell(p, p.o_rows, 0), total);
  }
  if (!has_lane) return;
  // FIRST before the early return: a warp whose selected rows are all
  // NULL still holds the first selected position
  if (p.o_first[j] >= 0) {
    const long long t = warp_min(first);
    if (lead && t != LLONG_MAX) atomicMin(cell(p, p.o_first[j], 0), t);
  }
  const long long c = warp_sum(static_cast<long long>(nn));
  if (c == 0) return;
  if (p.o_nonnull[j] >= 0 && lead) add_u64(cell(p, p.o_nonnull[j], 0), c);
  if (!FLOAT && (p.o_isum[j] >= 0 || (DT == DT_INT32 && p.o_fsum[j] >= 0))) {
    const long long t = warp_sum(is);
    if (lead && p.o_isum[j] >= 0) add_u64(cell(p, p.o_isum[j], 0), t);
    if (lead && DT == DT_INT32 && p.o_fsum[j] >= 0)
      add_f64(cell(p, p.o_fsum[j], 0), (double)t);
  }
  if (DT != DT_INT32 && p.o_fsum[j] >= 0) {
    const double t = warp_sum(fs);
    if (lead) add_f64(cell(p, p.o_fsum[j], 0), t);
  }
  if (p.o_sumsq[j] >= 0) {
    const double t =
        warp_sum(DT == DT_INT32 ? u128_to_double(q_hi, q_lo) : sq);
    if (lead) add_f64(cell(p, p.o_sumsq[j], 0), t);
  }
  if (p.o_min[j] >= 0) {
    long long t;
    if (NARROW)
      t = wide_image(__reduce_min_sync(FULL, (int)mn), FLOAT);
    else
      t = warp_min((long long)mn);
    if (lead) atomicMin(cell(p, p.o_min[j], 0), t);
  }
  if (p.o_max[j] >= 0) {
    long long t;
    if (NARROW)
      t = wide_image(__reduce_max_sync(FULL, (int)mx), FLOAT);
    else
      t = warp_max((long long)mx);
    if (lead) atomicMax(cell(p, p.o_max[j], 0), t);
  }
}

// FIRST's value: the lane's value at its first position (at row n - 1
// when there is none, as the plain version indexes), int64 for integers,
// float64 bits for floats; and that row's validity (0 when there is none)
__device__ __forceinline__ void first_value(const FoldParams& p, int j) {
  const long long first = *reinterpret_cast<volatile long long*>(
      cell(p, p.o_first[j], 0));
  const long long at = first < p.n - 1 ? first : p.n - 1;
  const Value v = load(p, j, at);
  *cell(p, p.o_firstval[j], 0) =
      p.dtype[j] <= DT_INT64 ? v.iv : __double_as_longlong(v.dv);
  if (p.o_firstok[j] >= 0)
    *cell(p, p.o_firstok[j], 0) =
        first != LLONG_MAX && (p.ok[j] == nullptr || p.ok[j][at] != 0);
}

// DT: the dtype of every lane of the launch (the launcher groups lanes by
// dtype on this route; a launch without lanes counts rows as int32)
template <int DT>
__global__ void __launch_bounds__(THREADS)
    fold_simple(const __grid_constant__ FoldParams p) {
  const int passes = p.n_lanes > 0 ? p.n_lanes : 1;
  bool wants_first = false;
  for (int j = 0; j < passes; ++j) {
    const bool has_lane = j < p.n_lanes;
    simple_pass<DT>(p, j, has_lane, j == 0);
    wants_first = wants_first || (has_lane && p.o_first[j] >= 0);
  }
  if (!wants_first) return;
  // the last block to finish reads FIRST's values: every block's
  // positions are in the buffer before its ticket
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(p.ticket, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int j = threadIdx.x;
  if (j < p.n_lanes && p.o_first[j] >= 0) first_value(p, j);
  if (threadIdx.x == 0) *p.ticket = 0ull;   // for the next launch
}

// ------------------------------------------------------------- bookends

// the overflow flag and the ticket 0, every state row its first value
__global__ void fold_init(const FoldParams p) {
  const long long words = 1 + (long long)p.n_rows * p.n_slots;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < words; w += (long long)gridDim.x * blockDim.x)
    p.out[w] = w == 0 ? 0 : p.init[(w - 1) / p.n_slots];
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.ticket = 0ull;
}

template <int DT>
cudaError_t launch_simple(const FoldParams& g, int sms, cudaStream_t s) {
  static int per_sm = 0;
  cudaError_t e;
  if (per_sm == 0 &&
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fold_simple<DT>, THREADS, 0)) != cudaSuccess)
    return e;
  const long long tiles = (g.n + TILE_R - 1) / TILE_R;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  fold_simple<DT><<<grid, THREADS, 0, s>>>(g);
  return cudaGetLastError();
}

template <int NL, bool REAL>
cudaError_t launch_shared(const FoldParams& g, int smem, int sms,
                          cudaStream_t s) {
  static int optin_set = -1;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (optin_set != device) {
    int optin = 0;
    if ((e = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
        cudaSuccess)
      return e;
    if ((e = cudaFuncSetAttribute(fold_shared<NL, REAL>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin)) != cudaSuccess)
      return e;
    optin_set = device;
  }
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fold_shared<NL, REAL>, THREADS, (size_t)smem)) !=
      cudaSuccess)
    return e;
  const long long tiles = (g.n + TILE_S - 1) / TILE_S;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  fold_shared<NL, REAL><<<grid, THREADS, (size_t)smem, s>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Fold rows [0, n) with one FoldParams per group of at most MAX_LANES
// lanes (`groups[0]` carries the init values and the row count), on
// `route` 0 (shared), 1 (global) or 2 (registers: no GROUP BY; each
// group's lanes share one dtype); `smem`: the shared route's dynamic bytes
// (`n_slots` * (8 * (n_wide + n64) + 4 * n32) of the largest group).
// Asynchronous on `stream`.  Returns the first failing call's error;
// *launched counts kernel launches.
int agg_fold_launch(int device, const FoldParams* groups, int n_groups,
                    int route, int smem, void* stream, int* launched) {
  *launched = 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int sms = 0, per_sm = 0;
  if (sms == 0) {
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fold_global, THREADS, 0)) != cudaSuccess)
      return e;
  }
  const FoldParams& g0 = groups[0];
  const long long words = 1 + (long long)g0.n_rows * g0.n_slots;
  const long long ib = (words + THREADS - 1) / THREADS;
  fold_init<<<(unsigned)(ib < 4096 ? ib : 4096), THREADS, 0, s>>>(g0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  if (g0.n <= 0) return cudaSuccess;
  for (int g = 0; g < n_groups; ++g) {
    const FoldParams& p = groups[g];
    if (route == 0) {
      const int nl = p.n_lanes;
      bool real = false;
      for (int j = 0; j < nl; ++j) real = real || p.dtype[j] == DT_FLOAT32;
      if (real)
        e = nl <= 1   ? launch_shared<1, true>(p, smem, sms, s)
            : nl <= 2 ? launch_shared<2, true>(p, smem, sms, s)
            : nl <= 4 ? launch_shared<4, true>(p, smem, sms, s)
                      : launch_shared<8, true>(p, smem, sms, s);
      else
        e = nl <= 1   ? launch_shared<1, false>(p, smem, sms, s)
            : nl <= 2 ? launch_shared<2, false>(p, smem, sms, s)
            : nl <= 4 ? launch_shared<4, false>(p, smem, sms, s)
                      : launch_shared<8, false>(p, smem, sms, s);
    } else if (route == 1) {
      const long long want = (g0.n + THREADS - 1) / THREADS;
      const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
      fold_global<<<(unsigned)(want < most ? want : most), THREADS, 0, s>>>(
          p);
      e = cudaGetLastError();
    } else {
      switch (p.n_lanes > 0 ? p.dtype[0] : DT_INT32) {
        case DT_INT32: e = launch_simple<DT_INT32>(p, sms, s); break;
        case DT_INT64: e = launch_simple<DT_INT64>(p, sms, s); break;
        case DT_FLOAT32: e = launch_simple<DT_FLOAT32>(p, sms, s); break;
        default: e = launch_simple<DT_FLOAT64>(p, sms, s);
      }
    }
    if (e != cudaSuccess) return e;
    ++*launched;
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

int agg_fold_params_bytes() { return (int)sizeof(FoldParams); }

const char* agg_fold_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

// Direct-index GROUP BY aggregation (COUNT / SUM / AVG states) for Hopper.
//
// Replaces the TPU kernel of tikv_tpu/device/pallas_hash.py (`build`,
// pallas_call at :361).  It computes the same per-slot states: for every
// slot of the layout "groups [0, capacity), NULL slot capacity, scrap
// capacity+1" an int64 row count, and per aggregate lane an int64
// non-NULL count and an exact int64 sum of int32 values.  Slot rules
// (pallas_hash.py:276-300):
//   simple: every masked row goes to slot 0;
//   dense:  rel = key - base in int32 (wrapping); in-range rows go to rel;
//           a NULL key goes to `capacity` only when that slot exists
//           (n_slots > capacity); every other row goes nowhere;
//   sparse: the precomputed slot id, when it is < n_slots.
// A lane with a validity plane contributes only where it is valid.
//
// Bound: bytes read.  Config 4 (GROUP BY an int32 key, SUM of an int32
// value) reads 8 B/row, about 0.25 ms at 3.35 TB/s for 100 * 2^20 rows;
// config 3 (no GROUP BY, SUM and AVG of one column) reads 4 B/row.  What
// holds the table modes above it is the rate of shared-memory atomics.
//
// Design:
// - Every distinct plane is read once.  The launcher passes distinct
//   (values, validity) lanes; a lane whose values or validity plane is an
//   earlier lane's (`vsrc` / `osrc`) copies that lane's registers.
// - Rows are read 4 at a time, int4 for int32 planes and one 32-bit word
//   for 4 bool bytes, UNROLL such groups per thread loaded before any is
//   added, so 4 or more 16-byte loads are in flight.  A tile is the block's
//   THREADS * 4 * UNROLL consecutive rows; blocks stride over tiles.  The
//   launcher picks `head` (< 4) so that every plane is on a 16-byte (bool:
//   4-byte) boundary at row `head`; rows [0, head) are read one by one.
//   Where the planes disagree on that phase, `vec` is 0 and every row is
//   read with scalar loads.
// - dense / sparse: each block keeps a shared table of cells per slot, in
//   one of two formats the launcher chooses:
//   FMT_SPLIT (values of at most 2 bytes, every lane in one launch): 32-bit
//   cells -- a sum per value lane, a count per lane with its own validity,
//   the row count -- each added with ONE native 32-bit shared atomic
//   (ATOMS.ADD).  Every `fold_every` tiles (fewer than 2^(32 - 8 nb) rows,
//   so no sum leaves int32) the block folds: a barrier, then each thread
//   adds the cells of the slots it owns into their int64 twins in shared
//   memory, with no atomic.  At the end each owner adds its slots into the
//   global int64 outputs.
//   FMT_PACKED (any int32 values): one 64-bit cell per lane, count <<
//   shift | sum of (value + bias), bias = 2^(8 nb - 1), plus a row-count
//   cell unless a lane's count is the row count: ONE shared atomic per row
//   and lane, but a 64-bit shared add compiles to a compare-and-swap loop
//   (ATOMS.CAST.SPIN.64) on sm_90.  It folds into the global outputs every
//   `fold_every` tiles (2^k rows, k = (63 - 8 nb) / 2) and at the end.
// - simple: counts and int64 sums stay in registers; a warp-shuffle
//   reduction, one shared write per warp and one global atomic per state
//   and block end the kernel.
// Two's-complement wraparound of the unsigned 64-bit atomics equals int64
// arithmetic, so every sum is exact.  TMA-fed tiles and fusing the
// selection / computed arguments into the kernel are for a later
// revision.

#include <cuda_runtime.h>

#define MAX_LANES 8
#define MAX_CELLS (2 * MAX_LANES + 1)
#define THREADS 256
#define WARPS (THREADS / 32)

enum { MODE_SIMPLE = 0, MODE_DENSE = 1, MODE_SPARSE = 2 };
enum { FMT_PACKED = 0, FMT_SPLIT = 1 };

// One launch's arguments (the Python launcher fills the same layout).
struct Params {
  const int* key;               // dense: int32 keys; sparse: slot ids
  const unsigned char* key_ok;  // dense: key validity, or null
  const unsigned char* mask;    // selection, or null: every row
  long long n;                  // rows [0, n)
  long long head;               // rows [0, head) read one by one
  int vec;                      // 1: 16-byte loads from row `head` on
  int base, capacity, n_slots;
  int n_lanes;
  int row_lane;                 // packed: lane whose count is the row count
  int n_cells;                  // cells per slot
  int shift;                    // packed: cell = count << shift | biased sum
  unsigned bias;                // packed: 2^(8 nb - 1)
  int fold_every;               // tiles between folds
  const int* values[MAX_LANES];          // null: a COUNT lane
  const unsigned char* ok[MAX_LANES];    // null: valid where live
  int vsrc[MAX_LANES];                   // lane that loads the values plane
  int osrc[MAX_LANES];                   // lane that loads the ok plane
  unsigned long long* sum_out[MAX_LANES];      // int64 [n_slots] or null
  unsigned long long* nonnull_out[MAX_LANES];  // int64 [n_slots] or null
  unsigned long long* count_out;               // int64 [n_slots] or null
  // FMT_SPLIT: the 32-bit cell of each lane's sum / non-NULL count (-1:
  // none) and of the row count; cells [0, n_sum) hold sums; cell c is
  // added into cell_out[c]
  int sum_cell[MAX_LANES];
  int cnt_cell[MAX_LANES];
  int row_cell;
  int n_sum;
  unsigned long long* cell_out[MAX_CELLS];
};

// 4-row groups a thread loads before adding any: the simple kernel keeps 4
// one-plane groups in flight; a table kernel 2 groups of key + value (more
// registers cost it resident warps, which hide its atomics' latency)
template <int MODE, int NL>
struct Unroll {
  static constexpr int value =
      MODE == MODE_SIMPLE ? (NL <= 2 ? 4 : NL <= 4 ? 2 : 1) : (NL <= 4 ? 2 : 1);
};

// ---------------------------------------------------------------------------
// 4-row loads (rows at or past `end` read nothing)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load4(const int* p, long long i, bool full,
                                      long long end, int v[4]) {
  if (full) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p + i));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = i + r < end ? __ldg(p + i + r) : 0;
  }
}

// Bit r set where bool byte i + r is true.
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

// Four rows' inputs: which rows are live (and, in the table modes, land in
// a slot), their slots, and per lane its values and valid rows.
template <int NL>
struct Group {
  unsigned live;
  int slot[4];
  int v[NL > 0 ? NL : 1][4];
  unsigned ok[NL > 0 ? NL : 1];
};

template <int MODE, int NL>
__device__ __forceinline__ void load_group(const Params& p, long long i,
                                           bool full, long long end,
                                           Group<NL>& g) {
  const long long left = end - i;
  unsigned live = left >= 4 ? 0xFu : left > 0 ? (1u << left) - 1u : 0u;
  if (p.mask != nullptr) live &= bits4(p.mask, i, full, end);
  if constexpr (MODE != MODE_SIMPLE) {
    int k[4];
    load4(p.key, i, full, end, k);
    unsigned kok = 0xFu;
    if (MODE == MODE_DENSE && p.key_ok != nullptr)
      kok = bits4(p.key_ok, i, full, end);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int s;
      if constexpr (MODE == MODE_SPARSE) {
        s = (k[r] >= 0 && k[r] < p.n_slots) ? k[r] : -1;
      } else if (!((kok >> r) & 1u)) {
        s = p.n_slots > p.capacity ? p.capacity : -1;
      } else {
        const int rel = (int)((unsigned)k[r] - (unsigned)p.base);
        s = (rel >= 0 && rel < p.capacity) ? rel : -1;
      }
      g.slot[r] = s;
      if (s < 0) live &= ~(1u << r);
    }
  }
  g.live = live;
  // each plane is loaded by the first lane that reads it; later lanes copy
  // (loops of constant trip count, so every index is static)
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (p.values[l] != nullptr && p.vsrc[l] == l)
      load4(p.values[l], i, full, end, g.v[l]);
    g.ok[l] = live;
    if (p.ok[l] != nullptr && p.osrc[l] == l)
      g.ok[l] = live & bits4(p.ok[l], i, full, end);
  }
#pragma unroll
  for (int l = 1; l < NL; ++l) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      if (j >= l) continue;
      if (p.values[l] != nullptr && p.vsrc[l] == j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) g.v[l][r] = g.v[j][r];
      }
      if (p.ok[l] != nullptr && p.osrc[l] == j) g.ok[l] = g.ok[j];
    }
  }
}

// Row `r` of the group tile number t: UNROLL groups of 4 rows per thread,
// group u at row head + t * TILE + 4 * (u * THREADS + tid).
template <int MODE, int NL>
__device__ __forceinline__ long long group_row(const Params& p, long long t,
                                               int u) {
  constexpr int TILE = THREADS * 4 * Unroll<MODE, NL>::value;
  return p.head + t * TILE + 4LL * (u * THREADS + threadIdx.x);
}

template <int MODE, int NL>
__device__ __forceinline__ long long n_tiles(const Params& p) {
  constexpr int TILE = THREADS * 4 * Unroll<MODE, NL>::value;
  return p.n > p.head ? (p.n - p.head + TILE - 1) / TILE : 0;
}

// ---------------------------------------------------------------------------
// dense / sparse, FMT_PACKED: one 64-bit packed cell per slot and lane
// ---------------------------------------------------------------------------

template <int NL>
__device__ __forceinline__ void add_packed(const Params& p,
                                           unsigned long long* cells,
                                           const Group<NL>& g) {
  const unsigned long long one = 1ull << p.shift;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if ((g.live >> r) & 1u) {
      const int s = g.slot[r];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if ((g.ok[l] >> r) & 1u) {
          const unsigned u =
              p.values[l] != nullptr ? (unsigned)g.v[l][r] + p.bias : 0u;
          atomicAdd(&cells[l * p.n_slots + s], one + u);
        }
      }
      if (p.n_cells > NL) atomicAdd(&cells[NL * p.n_slots + s], one);
    }
  }
}

// Unpack every non-empty cell into the global outputs and zero it.
template <int NL>
__device__ void fold_packed(const Params& p, unsigned long long* cells) {
  const unsigned long long low = (1ull << p.shift) - 1ull;
#pragma unroll
  for (int c = 0; c <= NL; ++c) {
    if (c >= p.n_cells) break;
    for (int s = threadIdx.x; s < p.n_slots; s += THREADS) {
      const unsigned long long x = cells[c * p.n_slots + s];
      if (x == 0) continue;
      cells[c * p.n_slots + s] = 0;
      const unsigned long long cnt = x >> p.shift;
      if (c == NL || c == p.row_lane) atomicAdd(&p.count_out[s], cnt);
      if (c == NL) continue;
      if (p.nonnull_out[c] != nullptr) atomicAdd(&p.nonnull_out[c][s], cnt);
      const long long sum = (long long)(x & low) - (long long)cnt * p.bias;
      if (p.sum_out[c] != nullptr && sum != 0)
        atomicAdd(&p.sum_out[c][s], (unsigned long long)sum);
    }
  }
}

// ---------------------------------------------------------------------------
// dense / sparse, FMT_SPLIT: 32-bit cells (a native shared atomic each),
// folded by their owner threads into an int64 shared table
// ---------------------------------------------------------------------------

template <int NL>
__device__ __forceinline__ void add_split(const Params& p, unsigned* narrow,
                                          const Group<NL>& g) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if ((g.live >> r) & 1u) {
      const int s = g.slot[r];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if ((g.ok[l] >> r) & 1u) {
          if (p.sum_cell[l] >= 0 && g.v[l][r] != 0)
            atomicAdd(&narrow[p.sum_cell[l] * p.n_slots + s],
                      (unsigned)g.v[l][r]);
          if (p.cnt_cell[l] >= 0)
            atomicAdd(&narrow[p.cnt_cell[l] * p.n_slots + s], 1u);
        }
      }
      atomicAdd(&narrow[p.row_cell * p.n_slots + s], 1u);
    }
  }
}

// A 32-bit cell's value since its last fold: sums are signed (their
// magnitude stays below 2^31 between folds), counts unsigned.
__device__ __forceinline__ unsigned long long widen(const Params& p, int c,
                                                    unsigned x) {
  return c < p.n_sum ? (unsigned long long)(long long)(int)x
                     : (unsigned long long)x;
}

// Each thread moves the cells of the slots it owns into the wide table
// (`out`: and then into the global outputs).
__device__ void fold_split(const Params& p, unsigned long long* wide,
                           unsigned* narrow, bool out) {
  for (int c = 0; c < p.n_cells; ++c) {
    for (int s = threadIdx.x; s < p.n_slots; s += THREADS) {
      const int j = c * p.n_slots + s;
      const unsigned x = narrow[j];
      if (out) {
        const unsigned long long w = wide[j] + widen(p, c, x);
        if (w != 0 && p.cell_out[c] != nullptr)
          atomicAdd(&p.cell_out[c][s], w);
      } else if (x != 0) {
        narrow[j] = 0;
        wide[j] += widen(p, c, x);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the table kernel: zero the table, one pass over the rows, fold
// ---------------------------------------------------------------------------

template <int MODE, int NL, int FMT>
__global__ void __launch_bounds__(THREADS)
table_kernel(const __grid_constant__ Params p) {
  // FMT_PACKED: the packed cells; FMT_SPLIT: the int64 table, then the
  // 32-bit cells
  extern __shared__ unsigned long long smem[];
  const int cells = p.n_cells * p.n_slots;
  unsigned* narrow = reinterpret_cast<unsigned*>(smem + cells);
  constexpr int U = Unroll<MODE, NL>::value;
  for (int j = threadIdx.x; j < cells; j += THREADS) {
    smem[j] = 0ull;
    if (FMT == FMT_SPLIT) narrow[j] = 0u;
  }
  __syncthreads();
  auto add = [&](const Group<NL>& g) {
    if constexpr (FMT == FMT_SPLIT)
      add_split<NL>(p, narrow, g);
    else
      add_packed<NL>(p, smem, g);
  };
  if (blockIdx.x == 0 && threadIdx.x < p.head) {
    Group<NL> g;
    load_group<MODE, NL>(p, threadIdx.x, false, threadIdx.x + 1, g);
    add(g);
  }
  const long long tiles = n_tiles<MODE, NL>(p);
  int since = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    Group<NL> g[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = group_row<MODE, NL>(p, t, u);
      load_group<MODE, NL>(p, i, p.vec && i + 4 <= p.n, p.n, g[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) add(g[u]);
    if (++since == p.fold_every) {
      since = 0;
      __syncthreads();
      if constexpr (FMT == FMT_SPLIT)
        fold_split(p, smem, narrow, false);
      else
        fold_packed<NL>(p, smem);
      __syncthreads();
    }
  }
  __syncthreads();
  if constexpr (FMT == FMT_SPLIT)
    fold_split(p, smem, narrow, true);
  else
    fold_packed<NL>(p, smem);
}

// ---------------------------------------------------------------------------
// simple: registers, then one global atomic per state and block
// ---------------------------------------------------------------------------

template <int NL>
__global__ void __launch_bounds__(THREADS)
simple_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned long long red[];   // [WARPS][1 + 2 NL]
  constexpr int U = Unroll<MODE_SIMPLE, NL>::value;
  constexpr int NS = 1 + 2 * NL;
  unsigned long long st[NS];   // rows, then per lane sum and non-NULL
#pragma unroll
  for (int j = 0; j < NS; ++j) st[j] = 0ull;

  auto add = [&](const Group<NL>& g) {
    st[0] += __popc(g.live);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      st[2 + 2 * l] += __popc(g.ok[l]);
      if (p.values[l] == nullptr) continue;
      long long s = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s += ((g.ok[l] >> r) & 1u) ? (long long)g.v[l][r] : 0ll;
      st[1 + 2 * l] += (unsigned long long)s;
    }
  };

  if (blockIdx.x == 0 && threadIdx.x < p.head) {
    Group<NL> g;
    load_group<MODE_SIMPLE, NL>(p, threadIdx.x, false, threadIdx.x + 1, g);
    add(g);
  }
  const long long tiles = n_tiles<MODE_SIMPLE, NL>(p);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    Group<NL> g[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = group_row<MODE_SIMPLE, NL>(p, t, u);
      load_group<MODE_SIMPLE, NL>(p, i, p.vec && i + 4 <= p.n, p.n, g[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) add(g[u]);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    unsigned long long x = st[j];
#pragma unroll
    for (int d = 16; d > 0; d /= 2) x += __shfl_down_sync(0xFFFFFFFFu, x, d);
    if (lane == 0) red[warp * NS + j] = x;
  }
  __syncthreads();
  if (threadIdx.x >= NS) return;
  const int j = threadIdx.x;
  unsigned long long x = 0;
  for (int w = 0; w < WARPS; ++w) x += red[w * NS + j];
  if (x == 0) return;
  unsigned long long* out =
      j == 0 ? p.count_out
             : (j % 2 ? p.sum_out[(j - 1) / 2] : p.nonnull_out[(j - 2) / 2]);
  if (out != nullptr) atomicAdd(out, x);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int MODE, int FMT, int NL>
static const void* kernel_fn() {
  if constexpr (MODE == MODE_SIMPLE)
    return (const void*)simple_kernel<NL>;
  else
    return (const void*)table_kernel<MODE, NL, FMT>;
}

template <int MODE, int FMT>
static const void* kernel_of_lanes(int nl) {
  switch (nl) {
    case 0: return kernel_fn<MODE, FMT, 0>();
    case 1: return kernel_fn<MODE, FMT, 1>();
    case 2: return kernel_fn<MODE, FMT, 2>();
    case 3: return kernel_fn<MODE, FMT, 3>();
    case 4: return kernel_fn<MODE, FMT, 4>();
    case 5: return kernel_fn<MODE, FMT, 5>();
    case 6: return kernel_fn<MODE, FMT, 6>();
    case 7: return kernel_fn<MODE, FMT, 7>();
    case 8: return kernel_fn<MODE, FMT, 8>();
    default: return nullptr;
  }
}

// The kernel of a mode, cell format (table modes) and lane count.
static const void* kernel_of(int mode, int fmt, int nl) {
  if (mode == MODE_SIMPLE) return kernel_of_lanes<MODE_SIMPLE, 0>(nl);
  if (fmt != FMT_PACKED && fmt != FMT_SPLIT) return nullptr;
  if (mode == MODE_DENSE)
    return fmt == FMT_SPLIT ? kernel_of_lanes<MODE_DENSE, FMT_SPLIT>(nl)
                            : kernel_of_lanes<MODE_DENSE, FMT_PACKED>(nl);
  if (mode == MODE_SPARSE)
    return fmt == FMT_SPLIT ? kernel_of_lanes<MODE_SPARSE, FMT_SPLIT>(nl)
                            : kernel_of_lanes<MODE_SPARSE, FMT_PACKED>(nl);
  return nullptr;
}

extern "C" {

// Once per (device, mode, format, lane count, shared bytes): let the
// kernel opt into the card's largest dynamic shared memory and report how
// many of its blocks fit the card at once (`*resident`).
int hash_agg_prepare(int device, int mode, int fmt, int n_lanes, int smem,
                     int* resident) {
  const void* fn = kernel_of(mode, fmt, n_lanes);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int optin = 0, sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                         smem)) != cudaSuccess)
    return e;
  *resident = per_sm * sms;
  return cudaSuccess;
}

// Launch one aggregation pass on `stream` (asynchronous; no allocation;
// no query of the card).  Returns cudaGetLastError() after the launch.
int hash_agg_launch(int device, const Params* p, int mode, int fmt,
                    int grid, int smem, void* stream) {
  const void* fn = kernel_of(mode, fmt, p->n_lanes);
  if (fn == nullptr || grid < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  void* args[] = {(void*)p};
  e = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(THREADS), args,
                       (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();           // a refused launch leaves no sticky error
    return e;
  }
  return cudaGetLastError();
}

// Largest dynamic shared memory one block may opt into on `device`.
int hash_agg_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

const char* hash_agg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

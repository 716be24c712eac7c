// Two-level GROUP BY aggregation for Hopper.
//
// Replaces the TPU kernels that compute kernels.twolevel_partial's function
// (tikv_tpu/device/kernels.py:182): the Pallas prototypes
// prof/prof_pl.py:44 `make_v1`, prof/prof_pl2.py:43 `make` and
// prof/prof_pallas.py:92/147 `run_a`/`run_b`, and the XLA two-level body
// the reference runner uses outside the fused kernel's gate
// (tikv_tpu/device/runner.py:2743), which fuses slot_index (:324),
// make_planes (:122) and twolevel_partial into one block body.  Summed over
// every row of the call it computes, for slot ids idx[row] and int8 /
// float32 planes,
//
//   S8[hi][p*LO + lo] = sum over rows with idx == hi*LO + lo of L8[p][row]
//   Sf[hi][p*LO + lo] = the same over Lf, in float64
//
// in the reference carry's layout: S8 is (HI, p8*LO) int64, Sf is
// (HI, pf*LO) float64.  A row whose slot lies outside [0, HI*LO) adds
// nowhere, as in the one-hot product.
//
// Two sources feed one accumulate/merge core:
//  - twolevel_fused_launch (the runner's path) reads the feed's raw
//    columns and builds each row's slot and planes in registers, as the
//    reference's fused body does in VMEM: the slot as slot_index does (a
//    dense int32 key shifts in int32 against base's int32 wraparound, an
//    int64 key in int64; a NULL key goes to `capacity`; a live key outside
//    [0, capacity) goes to scrap, `capacity + 1`, and sets *overflow; a
//    sparse key is a precomputed slot id), and the planes as make_planes
//    does: the row mask, mask & validity, the nb biased bytes
//    ((v + 2^(8nb-1)) mod 2^64 >> 8k & 0xFF) - 128, and float32 values.
//    Masked-out rows add nowhere (their planes are all zero).  Planes that
//    several aggregates share (4n's COUNT/SUM/AVG of one column) are
//    accumulated once: a lane is one (values, validity) pair and names the
//    distinct planes it feeds; the launcher copies the duplicate columns.
//  - twolevel_launch takes materialized idx / L8 / Lf planes, the
//    counterpart of the prof/ prototypes.
//
// Bound: bytes read.  The fused source reads the raw columns once: config
// 4n (int32 key, int32 value, bool validity) 9 B/row, about 0.28 ms at
// 3.35 TB/s for 100 * 2^20 rows; the work is a few integer operations and
// one add per non-zero plane value.  The int8 tensor-core contraction the
// TPU used does HI * p8 * LO multiply-adds per row (9,216 at 4n, 197,376 at
// 4w: ~21 ms at the 1,979 TOP/s int8 peak), so it cannot reach that bound;
// Hopper has fast scattered atomics in shared memory instead.  Float64
// shared atomics compile to a compare-and-swap loop on this card.
//
// Routes, chosen by the launcher from the table's bytes (4 B per distinct
// int8 plane, 8 B per float plane, per slot) and the card's attributes:
//  - shared: the table fits one block's opt-in shared memory; each block
//    keeps a private table, int32 cells for int8 planes and float64 cells
//    for float planes, updated with shared atomics;
//  - cluster: the table fits a thread-block cluster of up to 8 blocks;
//    it is split across the cluster's shared memory by HI rows (block
//    hi mod cluster size owns HI row hi) and every update goes to the
//    owning block with an atomic on distributed shared memory (float64
//    atomics included).  On an H100 these run at about the rate of global
//    atomics (config 4w: 3.3-3.9 ms on either route, chip_smoke.py's
//    route sweep); letting every block of a cluster walk the cluster's
//    rows and add only its own slice's, with local atomics, was slower
//    still (the re-reads from L2 leave each block latency-bound);
//  - global: beyond that, every non-zero plane value is added straight
//    into the int64 / float64 outputs with device atomics.
// At the end of the shared and cluster routes each block adds its
// non-zero cells into the outputs with one 64-bit atomic each.  An int32
// cell gains at most 128 in magnitude per row, so it stays exact while the
// rows that feed one table -- a block's, or a whole cluster's -- number
// at most 2^23 plus one stride (|cell| < 2^30 + 2^21); the launcher sizes
// the grid so they do.  Two's-complement wraparound of the unsigned 64-bit
// atomics equals int64 arithmetic, so the integer sums are exact.  Float
// cells add float32 values in float64, in an order that varies.
//
// Loads are 16 B per thread: a thread takes 4 consecutive rows per step
// (int4 for int32 columns, two longlong2 for int64, one 32-bit word for 4
// bool bytes) and masks the ragged tail.  The launcher passes 16-byte
// aligned columns.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define THREADS 256
#define MAX_LANES 64
#define MAX_PLANES 32
// rows one table may see, give or take one stride, while its int32 cells
// stay exact
#define ROWS_PER_TABLE (1LL << 23)

enum { ROUTE_SHARED = 0, ROUTE_CLUSTER = 1, ROUTE_GLOBAL = 2 };
enum { SRC_PLANES = 0, SRC_DENSE32 = 1, SRC_DENSE64 = 2, SRC_SPARSE = 3 };
enum { LANE_COUNT = 0, LANE_INT32 = 1, LANE_INT64 = 2, LANE_REAL = 3 };

// The packed output and the table's distinct planes.
struct Layout {
  int lo_shift, HI;
  int w8, wf;             // output row widths: p8 * LO, pf * LO
  int d8, df;             // distinct planes the table accumulates
  int out8[MAX_PLANES];   // distinct int8 plane -> its output plane
  int outf[MAX_PLANES];   // distinct float plane -> its output plane
};

// ---------------------------------------------------------------------------
// tables: where a row's contributions go
// ---------------------------------------------------------------------------

// A row's cells in a table in (distributed) shared memory: distinct plane
// d of the row's slot at c8[d] / cf[d].
struct SmemRow {
  int* c8;
  double* cf;
  __device__ __forceinline__ void add8(int d, int, int v) const {
    atomicAdd(c8 + d, v);
  }
  __device__ __forceinline__ void addf(int e, int, double v) const {
    atomicAdd(cf + e, v);
  }
};

// One private table per block: slot-major cells (slot * d8 + d).
struct SharedTable {
  using Row = SmemRow;
  int* s8;
  double* sf;
  int d8, df;
  int slots;
  __device__ __forceinline__ Row row(int slot) const {
    return {s8 + slot * d8, sf + slot * df};
  }
};

// One table per cluster: HI row hi lives in block hi mod cs, at local HI
// row hi / cs, slot-major there.
struct ClusterTable {
  using Row = SmemRow;
  int* s8;
  double* sf;
  int d8, df;
  int slots, lo_shift, rank_bits;
  __device__ __forceinline__ Row row(int slot) const {
    const int hi = slot >> lo_shift;
    const unsigned rank = hi & ((1 << rank_bits) - 1);
    const int local =
        ((hi >> rank_bits) << lo_shift) | (slot & ((1 << lo_shift) - 1));
    const cg::cluster_group cluster = cg::this_cluster();
    return {cluster.map_shared_rank(s8, rank) + local * d8,
            cluster.map_shared_rank(sf, rank) + local * df};
  }
};

// No table: a row adds into its output cells, output plane `out` at
// c8[out * LO].
struct GlobalRow {
  unsigned long long* c8;
  double* cf;
  int LO;
  __device__ __forceinline__ void add8(int, int out, int v) const {
    atomicAdd(c8 + out * LO, (unsigned long long)(long long)v);
  }
  __device__ __forceinline__ void addf(int, int out, double v) const {
    atomicAdd(cf + out * LO, v);
  }
};

struct GlobalTable {
  using Row = GlobalRow;
  unsigned long long* S8;
  double* Sf;
  int w8, wf;
  int slots, lo_shift;
  __device__ __forceinline__ Row row(int slot) const {
    const long long hi = slot >> lo_shift;
    const int lo = slot & ((1 << lo_shift) - 1);
    return {S8 + hi * w8 + lo, Sf == nullptr ? nullptr : Sf + hi * wf + lo,
            1 << lo_shift};
  }
};

// ---------------------------------------------------------------------------
// 4-row loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load4(const int* p, long long i, bool full,
                                      long long n, int v[4]) {
  if (full) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p + i));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = i + r < n ? p[i + r] : 0;
  }
}

__device__ __forceinline__ void load4(const long long* p, long long i,
                                      bool full, long long n, long long v[4]) {
  if (full) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p + i));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p + i + 2));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = i + r < n ? p[i + r] : 0;
  }
}

__device__ __forceinline__ void load4(const float* p, long long i, bool full,
                                      long long n, float v[4]) {
  if (full) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + i));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = i + r < n ? p[i + r] : 0.0f;
  }
}

// Bit r set where bool byte i + r is true (rows at or past n are false).
__device__ __forceinline__ unsigned bits4(const unsigned char* p, long long i,
                                          bool full, long long n) {
  unsigned b = 0;
  if (full) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p + i));
#pragma unroll
    for (int r = 0; r < 4; ++r) b |= ((w >> (8 * r)) & 0xFFu) ? 1u << r : 0u;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) b |= (i + r < n && p[i + r]) ? 1u << r : 0u;
  }
  return b;
}

// ---------------------------------------------------------------------------
// sources: a row's slot and plane values
// ---------------------------------------------------------------------------

// Materialized planes (the prototypes' interface): idx (n,) int32, L8
// (p8, n) int8, Lf (pf, n) float32.  Plane p is distinct plane p.
struct PlaneSource {
  const int* idx;
  const signed char* L8;
  const float* Lf;
  int p8, pf;

  template <class Tab>
  __device__ __forceinline__ void group(long long i, long long n,
                                        const Tab& tab) const {
    for (int r = 0; r < 4 && i + r < n; ++r) {
      const long long row = i + r;
      const int s = idx[row];
      if (s < 0 || s >= tab.slots) continue;
      const typename Tab::Row c = tab.row(s);
      for (int p = 0; p < p8; ++p) {
        const int v = L8[p * n + row];
        if (v != 0) c.add8(p, p, v);
      }
      for (int p = 0; p < pf; ++p) {
        const float v = Lf[p * n + row];
        if (v != 0.0f) c.addf(p, p, (double)v);
      }
    }
  }
};

// One (values, validity) pair.  It adds 1 to distinct int8 plane
// ok_plane (output plane ok_out) where the row is live and valid, and its
// value's nb bytes to planes val_plane + k (LANE_INT32 / LANE_INT64) or
// its float32 value to float plane val_plane (LANE_REAL).  -1: no plane.
struct Lane {
  const void* values;         // null for LANE_COUNT
  const unsigned char* ok;    // validity, or null: valid on every live row
  int kind, nb;
  int ok_plane, ok_out;
  int val_plane, val_out;
};

template <class Row>
__device__ __forceinline__ void add_bytes(const Row& c, const Lane& ln,
                                          long long v) {
  const unsigned long long biased =
      (unsigned long long)v + (1ull << (8 * ln.nb - 1));
  for (int k = 0; k < ln.nb; ++k) {
    const int byte = (int)((biased >> (8 * k)) & 0xFFu) - 128;
    if (byte != 0) c.add8(ln.val_plane + k, ln.val_out + k, byte);
  }
}

// The feed's raw columns.  SRC: SRC_DENSE32 / SRC_DENSE64 (key values,
// key_ok) or SRC_SPARSE (key = int32 slot ids).
template <int SRC>
struct FusedSource {
  const void* key;
  const unsigned char* key_ok;  // null: no NULL key
  const unsigned char* mask;    // null: every row
  long long base;               // dense: int64 base (int32 keys: its wrap)
  int capacity;
  int n_lanes;
  int* overflow;
  Lane lanes[MAX_LANES];

  template <class Tab>
  __device__ __forceinline__ void group(long long i, long long n,
                                        const Tab& tab) const {
    const bool full = i + 4 <= n;
    unsigned live = full ? 0xFu : (1u << (unsigned)(n - i)) - 1u;
    if (mask != nullptr) live &= bits4(mask, i, full, n);
    if (live == 0) return;
    int slot[4];
    if constexpr (SRC == SRC_SPARSE) {
      load4((const int*)key, i, full, n, slot);
    } else {
      long long rel[4];
      if constexpr (SRC == SRC_DENSE32) {
        int k[4];
        load4((const int*)key, i, full, n, k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          rel[r] = (int)((unsigned)k[r] - (unsigned)(int)base);
      } else {
        long long k[4];
        load4((const long long*)key, i, full, n, k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          rel[r] = (long long)((unsigned long long)k[r] -
                               (unsigned long long)base);
      }
      const unsigned kok =
          key_ok == nullptr ? 0xFu : bits4(key_ok, i, full, n);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (!((kok >> r) & 1u)) {
          slot[r] = capacity;
        } else if (rel[r] >= 0 && rel[r] < capacity) {
          slot[r] = (int)rel[r];
        } else {
          slot[r] = capacity + 1;
          if ((live >> r) & 1u) *overflow = 1;
        }
      }
    }
    typename Tab::Row row[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!((live >> r) & 1u)) continue;
      if (slot[r] < 0 || slot[r] >= tab.slots)
        live &= ~(1u << r);
      else
        row[r] = tab.row(slot[r]);
    }
    for (int l = 0; l < n_lanes; ++l) {
      const Lane& ln = lanes[l];
      unsigned ok = live;
      if (ln.ok != nullptr) ok &= bits4(ln.ok, i, full, n);
      if (ok == 0) continue;
      if (ln.ok_plane >= 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if ((ok >> r) & 1u) row[r].add8(ln.ok_plane, ln.ok_out, 1);
      }
      if (ln.kind == LANE_INT32) {
        int v[4];
        load4((const int*)ln.values, i, full, n, v);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if ((ok >> r) & 1u) add_bytes(row[r], ln, v[r]);
      } else if (ln.kind == LANE_INT64) {
        long long v[4];
        load4((const long long*)ln.values, i, full, n, v);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if ((ok >> r) & 1u) add_bytes(row[r], ln, v[r]);
      } else if (ln.kind == LANE_REAL) {
        float v[4];
        load4((const float*)ln.values, i, full, n, v);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (((ok >> r) & 1u) && v[r] != 0.0f)
            row[r].addf(ln.val_plane, ln.val_out, (double)v[r]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// the kernel: zero the table, one grid-stride pass, merge
// ---------------------------------------------------------------------------

template <class Src, int ROUTE>
__global__ void __launch_bounds__(THREADS)
twolevel_kernel(const __grid_constant__ Src src,
                const __grid_constant__ Layout L, long long n,
                unsigned long long* __restrict__ S8,
                double* __restrict__ Sf) {
  extern __shared__ double smem[];
  const int slots = L.HI << L.lo_shift;
  const long long stride = 4LL * gridDim.x * blockDim.x;
  const long long first = 4LL * ((long long)blockIdx.x * blockDim.x +
                                 threadIdx.x);
  if constexpr (ROUTE == ROUTE_GLOBAL) {
    const GlobalTable tab{S8, Sf, L.w8, L.wf, slots, L.lo_shift};
    for (long long i = first; i < n; i += stride) src.group(i, n, tab);
  } else {
    unsigned rank = 0;
    int rank_bits = 0, local_hi = L.HI;
    if constexpr (ROUTE == ROUTE_CLUSTER) {
      const cg::cluster_group cluster = cg::this_cluster();
      rank = cluster.block_rank();
      rank_bits = __ffs(cluster.num_blocks()) - 1;  // a power of two
      local_hi = (L.HI + cluster.num_blocks() - 1) >> rank_bits;
    }
    const int local_slots = local_hi << L.lo_shift;
    double* sf = smem;                                       // float64 cells
    int* s8 = (int*)(smem + (long long)local_slots * L.df);  // int32 cells
    for (int j = threadIdx.x; j < local_slots * L.d8; j += blockDim.x)
      s8[j] = 0;
    for (int j = threadIdx.x; j < local_slots * L.df; j += blockDim.x)
      sf[j] = 0.0;
    if constexpr (ROUTE == ROUTE_CLUSTER) {
      // every block's slice is zero before any peer adds into it
      cg::this_cluster().sync();
      const ClusterTable tab{s8, sf, L.d8, L.df, slots, L.lo_shift,
                             rank_bits};
      for (long long i = first; i < n; i += stride) src.group(i, n, tab);
      // every peer's adds have landed, and no block exits while a peer
      // may still add into its shared memory
      cg::this_cluster().sync();
    } else {
      __syncthreads();
      const SharedTable tab{s8, sf, L.d8, L.df, slots};
      for (long long i = first; i < n; i += stride) src.group(i, n, tab);
      __syncthreads();
    }
    const int LO = 1 << L.lo_shift;
    for (int s = threadIdx.x; s < local_slots; s += blockDim.x) {
      const int lo = s & (LO - 1);
      const long long hi = ((long long)(s >> L.lo_shift) << rank_bits) | rank;
      if (hi >= L.HI) continue;
      for (int d = 0; d < L.d8; ++d) {
        const int v = s8[s * L.d8 + d];
        if (v != 0)
          atomicAdd(&S8[hi * L.w8 + L.out8[d] * LO + lo],
                    (unsigned long long)(long long)v);
      }
      for (int e = 0; e < L.df; ++e) {
        const double v = sf[s * L.df + e];
        if (v != 0.0) atomicAdd(&Sf[hi * L.wf + L.outf[e] * LO + lo], v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <class Src>
static cudaError_t active_clusters(int cs, size_t smem, int* clusters) {
  const void* kern = (const void*)twolevel_kernel<Src, ROUTE_CLUSTER>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

static cudaError_t active_clusters_of(int source, int cs, size_t smem,
                                      int* clusters) {
  switch (source) {
    case SRC_PLANES:
      return active_clusters<PlaneSource>(cs, smem, clusters);
    case SRC_DENSE32:
      return active_clusters<FusedSource<SRC_DENSE32>>(cs, smem, clusters);
    case SRC_DENSE64:
      return active_clusters<FusedSource<SRC_DENSE64>>(cs, smem, clusters);
    case SRC_SPARSE:
      return active_clusters<FusedSource<SRC_SPARSE>>(cs, smem, clusters);
  }
  return cudaErrorInvalidValue;
}

// Shared memory of one block's table slice: local HI rows x LO slots.
static size_t slice_bytes(const Layout& L, int cs) {
  const long long hi = (L.HI + cs - 1) / cs;
  return (size_t)((hi << L.lo_shift) * (4LL * L.d8 + 8LL * L.df));
}

static long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <class Src>
static cudaError_t run(int device, const Src& src, const Layout& L,
                       long long n, int route, int cs,
                       unsigned long long* S8, double* Sf,
                       cudaStream_t st) {
  cudaError_t e;
  int sms = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return e;
  // no more blocks (row streams) than 4-row groups need
  const long long want = cdiv(cdiv(n, 4), THREADS);
  if (route == ROUTE_CLUSTER) {
    if (cs < 2 || cs > 8 || (cs & (cs - 1))) return cudaErrorInvalidValue;
    const size_t smem = slice_bytes(L, cs);
    int clusters = 0;
    if ((e = active_clusters<Src>(cs, smem, &clusters)) != cudaSuccess)
      return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    long long grid_c = clusters;
    if (grid_c > cdiv(want, cs)) grid_c = cdiv(want, cs);
    // more clusters (run in waves) rather than a cluster whose cells
    // could overflow: its rows all land in one table
    if (grid_c < cdiv(n, ROWS_PER_TABLE)) grid_c = cdiv(n, ROWS_PER_TABLE);
    if (grid_c < 1) grid_c = 1;
    if (grid_c * cs > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(grid_c * cs));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((e = cudaLaunchKernelEx(&cfg, twolevel_kernel<Src, ROUTE_CLUSTER>,
                                src, L, n, S8, Sf)) != cudaSuccess)
      return e;
    return cudaGetLastError();
  }
  const bool shared = route == ROUTE_SHARED;
  const size_t smem = shared ? slice_bytes(L, 1) : 0;
  const void* kern =
      shared ? (const void*)twolevel_kernel<Src, ROUTE_SHARED>
             : (const void*)twolevel_kernel<Src, ROUTE_GLOBAL>;
  if (shared && (e = cudaFuncSetAttribute(
                     kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     (int)smem)) != cudaSuccess)
    return e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         THREADS, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = want;
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  // more blocks (run in waves) rather than a block whose cells could
  // overflow
  if (shared && grid < cdiv(n, ROWS_PER_TABLE)) grid = cdiv(n, ROWS_PER_TABLE);
  if (grid < 1) grid = 1;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (shared)
    twolevel_kernel<Src, ROUTE_SHARED>
        <<<(unsigned)grid, THREADS, smem, st>>>(src, L, n, S8, Sf);
  else
    twolevel_kernel<Src, ROUTE_GLOBAL>
        <<<(unsigned)grid, THREADS, 0, st>>>(src, L, n, S8, Sf);
  return cudaGetLastError();
}

// An entry reports an error by its return value.  A refused call also
// leaves the error as the runtime's last error; clear it, or the next
// launch's check (ours or another library's) would report it again.
static int reported(cudaError_t e) {
  if (e != cudaSuccess) (void)cudaGetLastError();
  return e;
}

static bool layout_ok(int lo_shift, int HI, int d8, int df) {
  return lo_shift >= 0 && lo_shift <= 10 && HI >= 1 && d8 >= 1 &&
         d8 <= MAX_PLANES && df >= 0 && df <= MAX_PLANES &&
         ((long long)HI << lo_shift) < (1LL << 30);
}

extern "C" {

// Largest dynamic shared memory one block may opt into on `device`.
int twolevel_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// How many clusters of `cs` blocks, each with `smem` bytes of dynamic
// shared memory, the card can hold at once for `source`'s cluster kernel
// (cudaOccupancyMaxActiveClusters).  Returns a CUDA error code.
int twolevel_active_clusters(int device, int source, int cs, long long smem,
                             int* clusters) {
  *clusters = 0;
  if (cs < 2 || cs > 8 || smem < 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return reported(e);
  return reported(active_clusters_of(source, cs, (size_t)smem, clusters));
}

// Add the sums over materialized planes, rows [0, n), into S8/Sf on
// `stream` (asynchronous; no allocation; the caller zeroes the outputs).
// `route`/`cs` as chosen by the launcher.  Returns cudaGetLastError()
// after the launch: 0 on success.
int twolevel_launch(int device, const void* idx, const void* L8,
                    const void* Lf, long long n, int p8, int pf, int lo_shift,
                    int HI, int route, int cs, void* S8, void* Sf,
                    void* stream) {
  if (n < 0 || !layout_ok(lo_shift, HI, p8, pf) ||
      (pf > 0 && (Lf == nullptr || Sf == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return reported(e);
  if (n == 0) return cudaSuccess;
  Layout L = {};
  L.lo_shift = lo_shift, L.HI = HI, L.d8 = p8, L.df = pf;
  L.w8 = p8 << lo_shift, L.wf = pf << lo_shift;
  for (int p = 0; p < p8; ++p) L.out8[p] = p;
  for (int p = 0; p < pf; ++p) L.outf[p] = p;
  const PlaneSource src{(const int*)idx, (const signed char*)L8,
                        (const float*)Lf, p8, pf};
  return reported(run(device, src, L, n, route, cs,
                      (unsigned long long*)S8, (double*)Sf,
                      (cudaStream_t)stream));
}

// Add the sums over the raw columns, rows [0, n), into S8/Sf and set
// *overflow (int32) where a live dense key leaves [0, capacity), on
// `stream` (asynchronous; no allocation; the caller zeroes the outputs).
// Lane l: values[l], ok[l] and meta[6l..6l+5] = kind, nb, ok_plane,
// ok_out, val_plane, val_out.  out8[d] / outf[e]: the output plane of
// distinct plane d / e.  Returns cudaGetLastError() after the launch.
int twolevel_fused_launch(int device, int source, const void* key,
                          const void* key_ok, const void* mask,
                          long long base, int capacity, long long n,
                          int n_lanes, void** values, void** ok,
                          const int* meta, int lo_shift, int HI, int p8,
                          int pf, int d8, int df, const int* out8,
                          const int* outf, int route, int cs, void* S8,
                          void* Sf, void* overflow, void* stream) {
  if (n < 0 || n_lanes < 1 || n_lanes > MAX_LANES || capacity < 1 ||
      key == nullptr || !layout_ok(lo_shift, HI, d8, df) || p8 < d8 ||
      pf < df || p8 > MAX_PLANES || pf > MAX_PLANES ||
      (df > 0 && Sf == nullptr) ||
      (source != SRC_SPARSE && overflow == nullptr) ||
      ((long long)HI << lo_shift) < (long long)capacity + 2)
    return cudaErrorInvalidValue;
  Layout L = {};
  L.lo_shift = lo_shift, L.HI = HI, L.d8 = d8, L.df = df;
  L.w8 = p8 << lo_shift, L.wf = pf << lo_shift;
  for (int d = 0; d < d8; ++d) {
    if (out8[d] < 0 || out8[d] >= p8) return cudaErrorInvalidValue;
    L.out8[d] = out8[d];
  }
  for (int d = 0; d < df; ++d) {
    if (outf[d] < 0 || outf[d] >= pf) return cudaErrorInvalidValue;
    L.outf[d] = outf[d];
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return reported(e);
  if (n == 0) return cudaSuccess;
  unsigned long long* s8 = (unsigned long long*)S8;
  double* sf = (double*)Sf;
  cudaStream_t st = (cudaStream_t)stream;
  auto fill = [&](auto& src) -> cudaError_t {
    src.key = key;
    src.key_ok = (const unsigned char*)key_ok;
    src.mask = (const unsigned char*)mask;
    src.base = base;
    src.capacity = capacity;
    src.n_lanes = n_lanes;
    src.overflow = (int*)overflow;
    for (int l = 0; l < n_lanes; ++l) {
      const int* m = meta + 6 * l;
      Lane& ln = src.lanes[l];
      ln = {values[l], (const unsigned char*)ok[l], m[0], m[1], m[2], m[3],
            m[4], m[5]};
      const bool has_values = ln.kind != LANE_COUNT;
      if (ln.kind < LANE_COUNT || ln.kind > LANE_REAL ||
          has_values != (ln.values != nullptr) ||
          ((ln.kind == LANE_INT32 || ln.kind == LANE_INT64) &&
           (ln.nb < 1 || ln.nb > 8 || ln.val_plane < 0 ||
            ln.val_plane + ln.nb > d8 || ln.val_out < 0 ||
            ln.val_out + ln.nb > p8)) ||
          (ln.kind == LANE_REAL &&
           (ln.val_plane < 0 || ln.val_plane >= df || ln.val_out < 0 ||
            ln.val_out >= pf)) ||
          ln.ok_plane >= d8 || (ln.ok_plane >= 0 && ln.ok_out >= p8))
        return cudaErrorInvalidValue;
    }
    return run(device, src, L, n, route, cs, s8, sf, st);
  };
  switch (source) {
    case SRC_DENSE32: {
      FusedSource<SRC_DENSE32> src = {};
      return reported(fill(src));
    }
    case SRC_DENSE64: {
      FusedSource<SRC_DENSE64> src = {};
      return reported(fill(src));
    }
    case SRC_SPARSE: {
      FusedSource<SRC_SPARSE> src = {};
      return reported(fill(src));
    }
  }
  return cudaErrorInvalidValue;
}

const char* twolevel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

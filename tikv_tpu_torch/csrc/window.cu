// The window functions of a sorted view for Hopper (window_scan):
// partition heads, row_number, segmented running COUNT and int64 SUM, and
// LAG / LEAD, over rows already ordered by sort_perm (csrc/sort.cu).
//
// Replaces the scan half of the XLA kernel tikv_tpu/device/join.py
// window (:508); its sort half is sort_perm.  Row i of the view is source
// row perm[i].  A row is a partition head when it is row 0 or a partition
// key differs from the row before (!=, so two NaN keys differ and -0.0
// equals +0.0, as jnp compares); seg_start[i] is the last head at or
// before i (a max-scan of head positions); row_number is i - seg_start[i]
// + 1.  A running channel is the inclusive sum from the segment's head of
// ok (a count) or of ok ? v : 0 (an int64 sum, wrapping as jnp's cumsum
// does).  LAG(off) / LEAD(off) read row src = i -/+ off of the view when
// it lies in the same segment (src >= seg_start[i] for LAG; no head in
// (i, src], i.e. seg_start[src] <= i, for LEAD) and its argument is not
// NULL; else 0 and not valid.  Outputs are the reference's (join.py:
// 589-601): rn, each channel, and each shift's values and validity.  A
// REAL running sum never reaches here: the reference keeps it on the host.
//
// Four kernels: a tile pass (1024 rows a block, 4 consecutive rows a
// thread) that reduces each tile to its last head and, per channel, the
// sum since that head; a one-block carry pass that scans the tiles in
// order under the segmented operator ((f, a), (g, b)) -> (f | g, g ? b :
// a + b) (and max for the heads); the emit pass, which recomputes a tile,
// scans it within the block from its carry and writes seg_start, rn and
// the channels; and the shift pass for LAG / LEAD, which needs seg_start
// of another row.  Block scans are CUB's (scan.cuh).
//
// Bound: bytes.  The permutation and each partition key, channel and
// shift argument are read once (keys, values and validity through the
// permutation: gathers), the outputs written once; at cell 7w
// (10,485,760 rows; one int64 partition key; rn, one count and one sum
// channel, which its COUNT, SUM and AVG share, and two shifts) about
// 0.66 GB, 0.20 ms.  The gathers of partition keys and arguments by perm
// are random reads: whole 32-byte sectors for 8 bytes each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define THREADS 256
#define ITEMS 4
#define TILE (THREADS * ITEMS)
#define MAX_PART 8
#define MAX_CH 16
#define MAX_SH 16

enum { CH_COUNT = 0, CH_SUM = 1 };

// window_scan's launch parameters (device/window.py mirrors the layout).
// Scratch: seg_start int32[n], tile_head int32[n_tiles], tile_agg
// int64[MAX_CH][n_tiles].
struct WindowParams {
  long long n;
  const int* perm;
  int n_part;
  const void* part[MAX_PART];
  int part_f64[MAX_PART];
  long long* rn;  // null: not asked for
  int n_ch;
  int ch_kind[MAX_CH];
  const long long* ch_v[MAX_CH];
  const unsigned char* ch_ok[MAX_CH];
  long long* ch_out[MAX_CH];
  int n_sh;
  int sh_off[MAX_SH];  // negative: LAG, positive: LEAD
  const long long* sh_v[MAX_SH];  // 8-byte values (int64 or float64 bits)
  const unsigned char* sh_ok[MAX_SH];
  long long* sh_out[MAX_SH];
  unsigned char* sh_valid[MAX_SH];
  int* seg_start;
  int* tile_head;
  long long* tile_agg;
  int n_tiles;
};

namespace {

struct Seg {
  int f;        // a head lies in the span
  long long v;  // the sum since the span's last head (or over the span)
};

struct SegOp {
  __device__ Seg operator()(Seg a, Seg b) const {
    Seg r;
    r.f = a.f | b.f;
    r.v = b.f ? b.v : a.v + b.v;
    return r;
  }
};

struct MaxI {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

__device__ __forceinline__ bool is_head(const WindowParams& p, long long i) {
  if (i == 0) return true;
  const int a = p.perm[i], b = p.perm[i - 1];
  for (int k = 0; k < p.n_part; ++k) {
    if (p.part_f64[k]) {
      const double* x = static_cast<const double*>(p.part[k]);
      if (x[a] != x[b]) return true;
    } else {
      const long long* x = static_cast<const long long*>(p.part[k]);
      if (x[a] != x[b]) return true;
    }
  }
  return false;
}

__device__ __forceinline__ long long channel_value(const WindowParams& p,
                                                   int c, int src) {
  if (!p.ch_ok[c][src]) return 0;
  return p.ch_kind[c] == CH_COUNT ? 1 : p.ch_v[c][src];
}

__global__ void __launch_bounds__(THREADS) tile_kernel(WindowParams p) {
  const long long start = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  int last = -1;
  bool head[ITEMS];
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = start + j;
    head[j] = i < p.n && is_head(p, i);
    if (head[j]) last = (int)i;
  }
  int tmax;
  block_exclusive_scan<THREADS>(last, MaxI(), -1, &tmax);
  if (threadIdx.x == 0) p.tile_head[blockIdx.x] = tmax;
  for (int c = 0; c < p.n_ch; ++c) {
    Seg s = {0, 0};
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = start + j;
      if (i >= p.n) break;
      const long long v = channel_value(p, c, p.perm[i]);
      if (head[j]) {
        s.f = 1;
        s.v = v;
      } else {
        s.v += v;
      }
    }
    Seg tot;
    block_exclusive_scan<THREADS>(s, SegOp(), Seg{0, 0}, &tot);
    if (threadIdx.x == 0)
      p.tile_agg[(long long)c * p.n_tiles + blockIdx.x] = tot.v;
  }
}

// one block: tile_head becomes the exclusive max-scan of the tiles' last
// heads, tile_agg each channel's exclusive segmented scan (the carry into
// each tile)
__global__ void __launch_bounds__(THREADS) carry_kernel(WindowParams p) {
  int hcarry = -1;
  Seg carry[MAX_CH];
  for (int c = 0; c < p.n_ch; ++c) carry[c] = Seg{0, 0};
  for (int base = 0; base < p.n_tiles; base += THREADS) {
    const int t = base + threadIdx.x;
    const int h = t < p.n_tiles ? p.tile_head[t] : -1;
    // a tile holds a head iff its last head is one of its own rows
    const int f = h >= 0 && (long long)h >= (long long)t * TILE;
    for (int c = 0; c < p.n_ch; ++c) {
      long long* agg = p.tile_agg + (long long)c * p.n_tiles;
      const Seg s = {f, t < p.n_tiles ? agg[t] : 0};
      Seg tot;
      const Seg ex =
          block_exclusive_scan<THREADS>(s, SegOp(), Seg{0, 0}, &tot);
      if (t < p.n_tiles) agg[t] = SegOp()(carry[c], ex).v;
      carry[c] = SegOp()(carry[c], tot);
    }
    int hmax;
    const int hex = block_exclusive_scan<THREADS>(h, MaxI(), -1, &hmax);
    if (t < p.n_tiles) p.tile_head[t] = hcarry > hex ? hcarry : hex;
    hcarry = hcarry > hmax ? hcarry : hmax;
  }
}

__global__ void __launch_bounds__(THREADS) emit_kernel(WindowParams p) {
  const long long start = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  int last = -1;
  bool head[ITEMS];
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = start + j;
    head[j] = i < p.n && is_head(p, i);
    if (head[j]) last = (int)i;
  }
  int tmax;
  const int hex = block_exclusive_scan<THREADS>(last, MaxI(), -1, &tmax);
  int cur = p.tile_head[blockIdx.x] > hex ? p.tile_head[blockIdx.x] : hex;
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = start + j;
    if (i >= p.n) break;
    if (head[j]) cur = (int)i;
    p.seg_start[i] = cur;
    if (p.rn != nullptr) p.rn[i] = i - cur + 1;
  }
  for (int c = 0; c < p.n_ch; ++c) {
    Seg s = {0, 0};
    long long v[ITEMS];
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = start + j;
      v[j] = i < p.n ? channel_value(p, c, p.perm[i]) : 0;
      if (head[j]) {
        s.f = 1;
        s.v = v[j];
      } else {
        s.v += v[j];
      }
    }
    Seg tot;
    const Seg ex =
        block_exclusive_scan<THREADS>(s, SegOp(), Seg{0, 0}, &tot);
    Seg run = SegOp()(
        Seg{0, p.tile_agg[(long long)c * p.n_tiles + blockIdx.x]}, ex);
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = start + j;
      if (i >= p.n) break;
      run.v = head[j] ? v[j] : run.v + v[j];
      p.ch_out[c][i] = run.v;
    }
  }
}

__global__ void __launch_bounds__(THREADS) shift_kernel(WindowParams p) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < p.n;
       i += stride) {
    for (int k = 0; k < p.n_sh; ++k) {
      const long long src = i + p.sh_off[k];
      bool ok = src >= 0 && src < p.n;
      if (ok)
        ok = p.sh_off[k] < 0 ? src >= p.seg_start[i] : p.seg_start[src] <= i;
      long long v = 0;
      if (ok) {
        const int row = p.perm[src];
        ok = p.sh_ok[k][row] != 0;
        if (ok) v = p.sh_v[k][row];
      }
      p.sh_out[k][i] = v;
      p.sh_valid[k][i] = ok ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// n >= 1
int window_scan_launch(int device, const WindowParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p->n < 1 || p->n_part > MAX_PART || p->n_ch > MAX_CH ||
      p->n_sh > MAX_SH || p->n_tiles != (int)((p->n + TILE - 1) / TILE))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_kernel<<<p->n_tiles, THREADS, 0, s>>>(*p);
  carry_kernel<<<1, THREADS, 0, s>>>(*p);
  emit_kernel<<<p->n_tiles, THREADS, 0, s>>>(*p);
  if (p->n_sh > 0) {
    long long blocks = (p->n + THREADS - 1) / THREADS;
    if (blocks > 4096) blocks = 4096;
    shift_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(*p);
  }
  return cudaGetLastError();
}

int window_params_bytes() { return (int)sizeof(WindowParams); }
int window_tile_rows() { return TILE; }

const char* window_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

// The window functions of a sorted view for Hopper (window_scan):
// partition heads, row_number, segmented running COUNT and int64 SUM, and
// LAG / LEAD, over rows already ordered by sort_perm (csrc/sort.cu).
//
// Replaces the scan half of the XLA kernel tikv_tpu/device/join.py
// window (:508); its sort half is sort_perm.  Row i of the view is source
// row perm[i].  A row is a partition head when it is row 0 or a partition
// key differs from the row before (!=, so two NaN keys differ and -0.0
// equals +0.0, as jnp compares); seg_start[i] is the last head at or
// before i; row_number is i - seg_start[i] + 1.  A running channel is the
// inclusive sum from the segment's head of ok (a count) or of ok ? v : 0
// (an int64 sum, wrapping as jnp's cumsum does).  LAG(off) / LEAD(off)
// read row src = i -/+ off of the view when it lies in the same segment
// (src >= seg_start[i] for LAG; seg_start[src] <= i for LEAD: no head in
// (i, src]) and its argument is not NULL; else 0 and not valid.  Outputs
// are the reference's (join.py:589-601): rn, each channel, and each
// shift's values and validity.  A REAL running sum never reaches here: the
// reference keeps it on the host.
//
// Design: one pass, window_kernel, with decoupled look-back. A block takes a
// tile index from an atomic counter (so it waits only on tiles already running)
// and stages the tile's slice of perm in shared memory, with a halo of the
// largest LAG offset before it and of the largest LEAD offset after it (each at
// most CAP) and the row before the first. Through it, each partition key is
// gathered once a row into shared memory (plus the halo), and a row is a head
// when its key differs from its neighbour's; then each distinct argument (a
// values column and its validity; a COUNT over the same validity rides with it)
// is gathered once a row: its channels are block scans under the segmented
// operator ((f, a), (g, b)) -> (f | g, g ? b : a + b) over blocked rows, staged
// in shared memory and stored striped (coalesced) as the tile's partial sums;
// its LAG / LEAD read the halo in shared memory, striped, the same-segment test
// a difference of running head counts. As soon as its channels are summed the
// tile publishes (its last head, each channel's sum since it); at its end it
// looks back over the tiles before it until it meets one that holds a head or
// an inclusive value (a head in a later tile settles everything before it),
// then writes row_number and adds the carry to the rows before its first head.
// The 8-byte columns and perm are read with the evict-first hint, so the
// validity columns stay in L2. A shift past CAP takes a second, coalesced pass
// (far_kernel) over the view-order copies of its argument and seg_start that
// the first pass writes. Block scans are CUB's (scan.cuh).
//
// Bound: bytes.  The permutation and each partition key, channel and
// shift argument read once (keys, values and validity through the
// permutation: gathers), the outputs written once; at cell 7w (10,485,760
// rows; one int64 partition key; rn, one count and one sum channel, which
// its COUNT, SUM and AVG share, and two shifts) about 0.66 GB, 0.20 ms.
// The gathers are random reads of whole 32-byte sectors: this pass reads
// the three columns (k, v, ok) once each, about 1.5 GB in all at 7w.  On
// an H100 a tile's time goes mostly to those gathers (PERF.md): random
// sectors, not the scans, bound it, and more resident blocks (fewer
// registers) made it slower, not faster.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define THREADS 256
#define ITEMS 5                      // odd: 8-byte shared reads spread
#define TILE (THREADS * ITEMS)
#define MIN_BLOCKS 3                 // resident blocks an SM: registers
#define CAP 64                       // the largest offset a halo serves
#define WIN (TILE + 2 * CAP + 1)     // a tile's rows with both halos
#define MAX_PART 8
#define MAX_CH 16
#define MAX_SH 16
#define MAX_ARG 32                   // MAX_CH + MAX_SH: never short

enum { CH_COUNT = 0, CH_SUM = 1 };
enum { TILE_AGG = 1, TILE_INCL = 2 };

// window_scan's launch parameters (device/window.py mirrors the layout).
// Scratch: flags int32[n_tiles + 1] (zeroed here: each tile's state, then
// the tile counter), agg and incl int64[n_tiles x (1 + n_ch)] (a tile's
// last head and channel sums, its own and over tiles [0, tile]); for a
// shift past CAP, seg_start int32[n] and its argument's view-order copies.
struct WindowParams {
  long long n;
  const int* perm;
  int n_part;
  const void* part[MAX_PART];
  int part_f64[MAX_PART];
  long long* rn;  // null: not asked for
  int n_arg;
  const long long* arg_v[MAX_ARG];  // 8-byte values; null: validity only
  const unsigned char* arg_ok[MAX_ARG];
  long long* arg_vcopy[MAX_ARG];    // null unless a shift past CAP reads it
  unsigned char* arg_okcopy[MAX_ARG];
  int n_ch;
  int ch_kind[MAX_CH];
  int ch_arg[MAX_CH];
  long long* ch_out[MAX_CH];
  int n_sh;
  int sh_off[MAX_SH];  // negative: LAG, positive: LEAD
  int sh_arg[MAX_SH];
  long long* sh_out[MAX_SH];
  unsigned char* sh_valid[MAX_SH];
  int lag_halo;   // the largest |offset| of a LAG within CAP (0: none)
  int lead_halo;  // the same for LEAD
  int* seg_start;
  int* flags;
  long long* agg;
  long long* incl;
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

__host__ __device__ __forceinline__ int far_off(int off) {
  return off > CAP || off < -CAP;
}

__device__ __forceinline__ long long ld_volatile(const long long* a) {
  return *reinterpret_cast<const volatile long long*>(a);
}

// dst[w] = col[sp[w]] (and dst_ok[w] = ok[sp[w]] when ok is set; col may
// then be null) for window rows w in [lo, hi); the 8-byte columns stream
// through L2 (evict first), so the validity columns, an eighth of their
// size, stay there
__device__ __forceinline__ void gather(long long* dst, const long long* col,
                                       unsigned char* dst_ok,
                                       const unsigned char* ok,
                                       const int* sp, int lo, int hi) {
  for (int w = lo + (int)threadIdx.x; w < hi; w += THREADS) {
    const int src = sp[w];
    if (col != nullptr) dst[w] = __ldcs(col + src);
    if (ok != nullptr) dst_ok[w] = ok[src];
  }
}

// thread 0: the tile's own (last head, channel sums), then its flag (tile
// 0 publishes only its inclusive value)
__device__ __forceinline__ void publish_agg(const WindowParams& p,
                                            long long tile, int tail,
                                            const long long* tot) {
  if (threadIdx.x != 0 || tile == 0) return;
  long long* mine = p.agg + tile * (1 + p.n_ch);
  mine[0] = tail;
  for (int c = 0; c < p.n_ch; ++c) mine[1 + c] = tot[c];
  __threadfence();
  *reinterpret_cast<volatile int*>(&p.flags[tile]) = TILE_AGG;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    window_kernel(const __grid_constant__ WindowParams p) {
  __shared__ int s_perm[WIN];
  __shared__ long long s_val[WIN];
  __shared__ unsigned char s_ok[WIN];
  __shared__ unsigned char s_head[WIN];
  __shared__ short s_hc[WIN];          // heads in window rows [1, w]
  __shared__ int s_ss[TILE];           // a row's last head in the tile, -1
  __shared__ long long s_out[TILE];    // a channel's rows, to store striped
  __shared__ long long s_tot[MAX_CH];
  __shared__ long long s_carry[1 + MAX_CH];
  __shared__ int s_tile;
  const int t = threadIdx.x;
  const long long n = p.n;
  if (t == 0) s_tile = atomicAdd(&p.flags[p.n_tiles], 1);
  __syncthreads();
  const long long tile = s_tile;
  const long long start = tile * TILE;
  const long long end = start + TILE < n ? start + TILE : n;
  const int rows = (int)(end - start);
  // the window: rows [wlo - 1, whi) at w = row - wlo + 1
  const long long wlo = start - p.lag_halo > 0 ? start - p.lag_halo : 0;
  const long long whi = end + p.lead_halo < n ? end + p.lead_halo : n;
  const int wn = (int)(whi - wlo + 1);
  const int w_start = (int)(start - wlo + 1);  // the tile's first row
  const bool near = p.lag_halo > 0 || p.lead_halo > 0;
  for (int w = t; w < wn; w += THREADS) {
    const long long g = wlo - 1 + w;
    s_perm[w] = g >= 0 ? __ldcs(p.perm + g) : 0;
    s_head[w] = g == 0;
  }
  __syncthreads();
  // heads over the window's rows: a key differs from the row before
  for (int k = 0; k < p.n_part; ++k) {
    gather(s_val, static_cast<const long long*>(p.part[k]), nullptr,
           nullptr, s_perm, wlo > 0 ? 0 : 1, wn);
    __syncthreads();
    for (int w = 1 + t; w < wn; w += THREADS) {
      if (wlo - 1 + w < 1) continue;
      const long long a = s_val[w], b = s_val[w - 1];
      const bool differ =
          p.part_f64[k] ? __longlong_as_double(a) != __longlong_as_double(b)
                        : a != b;
      if (differ) s_head[w] = 1;
    }
    __syncthreads();
  }
  if (near) {  // running head counts over window rows 1 .. wn - 1
    const int per = (wn - 1 + THREADS - 1) / THREADS;
    const int b = 1 + t * per;
    int c = 0;
    for (int j = 0; j < per; ++j)
      if (b + j < wn) c += s_head[b + j];
    int all;
    int run = block_exclusive_scan<THREADS>(c, Add<int>(), 0, &all);
    for (int j = 0; j < per; ++j)
      if (b + j < wn) {
        run += s_head[b + j];
        s_hc[b + j] = (short)run;
      }
    if (t == 0) s_hc[0] = 0;
  }
  // the scans run over blocked rows: thread t's are tile rows t * ITEMS + j
  const int i0 = t * ITEMS;
  unsigned heads = 0;
  int last = -1;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (i0 + j < rows && s_head[w_start + i0 + j]) {
      heads |= 1u << j;
      last = (int)(start + i0 + j);
    }
  int tail;  // the tile's last head (-1: none)
  const int before = block_exclusive_scan<THREADS>(last, MaxI(), -1, &tail);
  {
    int cur = before;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (i0 + j >= rows) break;
      if ((heads >> j) & 1u) cur = (int)(start + i0 + j);
      s_ss[i0 + j] = cur;  // -1: before the tile's first head
    }
  }
  // the tile's own value is published as soon as its channels are summed
  // (before its shifts and stores), so the tiles after it wait less
  int last_ch_arg = -1;
  for (int c = 0; c < p.n_ch; ++c)
    last_ch_arg = p.ch_arg[c] > last_ch_arg ? p.ch_arg[c] : last_ch_arg;
  if (last_ch_arg < 0) publish_agg(p, tile, tail, s_tot);
  for (int a = 0; a < p.n_arg; ++a) {
    bool shifted = false;
    for (int s = 0; s < p.n_sh; ++s)
      shifted = shifted || (p.sh_arg[s] == a && !far_off(p.sh_off[s]));
    __syncthreads();  // the previous column's readers are done
    gather(s_val, p.arg_v[a], s_ok, p.arg_ok[a], s_perm,
           shifted ? 1 : w_start, shifted ? wn : w_start + rows);
    __syncthreads();
    for (int c = 0; c < p.n_ch; ++c) {
      if (p.ch_arg[c] != a) continue;
      const bool count = p.ch_kind[c] == CH_COUNT;
      Seg sg = {0, 0};
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (i0 + j >= rows) break;
        const int w = w_start + i0 + j;
        const long long x = s_ok[w] ? (count ? 1 : s_val[w]) : 0;
        if ((heads >> j) & 1u) {
          sg.f = 1;
          sg.v = x;
        } else {
          sg.v += x;
        }
      }
      Seg tot;
      long long run =
          block_exclusive_scan<THREADS>(sg, SegOp(), Seg{0, 0}, &tot).v;
      if (t == 0) s_tot[c] = tot.v;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (i0 + j >= rows) break;
        const int w = w_start + i0 + j;
        const long long x = s_ok[w] ? (count ? 1 : s_val[w]) : 0;
        run = ((heads >> j) & 1u) ? x : run + x;
        s_out[i0 + j] = run;  // rows before the first head: partial
      }
      __syncthreads();
      long long* out = p.ch_out[c] + start;
      for (int i = t; i < rows; i += THREADS) out[i] = s_out[i];
      __syncthreads();  // before the next channel's rows
    }
    if (a == last_ch_arg) publish_agg(p, tile, tail, s_tot);
    // shifts and copies run over striped rows: coalesced stores
    for (int s = 0; s < p.n_sh; ++s) {
      const int off = p.sh_off[s];
      if (p.sh_arg[s] != a || far_off(off)) continue;
      for (int i = t; i < rows; i += THREADS) {
        const long long r = start + i;
        const long long src = r + off;
        bool valid = src >= 0 && src < n;
        long long x = 0;
        if (valid) {
          const int ws = (int)(src - wlo + 1);
          // no head in (min(r, src), max(r, src)]
          valid = s_hc[ws] == s_hc[w_start + i] && s_ok[ws] != 0;
          if (valid) x = s_val[ws];
        }
        p.sh_out[s][r] = x;
        p.sh_valid[s][r] = valid ? 1 : 0;
      }
    }
    if (p.arg_vcopy[a] != nullptr)
      for (int i = t; i < rows; i += THREADS) {
        p.arg_vcopy[a][start + i] = s_val[w_start + i];
        p.arg_okcopy[a][start + i] = s_ok[w_start + i];
      }
  }
  __syncthreads();
  // publish, look back, carry (thread 0): s_carry gets the last head
  // before the tile and each channel's running value at its end
  if (t == 0) {
    const int S = 1 + p.n_ch;
    for (int c = 0; c < p.n_ch; ++c) s_carry[1 + c] = 0;
    s_carry[0] = -1;
    if (tile > 0) {
      // the tiles before: their sums add up until one holds a head (an
      // inclusive value always does)
      for (long long j = tile - 1; s_carry[0] < 0;) {
        const int fl = *reinterpret_cast<volatile int*>(&p.flags[j]);
        if (fl == 0) continue;
        __threadfence();
        const long long* src = (fl == TILE_INCL ? p.incl : p.agg) + j * S;
        for (int c = 0; c < p.n_ch; ++c)
          s_carry[1 + c] += ld_volatile(src + 1 + c);
        s_carry[0] = ld_volatile(src);
        --j;
      }
    }
    long long* inc = p.incl + tile * S;
    inc[0] = tail >= 0 ? tail : s_carry[0];
    for (int c = 0; c < p.n_ch; ++c)
      inc[1 + c] = s_tot[c] + (tail >= 0 ? 0 : s_carry[1 + c]);
    __threadfence();
    *reinterpret_cast<volatile int*>(&p.flags[tile]) = TILE_INCL;
  }
  __syncthreads();
  // every row's segment start; the rows before the first head take the
  // carry
  const long long carry_head = s_carry[0];
  for (int i = t; i < rows; i += THREADS) {
    const long long r = start + i;
    const int ss = s_ss[i];
    const long long head = ss >= 0 ? ss : carry_head;
    if (p.rn != nullptr) p.rn[r] = r - head + 1;
    if (p.seg_start != nullptr) p.seg_start[r] = (int)head;
    if (ss < 0)
      for (int c = 0; c < p.n_ch; ++c) p.ch_out[c][r] += s_carry[1 + c];
  }
}

// the shifts past CAP, over the view-order copies and seg_start
__global__ void __launch_bounds__(THREADS)
    far_kernel(const __grid_constant__ WindowParams p) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < p.n;
       i += stride) {
    for (int s = 0; s < p.n_sh; ++s) {
      const int off = p.sh_off[s];
      if (!far_off(off)) continue;
      const int a = p.sh_arg[s];
      const long long src = i + off;
      bool valid = src >= 0 && src < p.n;
      if (valid)
        valid = off < 0 ? src >= p.seg_start[i] : p.seg_start[src] <= i;
      long long x = 0;
      if (valid) {
        valid = p.arg_okcopy[a][src] != 0;
        if (valid) x = p.arg_vcopy[a][src];
      }
      p.sh_out[s][i] = x;
      p.sh_valid[s][i] = valid ? 1 : 0;
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
      p->n_sh > MAX_SH || p->n_arg > MAX_ARG || p->lag_halo < 0 ||
      p->lag_halo > CAP || p->lead_halo < 0 || p->lead_halo > CAP ||
      p->n_tiles != (int)((p->n + TILE - 1) / TILE))
    return cudaErrorInvalidValue;
  bool far = false;
  for (int s = 0; s < p->n_sh; ++s) {
    if (p->sh_arg[s] < 0 || p->sh_arg[s] >= p->n_arg ||
        p->arg_v[p->sh_arg[s]] == nullptr)
      return cudaErrorInvalidValue;
    if (far_off(p->sh_off[s])) {
      far = true;
      if (p->seg_start == nullptr || p->arg_vcopy[p->sh_arg[s]] == nullptr)
        return cudaErrorInvalidValue;
    }
  }
  for (int c = 0; c < p->n_ch; ++c)
    if (p->ch_arg[c] < 0 || p->ch_arg[c] >= p->n_arg ||
        (p->ch_kind[c] == CH_SUM && p->arg_v[p->ch_arg[c]] == nullptr))
      return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(p->flags, 0, sizeof(int) * (p->n_tiles + 1),
                           s)) != cudaSuccess)
    return e;
  window_kernel<<<p->n_tiles, THREADS, 0, s>>>(*p);
  if (far) {
    long long blocks = (p->n + THREADS - 1) / THREADS;
    if (blocks > 4096) blocks = 4096;
    far_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(*p);
  }
  return cudaGetLastError();
}

int window_params_bytes() { return (int)sizeof(WindowParams); }
int window_tile_rows() { return TILE; }
int window_halo_cap() { return CAP; }

const char* window_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

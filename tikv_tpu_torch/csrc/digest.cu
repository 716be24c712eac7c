// Plane digests and row patches for Hopper: the scrub's re-hash of a
// resident feed plane (plane_digest), the arrival check of a migrated feed
// (feed_verify: every plane's digest in one launch) and the in-place write
// of a few rows of one plane with the digests of what they held and now
// hold (patch_rows).
//
// Replaces the XLA kernels of tikv_tpu/device/runner.py:
//   plane_digest <- _range_digest_kernel (:1981): sum of bits(x[i]) * (2i+1)
//                   mod 2^64 over the global positions [lo, hi) of one
//                   plane; a bool reads as 0/1, any other dtype as the
//                   unsigned view of its own width, widened to 64 bits;
//   feed_verify  <- install_feeds (:2108-2166): the arrival side of a
//                   feed's move between mesh slices re-hashes every plane
//                   with _range_digest_kernel (:1981), one launch and one
//                   host sync a plane (:2130-2135); here all P planes of
//                   the feed in one launch, blockIdx.y the plane, and one
//                   copy of P digests;
//   patch_rows   <- _dus (:1816) and the DeviceMvccResolver's dus
//                   (device/mvcc.py:514): a slice update at a traced
//                   offset, there one launch per spill row and plane; here
//                   m unique positions of every plane of a feed that
//                   shares them in one launch (blockIdx.y the plane).
//                   With digests on, the same pass returns for each plane
//                   the two range digests _patch_plane (:1793) takes
//                   around each span (over the positions written, before
//                   and after) and the recorded digest updated by its rule
//                   R' = R - H(old) + H(new); corrupt_resident_plane
//                   (:2023) is a one-row patch.  The span form, the rows
//                   named by K span descriptors in place of the
//                   positions, is what a delta journal patch launches.
//
// Bound: bytes.  plane_digest reads the plane once: 4 B x 104,857,600 rows
// is 0.125 ms at 3.35 TB/s.  Each thread takes 16-byte chunks of the
// aligned interior (16 / width elements each) in a grid-stride loop with
// one u64 accumulator; the elements before the first 16-byte boundary and
// after the last whole chunk are taken one by one.  A warp reduction, a
// block reduction in shared memory and one wrapping 64-bit atomicAdd per
// block finish the sum: addition mod 2^64 commutes, so the result does not
// depend on the order.  The 64-bit multiply per element costs a few
// integer instructions; at 1-byte planes that is 16 a chunk, still under
// the bytes' time.
// feed_verify reads the feed's live bytes once (3 int32 planes of 2^21
// rows: 24 MiB, 7.5 us at 3.35 TB/s): each block of row y sums its share
// of plane y's chunks exactly as plane_digest does and adds it into the
// plane's word with one atomicAdd, so every digest is bit-equal to
// plane_digest's.  The planes' descriptors (address, 16-byte interior,
// width) ride in the launch parameters up to PARAM_PLANES planes (3 KiB
// of the 4 KiB), else in a device table the wrapper copies from pinned
// memory on the launch stream.
// patch_rows reads m positions and m values of each of P planes and writes
// m elements of each (and reads m old ones when digests are asked for):
// kilobytes, so it is bound by its launch.  A call is one device
// operation where its positions, values, recorded digests and plane
// descriptors fit a parameter block (up to 4 KB: PatchArgs<N>, N sized to
// the request), which covers the runner's patches of a few rows; past
// that the payload is one copy from pinned memory, then the launch.  A
// plane whose m rows fit one block (PATCH_ROWS) reduces its two digests in
// that block, one warp-shuffle pass and at most one __syncthreads, and
// stores them with R' directly: no memset and no atomics.  More rows take
// several blocks a plane; each stores its partial in the call's own
// scratch (zeroed by the payload's copy) and the last block of the plane,
// by a ticket in that scratch, sums them.  The recorded digest R comes
// from the descriptor or from device memory (the previous patch's R'), so
// a patch never re-hashes the plane and a corruption already in it is not
// laundered into the record.
// Positions must be unique (the wrapper checks): a parallel scatter would
// not say which of two writes to one row wins.
// The span form is the same kernel over K sorted, disjoint row spans
// [lo, hi) of every plane of a feed, one launch whatever K and P: the form
// of _dus (:1816) the delta journal gives (its rows always come as spans,
// tikv_tpu/copr/region_cache.py:794 _merge_spans), with _patch_plane's
// range digests over each span and the same R' rule.  A span travels as a
// 16-byte descriptor (lo, len, prefix: the rows of the spans before it,
// where its values start) where the positions would lie, never as
// positions: the parameter block holds the plane descriptors and up to a
// few hundred spans beside the values, past that the payload is one copy
// from pinned memory.  Row i of the concatenation finds its span by a
// binary search over the prefixes (each thread's rows ascend, so each
// search starts at its last span), and writes row lo + (i - prefix).
// Bound: bytes, 2 x rows x the planes' widths plus the payload; at the
// journal's sizes (1 to 65,536 rows) it is bound by its launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ u64 warp_sum(u64 v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// adds the block's sum of `v` into *out (thread 0); every thread calls it
__device__ __forceinline__ void block_add(u64 v, u64* out) {
  __shared__ u64 part[THREADS / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? part[lane] : 0;
    v = warp_sum(v);
    if (lane == 0 && v != 0) atomicAdd(out, v);
  }
}

// the unsigned bits of element i of a plane of `width` bytes
__device__ __forceinline__ u64 bits_at(const unsigned char* base, int width,
                                       long long i) {
  switch (width) {
    case 1:
      return base[i];
    case 2:
      return reinterpret_cast<const unsigned short*>(base)[i];
    case 4:
      return reinterpret_cast<const unsigned*>(base)[i];
    default:
      return reinterpret_cast<const u64*>(base)[i];
  }
}

// the digest of one 16-byte chunk whose first element has position i0
template <int W>
__device__ __forceinline__ u64 chunk_digest(const uint4 c, long long i0) {
  const unsigned words[4] = {c.x, c.y, c.z, c.w};
  u64 s = 0;
  u64 w = 2 * (u64)i0 + 1;
#pragma unroll
  for (int j = 0; j < 16 / W; ++j) {
    u64 b;
    if (W == 8) {
      b = (u64)words[2 * j] | ((u64)words[2 * j + 1] << 32);
    } else if (W == 4) {
      b = words[j];
    } else {
      b = (words[(j * W) >> 2] >> (8 * ((j * W) & 3))) &
          ((W == 2) ? 0xffffu : 0xffu);
    }
    s += b * w;
    w += 2;
  }
  return s;
}

// Sum over [lo, hi) of bits(x[i]) * (2i + 1): elements [lo, a) and
// [b, hi) one by one, the chunks of [a, b) 16 bytes at a time (a and b on
// 16-byte boundaries of the plane's address).
template <int W>
__global__ void __launch_bounds__(THREADS)
    digest_kernel(const unsigned char* base, long long lo, long long a,
                  long long b, long long hi, u64* out) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  constexpr int E = 16 / W;  // elements per chunk
  u64 s = 0;
  const uint4* chunks = reinterpret_cast<const uint4*>(base + a * W);
  const long long n_chunks = (b - a) / E;
  for (long long c = tid; c < n_chunks; c += stride)
    s += chunk_digest<W>(chunks[c], a + c * E);
  // the ragged ends: fewer than E elements each
  const long long head = a - lo;
  if (tid < head) s += bits_at(base, W, lo + tid) * (2 * (u64)(lo + tid) + 1);
  if (tid < hi - b) s += bits_at(base, W, b + tid) * (2 * (u64)(b + tid) + 1);
  block_add(s, out);
}

}  // namespace

// one plane of a feed_verify launch: [lo, a) and [b, hi) element by
// element, the chunks of [a, b) 16 bytes at a time
struct VerifyPlane {
  const unsigned char* base;
  long long a;
  long long b;
  int width;
  int pad;
};

constexpr int PARAM_PLANES = 96;

struct VerifyParams {
  long long lo;
  long long hi;
  VerifyPlane planes[PARAM_PLANES];
};

namespace {

template <int W>
__device__ __forceinline__ u64 plane_sum(const VerifyPlane& pl, long long lo,
                                         long long hi, long long tid,
                                         long long stride) {
  constexpr int E = 16 / W;
  u64 s = 0;
  const uint4* chunks = reinterpret_cast<const uint4*>(pl.base + pl.a * W);
  const long long n_chunks = (pl.b - pl.a) / E;
  for (long long c = tid; c < n_chunks; c += stride)
    s += chunk_digest<W>(chunks[c], pl.a + c * E);
  if (tid < pl.a - lo)
    s += bits_at(pl.base, W, lo + tid) * (2 * (u64)(lo + tid) + 1);
  if (tid < hi - pl.b)
    s += bits_at(pl.base, W, pl.b + tid) * (2 * (u64)(pl.b + tid) + 1);
  return s;
}

// out[y] += the digest of plane y over [lo, hi); `table` is null when the
// descriptors ride in `prm`
__global__ void __launch_bounds__(THREADS)
    verify_kernel(const VerifyParams prm, const VerifyPlane* table,
                  u64* out) {
  const int y = blockIdx.y;
  const VerifyPlane pl = table != nullptr ? table[y] : prm.planes[y];
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  u64 s;
  switch (pl.width) {
    case 1:
      s = plane_sum<1>(pl, prm.lo, prm.hi, tid, stride);
      break;
    case 2:
      s = plane_sum<2>(pl, prm.lo, prm.hi, tid, stride);
      break;
    case 4:
      s = plane_sum<4>(pl, prm.lo, prm.hi, tid, stride);
      break;
    default:
      s = plane_sum<8>(pl, prm.lo, prm.hi, tid, stride);
  }
  block_add(s, out + y);
}

}  // namespace

// one plane of a patch launch (device/digest.py _PATCH_DESC)
struct PatchPlane {
  unsigned char* plane;
  const unsigned char* vals;  // device values, or null: the payload's
  const u64* rec;             // the recorded digest on the device, or null
  u64 rec_value;              // the recorded digest when rec is null
  long long val_off;          // the values' offset in the payload
  int width;
  int pad;
};

constexpr int PATCH_ROWS = 1024;  // rows a block takes

// The launch parameters of a patch: N payload bytes inline (N = 0: the
// payload lies in device memory at `table`).  The payload holds the P
// plane descriptors, then the m positions (int64, at pos_off) or, with
// n_spans > 0, the span descriptors (SpanDesc, at pos_off), then the
// values of the planes whose values came from the host (at each val_off),
// then, on the several-blocks-a-plane path, the scratch (at scratch_off:
// P * gridDim.x partial pairs, then P tickets).
template <int N>
struct PatchArgs {
  unsigned char* table;
  u64* out;  // (P, 3): H(old), H(new), R - H(old) + H(new); null: none
  long long m;
  long long pos_off;
  long long scratch_off;
  int rows_per_block;
  int n_spans;  // 0: positions
  alignas(16) unsigned char data[N > 0 ? N : 16];
};

// one span of a span patch (device/digest.py _SPAN_DESC)
struct SpanDesc {
  long long lo;  // the span's first row in the planes
  int len;       // its rows
  int prefix;    // the rows of the spans before it: its first value
};

namespace {

__device__ __forceinline__ void store_at(unsigned char* base, int width,
                                         long long i, u64 v) {
  switch (width) {
    case 1:
      base[i] = (unsigned char)v;
      break;
    case 2:
      reinterpret_cast<unsigned short*>(base)[i] = (unsigned short)v;
      break;
    case 4:
      reinterpret_cast<unsigned*>(base)[i] = (unsigned)v;
      break;
    default:
      reinterpret_cast<u64*>(base)[i] = v;
  }
}

// the block's sums of a and b, in thread 0
__device__ __forceinline__ void pair_sum(u64& a, u64& b) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (blockDim.x <= 32) return;
  __shared__ u64 pa[THREADS / 32], pb[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    pa[warp] = a;
    pb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    a = warp_sum(lane < nw ? pa[lane] : 0);
    b = warp_sum(lane < nw ? pb[lane] : 0);
  }
}

__device__ __forceinline__ void store_digests(u64* o, const PatchPlane& d,
                                              u64 h_old, u64 h_new) {
  const u64 rec = d.rec != nullptr ? *d.rec : d.rec_value;
  o[0] = h_old;
  o[1] = h_new;
  o[2] = rec - h_old + h_new;
}

// the row that value i of a span patch lands on: its span is the last at
// or after `k` whose first value is at or before i (k moves there)
__device__ __forceinline__ long long span_row(const SpanDesc* s, int& k,
                                              int K, long long i) {
  int hi = K - 1;
  while (k < hi) {
    const int mid = (k + hi + 1) >> 1;
    if (s[mid].prefix <= i)
      k = mid;
    else
      hi = mid - 1;
  }
  return s[k].lo + (i - s[k].prefix);
}

template <int N>
__global__ void __launch_bounds__(THREADS)
    patch_kernel(const __grid_constant__ PatchArgs<N> p) {
  const unsigned char* pay;
  if constexpr (N > 0)
    pay = p.data;
  else
    pay = p.table;
  const PatchPlane d = reinterpret_cast<const PatchPlane*>(pay)[blockIdx.y];
  const long long* pos = reinterpret_cast<const long long*>(pay + p.pos_off);
  const SpanDesc* spans = reinterpret_cast<const SpanDesc*>(pay + p.pos_off);
  const unsigned char* vals = d.vals != nullptr ? d.vals : pay + d.val_off;
  const bool sums = p.out != nullptr;
  const long long r0 = (long long)blockIdx.x * p.rows_per_block;
  const long long r1 =
      r0 + p.rows_per_block < p.m ? r0 + p.rows_per_block : p.m;
  u64 h_old = 0, h_new = 0;
  int k = 0;
  for (long long i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const long long q = p.n_spans > 0 ? span_row(spans, k, p.n_spans, i)
                                      : pos[i];
    const u64 w = 2 * (u64)q + 1;
    if (sums) h_old += bits_at(d.plane, d.width, q) * w;
    const u64 nv = bits_at(vals, d.width, i);
    store_at(d.plane, d.width, q, nv);
    h_new += nv * w;
  }
  if (!sums) return;  // the same for every thread of the launch
  pair_sum(h_old, h_new);
  if (threadIdx.x != 0) return;
  u64* o = p.out + 3 * blockIdx.y;
  if (gridDim.x == 1) {
    store_digests(o, d, h_old, h_new);
    return;
  }
  // several blocks a plane (device payload only): partials, then the last
  // block of the plane sums them
  u64* parts = reinterpret_cast<u64*>(p.table + p.scratch_off);
  unsigned* tickets =
      reinterpret_cast<unsigned*>(parts + 2 * (size_t)gridDim.y * gridDim.x);
  u64* mine = parts + 2 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
  mine[0] = h_old;
  mine[1] = h_new;
  __threadfence();
  if (atomicAdd(tickets + blockIdx.y, 1u) != gridDim.x - 1) return;
  __threadfence();
  const volatile u64* row = parts + 2 * (size_t)blockIdx.y * gridDim.x;
  u64 a = 0, b = 0;
  for (unsigned j = 0; j < gridDim.x; ++j) {
    a += row[2 * j];
    b += row[2 * j + 1];
  }
  store_digests(o, d, a, b);
}

template <int N>
cudaError_t patch_as(const void* args, int grid_x, int P, int threads,
                     cudaStream_t s) {
  PatchArgs<N> p;  // the caller's bytes need not be 16-byte aligned
  memcpy(&p, args, sizeof(p));
  if (N > 0 && p.out != nullptr && grid_x > 1) return cudaErrorInvalidValue;
  if (N == 0 && p.table == nullptr) return cudaErrorInvalidValue;
  if (p.n_spans < 0) return cudaErrorInvalidValue;
  patch_kernel<N><<<dim3((unsigned)grid_x, (unsigned)P), threads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `out` (8 bytes) is zeroed here; `width` is 1, 2, 4 or 8; `grid_cap`
// bounds the grid (a few blocks per SM).
int plane_digest_launch(int device, const void* plane, int width,
                        long long lo, long long hi, long long grid_cap,
                        void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(out, 0, 8, s)) != cudaSuccess) return e;
  if (hi <= lo) return cudaSuccess;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(plane);
  const long long E = 16 / width;
  // the first element at or after lo on a 16-byte boundary, and the end
  // of the last whole chunk; no chunk when the range is shorter than one
  long long a = lo;
  while (a < hi && (addr + (uintptr_t)(a * width)) % 16 != 0) ++a;
  long long b = a + (hi - a) / E * E;
  if (a >= hi) a = b = hi;
  const long long n_chunks = (b - a) / E;
  long long blocks = (n_chunks + THREADS - 1) / THREADS;
  if (blocks > grid_cap) blocks = grid_cap;
  if (blocks < 1) blocks = 1;
  const unsigned char* base = static_cast<const unsigned char*>(plane);
  u64* o = static_cast<u64*>(out);
  switch (width) {
    case 1:
      digest_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(base, lo, a, b,
                                                            hi, o);
      break;
    case 2:
      digest_kernel<2><<<(unsigned)blocks, THREADS, 0, s>>>(base, lo, a, b,
                                                            hi, o);
      break;
    case 4:
      digest_kernel<4><<<(unsigned)blocks, THREADS, 0, s>>>(base, lo, a, b,
                                                            hi, o);
      break;
    case 8:
      digest_kernel<8><<<(unsigned)blocks, THREADS, 0, s>>>(base, lo, a, b,
                                                            hi, o);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the sizes the wrapper lays its descriptors out by
int feed_verify_desc_bytes() { return (int)sizeof(VerifyPlane); }
int feed_verify_param_planes() { return PARAM_PLANES; }

// Fill P descriptors into `descs` (host memory, P * sizeof(VerifyPlane)
// bytes) for planes of `widths` bytes an element over [lo, hi).
int feed_verify_describe(int P, const void* const* planes, const int* widths,
                         long long lo, long long hi, void* descs) {
  VerifyPlane* d = static_cast<VerifyPlane*>(descs);
  for (int p = 0; p < P; ++p) {
    const int w = widths[p];
    if (w != 1 && w != 2 && w != 4 && w != 8) return cudaErrorInvalidValue;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(planes[p]);
    const long long E = 16 / w;
    long long a = lo;
    while (a < hi && (addr + (uintptr_t)(a * w)) % 16 != 0) ++a;
    long long b = a + (hi - a) / E * E;
    if (a >= hi) a = b = hi;
    d[p].base = static_cast<const unsigned char*>(planes[p]);
    d[p].a = a;
    d[p].b = b;
    d[p].width = w;
    d[p].pad = 0;
  }
  return cudaSuccess;
}

// `out` (P * 8 bytes) is zeroed here; `descs` is feed_verify_describe's
// host array; `table` is null when P <= PARAM_PLANES, else the same
// descriptors in device memory; `grid_cap` bounds the blocks of all planes.
int feed_verify_launch(int device, int P, const void* descs,
                       const void* table, long long lo, long long hi,
                       long long grid_cap, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0) return cudaSuccess;
  if (P > 65535 || (table == nullptr && P > PARAM_PLANES))
    return cudaErrorInvalidValue;
  if ((e = cudaMemsetAsync(out, 0, 8 * (size_t)P, s)) != cudaSuccess)
    return e;
  if (hi <= lo) return cudaSuccess;
  const VerifyPlane* d = static_cast<const VerifyPlane*>(descs);
  VerifyParams prm;
  prm.lo = lo;
  prm.hi = hi;
  long long most = 0;
  for (int p = 0; p < P; ++p) {
    const long long c = (d[p].b - d[p].a) / (16 / d[p].width);
    if (c > most) most = c;
    if (table == nullptr) prm.planes[p] = d[p];
  }
  long long bx = (most + THREADS - 1) / THREADS;
  long long cap = grid_cap / P;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  verify_kernel<<<dim3((unsigned)bx, (unsigned)P), THREADS, 0, s>>>(
      prm, static_cast<const VerifyPlane*>(table), static_cast<u64*>(out));
  return cudaGetLastError();
}

// the sizes the wrapper lays a patch out by
int patch_desc_bytes() { return (int)sizeof(PatchPlane); }
int span_desc_bytes() { return (int)sizeof(SpanDesc); }
int patch_rows_per_block() { return PATCH_ROWS; }
int patch_args_size(int n) {
  switch (n) {
    case 0:
      return (int)sizeof(PatchArgs<0>);
    case 208:
      return (int)sizeof(PatchArgs<208>);
    case 976:
      return (int)sizeof(PatchArgs<976>);
    case 4048:
      return (int)sizeof(PatchArgs<4048>);
    default:
      return -1;
  }
}

// One patch launch: `args` is a PatchArgs<n> of `bytes` bytes (n 0, 208,
// 976 or 4048), its grid (grid_x, P) and `threads` a block; positions are
// unique and in range, spans sorted, disjoint and inside every plane (the
// wrapper checks).
int patch_feed_launch(int device, const void* args, int bytes, int grid_x,
                      int P, int threads, void* stream) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device && (e = cudaSetDevice(device)) != cudaSuccess) return e;
  if (grid_x < 1 || P < 1 || P > 65535 || threads < 32 ||
      threads > THREADS || threads % 32 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bytes == (int)sizeof(PatchArgs<0>))
    return patch_as<0>(args, grid_x, P, threads, s);
  if (bytes == (int)sizeof(PatchArgs<208>))
    return patch_as<208>(args, grid_x, P, threads, s);
  if (bytes == (int)sizeof(PatchArgs<976>))
    return patch_as<976>(args, grid_x, P, threads, s);
  if (bytes == (int)sizeof(PatchArgs<4048>))
    return patch_as<4048>(args, grid_x, P, threads, s);
  return cudaErrorInvalidValue;
}

const char* digest_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

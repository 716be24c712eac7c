// Plane digests and row patches for Hopper: the scrub's re-hash of a
// resident feed plane (plane_digest) and the in-place write of a few rows
// of one plane with the digests of what they held and now hold
// (patch_rows).
//
// Replaces the XLA kernels of tikv_tpu/device/runner.py:
//   plane_digest <- _range_digest_kernel (:1981): sum of bits(x[i]) * (2i+1)
//                   mod 2^64 over the global positions [lo, hi) of one
//                   plane; a bool reads as 0/1, any other dtype as the
//                   unsigned view of its own width, widened to 64 bits;
//   patch_rows   <- _dus (:1816) and the DeviceMvccResolver's dus
//                   (device/mvcc.py:514): a slice update at a traced
//                   offset, there one launch per spill row and plane; here
//                   m unique positions of one plane in one launch.  With
//                   digests on, the same pass returns the two range
//                   digests _patch_plane (:1793) takes around each span
//                   (over the positions written, before and after), and
//                   corrupt_resident_plane (:2023) is a one-row patch.
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
// patch_rows reads m positions and m values and writes m elements (and
// reads m old ones when digests are asked for): one thread per position.
// Positions must be unique (the wrapper checks): a parallel scatter would
// not say which of two writes to one row wins.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(THREADS)
    patch_kernel(unsigned char* plane, int width, const long long* pos,
                 const unsigned char* vals, long long m, u64* sums) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  u64 d_old = 0, d_new = 0;
  if (i < m) {
    const long long p = pos[i];
    const u64 w = 2 * (u64)p + 1;
    if (sums != nullptr) d_old = bits_at(plane, width, p) * w;
    const u64 nv = bits_at(vals, width, i);
    switch (width) {
      case 1:
        plane[p] = (unsigned char)nv;
        break;
      case 2:
        reinterpret_cast<unsigned short*>(plane)[p] = (unsigned short)nv;
        break;
      case 4:
        reinterpret_cast<unsigned*>(plane)[p] = (unsigned)nv;
        break;
      default:
        reinterpret_cast<u64*>(plane)[p] = nv;
    }
    d_new = nv * w;
  }
  if (sums != nullptr) {  // the same for every thread of the launch
    block_add(d_old, sums);
    __syncthreads();
    block_add(d_new, sums + 1);
  }
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

// `sums` (16 bytes: the old and the new digest) is zeroed here, or null
// when no digest is asked for; positions are unique and in range.
int patch_rows_launch(int device, void* plane, int width, const void* pos,
                      const void* vals, long long m, void* sums,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sums != nullptr && (e = cudaMemsetAsync(sums, 0, 16, s)) != cudaSuccess)
    return e;
  if (width != 1 && width != 2 && width != 4 && width != 8)
    return cudaErrorInvalidValue;
  const long long blocks = m > 0 ? (m + THREADS - 1) / THREADS : 1;
  patch_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<unsigned char*>(plane), width,
      static_cast<const long long*>(pos),
      static_cast<const unsigned char*>(vals), m, static_cast<u64*>(sums));
  return cudaGetLastError();
}

const char* digest_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

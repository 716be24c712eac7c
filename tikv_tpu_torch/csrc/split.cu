// The device split of a resident feed for Hopper: every plane of one split
// child's feed sliced from the parent's planes in one launch, with the
// child's digest of each plane in the same pass.
//
// Replaces the XLA kernel of tikv_tpu/device/runner.py:
//   split_planes <- _split_plane_kernel (:2168): one plane x of n_pad_parent
//                   rows -> a child plane of n_pad_child rows, x[:n_pad]
//                   for the left child, roll(x, -pos)[:n_pad] for the
//                   right one, rows at or past n_child zero; one jitted
//                   call a plane, then a digest kernel a plane
//                   (_mint_split_child, :2254) and one sync a digest.
// Here one launch covers every plane of the child: plane p reads parent
// rows [lo, lo + n_child) once (lo = 0 left, pos right; the roll's wrapped
// rows are always zeroed, so they are never read), writes child rows
// [0, n_child) and zeros over [n_child, n_pad_child), and accumulates
//   digest_p = sum_{i < n_child} bits(child[i]) * (2i + 1)  mod 2^64
// at the child's positions i (digest.cu's formula: a bool reads as 0/1,
// any other dtype as the unsigned view of its own width).  All P digests
// land in one (P,) buffer, so the caller's verify is one 8P-byte copy.
//
// The planes' pointers and widths ride a small device table (P entries of
// 32 bytes; up to MAX_PLANES = 256, past the 4 KB of launch parameters),
// one read per block.  Block (x, y) takes plane y; the x blocks stride its
// rows.  Bound: bytes.  A child reads n_child * w and writes
// n_pad_child * w bytes a plane; each thread keeps ITEMS independent
// element loads in flight (coalesced across the warp: consecutive threads,
// consecutive rows), which needs no 16-byte alignment, so the right child
// at any pos (odd, unaligned, n - 1) takes the same path as the left.  A
// warp reduction, a block reduction in shared memory and one wrapping
// 64-bit atomicAdd per block and plane finish the digest (addition mod
// 2^64 commutes: the order does not change the result).

#include <cuda_runtime.h>
#include <stdint.h>

// one plane of a launch: the parent's plane, the child's, the element width
struct SplitPlane {
  const void* src;
  void* dst;
  long long width;
  long long pad;
};

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // elements a thread has in flight per step
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

template <typename T>
__device__ __forceinline__ u64 split_rows(const T* __restrict__ src,
                                          T* __restrict__ dst, long long lo,
                                          long long n_child,
                                          long long n_pad) {
  const long long step = (long long)gridDim.x * THREADS * ITEMS;
  u64 s = 0;
  for (long long base = (long long)blockIdx.x * THREADS * ITEMS + threadIdx.x;
       base < n_pad; base += step) {
    T v[ITEMS];
    // every load first, then the stores: the loads stay in flight together
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = base + (long long)j * THREADS;
      v[j] = i < n_child ? src[lo + i] : T(0);
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = base + (long long)j * THREADS;
      if (i < n_pad) dst[i] = v[j];
      if (i < n_child) s += (u64)v[j] * (2 * (u64)i + 1);
    }
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
    split_kernel(const SplitPlane* __restrict__ table, long long lo,
                 long long n_child, long long n_pad, u64* digests) {
  const SplitPlane pl = table[blockIdx.y];
  u64 s;
  switch (pl.width) {
    case 1:
      s = split_rows(static_cast<const uint8_t*>(pl.src),
                     static_cast<uint8_t*>(pl.dst), lo, n_child, n_pad);
      break;
    case 2:
      s = split_rows(static_cast<const uint16_t*>(pl.src),
                     static_cast<uint16_t*>(pl.dst), lo, n_child, n_pad);
      break;
    case 4:
      s = split_rows(static_cast<const uint32_t*>(pl.src),
                     static_cast<uint32_t*>(pl.dst), lo, n_child, n_pad);
      break;
    default:
      s = split_rows(static_cast<const u64*>(pl.src),
                     static_cast<u64*>(pl.dst), lo, n_child, n_pad);
  }
  block_add(s, digests + blockIdx.y);
}

}  // namespace

extern "C" {

int split_plane_size() { return (int)sizeof(SplitPlane); }

// rows one block covers in one step of its stride
int split_rows_per_block() { return THREADS * ITEMS; }

// `table`: P SplitPlane entries in device memory (widths 1, 2, 4 or 8,
// checked by the wrapper); `digests` (8P bytes) is zeroed here; `grid_x`
// blocks stride each plane's rows.
int split_planes_launch(int device, const void* table, int P, long long lo,
                        long long n_child, long long n_pad, long long grid_x,
                        void* digests, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (P <= 0 || P > 65535 || grid_x < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(digests, 0, 8 * (size_t)P, s)) != cudaSuccess)
    return e;
  dim3 grid((unsigned)grid_x, (unsigned)P);
  split_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const SplitPlane*>(table), lo, n_child, n_pad,
      static_cast<u64*>(digests));
  return cudaGetLastError();
}

const char* split_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

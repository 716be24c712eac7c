// Selection vectors for Hopper: the packed predicate mask (sel_mask) and
// the in-order compaction of the selected rows (sel_compact).
//
// Replaces the XLA kernels of tikv_tpu/device/selection.py:
//   sel_mask    <- build_mask_kernel (:227): the row count and the
//                  jnp.packbits mask of a predicate (the bool mask itself
//                  stays on the device as the kernel's input);
//   sel_compact <- build_index_kernel (:323): ascending int32 row indices
//                  into [k_cap] with -1 fill and an overflow flag
//                  (nonzero(size=k_cap)), and build_compact_kernel (:357):
//                  the same indices plus each projected plane's value at
//                  them, the gather fused into the compaction.
//
// Layout shared by both kernels: a CUDA block covers ROWS_PER_BLOCK =
// 32768 rows, 128 per thread, i.e. 4096 packed bytes per block and 16 per
// thread.  sel_mask writes one popcount per block (`block_counts`), which
// is what sel_compact scans.
//
// Bound: bytes.  sel_mask reads n bool bytes once and writes n / 8 packed
// bytes: (1 + 1/8) B x 10,485,760 rows (config 2) is 3.5 us at 3.35 TB/s,
// far below a launch's own latency.  Each thread reads its 128 bools with
// 8 16-byte loads (all in flight before any is packed), packs 8 bools into
// a byte with one multiply (bit order of np.packbits: row 8j is bit 7 of
// byte j), and stores its 16 bytes with one 16-byte store; rows at or past
// n read as false.  The count is a block reduction and one 64-bit atomic
// per block.
// sel_compact reads the packed mask (n / 8 bytes), the block counts, and
// for each selected row below k_cap its projected planes' elements; it
// writes 4 B per index and the gathered elements.  The exclusive scan over
// the block counts is in the kernel: each block sums the counts of the
// blocks before it (a block-wide reduction; 320 counts at config 2), then
// scans its threads' popcounts, so every thread knows where its rows go
// and writes them in row order.  The last block writes the total count and
// the overflow flag.

#include <cuda_runtime.h>

#define THREADS 256
#define ROWS_PER_THREAD 128
#define ROWS_PER_BLOCK (THREADS * ROWS_PER_THREAD)
#define MAX_PLANES 128

struct CompactParams {
  const unsigned char* packed;  // n_blocks * ROWS_PER_BLOCK / 8 bytes
  const int* block_counts;      // n_blocks
  long long n_blocks;
  long long k_cap;
  int* idx;                     // k_cap, filled with -1 beforehand
  long long* header;            // [0] selected rows, [1] overflow flag
  int n_planes;
  int esize[MAX_PLANES];        // 1, 4 or 8 bytes
  const void* src[MAX_PLANES];
  void* dst[MAX_PLANES];        // k_cap elements each, zeroed beforehand
};

namespace {

constexpr unsigned FULL = 0xffffffffu;

// 8 bool bytes (row 8j in the lowest byte) -> one byte, row 8j in bit 7
__device__ __forceinline__ unsigned pack8(unsigned long long x) {
  return (unsigned)(((x & 0x0101010101010101ULL) * 0x8040201008040201ULL) >>
                    56);
}

__device__ __forceinline__ unsigned pack16(uint4 a, uint4 b) {
  return pack8(((unsigned long long)a.y << 32) | a.x) |
         (pack8(((unsigned long long)a.w << 32) | a.z) << 8) |
         (pack8(((unsigned long long)b.y << 32) | b.x) << 16) |
         (pack8(((unsigned long long)b.w << 32) | b.z) << 24);
}

// sum of `v` over the block, returned to every thread
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(THREADS)
    sel_mask_kernel(const unsigned char* __restrict__ pred, long long n,
                    int vec, unsigned char* __restrict__ packed,
                    int* __restrict__ block_counts,
                    unsigned long long* __restrict__ count) {
  __shared__ long long red[THREADS / 32];
  const long long row0 = (long long)blockIdx.x * ROWS_PER_BLOCK +
                         (long long)threadIdx.x * ROWS_PER_THREAD;
  unsigned words[4];
  if (vec && row0 + ROWS_PER_THREAD <= n) {
    const uint4* src = reinterpret_cast<const uint4*>(pred + row0);
    uint4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __ldcs(src + i);
#pragma unroll
    for (int w = 0; w < 4; ++w) words[w] = pack16(v[2 * w], v[2 * w + 1]);
  } else {
    for (int w = 0; w < 4; ++w) {
      unsigned word = 0;
      for (int byte = 0; byte < 4; ++byte) {
        unsigned bits = 0;
        for (int bit = 0; bit < 8; ++bit) {
          const long long r = row0 + 32 * w + 8 * byte + bit;
          bits = (bits << 1) | ((r < n && pred[r]) ? 1u : 0u);
        }
        word |= bits << (8 * byte);
      }
      words[w] = word;
    }
  }
  *reinterpret_cast<uint4*>(packed + row0 / 8) =
      make_uint4(words[0], words[1], words[2], words[3]);
  const long long total =
      block_sum(__popc(words[0]) + __popc(words[1]) + __popc(words[2]) +
                    __popc(words[3]),
                red);
  if (threadIdx.x == 0) {
    block_counts[blockIdx.x] = (int)total;
    atomicAdd(count, (unsigned long long)total);
  }
}

__device__ __forceinline__ void copy_element(const CompactParams& p,
                                             long long row, long long at) {
  for (int q = 0; q < p.n_planes; ++q) {
    switch (p.esize[q]) {
      case 1:
        static_cast<unsigned char*>(p.dst[q])[at] =
            static_cast<const unsigned char*>(p.src[q])[row];
        break;
      case 4:
        static_cast<int*>(p.dst[q])[at] = static_cast<const int*>(p.src[q])[row];
        break;
      default:
        static_cast<long long*>(p.dst[q])[at] =
            static_cast<const long long*>(p.src[q])[row];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    sel_compact_kernel(const __grid_constant__ CompactParams p) {
  __shared__ long long red[THREADS / 32];
  __shared__ int warp_total[THREADS / 32];
  const long long b = blockIdx.x;
  // this block's first output position: the selected rows of the blocks
  // before it
  long long before = 0;
  for (long long i = threadIdx.x; i < b; i += THREADS)
    before += p.block_counts[i];
  before = block_sum(before, red);
  if (b == p.n_blocks - 1 && threadIdx.x == 0) {
    const long long total = before + p.block_counts[b];
    p.header[0] = total;
    p.header[1] = total > p.k_cap ? 1 : 0;
  }
  if (before >= p.k_cap) return;  // the same for every thread of the block

  const uint4 v = reinterpret_cast<const uint4*>(
      p.packed + b * (ROWS_PER_BLOCK / 8))[threadIdx.x];
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
  const int cnt = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  long long at = before + incl - cnt;
  for (int w = 0; w < warp; ++w) at += warp_total[w];

  const long long row0 = b * ROWS_PER_BLOCK +
                         (long long)threadIdx.x * ROWS_PER_THREAD;
  for (int j = 0; j < 16 && at < p.k_cap; ++j) {
    unsigned byte = (words[j >> 2] >> (8 * (j & 3))) & 0xffu;
    while (byte != 0 && at < p.k_cap) {
      const int bit = 31 - __clz(byte);  // the highest bit is the first row
      byte &= ~(1u << bit);
      const long long row = row0 + 8 * j + (7 - bit);
      p.idx[at] = (int)row;
      copy_element(p, row, at);
      ++at;
    }
  }
}

}  // namespace

extern "C" {

// count (8 bytes) is zeroed here; packed holds n_blocks * 4096 bytes,
// 16-byte aligned; `vec`: pred is 16-byte aligned.
int sel_mask_launch(int device, const void* pred, long long n, int vec,
                    void* packed, void* block_counts, void* count,
                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(count, 0, 8, s)) != cudaSuccess) return e;
  const long long blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  sel_mask_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const unsigned char*>(pred), n, vec,
      static_cast<unsigned char*>(packed), static_cast<int*>(block_counts),
      static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}

// `out` (out_bytes) holds the header, the indices and the planes'
// outputs: zeroed here, then the indices set to -1.
int sel_compact_launch(int device, const CompactParams* p, void* out,
                       long long out_bytes, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(out, 0, out_bytes, s)) != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(p->idx, 0xff, 4 * p->k_cap, s)) != cudaSuccess)
    return e;
  sel_compact_kernel<<<(unsigned)p->n_blocks, THREADS, 0, s>>>(*p);
  return cudaGetLastError();
}

int sel_params_bytes() { return (int)sizeof(CompactParams); }

int sel_max_planes() { return MAX_PLANES; }

const char* sel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

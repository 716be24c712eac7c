// sel_mask for Hopper: count and pack a bool predicate evaluated elsewhere
// (a plan sel_pred does not cover), in one launch and no memset.
//
// Replaces the count-and-pack half of tikv_tpu/device/selection.py's
// build_mask_kernel (:227): the row count and the jnp.packbits mask of the
// selection, for a bool mask the kernel is handed.
//
// Output, shared with sel_pred and read by sel_compact (selection.cu): a
// block of ROWS_PER_BLOCK = 32768 rows is 4096 packed bytes, in
// np.packbits' bit order (row 8j is bit 7 of byte j), rows at or past n
// reading as 0; one int32 popcount per block in block_counts; the int64
// count of selected rows.
//
// Bound: bytes.  n bool bytes read once and n / 8 packed bytes written:
// (1 + 1/8) B x 10,485,760 rows (config 2) is 3.5 us at 3.35 TB/s, about
// twice the launch's own floor, so the design is about the launch and its
// tail:
// - one device operation a call.  The count is written by the last CTA to
//   finish.  Each CTA adds (1 << 32) | its popcount to one 64-bit tally in
//   a scratch word, in one atomic: the high half counts the CTAs done, the
//   low half the rows selected (below 2^31, so it never carries).  The CTA
//   that sees the other n_blocks - 1 already counted writes the low half
//   as the count and zeroes the tally for the next call; no fence, no
//   second atomic, no memset before the launch.  The wrapper zeroes the
//   scratch once, when it allocates it for a (device, stream), so two
//   streams never share a tally.
// - one CTA a block (512 threads of 64 rows), so each block count has
//   exactly one writer.  Config 2's 320 CTAs are all resident at once (4
//   a SM fit, 2.4 are needed), so the memory system, not the spread over
//   the SMs, sets the time.  Smaller units measured slower on the card
//   (config 2, streaming loads, a two-atomic ticket): 4,096-row CTAs
//   reduced per block by a thread block cluster of 8 took 0.0086-0.0091
//   ms, the same CTAs with atomics and no cluster 0.0077-0.0078, one
//   512-thread CTA a block 0.0048-0.0050; with this tally 256 threads of
//   128 rows (the former tiling) took 0.0052-0.0056 (PERF.md §6).
// - loads: each thread's four 16-byte loads are all in flight before the
//   packing (eight bool bytes to one byte with one multiply) and one
//   8-byte store, a warp's 256 bytes contiguous.  The loads go through the
//   read-only path: the route's predicate kernel has just written the
//   bools, and they are read from L2 where it still holds them.
// - the launch is programmatic (cudaLaunchKernelEx with programmatic
//   stream serialization): the grid may be scheduled while the kernel
//   before it (the torch predicate's) drains; griddepcontrol.wait, before
//   every global read and write, holds them until that kernel's writes
//   are visible, and the next call's kernel waits the same way for this
//   one before it touches the tally.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PER_BLOCK = 32768;  // a block of the MaskOut layout
constexpr int THREADS = 512;           // one CTA a block
constexpr int ROWS_PER_THREAD = ROWS_PER_BLOCK / THREADS;  // 64
constexpr int LOADS = ROWS_PER_THREAD / 16;                // 16-byte loads
constexpr int WORDS = ROWS_PER_THREAD / 32;                // packed words

static_assert(WORDS == 2, "a thread stores one 8-byte pair of words");

// the last-CTA tally (device/selection.py _MASK_SCRATCH_BYTES: one int64
// word, zeroed at allocation)
struct Scratch {
  unsigned long long tally;  // CTAs done << 32 | rows selected
};

__device__ __forceinline__ void wait_prior_grid() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// 8 bool bytes (row 8j in the lowest byte) -> one byte, row 8j in bit 7
__device__ __forceinline__ unsigned pack8(unsigned long long x) {
  return (unsigned)(((x & 0x0101010101010101ULL) * 0x8040201008040201ULL) >>
                    56);
}

// 32 bools -> a word whose byte i holds rows 8i .. 8i + 7
__device__ __forceinline__ unsigned pack32(uint4 a, uint4 b) {
  return pack8(((unsigned long long)a.y << 32) | a.x) |
         (pack8(((unsigned long long)a.w << 32) | a.z) << 8) |
         (pack8(((unsigned long long)b.y << 32) | b.x) << 16) |
         (pack8(((unsigned long long)b.w << 32) | b.z) << 24);
}

__global__ void __launch_bounds__(THREADS)
    sel_mask_kernel(const unsigned char* __restrict__ pred, long long n,
                    int vec, unsigned* __restrict__ packed,
                    int* __restrict__ block_counts,
                    unsigned long long* __restrict__ count,
                    Scratch* __restrict__ scratch, long long n_blocks) {
  __shared__ int warp_sums[THREADS / 32];
  wait_prior_grid();
  const long long row0 = (long long)blockIdx.x * ROWS_PER_BLOCK +
                         (long long)threadIdx.x * ROWS_PER_THREAD;
  unsigned words[WORDS];
  if (vec && row0 + ROWS_PER_THREAD <= n) {
    const uint4* src = reinterpret_cast<const uint4*>(pred + row0);
    uint4 v[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) v[i] = __ldg(src + i);
#pragma unroll
    for (int w = 0; w < WORDS; ++w)
      words[w] = pack32(v[2 * w], v[2 * w + 1]);
  } else {
    for (int w = 0; w < WORDS; ++w) {
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
  *reinterpret_cast<uint2*>(packed + row0 / 32) =
      make_uint2(words[0], words[1]);
  int c = __popc(words[0]) + __popc(words[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  int t = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
  if (threadIdx.x != 0) return;
  block_counts[blockIdx.x] = t;
  const unsigned long long add = (1ULL << 32) | (unsigned long long)t;
  const unsigned long long before = atomicAdd(&scratch->tally, add);
  if ((before >> 32) == (unsigned long long)n_blocks - 1) {
    *count = (before + add) & 0xffffffffULL;
    scratch->tally = 0;
  }
}

}  // namespace

extern "C" {

int sel_mask_rows_per_block() { return ROWS_PER_BLOCK; }

int sel_mask_scratch_bytes() { return (int)sizeof(Scratch); }

// Count and pack rows [0, n) of the bool mask `pred` (`vec`: 16-byte
// aligned): `packed` holds n_blocks * 4096 bytes, 16-byte aligned,
// `block_counts` n_blocks ints, `count` one int64; `scratch` is this
// stream's Scratch, zero between calls.  One programmatic launch.
int sel_mask_launch(int device, const void* pred, long long n, int vec,
                    void* packed, void* block_counts, void* count,
                    void* scratch, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n <= 0 || n >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long n_blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, sel_mask_kernel,
                         static_cast<const unsigned char*>(pred), n, vec,
                         static_cast<unsigned*>(packed),
                         static_cast<int*>(block_counts),
                         static_cast<unsigned long long*>(count),
                         static_cast<Scratch*>(scratch), n_blocks);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

const char* sel_mask_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

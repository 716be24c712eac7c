// sel_pred_batched's terms route for Hopper: G lanes of constants over one
// selection of terms "column 0 <cmp> constant" (a coalesced group's
// members: `c1 > ?`, `v BETWEEN ? AND ?` as two terms), G counts and G
// packed masks in one buffer.  Programs of any other shape take the
// interpreter of selection.cu's sel_pred_batched_kernel.
//
// Replaces, with selection.cu's interpreter, the XLA kernel of
// tikv_tpu/device/selection.py:
//   build_batched_mask_kernel (:273): the solo mask trace mapped over the
//   lanes (jax.vmap), which reads the feed once a lane.
//
// Bound: bytes, column 0 and its validity read once for the whole group
// and G packed masks written: (4 + G/8) B a row plus 8 B a lane, 0.019 ms
// at 10,485,760 int32 rows and G = 16 at 3.35 TB/s.
//
// Design:
// - The host decodes every (lane, term) once into an interval on order
//   images (device/selection.py term_interval): an int with its sign bit
//   flipped, a float with a negative's bits flipped and a positive's sign
//   bit set, so a row's comparison is one unsigned test
//   (image - lo) <= span, kept or not and inverted for Ne.  Nothing of
//   the opcode is decoded in the row loop, and no branch depends on it.
// - A thread takes 32 consecutive rows (int32 and float32 with 8 16-byte
//   loads, int64 with 16, the validity with 2), turns them into images
//   once, then for each lane builds its 32 mask bits and stores them as
//   one 32-bit word: a warp stores 128 contiguous bytes a lane.
// - Each lane's count stays in the thread's own shared-memory slot across
//   the grid-stride loop (no atomic, no warp reduction a tile); the block
//   reduces each lane once at the end and adds it with one atomic.
// - Words past n are written as zeros: every lane's n_blocks * 4096 bytes
//   are written.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ROWS 32                 // rows a thread takes at a time (one word)
#define MAX_LANES 64
#define MAX_TERMS 16

typedef unsigned long long u64;

enum { PDT_INT32 = 0, PDT_INT64 = 1, PDT_FLOAT32 = 2 };
enum { TERM_IN = 1, TERM_INVERT = 2 };

// device/selection.py mirrors the layout
struct TermsParams {
  const void* values;          // column 0: int32, int64 or float32
  const unsigned char* valid;  // bool, or null: every row valid
  int dtype;                   // PDT_*
  int wide;                    // 64-bit images (the program holds an int64)
  int real;                    // the terms compare floats
  int lanes;                   // G, 1..MAX_LANES
  int terms;                   // K, 1..MAX_TERMS
  int vec;                     // values and validity 16-byte aligned
  long long n;
  const u64* bounds;           // [G][K][2]: lo, span
  const unsigned* flags;       // [G][K]: TERM_IN | TERM_INVERT
  u64* counts;                 // [G], zeroed by the launcher
  unsigned char* packed;       // [G][lane_bytes]
  long long lane_bytes;        // a multiple of 4
};

namespace {

constexpr unsigned FULL = 0xffffffffu;

// the order image of a 32-bit payload (an int32, or a float32's bits)
__device__ __forceinline__ unsigned image32(unsigned x, bool real) {
  if (!real) return x ^ 0x80000000u;
  return (x & 0x80000000u) ? ~x : (x | 0x80000000u);
}

__device__ __forceinline__ u64 image64(u64 x, bool real) {
  constexpr u64 SIGN = 0x8000000000000000ull;
  if (!real) return x ^ SIGN;
  return (x & SIGN) ? ~x : (x | SIGN);
}

// rows [i, i + 32) of column 0 as images (rows past n: 0) and the valid
// bits of the rows that exist
template <class T>
__device__ __forceinline__ unsigned load_rows(const TermsParams& p,
                                              long long i, bool full,
                                              T (&img)[ROWS]) {
  const bool real = p.real != 0;
  if (p.dtype == PDT_INT64) {
    const long long* q = static_cast<const long long*>(p.values) + i;
    if (full) {
#pragma unroll
      for (int k = 0; k < ROWS / 2; ++k) {
        const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(q) + k);
        img[2 * k] = (T)image64((u64)x.x, false);
        img[2 * k + 1] = (T)image64((u64)x.y, false);
      }
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        img[r] = i + r < p.n ? (T)image64((u64)__ldg(q + r), false) : (T)0;
    }
  } else {
    const unsigned* q = static_cast<const unsigned*>(p.values) + i;
    unsigned raw[ROWS];
    if (full) {
#pragma unroll
      for (int k = 0; k < ROWS / 4; ++k) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(q) + k);
        raw[4 * k] = x.x, raw[4 * k + 1] = x.y;
        raw[4 * k + 2] = x.z, raw[4 * k + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) raw[r] = i + r < p.n ? __ldg(q + r) : 0u;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (sizeof(T) == 4) {
        img[r] = (T)image32(raw[r], real);
      } else if (real) {  // a float32 widened to float64, exact
        img[r] = (T)image64(
            (u64)__double_as_longlong((double)__uint_as_float(raw[r])), true);
      } else {            // an int32 sign-extended
        img[r] = (T)image64((u64)(long long)(int)raw[r], false);
      }
    }
  }
  const long long left = p.n - i;
  unsigned live = left >= ROWS ? FULL : left > 0 ? (1u << left) - 1u : 0u;
  if (p.valid == nullptr) return live;
  unsigned m = 0;
  if (full) {
#pragma unroll
    for (int k = 0; k < ROWS / 16; ++k) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p.valid + i) + k);
      const unsigned x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          m |= ((x[j] >> (8 * b)) & 0xFFu) ? 1u << (16 * k + 4 * j + b) : 0u;
    }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      m |= (i + r < p.n && __ldg(p.valid + i + r)) ? 1u << r : 0u;
  }
  return live & m;
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    sel_terms_kernel(const __grid_constant__ TermsParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.lanes, K = p.terms, t = threadIdx.x;
  T* s_lo = reinterpret_cast<T*>(smem);
  T* s_span = s_lo + G * K;
  unsigned* s_flag = reinterpret_cast<unsigned*>(s_span + G * K);
  unsigned* s_cnt = s_flag + G * K;      // [G][THREADS]: a thread's counts
  for (int j = t; j < G * K; j += THREADS) {
    s_lo[j] = (T)p.bounds[2 * j];
    s_span[j] = (T)p.bounds[2 * j + 1];
    s_flag[j] = p.flags[j];
  }
  for (int g = 0; g < G; ++g) s_cnt[g * THREADS + t] = 0;
  __syncthreads();
  const long long words = p.lane_bytes / 4;
  for (long long w = (long long)blockIdx.x * THREADS + t; w < words;
       w += (long long)gridDim.x * THREADS) {
    const long long i = w * ROWS;
    T img[ROWS];
    const bool full = p.vec && i + ROWS <= p.n;
    const unsigned row_ok = i < p.n ? load_rows<T>(p, i, full, img) : 0u;
    for (int g = 0; g < G; ++g) {
      unsigned keep = row_ok;
      for (int k = 0; k < K; ++k) {
        const int j = g * K + k;
        const T lo = s_lo[j], span = s_span[j];
        const unsigned fl = s_flag[j];
        unsigned bits = 0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          bits |= (T)(img[r] - lo) <= span ? 1u << r : 0u;
        keep &= ((fl & TERM_IN) ? bits : 0u) ^
                ((fl & TERM_INVERT) ? FULL : 0u);
      }
      // row 8j in bit 7 of byte j (np.packbits)
      *reinterpret_cast<unsigned*>(p.packed + g * p.lane_bytes + 4 * w) =
          __byte_perm(__brev(keep), 0, 0x0123);
      s_cnt[g * THREADS + t] += __popc(keep);
    }
  }
  __syncthreads();
  // lane g: warp w sums its 32 threads' slots, one atomic a warp and lane
  const int lane = t & 31, warp = t >> 5;
  for (int g = warp; g < G; g += THREADS / 32) {
    unsigned c = 0;
    for (int x = lane; x < THREADS; x += 32) c += s_cnt[g * THREADS + x];
    c = __reduce_add_sync(FULL, c);
    if (lane == 0 && c) atomicAdd(p.counts + g, (u64)c);
  }
}

template <class T>
long long terms_smem(const TermsParams& p) {
  return (long long)p.lanes * p.terms * (2 * sizeof(T) + 4) +
         (long long)p.lanes * THREADS * 4;
}

template <class T>
cudaError_t launch_terms(const TermsParams& p, cudaStream_t s) {
  const long long smem = terms_smem<T>(p);
  const void* fn = reinterpret_cast<const void*>(&sel_terms_kernel<T>);
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, THREADS, (size_t)smem)) != cudaSuccess)
    return e;
  const long long words = p.lane_bytes / 4;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (words + THREADS - 1) / THREADS;
  if (grid > need) grid = need < 1 ? 1 : need;
  void* args[] = {const_cast<TermsParams*>(&p)};
  if ((e = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(THREADS), args,
                            (size_t)smem, s)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sel_pred_batched's terms route over rows [0, n): the G counts are zeroed
// here; every lane's lane_bytes packed bytes are written.
int sel_terms_launch(int device, const TermsParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p->lanes < 1 || p->lanes > MAX_LANES || p->terms < 1 ||
      p->terms > MAX_TERMS || p->n < 1 || p->lane_bytes % 4 != 0 ||
      p->lane_bytes * 8 < p->n || p->dtype < PDT_INT32 ||
      p->dtype > PDT_FLOAT32 || (p->dtype == PDT_INT64 && !p->wide) ||
      (p->real != 0) != (p->dtype == PDT_FLOAT32))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(p->counts, 0, 8 * (size_t)p->lanes, s)) !=
      cudaSuccess)
    return e;
  return p->wide ? launch_terms<u64>(*p, s) : launch_terms<unsigned>(*p, s);
}

int sel_terms_params_bytes() { return (int)sizeof(TermsParams); }

int sel_terms_max_lanes() { return MAX_LANES; }

const char* sel_terms_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

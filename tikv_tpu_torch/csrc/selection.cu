// Selection vectors for Hopper: the predicate evaluated over the feed
// (sel_pred, and sel_pred_batched for a group of requests), the packed
// mask of a bool predicate (sel_mask) and the in-order compaction of the
// selected rows (sel_compact).
//
// Replaces the XLA kernels of tikv_tpu/device/selection.py:
//   sel_pred    <- build_mask_kernel (:227), the whole fused pass: the
//                  selection RPNs evaluated over the feed's planes, then
//                  the row count, the jnp.packbits mask and, where a later
//                  kernel takes one, the bool mask;
//   sel_pred_batched <- build_batched_mask_kernel (:273): G requests'
//                  constants over one program and one feed, G counts and
//                  G packed masks;
//   sel_mask    <- the count-and-pack half of the same kernel, for a bool
//                  predicate evaluated elsewhere (a plan sel_pred does not
//                  cover);
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
// sel_pred keeps sel_mask's layout (a block of 32768 rows, one count per
// block, the same packed bytes), so sel_compact reads either.  Bound:
// bytes, the planes the selection names read once and the packed mask (and
// the bool mask) written once: (4 + 1/8) B x 10,485,760 rows at config 2
// is 12.9 us at 3.35 TB/s.  A thread takes 16 consecutive rows at a time
// (a CTA's 256 threads 4096 rows, 8 CTAs a block), read with 16-byte
// loads.  The predicate is a short program (the wrapper's encoder in
// device/selection.py) passed by value in the launch parameters: column
// refs, constants (hoisted into the parameters, none on the device),
// calls.  Every thread runs the same program, so every branch is
// warp-uniform; each opcode runs over the thread's 16 rows before the
// next.  The stack is ND entries of 16 rows held in registers: every
// stack access sits in a fully unrolled loop over the ND positions, so
// its index is static.  A program without an int64 value keeps 32-bit
// payloads (an int32, or a float32's bits); one with one keeps 64-bit
// payloads (int64, an int32 sign-extended, or a float32 value as a
// double, exact).  int32 arithmetic wraps at 32 bits as torch's does;
// float32 arithmetic rounds to float32 with __fadd_rn / __fsub_rn /
// __fmul_rn, never contracted into an FMA; validity is 16 bits an entry.
// Rows at or past n read as false.
// sel_pred_batched runs sel_pred's program G times, once per lane of
// constants (a coalesced group's members: their programs differ in their
// constants only).  Bound: bytes, the program's planes read once for the
// whole group and G packed masks written: (4 + G/8) B a row plus 8 B a
// lane, 0.019 ms at 10,485,760 int32 rows and G = 16 at 3.35 TB/s.  The
// XLA kernel maps the solo trace over the lanes (jax.vmap) and reads the
// feed once a lane; here a thread reads its 16 rows of each plane once
// into its own slots of a shared tile and evaluates every lane from
// there.  A program of terms "column 0 compared with a constant" (the
// common parameterized selection, `c1 > ?`, `v BETWEEN ? AND ?` as two
// conditions) skips the tile and the interpreter: the thread keeps its
// rows in registers and each lane is one compare a row and term.  The
// lanes' constants (G x 32 int64 would pass the 4 KB of
// launch parameters at G = 16) travel in a small device buffer, staged in
// shared memory once a CTA.  Output: G int64 counts, then G packed masks
// of n_blocks * 4096 bytes, in one buffer, so one copy brings the group
// home.
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

#define PRED_ROWS 16          // rows a thread evaluates at a time
// CTAs a block of sel_mask's layout
#define PRED_STEPS (ROWS_PER_BLOCK / (THREADS * PRED_ROWS))
#define PRED_MAX_COLS 16
#define PRED_MAX_OPS 32
#define PRED_MAX_CONSTS 32
#define BATCH_MAX_LANES 64    // sel_pred_batched's lanes a launch
#define BATCH_SMEM_BYTES (160 * 1024)   // its largest shared tile

// sel_pred's opcodes (device/selection.py mirrors them).  A binary op with
// aux 1 takes constant `arg` as its right operand; OP_IN_* compares the
// top with constants [arg, arg + aux).
enum {
  OP_COL = 0, OP_CONST = 1,
  OP_NEG_I32 = 2, OP_NEG_I64 = 3, OP_NEG_F32 = 4, OP_NOT_I = 5,
  OP_NOT_R = 6, OP_ISNULL = 7, OP_ISTRUE_I = 8, OP_ISTRUE_R = 9,
  OP_ISFALSE_I = 10, OP_ISFALSE_R = 11, OP_IN_I = 12, OP_IN_R = 13,
  OP_BINARY = 16,
  OP_ADD_I32 = 16, OP_ADD_I64 = 17, OP_ADD_F32 = 18, OP_SUB_I32 = 19,
  OP_SUB_I64 = 20, OP_SUB_F32 = 21, OP_MUL_I32 = 22, OP_MUL_I64 = 23,
  OP_MUL_F32 = 24, OP_GT_I = 25, OP_GE_I = 26, OP_LT_I = 27, OP_LE_I = 28,
  OP_EQ_I = 29, OP_NE_I = 30, OP_GT_R = 31, OP_GE_R = 32, OP_LT_R = 33,
  OP_LE_R = 34, OP_EQ_R = 35, OP_NE_R = 36, OP_NULLEQ_I = 37,
  OP_NULLEQ_R = 38, OP_AND = 39, OP_OR = 40, OP_XOR = 41,
  OP_KEEP_I = 48, OP_KEEP_R = 49
};

enum { PDT_INT32 = 0, PDT_INT64 = 1, PDT_FLOAT32 = 2 };

struct PredParams {
  const void* values[PRED_MAX_COLS];
  const unsigned char* valid[PRED_MAX_COLS];  // null: every row valid
  int dtype[PRED_MAX_COLS];
  long long n;
  unsigned char* packed;        // n_blocks * 4096 bytes
  int* block_counts;
  unsigned long long* count;    // zeroed by the launcher
  unsigned char* bools;         // n_blocks * 32768 bytes, or null
  int vec;                      // every plane 16-byte aligned
  int n_ops;
  int op[PRED_MAX_OPS];
  int arg[PRED_MAX_OPS];
  int aux[PRED_MAX_OPS];
  long long cval[PRED_MAX_CONSTS];  // int64 value or float64 bits
  int cnull[PRED_MAX_CONSTS];
};

// sel_pred_batched's lanes: the program of PredParams (its constants
// unused) run once per lane with that lane's constants.
struct BatchParams {
  int lanes;                    // G, at most BATCH_MAX_LANES
  int n_consts;                 // constants a lane
  int n_cols;                   // columns the program reads
  int simple;                   // 1: comparisons of column 0 (no tile)
  int tile_offset;              // bytes of shared memory before the tile
  const long long* cval;        // [G][n_consts], on the device
  const int* cnull;             // [G][n_consts]
  unsigned long long* counts;   // [G], zeroed by the launcher
  unsigned char* packed;        // [G][lane_bytes]
  long long lane_bytes;         // n_blocks * 4096
  long long n_tiles;            // tiles of blockDim.x * 16 rows
};

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

// ------------------------------------------------------------- sel_pred

typedef unsigned long long u64;

// A value's payload T: u64 (int64, or a float's float64 bits) when the
// program holds an int64 value, else unsigned (int32, or a float32's
// bits), which halves the stack's registers.
__device__ __forceinline__ long long as_i(u64 x) { return (long long)x; }
__device__ __forceinline__ long long as_i(unsigned x) { return (int)x; }
__device__ __forceinline__ double as_d(u64 x) {
  return __longlong_as_double((long long)x);
}
__device__ __forceinline__ double as_d(unsigned x) {
  return (double)__uint_as_float(x);
}
template <class T>
__device__ __forceinline__ T of_i(long long x) {
  return (T)x;
}
template <class T>
__device__ __forceinline__ T of_d(double x);
template <>
__device__ __forceinline__ u64 of_d<u64>(double x) {
  return (u64)__double_as_longlong(x);
}
template <>
__device__ __forceinline__ unsigned of_d<unsigned>(double x) {
  return __float_as_uint((float)x);
}
template <class T>
__device__ __forceinline__ float f32(T x) {
  return (float)as_d(x);
}

// bit r set where bool byte i + r is nonzero
__device__ __forceinline__ unsigned bits16(const unsigned char* p, long long i,
                                           bool full, long long n) {
  unsigned b = 0;
  if (full) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p + i));
    const unsigned x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        b |= ((x[q] >> (8 * r)) & 0xFFu) ? 1u << (4 * q + r) : 0u;
  } else {
#pragma unroll
    for (int r = 0; r < PRED_ROWS; ++r)
      b |= (i + r < n && __ldg(p + i + r)) ? 1u << r : 0u;
  }
  return b;
}

// column c's rows [i, i + 16) and their validity
template <class T>
__device__ __forceinline__ void load_col(const PredParams& p, int c,
                                         long long i, bool full,
                                         T (&v)[PRED_ROWS], unsigned& m) {
  const long long n = p.n;
  switch (p.dtype[c]) {
    case PDT_INT32: {
      const int* q = static_cast<const int*>(p.values[c]) + i;
      if (full) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int4 x = __ldg(reinterpret_cast<const int4*>(q) + k);
          v[4 * k] = of_i<T>(x.x), v[4 * k + 1] = of_i<T>(x.y);
          v[4 * k + 2] = of_i<T>(x.z), v[4 * k + 3] = of_i<T>(x.w);
        }
      } else {
#pragma unroll
        for (int r = 0; r < PRED_ROWS; ++r)
          v[r] = i + r < n ? of_i<T>(__ldg(q + r)) : (T)0;
      }
      break;
    }
    case PDT_INT64: {
      const long long* q = static_cast<const long long*>(p.values[c]) + i;
      if (full) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(q) + k);
          v[2 * k] = of_i<T>(x.x), v[2 * k + 1] = of_i<T>(x.y);
        }
      } else {
#pragma unroll
        for (int r = 0; r < PRED_ROWS; ++r)
          v[r] = i + r < n ? of_i<T>(__ldg(q + r)) : (T)0;
      }
      break;
    }
    default: {
      const float* q = static_cast<const float*>(p.values[c]) + i;
      if (full) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(q) + k);
          v[4 * k] = of_d<T>(x.x), v[4 * k + 1] = of_d<T>(x.y);
          v[4 * k + 2] = of_d<T>(x.z), v[4 * k + 3] = of_d<T>(x.w);
        }
      } else {
#pragma unroll
        for (int r = 0; r < PRED_ROWS; ++r)
          v[r] = i + r < n ? of_d<T>(__ldg(q + r)) : (T)0;
      }
    }
  }
  m = p.valid[c] != nullptr ? bits16(p.valid[c], i, full, n) : 0xFFFFu;
}

// bit r of the result: f(r), for the thread's 16 rows
template <class F>
__device__ __forceinline__ unsigned bits_of(F f) {
  unsigned b = 0;
#pragma unroll
  for (int r = 0; r < PRED_ROWS; ++r) b |= f(r) ? 1u << r : 0u;
  return b;
}
#define BITS16(expr) bits_of([&](int r) { return (expr); })

template <class T>
__device__ __forceinline__ void set_bits(T (&v)[PRED_ROWS], unsigned b) {
#pragma unroll
  for (int r = 0; r < PRED_ROWS; ++r) v[r] = (b >> r) & 1u;
}

template <class T>
__device__ __forceinline__ void unary(int op, T (&v)[PRED_ROWS],
                                      unsigned& m) {
  switch (op) {
    case OP_NEG_I32:
#pragma unroll
      for (int r = 0; r < PRED_ROWS; ++r)
        v[r] = of_i<T>((int)(0u - (unsigned)v[r]));
      break;
    case OP_NEG_I64:
#pragma unroll
      for (int r = 0; r < PRED_ROWS; ++r) v[r] = (T)0 - v[r];
      break;
    case OP_NEG_F32:
#pragma unroll
      for (int r = 0; r < PRED_ROWS; ++r) v[r] = of_d<T>(-as_d(v[r]));
      break;
    case OP_NOT_I:
      set_bits(v, BITS16(as_i(v[r]) == 0));
      break;
    case OP_NOT_R:
      set_bits(v, BITS16(as_d(v[r]) == 0.0));
      break;
    case OP_ISNULL:
      set_bits(v, ~m & 0xFFFFu);
      m = 0xFFFFu;
      break;
    case OP_ISTRUE_I:
      set_bits(v, m & BITS16(as_i(v[r]) != 0));
      m = 0xFFFFu;
      break;
    case OP_ISTRUE_R:
      set_bits(v, m & BITS16(as_d(v[r]) != 0.0));
      m = 0xFFFFu;
      break;
    case OP_ISFALSE_I:
      set_bits(v, m & BITS16(as_i(v[r]) == 0));
      m = 0xFFFFu;
      break;
    case OP_ISFALSE_R:
      set_bits(v, m & BITS16(as_d(v[r]) == 0.0));
      m = 0xFFFFu;
      break;
  }
}

// IN (list of constants [c0, c0 + count)): NULL when nothing matches and
// the probe or a list element is NULL
template <class T, class C>
__device__ __forceinline__ void in_list(const C& cs, int op, int c0,
                                        int count, T (&v)[PRED_ROWS],
                                        unsigned& m) {
  unsigned hit = 0;
  bool list_null = false;
  for (int k = 0; k < count; ++k) {
    if (cs.null(c0 + k)) {
      list_null = true;
      continue;
    }
    const T x = (T)cs.val(c0 + k);
    hit |= op == OP_IN_I ? BITS16(as_i(v[r]) == as_i(x))
                         : BITS16(as_d(v[r]) == as_d(x));
  }
  hit &= m;
  const unsigned any_null = list_null ? 0xFFFFu : ~m & 0xFFFFu;
  set_bits(v, hit);
  m = (hit | ~any_null) & 0xFFFFu;
}

// a <- a op b (IMM: b is the constant bc, valid where bm)
template <bool IMM, class T>
__device__ __forceinline__ void binary(int op, T (&a)[PRED_ROWS],
                                       unsigned& am,
                                       const T (&b)[PRED_ROWS],
                                       unsigned bm, T bc) {
#define B(r) (IMM ? bc : b[r])
#define EACH(stmt)                                 \
  _Pragma("unroll") for (int r = 0; r < PRED_ROWS; ++r) { stmt; }
#define CMP_CASE(code, expr)   \
  case code:                   \
    set_bits(a, BITS16(expr)); \
    am &= bm;                  \
    break;
  switch (op) {
    case OP_ADD_I32:
      EACH(a[r] = of_i<T>((int)((unsigned)a[r] + (unsigned)B(r))));
      am &= bm;
      break;
    case OP_ADD_I64:
      EACH(a[r] = a[r] + B(r));
      am &= bm;
      break;
    case OP_ADD_F32:
      EACH(a[r] = of_d<T>((double)__fadd_rn(f32(a[r]), f32(B(r)))));
      am &= bm;
      break;
    case OP_SUB_I32:
      EACH(a[r] = of_i<T>((int)((unsigned)a[r] - (unsigned)B(r))));
      am &= bm;
      break;
    case OP_SUB_I64:
      EACH(a[r] = a[r] - B(r));
      am &= bm;
      break;
    case OP_SUB_F32:
      EACH(a[r] = of_d<T>((double)__fsub_rn(f32(a[r]), f32(B(r)))));
      am &= bm;
      break;
    case OP_MUL_I32:
      EACH(a[r] = of_i<T>((int)((unsigned)a[r] * (unsigned)B(r))));
      am &= bm;
      break;
    case OP_MUL_I64:
      EACH(a[r] = a[r] * B(r));
      am &= bm;
      break;
    case OP_MUL_F32:
      EACH(a[r] = of_d<T>((double)__fmul_rn(f32(a[r]), f32(B(r)))));
      am &= bm;
      break;
    CMP_CASE(OP_GT_I, as_i(a[r]) > as_i(B(r)))
    CMP_CASE(OP_GE_I, as_i(a[r]) >= as_i(B(r)))
    CMP_CASE(OP_LT_I, as_i(a[r]) < as_i(B(r)))
    CMP_CASE(OP_LE_I, as_i(a[r]) <= as_i(B(r)))
    CMP_CASE(OP_EQ_I, as_i(a[r]) == as_i(B(r)))
    CMP_CASE(OP_NE_I, as_i(a[r]) != as_i(B(r)))
    CMP_CASE(OP_GT_R, as_d(a[r]) > as_d(B(r)))
    CMP_CASE(OP_GE_R, as_d(a[r]) >= as_d(B(r)))
    CMP_CASE(OP_LT_R, as_d(a[r]) < as_d(B(r)))
    CMP_CASE(OP_LE_R, as_d(a[r]) <= as_d(B(r)))
    CMP_CASE(OP_EQ_R, as_d(a[r]) == as_d(B(r)))
    CMP_CASE(OP_NE_R, as_d(a[r]) != as_d(B(r)))
    case OP_NULLEQ_I:
    case OP_NULLEQ_R: {
      const unsigned eq = op == OP_NULLEQ_I
                              ? BITS16(as_i(a[r]) == as_i(B(r)))
                              : BITS16(as_d(a[r]) == as_d(B(r)));
      set_bits(a, (~am & ~bm & 0xFFFFu) | (am & bm & eq));
      am = 0xFFFFu;
      break;
    }
    case OP_AND: {
      const unsigned af = am & BITS16(as_i(a[r]) == 0);
      const unsigned bf = bm & BITS16(as_i(B(r)) == 0);
      set_bits(a, ~(af | bf) & 0xFFFFu);
      am = (am & bm) | af | bf;
      break;
    }
    case OP_OR: {
      const unsigned at = am & BITS16(as_i(a[r]) != 0);
      const unsigned bt = bm & BITS16(as_i(B(r)) != 0);
      set_bits(a, at | bt);
      am = (am & bm) | at | bt;
      break;
    }
    case OP_XOR:
      set_bits(a, BITS16((as_i(a[r]) != 0) != (as_i(B(r)) != 0)));
      am &= bm;
      break;
  }
#undef B
#undef EACH
#undef CMP_CASE
}

// 16 row bits -> 16 bool bytes (row r in byte r)
__device__ __forceinline__ unsigned nibble_bytes(unsigned x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

// The program's constants: sel_pred's, in its launch parameters.
struct ParamConsts {
  const PredParams& p;
  __device__ __forceinline__ long long val(int c) const { return p.cval[c]; }
  __device__ __forceinline__ int null(int c) const { return p.cnull[c]; }
};

// The program over a thread's 16 rows: `keep` the rows still kept (those
// below n), `load(c, v, m)` column c's rows and their validity, `cs` the
// constants.  Returns the rows that every RPN keeps.
template <int ND, class T, class C, class Load>
__device__ __forceinline__ unsigned run_program(const PredParams& p,
                                                const C& cs, unsigned keep,
                                                Load&& load) {
  T st[ND][PRED_ROWS];
  unsigned sm[ND];
  int sp = 0;
  for (int k = 0; k < p.n_ops; ++k) {
    const int op = p.op[k], arg = p.arg[k], aux = p.aux[k];
    if (op == OP_COL || op == OP_CONST) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        if (d != sp) continue;
        if (op == OP_COL) {
          load(arg, st[d], sm[d]);
        } else {
#pragma unroll
          for (int r = 0; r < PRED_ROWS; ++r) st[d][r] = (T)cs.val(arg);
          sm[d] = cs.null(arg) ? 0u : 0xFFFFu;
        }
      }
      ++sp;
    } else if (op == OP_KEEP_I || op == OP_KEEP_R) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        if (d != sp - 1) continue;
        const unsigned nz = op == OP_KEEP_I
                                ? BITS16(as_i(st[d][r]) != 0)
                                : BITS16(as_d(st[d][r]) != 0.0);
        keep &= sm[d] & nz;
      }
      --sp;
    } else if (op >= OP_BINARY && aux) {
#pragma unroll
      for (int d = 0; d < ND; ++d)
        if (d == sp - 1)
          binary<true, T>(op, st[d], sm[d], st[d],
                          cs.null(arg) ? 0u : 0xFFFFu, (T)cs.val(arg));
    } else if (op >= OP_BINARY) {
#pragma unroll
      for (int d = 1; d < ND; ++d)
        if (d == sp - 1)
          binary<false, T>(op, st[d - 1], sm[d - 1], st[d], sm[d], (T)0);
      --sp;
    } else if (op == OP_IN_I || op == OP_IN_R) {
#pragma unroll
      for (int d = 0; d < ND; ++d)
        if (d == sp - 1) in_list<T>(cs, op, arg, aux, st[d], sm[d]);
    } else {
#pragma unroll
      for (int d = 0; d < ND; ++d)
        if (d == sp - 1) unary<T>(op, st[d], sm[d]);
    }
  }
  return keep;
}

// 16 kept-row bits -> the two packed bytes of rows [i, i + 16): row 16j
// in bit 7 of the first byte (np.packbits)
__device__ __forceinline__ unsigned short packed16(unsigned keep) {
  const unsigned lo = __brev(keep & 0xFFu) >> 24;
  const unsigned hi = __brev((keep >> 8) & 0xFFu) >> 24;
  return (unsigned short)(lo | (hi << 8));
}

// One CTA evaluates 4096 rows (16 a thread) and adds its popcount into
// the count of its 32768-row block (zeroed by the launcher).
template <int ND, class T>
__global__ void __launch_bounds__(THREADS)
    sel_pred_kernel(const __grid_constant__ PredParams p) {
  __shared__ long long red[THREADS / 32];
  const long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) *
                      PRED_ROWS;
  const long long left = p.n - i;
  unsigned keep =
      left >= PRED_ROWS ? 0xFFFFu : left > 0 ? (1u << left) - 1u : 0u;
  if (keep != 0) {
    const bool full = p.vec && left >= PRED_ROWS;
    keep = run_program<ND, T>(
        p, ParamConsts{p}, keep,
        [&](int c, T (&v)[PRED_ROWS], unsigned& m) {
          load_col<T>(p, c, i, full, v, m);
        });
  }
  *reinterpret_cast<unsigned short*>(p.packed + i / 8) = packed16(keep);
  if (p.bools != nullptr)
    *reinterpret_cast<uint4*>(p.bools + i) =
        make_uint4(nibble_bytes(keep & 0xFu),
                   nibble_bytes((keep >> 4) & 0xFu),
                   nibble_bytes((keep >> 8) & 0xFu),
                   nibble_bytes(keep >> 12));
  const long long total = block_sum(__popc(keep), red);
  if (threadIdx.x == 0 && total != 0) {
    atomicAdd(&p.block_counts[i / ROWS_PER_BLOCK], (int)total);
    atomicAdd(p.count, (unsigned long long)total);
  }
}

// ------------------------------------------------------ sel_pred_batched

// Rows [i, i + 16) compared with the constant c by comparison `op`
// (OP_GT_I .. OP_NE_R), as `binary` compares them.
template <class T>
__device__ __forceinline__ unsigned cmp16(int op, const T (&v)[PRED_ROWS],
                                          T c) {
  switch (op) {
    case OP_GT_I: return BITS16(as_i(v[r]) > as_i(c));
    case OP_GE_I: return BITS16(as_i(v[r]) >= as_i(c));
    case OP_LT_I: return BITS16(as_i(v[r]) < as_i(c));
    case OP_LE_I: return BITS16(as_i(v[r]) <= as_i(c));
    case OP_EQ_I: return BITS16(as_i(v[r]) == as_i(c));
    case OP_NE_I: return BITS16(as_i(v[r]) != as_i(c));
    case OP_GT_R: return BITS16(as_d(v[r]) > as_d(c));
    case OP_GE_R: return BITS16(as_d(v[r]) >= as_d(c));
    case OP_LT_R: return BITS16(as_d(v[r]) < as_d(c));
    case OP_LE_R: return BITS16(as_d(v[r]) <= as_d(c));
    case OP_EQ_R: return BITS16(as_d(v[r]) == as_d(c));
    default: return BITS16(as_d(v[r]) != as_d(c));
  }
}

// One lane's constants, staged in shared memory.
struct LaneConsts {
  const long long* v;
  const int* nl;
  __device__ __forceinline__ long long val(int c) const { return v[c]; }
  __device__ __forceinline__ int null(int c) const { return nl[c]; }
};

// sel_pred's program over one tile of the feed for G lanes of constants.
// A thread takes 16 rows, as sel_pred does: it reads each column the
// program names once (16-byte loads where `vec`) into its own slots of the
// shared tile (layout [column][row][thread], so the warp's accesses are
// consecutive words), then runs the program once per lane over those
// slots, writes that lane's 2 packed bytes and adds the lane's popcount
// (a warp sum, then one shared atomic a warp) to the CTA's count of the
// lane.  A thread only reads back the slots it wrote: no barrier between
// the tile's load and the lanes.  The CTA walks the tiles grid-stride and
// adds its G counts to the output once at the end.
template <int ND, class T>
__global__ void sel_pred_batched_kernel(const __grid_constant__ PredParams p,
                                        const __grid_constant__ BatchParams b) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned lane_count[BATCH_MAX_LANES];
  const int nt = blockDim.x, t = threadIdx.x;
  const int nc = b.n_consts, G = b.lanes;
  long long* s_cval = reinterpret_cast<long long*>(smem);
  int* s_cnull = reinterpret_cast<int*>(s_cval + G * nc);
  T* tile = reinterpret_cast<T*>(smem + b.tile_offset);
  unsigned* tile_ok = reinterpret_cast<unsigned*>(
      tile + (long long)b.n_cols * PRED_ROWS * nt);
  for (int k = t; k < G * nc; k += nt) {
    s_cval[k] = b.cval[k];
    s_cnull[k] = b.cnull[k];
  }
  for (int g = t; g < G; g += nt) lane_count[g] = 0;
  __syncthreads();
  const long long rows_per_tile = (long long)nt * PRED_ROWS;
  for (long long tl = blockIdx.x; tl < b.n_tiles; tl += gridDim.x) {
    const long long i = tl * rows_per_tile + (long long)t * PRED_ROWS;
    const long long left = p.n - i;
    const unsigned live =
        left >= PRED_ROWS ? 0xFFFFu : left > 0 ? (1u << left) - 1u : 0u;
    if (b.simple) {
      // the program is terms (column 0 compared with a constant, kept):
      // the rows stay in registers and each lane costs one compare a
      // row and term
      T v[PRED_ROWS];
      unsigned m = 0;
      if (live != 0) load_col<T>(p, 0, i, p.vec && left >= PRED_ROWS, v, m);
      for (int g = 0; g < G; ++g) {
        unsigned keep = live & m;
        for (int k = 1; k < p.n_ops && keep != 0; k += 3) {
          const int c = g * nc + p.arg[k];
          keep &= s_cnull[c] ? 0u : cmp16<T>(p.op[k], v, (T)s_cval[c]);
        }
        *reinterpret_cast<unsigned short*>(b.packed + g * b.lane_bytes +
                                           i / 8) = packed16(keep);
        const unsigned cnt = __reduce_add_sync(FULL, __popc(keep));
        if ((t & 31) == 0 && cnt != 0) atomicAdd(&lane_count[g], cnt);
      }
      continue;
    }
    if (live != 0) {
      const bool full = p.vec && left >= PRED_ROWS;
      for (int c = 0; c < b.n_cols; ++c) {
        T v[PRED_ROWS];
        unsigned m;
        load_col<T>(p, c, i, full, v, m);
#pragma unroll
        for (int r = 0; r < PRED_ROWS; ++r)
          tile[((long long)c * PRED_ROWS + r) * nt + t] = v[r];
        tile_ok[c * nt + t] = m;
      }
    }
    for (int g = 0; g < G; ++g) {
      unsigned keep = live;
      if (live != 0)
        keep = run_program<ND, T>(
            p, LaneConsts{s_cval + g * nc, s_cnull + g * nc}, live,
            [&](int c, T (&v)[PRED_ROWS], unsigned& m) {
#pragma unroll
              for (int r = 0; r < PRED_ROWS; ++r)
                v[r] = tile[((long long)c * PRED_ROWS + r) * nt + t];
              m = tile_ok[c * nt + t];
            });
      *reinterpret_cast<unsigned short*>(b.packed + g * b.lane_bytes +
                                         i / 8) = packed16(keep);
      const unsigned cnt = __reduce_add_sync(FULL, __popc(keep));
      if ((t & 31) == 0 && cnt != 0) atomicAdd(&lane_count[g], cnt);
    }
  }
  __syncthreads();
  for (int g = t; g < G; g += nt)
    if (lane_count[g] != 0)
      atomicAdd(b.counts + g, (unsigned long long)lane_count[g]);
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

// sel_pred_batched at `nt` threads a CTA: its shared bytes
template <class T>
long long batched_smem(const BatchParams& b, int nt) {
  if (b.simple) return b.tile_offset;
  return b.tile_offset +
         (long long)b.n_cols * nt * (PRED_ROWS * (long long)sizeof(T) + 4);
}

// Launch sel_pred_batched<ND, T>: the widest CTA whose tile fits
// BATCH_SMEM_BYTES, and as many CTAs as the card keeps resident (each
// walks the tiles grid-stride).
template <int ND, class T>
cudaError_t launch_batched(const PredParams* p, BatchParams* b,
                           long long n_blocks, cudaStream_t s) {
  int nt = THREADS;
  while (nt > 32 && batched_smem<T>(*b, nt) > BATCH_SMEM_BYTES) nt /= 2;
  const long long smem = batched_smem<T>(*b, nt);
  if (smem > BATCH_SMEM_BYTES) return cudaErrorInvalidValue;
  b->n_tiles = n_blocks * ROWS_PER_BLOCK / ((long long)nt * PRED_ROWS);
  const void* fn = reinterpret_cast<const void*>(
      &sel_pred_batched_kernel<ND, T>);
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
           &per_sm, fn, nt, (size_t)smem)) != cudaSuccess)
    return e;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > b->n_tiles) grid = b->n_tiles;
  void* args[] = {const_cast<PredParams*>(p), b};
  return cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(nt), args,
                          (size_t)smem, s);
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

// sel_pred over rows [0, n): `nd` the program's stack depth (at most 4),
// `wide` 1 when it holds an int64 value (64-bit payloads); the count and
// the `n_blocks` block counts are zeroed here.  One CTA per 4096 rows.
int sel_pred_launch(int device, const PredParams* p, int nd, int wide,
                    long long n_blocks, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(p->count, 0, 8, s)) != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(p->block_counts, 0, 4 * n_blocks, s)) !=
      cudaSuccess)
    return e;
  const unsigned grid = (unsigned)(n_blocks * PRED_STEPS);
  // the stack in registers: 1, 2 or 4 entries of 16 rows
  if (wide && nd <= 1)
    sel_pred_kernel<1, u64><<<grid, THREADS, 0, s>>>(*p);
  else if (wide && nd <= 2)
    sel_pred_kernel<2, u64><<<grid, THREADS, 0, s>>>(*p);
  else if (wide)
    sel_pred_kernel<4, u64><<<grid, THREADS, 0, s>>>(*p);
  else if (nd <= 1)
    sel_pred_kernel<1, unsigned><<<grid, THREADS, 0, s>>>(*p);
  else if (nd <= 2)
    sel_pred_kernel<2, unsigned><<<grid, THREADS, 0, s>>>(*p);
  else
    sel_pred_kernel<4, unsigned><<<grid, THREADS, 0, s>>>(*p);
  return cudaGetLastError();
}

int sel_pred_params_bytes() { return (int)sizeof(PredParams); }

// sel_pred_batched over rows [0, n) for b->lanes lanes: `p` the program
// (its cval / cnull unused), `b` the lanes' constants on the device and
// the outputs; `nd` and `wide` as for sel_pred.  The G counts are zeroed
// here; every lane's n_blocks * 4096 packed bytes are written.
int sel_pred_batched_launch(int device, const PredParams* p, BatchParams* b,
                            int nd, int wide, long long n_blocks,
                            void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b->lanes < 1 || b->lanes > BATCH_MAX_LANES ||
      b->n_consts > PRED_MAX_CONSTS || b->n_cols < 1 ||
      b->n_cols > PRED_MAX_COLS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(b->counts, 0, 8 * (size_t)b->lanes, s)) !=
      cudaSuccess)
    return e;
  if (wide && nd <= 1)
    e = launch_batched<1, u64>(p, b, n_blocks, s);
  else if (wide && nd <= 2)
    e = launch_batched<2, u64>(p, b, n_blocks, s);
  else if (wide)
    e = launch_batched<4, u64>(p, b, n_blocks, s);
  else if (nd <= 1)
    e = launch_batched<1, unsigned>(p, b, n_blocks, s);
  else if (nd <= 2)
    e = launch_batched<2, unsigned>(p, b, n_blocks, s);
  else
    e = launch_batched<4, unsigned>(p, b, n_blocks, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

int sel_batch_params_bytes() { return (int)sizeof(BatchParams); }

int sel_batch_max_lanes() { return BATCH_MAX_LANES; }

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

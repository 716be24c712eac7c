// Selection vectors for Hopper: the predicate evaluated over the feed
// (sel_pred, and sel_pred_batched for a group of requests) and the
// in-order compaction of the selected rows (sel_compact).  The packed mask
// of a bool predicate evaluated elsewhere (sel_mask) is sel_mask.cu's.
//
// Replaces the XLA kernels of tikv_tpu/device/selection.py:
//   sel_pred    <- build_mask_kernel (:227), the whole fused pass: the
//                  selection RPNs evaluated over the feed's planes, then
//                  the row count, the jnp.packbits mask and, where a later
//                  kernel takes one, the bool mask;
//   sel_pred_batched <- build_batched_mask_kernel (:273): G requests'
//                  constants over one program and one feed, G counts and
//                  G packed masks;
//   sel_compact <- build_index_kernel (:323): ascending int32 row indices
//                  into [k_cap] with -1 fill and an overflow flag
//                  (nonzero(size=k_cap)), and build_compact_kernel (:357):
//                  the same indices plus each projected plane's value at
//                  them, the gather fused into the compaction.
//
// The mask layout (sel_mask.cu keeps the same): a block of ROWS_PER_BLOCK
// = 32768 rows is 4096 packed bytes in np.packbits' bit order (row 8j is
// bit 7 of byte j), rows at or past n reading as 0, with one popcount per
// block (`block_counts`), which is what sel_compact scans.
// sel_pred writes that layout, as sel_mask does, so sel_compact reads
// either.  Bound: bytes, the planes the selection names read once and the
// packed mask (and the bool mask) written once: (4 + 1/8) B x 10,485,760
// rows at config 2 is 12.9 us at 3.35 TB/s.  A thread takes 16 consecutive
// rows at a time (a CTA's 256 threads 4096 rows, 8 CTAs a block), read
// with 16-byte loads.  The predicate is a short program (the wrapper's encoder in
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
// conditions) takes sel_batched.cu's terms kernel instead; the register
// path below keeps only terms whose comparisons read another dtype than
// the column's (device/selection.py terms_route).  It stays because this
// kernel's interpreter ran 57% slower at 6b-ep's shape on an H100 without
// it (PERF.md section 6).  The
// lanes' constants (G x 32 int64 would pass the 4 KB of
// launch parameters at G = 16) travel in a small device buffer, staged in
// shared memory once a CTA.  Output: G int64 counts, then G packed masks
// of n_blocks * 4096 bytes, in one buffer, so one copy brings the group
// home.
// sel_compact reads the packed mask (n / 8 bytes), the block counts, and
// for each selected row below k_cap its projected planes' elements; it
// writes the whole output buffer once (header, indices, each plane and the
// 16-byte gaps between them) in one launch, nothing zeroed beforehand.  A
// block issues its 16-byte mask load first, then reads every block count
// with 16-byte loads: one block reduction gives both the selected rows of
// the blocks before it (its offset) and the total.  The tail needs only
// the total, so it goes first: every block takes its grid-stride share,
// 16 bytes a store, of -1 over the indices [min(total, k_cap), k_cap) and
// 0 over each plane's tail and the gaps (the grid is at least as large as
// the tail needs, so a small mask with a large capacity fills quickly);
// block 0 writes the header (the total, exact past k_cap, and the
// overflow flag).  Then one block scan of its threads' popcounts (128 rows
// a thread) places each selected row; the rows are staged in shared
// memory in row order, 8192 output slots at a time (one window unless the
// block selects more), and the block writes a window's indices
// contiguously, then gathers every plane there, a thread's loads of up to
// 8 planes and 2 slots in flight before its stores.  Slots past k_cap are
// not written.

#include <cuda_runtime.h>

#define THREADS 256
#define ROWS_PER_THREAD 128
#define ROWS_PER_BLOCK (THREADS * ROWS_PER_THREAD)
#define MAX_PLANES 128

#define PRED_ROWS 16          // rows a thread evaluates at a time
// CTAs a block of the mask layout
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

// sel_compact's launch parameters (device/selection.py mirrors the
// layout).  The output is one buffer of out_bytes (a multiple of 16) from
// header: the header, idx at byte 16, then each plane's dst, 16-byte
// aligned, in order.
struct CompactParams {
  const unsigned char* packed;  // n_blocks * ROWS_PER_BLOCK / 8 bytes
  const int* block_counts;      // n_blocks
  long long n_blocks;
  long long k_cap;
  int* idx;                     // k_cap
  long long* header;            // [0] selected rows, [1] overflow flag
  long long out_bytes;
  int n_planes;
  int esize[MAX_PLANES];        // 1, 4 or 8 bytes
  const void* src[MAX_PLANES];
  void* dst[MAX_PLANES];        // k_cap elements each
};

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

#define COMPACT_WINDOW 8192  // output slots a block stages at a time

// the exclusive sum of v over the block's threads; *total gets the
// block's; syncs before returning, so calls may follow each other
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_total,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int x = warp_total[w];
    before += w < warp ? x : 0;
    all += x;
  }
  *total = all;
  __syncthreads();
  return before + incl - v;
}

#define GATHER_PLANES 8  // planes whose loads a thread keeps in flight

// an element of 1, 4 or 8 bytes as 64 bits, and back
__device__ __forceinline__ unsigned long long load_elem(const void* src,
                                                        int es, int row) {
  if (es == 1) return static_cast<const unsigned char*>(src)[row];
  if (es == 4) return static_cast<const unsigned*>(src)[row];
  return static_cast<const unsigned long long*>(src)[row];
}

__device__ __forceinline__ void store_elem(void* dst, int es, long long i,
                                           unsigned long long x) {
  if (es == 1)
    static_cast<unsigned char*>(dst)[i] = (unsigned char)x;
  else if (es == 4)
    static_cast<unsigned*>(dst)[i] = (unsigned)x;
  else
    static_cast<unsigned long long*>(dst)[i] = x;
}

// slots [at, at + len) of the indices and of every plane from the rows
// staged in `rows`: a warp's stores are contiguous, and each thread issues
// its loads of up to GATHER_PLANES planes and 2 slots before any store
__device__ __forceinline__ void write_slots(const CompactParams& p,
                                            const int* rows, long long at,
                                            int len) {
  for (int i = threadIdx.x; i < len; i += THREADS) p.idx[at + i] = rows[i];
  for (int q0 = 0; q0 < p.n_planes; q0 += GATHER_PLANES) {
    const int nq = p.n_planes - q0 < GATHER_PLANES ? p.n_planes - q0
                                                   : GATHER_PLANES;
    for (int i0 = threadIdx.x; i0 < len; i0 += 2 * THREADS) {
      unsigned long long x[2][GATHER_PLANES];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * THREADS;
#pragma unroll
        for (int q = 0; q < GATHER_PLANES; ++q)
          if (q < nq && i < len)
            x[u][q] = load_elem(p.src[q0 + q], p.esize[q0 + q], rows[i]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * THREADS;
#pragma unroll
        for (int q = 0; q < GATHER_PLANES; ++q)
          if (q < nq && i < len)
            store_elem(p.dst[q0 + q], p.esize[q0 + q], at + i, x[u][q]);
      }
    }
  }
}

// bytes [a, mid) of `out` to 0xff and [mid, b) to 0 (a <= mid <= b, b a
// multiple of 16), 16 bytes a store; thread `t` of `nt` takes every nt-th
// 16 bytes.  The first 16 bytes may begin below a: those bytes are
// another thread's output and are not written.
__device__ __forceinline__ void fill_tail(unsigned char* out, long long a,
                                          long long mid, long long b,
                                          long long t, long long nt) {
  for (long long c = a / 16 + t; c < b / 16; c += nt) {
    const long long lo = 16 * c;
    if (lo >= a && lo + 16 <= mid) {
      reinterpret_cast<uint4*>(out)[c] = make_uint4(~0u, ~0u, ~0u, ~0u);
    } else if (lo >= mid) {
      reinterpret_cast<uint4*>(out)[c] = make_uint4(0, 0, 0, 0);
    } else {
      for (long long x = lo > a ? lo : a; x < lo + 16; ++x)
        out[x] = x < mid ? 0xff : 0;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    sel_compact_kernel(const __grid_constant__ CompactParams p) {
  __shared__ int s_rows[COMPACT_WINDOW];   // a window's rows, in order
  __shared__ long long s_red[3][THREADS / 32];
  __shared__ int s_warp[THREADS / 32];
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const bool mine = b < p.n_blocks;  // the grid may pass n_blocks: tail only
  // the mask first (this thread's 128 rows): nothing below waits for the
  // offsets to issue it
  uint4 v = make_uint4(0, 0, 0, 0);
  if (mine)
    v = reinterpret_cast<const uint4*>(p.packed +
                                       b * (ROWS_PER_BLOCK / 8))[t];
  // every block count once: those before b (the offset), b's, all
  long long before = 0, own = 0, total = 0;
  const int* bc = p.block_counts;
  const long long nb = p.n_blocks;
  auto add = [&](long long i, int c) {
    before += i < b ? c : 0;
    own += i == b ? c : 0;
    total += c;
  };
  long long i0 = 0;
  if ((reinterpret_cast<unsigned long long>(bc) & 15) == 0) {
    i0 = nb & ~3ll;
    for (long long q = t; 4 * q < i0; q += THREADS) {
      const int4 c = reinterpret_cast<const int4*>(bc)[q];
      add(4 * q, c.x);
      add(4 * q + 1, c.y);
      add(4 * q + 2, c.z);
      add(4 * q + 3, c.w);
    }
  }
  for (long long i = i0 + t; i < nb; i += THREADS) add(i, bc[i]);
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_xor_sync(FULL, before, o);
    own += __shfl_xor_sync(FULL, own, o);
    total += __shfl_xor_sync(FULL, total, o);
  }
  if ((t & 31) == 0) {
    s_red[0][t >> 5] = before;
    s_red[1][t >> 5] = own;
    s_red[2][t >> 5] = total;
  }
  __syncthreads();
  before = own = total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    before += s_red[0][w];
    own += s_red[1][w];
    total += s_red[2][w];
  }
  if (b == 0 && t == 0) {
    p.header[0] = total;
    p.header[1] = total > p.k_cap ? 1 : 0;
  }
  // the tail, which needs only the total, before the rows: -1 past the
  // indices written, 0 past each plane's and over the gaps, every block a
  // share; its stores drain while the block compacts
  const long long m = total < p.k_cap ? total : p.k_cap;
  {
    const long long gt = b * THREADS + t, nt = (long long)gridDim.x * THREADS;
    unsigned char* out = reinterpret_cast<unsigned char*>(p.header);
    const long long idx0 = reinterpret_cast<unsigned char*>(p.idx) - out;
    long long end = p.n_planes > 0
                        ? static_cast<unsigned char*>(p.dst[0]) - out
                        : p.out_bytes;
    fill_tail(out, idx0 + 4 * m, idx0 + 4 * p.k_cap, end, gt, nt);
    for (int q = 0; q < p.n_planes; ++q) {
      const long long a = static_cast<unsigned char*>(p.dst[q]) - out +
                          p.esize[q] * m;
      end = q + 1 < p.n_planes
                ? static_cast<unsigned char*>(p.dst[q + 1]) - out
                : p.out_bytes;
      fill_tail(out, a, a, end, gt, nt);
    }
  }
  // the block's slots [before, before + limit): uniform over the block
  const long long room = p.k_cap - before;
  const int limit = (int)(own < room ? own : room);
  if (!mine || limit <= 0) return;
  // bit j of bits[k]: row 128 t + 32 k + j (a packed byte keeps its first
  // row in bit 7)
  const unsigned bits[4] = {__brev(__byte_perm(v.x, 0, 0x0123)),
                            __brev(__byte_perm(v.y, 0, 0x0123)),
                            __brev(__byte_perm(v.z, 0, 0x0123)),
                            __brev(__byte_perm(v.w, 0, 0x0123))};
  const int cnt = __popc(bits[0]) + __popc(bits[1]) + __popc(bits[2]) +
                  __popc(bits[3]);
  int all;
  const int first = block_exclusive_sum(cnt, s_warp, &all);
  const int row0 = (int)(b * ROWS_PER_BLOCK) + ROWS_PER_THREAD * t;
  // a window of COMPACT_WINDOW slots at a time (one, unless the block
  // selects more rows): its rows staged in order, then written out
  for (int w0 = 0; w0 < limit; w0 += COMPACT_WINDOW) {
    const int w1 = limit - w0 < COMPACT_WINDOW ? limit : w0 + COMPACT_WINDOW;
    if (first < w1 && first + cnt > w0) {
      int pos = first;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        for (unsigned x = bits[k]; x != 0 && pos < w1; x &= x - 1, ++pos)
          if (pos >= w0) s_rows[pos - w0] = row0 + 32 * k + __ffs(x) - 1;
      }
    }
    __syncthreads();
    write_slots(p, s_rows, before + w0, w1 - w0);
    __syncthreads();  // s_rows is the next window's
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

// one launch writes every byte of the output (p->header .. + out_bytes):
// a block per mask block, or more where the tail's 16-byte stores want
// them (8 a thread at most)
int sel_compact_launch(int device, const CompactParams* p, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const unsigned char* out = reinterpret_cast<unsigned char*>(p->header);
  if (p->n_blocks < 1 || p->k_cap < 1 || p->n_planes < 0 ||
      p->n_planes > MAX_PLANES)
    return cudaErrorInvalidValue;
  // the layout the kernel's tail assumes: 16-byte aligned regions in order
  bool laid_out = reinterpret_cast<unsigned long long>(out) % 16 == 0 &&
                  p->out_bytes % 16 == 0 &&
                  reinterpret_cast<unsigned char*>(p->idx) == out + 16;
  const unsigned char* end = out + 16 + 4 * p->k_cap;
  for (int q = 0; q < p->n_planes; ++q) {
    const unsigned char* d = static_cast<unsigned char*>(p->dst[q]);
    laid_out = laid_out && (d - out) % 16 == 0 && d >= end &&
               (p->esize[q] == 1 || p->esize[q] == 4 || p->esize[q] == 8);
    end = d + p->esize[q] * p->k_cap;
  }
  if (!laid_out || end > out + p->out_bytes) return cudaErrorInvalidValue;
  long long grid = (p->out_bytes + 16 * THREADS * 8 - 1) / (16 * THREADS * 8);
  if (grid > 2048) grid = 2048;
  if (grid < p->n_blocks) grid = p->n_blocks;
  sel_compact_kernel<<<(unsigned)grid, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}

int sel_params_bytes() { return (int)sizeof(CompactParams); }

int sel_max_planes() { return MAX_PLANES; }

const char* sel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

// The cross-shard merges of a row-sharded feed for Hopper: the psum of the
// shards' summed states and the min/max merge of their stacked states.
//
// Replaces the collectives of tikv_tpu/device/runner.py:
//   shard_psum         <- _pallas_sharded_wrap (:3930), whose shard_map
//                         psums the packed int32 partial pairs of the fused
//                         kernel over both mesh axes, and
//                         _finalize_psum_summed (:2599), the psum of every
//                         summed state leaf (count, sum, nonnull, sumsq,
//                         the two-level planes; int64 and float64);
//   shard_bucket_merge <- _finalize_hash_bucket_merge (:2606): after the
//                         psum, an all-to-all by key bucket sends bucket j
//                         of every shard's (1, slots_m) MIN/MAX partial to
//                         shard j, which reduces the (S, slots_m/S) pile.
// The mesh is driven from one process: the runner copies every shard's
// buffer to the mesh's first card (Tensor.to; none on one card) and
// merges the whole (S, slots) MIN/MAX pile there in the same launch as the
// psum of the summed rows, so the all-to-all, which would only add copies,
// has no counterpart.
//
// Two kernels read S <= MAX_SRC sources over segments of words (a
// segment: its first word, its length and its op; the same offsets in
// every source and in the output).  Block (x, y) takes segment y; the x
// blocks stride its words.  Per op:
//   sum (int64, float64): out[w] = src_0[w] + src_1[w] + ... + src_{S-1}[w],
//                       in shard order, no atomics: int64 words add with
//                       wraparound (the reference's int64 psum); float64
//                       words add in that fixed order, so the result is
//                       deterministic and bit-equal to the plain version
//                       (shard.shard_psum_plain: acc = acc + part_s), NaN
//                       bits included: the first NaN in shard order,
//                       quieted, as the card's add of (acc, part) gives.
//   min, max (int64, float64): out[w] = min (or max) over s of src_s[w].
//                       A NaN propagates, as torch.amin/amax and jnp.min
//                       do: the first NaN in shard order is kept, bits and
//                       all; among equal values (+0.0 and -0.0) the first
//                       in shard order is kept.
// psum_kernel takes the sum ops only (shard_psum, and every launch whose
// segments are all sums); merge_kernel takes any mix of the six
// (shard_bucket_merge, and shard_merge: the runner's GROUP BY fold merge,
// its summed rows and its MIN/MAX rows in one launch).  A block reads its
// segment's op once, before the word loop, and each op has its own loop.
// Bound: the launch.  At the main path's shapes a merge moves kilobytes
// (config 4: 1026 slots, S = 4), so what is left to cut is the work around
// the launch and the dependent steps inside it:
// - the parameter block is sized to the request (MergeArgs<S>): the S
//   source pointers and up to INLINE_SEGS segments, 256 bytes at S = 4
//   where one block for every shape took 1,880; more segments ride in a
//   device table (the wrapper copies it from pinned memory on the launch
//   stream);
// - S is a template parameter for 2, 4 and 8 sources: a thread issues
//   every source's 16-byte load of its word pair before the first add
//   (the adds keep shard order); other counts take a general path that
//   loads four sources at a time;
// - the launch is programmatic (cudaLaunchKernelEx with programmatic
//   stream serialization): the grid may be scheduled while the kernel
//   before it on the stream (a shard's hash_agg, twolevel or agg_fold)
//   drains, and griddepcontrol.wait at the kernel's start holds every
//   global read and write until that kernel has finished and its writes
//   are visible (out comes from the caching allocator and may be memory
//   the kernel before is still reading).  After a copy or a host-side
//   operation the attribute changes nothing.
// A thread takes two words with one 16-byte load a source where every
// source and the output share one 16-byte phase (the segment's odd
// leading and trailing words go one at a time), else one word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SRC = 32;
constexpr int INLINE_SEGS = 8;
constexpr int THREADS = 256;
constexpr long long QUIET = 1LL << 51;  // a float64 NaN's quiet bit

enum : int {
  OP_SUM_I64 = 0,
  OP_SUM_F64 = 1,
  OP_MIN_I64 = 2,
  OP_MAX_I64 = 3,
  OP_MIN_F64 = 4,
  OP_MAX_F64 = 5,
};

}  // namespace

// one segment of words (device/shard.py _Seg)
struct Seg {
  long long off;  // its first word
  long long len;  // its words
  int op;
  int pad;
};

// The launch parameters for S sources (S = 0: the general path, n_src
// sources in MAX_SRC slots); device/shard.py _args_type builds the same
// layout.
template <int S>
struct MergeArgs {
  const long long* src[S > 0 ? S : MAX_SRC];
  long long* out;
  const Seg* table;  // null: the segments ride in seg[]
  Seg seg[INLINE_SEGS];
  int n_segs;
  int vec;    // 1: sources and output share one 16-byte phase
  int n_src;  // S (the general path reads it)
  int pad;
};

namespace {

__device__ __forceinline__ double as_d(long long x) {
  return __longlong_as_double(x);
}

__device__ __forceinline__ long long of_d(double x) {
  return __double_as_longlong(x);
}

// Waits until the grid before this one on the stream has finished and its
// writes are visible; returns at once when the launch was not
// programmatic.
__device__ __forceinline__ void wait_prior_grid() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// one word merged over the sources, OP known at compile time: `a` the
// running word, `b` source s's
template <int OP>
__device__ __forceinline__ long long fold(long long a, long long b) {
  if constexpr (OP == OP_SUM_I64) {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  } else if constexpr (OP == OP_SUM_F64) {
    // The card's add returns its first operand's NaN, quieted, else its
    // second's (the plain version's acc + part keeps the running sum's);
    // the compiler may hand the add its operands in either order, so the
    // NaN is picked here, in shard order
    const double x = as_d(a), y = as_d(b);
    const long long r = of_d(x + y);
    return isnan(x) ? (a | QUIET) : isnan(y) ? (b | QUIET) : r;
  } else if constexpr (OP == OP_MIN_I64) {
    return b < a ? b : a;
  } else if constexpr (OP == OP_MAX_I64) {
    return b > a ? b : a;
  } else if constexpr (OP == OP_MIN_F64) {
    const double x = as_d(a), y = as_d(b);
    return (!isnan(x) && (isnan(y) || y < x)) ? b : a;
  } else {  // OP_MAX_F64
    const double x = as_d(a), y = as_d(b);
    return (!isnan(x) && (isnan(y) || y > x)) ? b : a;
  }
}

template <int OP>
__device__ __forceinline__ void fold2(longlong2& acc, const longlong2 v) {
  acc.x = fold<OP>(acc.x, v.x);
  acc.y = fold<OP>(acc.y, v.y);
}

__device__ __forceinline__ longlong2 load2(const long long* p) {
  return *reinterpret_cast<const longlong2*>(p);
}

// A compiler barrier after a word's loads (PIN): in the merge kernel, whose
// blocks take any of the six ops, the compiler otherwise sinks a float64
// sum's source load into the fold of the sources before it, predicated on
// the running value not being NaN, so each load waits for the one before.
// With it every load of a word is issued first (on sm_90a ptxas still
// spreads the float64 pair path's four loads over its adds; the int64
// paths issue all four first).
template <bool PIN>
__device__ __forceinline__ void loads_issued() {
  if constexpr (PIN) asm volatile("" ::: "memory");
}

// The word pair at w merged over the sources: every source's load issued
// before the first fold (S > 0), or four sources at a time (S = 0).
template <int S, int OP, bool PIN>
__device__ __forceinline__ longlong2 merge_pair(const MergeArgs<S>& p,
                                                long long w) {
  if constexpr (S > 0) {
    longlong2 v[S];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = load2(p.src[s] + w);
    loads_issued<PIN>();
    longlong2 acc = v[0];
#pragma unroll
    for (int s = 1; s < S; ++s) fold2<OP>(acc, v[s]);
    return acc;
  } else {
    longlong2 acc = load2(p.src[0] + w);
    for (int s0 = 1; s0 < p.n_src; s0 += 4) {
      longlong2 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + j < p.n_src) v[j] = load2(p.src[s0 + j] + w);
      loads_issued<PIN>();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + j < p.n_src) fold2<OP>(acc, v[j]);
    }
    return acc;
  }
}

template <int S, int OP, bool PIN>
__device__ __forceinline__ long long merge_word(const MergeArgs<S>& p,
                                                long long w) {
  if constexpr (S > 0) {
    long long v[S];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = p.src[s][w];
    loads_issued<PIN>();
    long long acc = v[0];
#pragma unroll
    for (int s = 1; s < S; ++s) acc = fold<OP>(acc, v[s]);
    return acc;
  } else {
    long long acc = p.src[0][w];
    for (int s = 1; s < p.n_src; ++s) acc = fold<OP>(acc, p.src[s][w]);
    return acc;
  }
}

// one segment's words [off, off + len) with its op known at compile time
template <int S, int OP, bool PIN = false>
__device__ __forceinline__ void merge_segment(const MergeArgs<S>& p,
                                              long long off, long long len) {
  long long lead = 0, pairs = 0;
  if (p.vec) {
    // the segment's first word is 16-byte aligned unless its address is
    // 8 mod 16; every source shares the output's phase (checked by the
    // wrapper)
    lead = (reinterpret_cast<uintptr_t>(p.out + off) & 15) ? 1 : 0;
    if (lead > len) lead = len;
    pairs = (len - lead) / 2;
  }
  const long long tail0 = lead + 2 * pairs;  // first word after the pairs
  const long long units = lead + pairs + (len - tail0);
  const long long step = (long long)gridDim.x * THREADS;
  for (long long u = (long long)blockIdx.x * THREADS + threadIdx.x;
       u < units; u += step) {
    if (u >= lead && u < lead + pairs) {
      const long long w = off + lead + 2 * (u - lead);
      *reinterpret_cast<longlong2*>(p.out + w) =
          merge_pair<S, OP, PIN>(p, w);
    } else {
      const long long w = off + (u < lead ? u : tail0 + (u - lead - pairs));
      p.out[w] = merge_word<S, OP, PIN>(p, w);
    }
  }
}

// The body of both kernels: the segment's op is read once, before the word
// loop, and each op has its own loop (a runtime op switch inside the loop
// put predicated adds between the loads).  The psum's kernel (SUMS) takes
// the two sum ops, the merge kernel all six (the launcher checks them).
template <int S, bool SUMS>
__device__ __forceinline__ void merge_body(const MergeArgs<S>& p) {
  wait_prior_grid();
  const Seg sg = p.table != nullptr ? p.table[blockIdx.y] : p.seg[blockIdx.y];
  const long long off = sg.off, len = sg.len;
  if constexpr (SUMS) {
    if (sg.op == OP_SUM_F64)
      merge_segment<S, OP_SUM_F64>(p, off, len);
    else
      merge_segment<S, OP_SUM_I64>(p, off, len);
  } else {
    switch (sg.op) {
      case OP_SUM_I64:
        merge_segment<S, OP_SUM_I64, true>(p, off, len);
        break;
      case OP_SUM_F64:
        merge_segment<S, OP_SUM_F64, true>(p, off, len);
        break;
      case OP_MIN_I64:
        merge_segment<S, OP_MIN_I64, true>(p, off, len);
        break;
      case OP_MAX_I64:
        merge_segment<S, OP_MAX_I64, true>(p, off, len);
        break;
      case OP_MIN_F64:
        merge_segment<S, OP_MIN_F64, true>(p, off, len);
        break;
      default:
        merge_segment<S, OP_MAX_F64, true>(p, off, len);
    }
  }
}

// (__grid_constant__: the body reads the block where it lies, in the
// parameter space, with no copy)
template <int S>
__global__ void __launch_bounds__(THREADS)
    psum_kernel(const __grid_constant__ MergeArgs<S> p) {
  merge_body<S, true>(p);
}

template <int S>
__global__ void __launch_bounds__(THREADS)
    merge_kernel(const __grid_constant__ MergeArgs<S> p) {
  merge_body<S, false>(p);
}

template <int S>
cudaError_t launch_as(bool sums, const void* args, int bytes, int grid_x,
                      int n_y, bool dependent, cudaStream_t stream) {
  const MergeArgs<S>& p = *static_cast<const MergeArgs<S>*>(args);
  if (bytes != (int)sizeof(MergeArgs<S>)) return cudaErrorInvalidValue;
  if (S == 0 && (p.n_src < 1 || p.n_src > MAX_SRC))
    return cudaErrorInvalidValue;
  if (p.table == nullptr) {
    if (n_y > INLINE_SEGS || n_y != p.n_segs) return cudaErrorInvalidValue;
    for (int i = 0; i < n_y; ++i) {
      const int op = p.seg[i].op;
      const bool sum = op == OP_SUM_I64 || op == OP_SUM_F64;
      if (op < OP_SUM_I64 || op > OP_MAX_F64 || (sums && !sum) ||
          p.seg[i].off < 0 || p.seg[i].len < 0)
        return cudaErrorInvalidValue;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid_x, (unsigned)n_y);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return sums ? cudaLaunchKernelEx(&cfg, psum_kernel<S>, p)
              : cudaLaunchKernelEx(&cfg, merge_kernel<S>, p);
}

}  // namespace

extern "C" {

// the sizes of the parameter blocks the wrapper lays out
int shard_args_size(int S) {
  switch (S) {
    case 2:
      return (int)sizeof(MergeArgs<2>);
    case 4:
      return (int)sizeof(MergeArgs<4>);
    case 8:
      return (int)sizeof(MergeArgs<8>);
    default:
      return (int)sizeof(MergeArgs<0>);
  }
}

int shard_seg_size() { return (int)sizeof(Seg); }

int shard_inline_segs() { return INLINE_SEGS; }

int shard_threads() { return THREADS; }

// One merge launch: `args` is a MergeArgs<S> of `bytes` bytes (S 2, 4, 8,
// or 0 for the general path), its grid (grid_x, n_y) with block y taking
// segment y (of seg[] or of the device table); `sums` picks the psum's
// kernel (sum segments only), else the merge kernel (any mix of the six
// ops); `dependent` launches it programmatically.
int shard_merge_launch(int device, int sums, int S, const void* args,
                       int bytes, int grid_x, int n_y, int dependent,
                       void* stream) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device && (e = cudaSetDevice(device)) != cudaSuccess) return e;
  if (grid_x < 1 || n_y < 1 || n_y > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 2:
      e = launch_as<2>(sums != 0, args, bytes, grid_x, n_y, dependent, s);
      break;
    case 4:
      e = launch_as<4>(sums != 0, args, bytes, grid_x, n_y, dependent, s);
      break;
    case 8:
      e = launch_as<8>(sums != 0, args, bytes, grid_x, n_y, dependent, s);
      break;
    case 0:
      e = launch_as<0>(sums != 0, args, bytes, grid_x, n_y, dependent, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

const char* shard_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

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
// buffer to the mesh's first card (Tensor.to; none on one card) for the
// psum, and merges the whole (S, slots) MIN/MAX pile there in one launch,
// so the all-to-all, which would only add copies, has no counterpart.
//
// Both kernels read S <= MAX_SRC sources, whose pointers ride the launch
// parameters, over up to MAX_SEGS segments of words (a segment: its first
// word, its length and its op; the same offsets in every source and in the
// output).  Block (x, y) takes segment y; the x blocks stride its words.
//   shard_psum:         out[w] = src_0[w] + src_1[w] + ... + src_{S-1}[w],
//                       in shard order, no atomics: int64 words add with
//                       wraparound (the reference's int64 psum); float64
//                       words add in that fixed order, so the result is
//                       deterministic and bit-equal to the plain version
//                       (shard.shard_psum_plain: acc = acc + part_s).
//   shard_bucket_merge: out[w] = min (or max) over s of src_s[w], int64 or
//                       float64.  A NaN propagates, as torch.amin/amax and
//                       jnp.min do: the first NaN in shard order is kept,
//                       bits and all; among equal values (+0.0 and -0.0)
//                       the first in shard order is kept.
// Bound: the launch.  At the main path's shapes a merge moves kilobytes
// (config 4: 1026 slots, S = 4); a thread takes two words with one 16-byte
// load a source where every source and the output share one 16-byte phase
// (the segment's odd leading and trailing words go one at a time), else
// one word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SRC = 32;
constexpr int MAX_SEGS = 80;
constexpr int THREADS = 256;

enum : int {
  OP_SUM_I64 = 0,
  OP_SUM_F64 = 1,
  OP_MIN_I64 = 2,
  OP_MAX_I64 = 3,
  OP_MIN_F64 = 4,
  OP_MAX_F64 = 5,
};

}  // namespace

// the launch parameters (device/shard.py _MergeParams)
struct MergeParams {
  const long long* src[MAX_SRC];
  long long* out;
  long long seg_off[MAX_SEGS];  // first word of the segment
  long long seg_len[MAX_SEGS];  // its words
  int seg_op[MAX_SEGS];
  int S;
  int n_segs;
  int vec;  // 1: sources and output share one 16-byte phase
  int pad;
};

namespace {

__device__ __forceinline__ double as_d(long long x) {
  return __longlong_as_double(x);
}

__device__ __forceinline__ long long of_d(double x) {
  return __double_as_longlong(x);
}

// one word merged over the sources: `a` is source 0's word, `b` source s's
__device__ __forceinline__ long long fold(int op, long long a, long long b) {
  switch (op) {
    case OP_SUM_I64:
      return (long long)((unsigned long long)a + (unsigned long long)b);
    case OP_SUM_F64:
      return of_d(as_d(a) + as_d(b));
    case OP_MIN_I64:
      return b < a ? b : a;
    case OP_MAX_I64:
      return b > a ? b : a;
    case OP_MIN_F64: {
      const double x = as_d(a), y = as_d(b);
      return (!isnan(x) && (isnan(y) || y < x)) ? b : a;
    }
    default: {  // OP_MAX_F64
      const double x = as_d(a), y = as_d(b);
      return (!isnan(x) && (isnan(y) || y > x)) ? b : a;
    }
  }
}

// the body of both kernels (the launcher checks each one's ops)
__device__ __forceinline__ void merge_body(const MergeParams& p) {
  const int seg = blockIdx.y;
  const int op = p.seg_op[seg];
  const long long off = p.seg_off[seg], len = p.seg_len[seg];
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
      longlong2 acc = *reinterpret_cast<const longlong2*>(p.src[0] + w);
      for (int s = 1; s < p.S; ++s) {
        const longlong2 v =
            *reinterpret_cast<const longlong2*>(p.src[s] + w);
        acc.x = fold(op, acc.x, v.x);
        acc.y = fold(op, acc.y, v.y);
      }
      *reinterpret_cast<longlong2*>(p.out + w) = acc;
    } else {
      const long long w = off + (u < lead ? u : tail0 + (u - lead - pairs));
      long long acc = p.src[0][w];
      for (int s = 1; s < p.S; ++s) acc = fold(op, acc, p.src[s][w]);
      p.out[w] = acc;
    }
  }
}

__global__ void __launch_bounds__(THREADS) psum_kernel(const MergeParams p) {
  merge_body(p);
}

__global__ void __launch_bounds__(THREADS)
    bucket_merge_kernel(const MergeParams p) {
  merge_body(p);
}

cudaError_t launch(bool sums, int device, const MergeParams* p, int grid_x,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p->S < 1 || p->S > MAX_SRC || p->n_segs < 1 || p->n_segs > MAX_SEGS ||
      grid_x < 1)
    return cudaErrorInvalidValue;
  for (int i = 0; i < p->n_segs; ++i) {
    const int op = p->seg_op[i];
    const bool sum = op == OP_SUM_I64 || op == OP_SUM_F64;
    if (op < OP_SUM_I64 || op > OP_MAX_F64 || sum != sums ||
        p->seg_off[i] < 0 || p->seg_len[i] < 0)
      return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)grid_x, (unsigned)p->n_segs);
  if (sums)
    psum_kernel<<<grid, THREADS, 0, s>>>(*p);
  else
    bucket_merge_kernel<<<grid, THREADS, 0, s>>>(*p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int shard_params_size() { return (int)sizeof(MergeParams); }

int shard_threads() { return THREADS; }

// out[w] = sum over the sources, every segment of `p` a sum op
int shard_psum_launch(int device, const MergeParams* p, int grid_x,
                      void* stream) {
  return launch(true, device, p, grid_x, stream);
}

// out[w] = min or max over the sources, every segment a min/max op
int shard_bucket_merge_launch(int device, const MergeParams* p, int grid_x,
                              void* stream) {
  return launch(false, device, p, grid_x, stream);
}

const char* shard_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

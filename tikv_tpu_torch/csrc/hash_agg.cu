// Direct-index GROUP BY aggregation (COUNT / SUM / AVG states) for Hopper.
//
// Replaces the TPU kernel of tikv_tpu/device/pallas_hash.py (`build`,
// pallas_call at :361).  It computes the same per-slot states: for every
// slot of the layout "groups [0, capacity), NULL slot capacity, scrap
// capacity+1" an int64 row count, and per aggregate lane an int64
// non-NULL count and an exact int64 sum of int32 values.  Slot rules
// (pallas_hash.py:276-300):
//   simple: every masked row goes to slot 0;
//   dense:  rel = key - base in int32 (wrapping); in-range rows go to rel;
//           a NULL key goes to `capacity` only when that slot exists
//           (n_slots > capacity); every other row goes nowhere;
//   sparse: the precomputed slot id, when it is < n_slots.
// A lane with a validity plane contributes only where it is valid.
//
// Bound: bytes read.  Config 4 (GROUP BY an int32 key, SUM of an int32
// value) reads 8 B/row, about 0.25 ms at 3.35 TB/s for 100 * 2^20 rows;
// the arithmetic is a few integer ops per row.
//
// Design (right and simple first): a grid-stride loop over the n live rows
// (the feed's padding is never read).  Each block keeps a private table in
// dynamic shared memory -- int64 sums, int32 row counts, int32 non-NULL
// counts -- updated with shared atomics; a thread folds a run of
// consecutive rows that land in the same slot in registers first (the
// simple mode is one run per thread).  At the end each block adds its
// non-empty slots into the global int64 outputs with one atomic per state.
// Two's-complement wraparound of the unsigned 64-bit atomics equals int64
// arithmetic, so the sums are exact.  Shared memory needs
// n_slots * (4 + 12 * lanes) bytes; the Python wrapper splits the lanes
// over several launches when that passes the card's per-block limit.
// TMA-fed tiles and tensor-core (wgmma) contraction are for a later
// revision.

#include <cuda_runtime.h>

#define MAX_LANES 8
#define THREADS 256

enum { MODE_SIMPLE = 0, MODE_DENSE = 1, MODE_SPARSE = 2 };

struct Lanes {
  const int* values[MAX_LANES];            // int32 values, or null (COUNT)
  const unsigned char* ok[MAX_LANES];      // validity, or null (== row mask)
  unsigned long long* sum_out[MAX_LANES];  // int64 [n_slots] or null
  unsigned long long* nonnull_out[MAX_LANES];
};

__device__ __forceinline__ int row_slot(long long i, int mode, const int* key,
                                        const unsigned char* key_ok,
                                        const unsigned char* mask, int base,
                                        int capacity, int n_slots) {
  if (mask != nullptr && !mask[i]) return -1;
  if (mode == MODE_SIMPLE) return 0;
  int k = key[i];
  if (mode == MODE_SPARSE) return (k >= 0 && k < n_slots) ? k : -1;
  if (key_ok != nullptr && !key_ok[i]) return n_slots > capacity ? capacity : -1;
  int rel = (int)((unsigned int)k - (unsigned int)base);
  return (rel >= 0 && rel < capacity) ? rel : -1;
}

template <int NL>
__global__ void __launch_bounds__(THREADS)
hash_agg_kernel(const int* __restrict__ key,
                const unsigned char* __restrict__ key_ok,
                const unsigned char* __restrict__ mask, long long n, int mode,
                int base, int capacity, int n_slots, Lanes lanes,
                unsigned long long* count_out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_sum = smem;                              // NL * n_slots
  unsigned int* s_cnt = (unsigned int*)(s_sum + NL * n_slots);   // n_slots
  unsigned int* s_nn = s_cnt + n_slots;                          // NL * n_slots

  for (int j = threadIdx.x; j < NL * n_slots; j += blockDim.x) s_sum[j] = 0ull;
  for (int j = threadIdx.x; j < (NL + 1) * n_slots; j += blockDim.x) s_cnt[j] = 0u;
  __syncthreads();

  // the current run: consecutive rows of this thread sharing one slot
  int cur = -1;
  unsigned int run_cnt = 0;
  long long run_sum[NL > 0 ? NL : 1];
  unsigned int run_nn[NL > 0 ? NL : 1];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    run_sum[l] = 0;
    run_nn[l] = 0;
  }

  auto flush = [&]() {
    if (cur < 0 || run_cnt == 0) return;
    atomicAdd(&s_cnt[cur], run_cnt);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (lanes.values[l] != nullptr && run_sum[l] != 0)
        atomicAdd(&s_sum[l * n_slots + cur], (unsigned long long)run_sum[l]);
      if (lanes.ok[l] != nullptr && run_nn[l] != 0)
        atomicAdd(&s_nn[l * n_slots + cur], run_nn[l]);
      run_sum[l] = 0;
      run_nn[l] = 0;
    }
    run_cnt = 0;
  };

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int s = row_slot(i, mode, key, key_ok, mask, base, capacity, n_slots);
    if (s < 0) continue;
    if (s != cur) {
      flush();
      cur = s;
    }
    ++run_cnt;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      bool ok = true;
      if (lanes.ok[l] != nullptr) {
        ok = lanes.ok[l][i] != 0;
        run_nn[l] += ok ? 1u : 0u;
      }
      if (lanes.values[l] != nullptr && ok) run_sum[l] += lanes.values[l][i];
    }
  }
  flush();
  __syncthreads();

  // every row that reached a slot counted there, so an empty count means
  // an all-zero slot: only non-empty slots touch global memory
  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
    unsigned int c = s_cnt[s];
    if (c == 0) continue;
    if (count_out != nullptr) atomicAdd(&count_out[s], (unsigned long long)c);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (lanes.sum_out[l] != nullptr)
        atomicAdd(&lanes.sum_out[l][s], s_sum[l * n_slots + s]);
      if (lanes.nonnull_out[l] != nullptr)
        atomicAdd(&lanes.nonnull_out[l][s],
                  (unsigned long long)s_nn[l * n_slots + s]);
    }
  }
}

template <int NL>
static cudaError_t launch(const int* key, const unsigned char* key_ok,
                          const unsigned char* mask, long long n, int mode,
                          int base, int capacity, int n_slots,
                          const Lanes& lanes, unsigned long long* count_out,
                          cudaStream_t stream) {
  const size_t smem = (size_t)n_slots * (4 + 12 * NL);
  auto kern = hash_agg_kernel<NL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                         smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) per_sm = 1;  // an oversized table is refused at launch
  long long grid = (n + THREADS - 1) / THREADS;
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  if (grid < 1) grid = 1;
  // the per-block int32 counts hold while a block sees < 2^31 rows
  if (n / grid >= (1LL << 31)) return cudaErrorInvalidValue;
  kern<<<(unsigned int)grid, THREADS, smem, stream>>>(
      key, key_ok, mask, n, mode, base, capacity, n_slots, lanes, count_out);
  return cudaGetLastError();
}

extern "C" {

// Launch one aggregation pass on `stream` (asynchronous; no allocation).
// Returns cudaGetLastError() after the launch: 0 on success.
int hash_agg_launch(int device, const void* key, const void* key_ok,
                    const void* mask, long long n, int mode, int base,
                    int capacity, int n_slots, int n_lanes, void** values,
                    void** ok, void** sum_out, void** nonnull_out,
                    void* count_out, void* stream) {
  if (n_lanes < 0 || n_lanes > MAX_LANES || n_slots < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Lanes lanes = {};
  for (int l = 0; l < n_lanes; ++l) {
    lanes.values[l] = (const int*)values[l];
    lanes.ok[l] = (const unsigned char*)ok[l];
    lanes.sum_out[l] = (unsigned long long*)sum_out[l];
    lanes.nonnull_out[l] = (unsigned long long*)nonnull_out[l];
  }
  const int* k = (const int*)key;
  const unsigned char* kok = (const unsigned char*)key_ok;
  const unsigned char* m = (const unsigned char*)mask;
  unsigned long long* c = (unsigned long long*)count_out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_lanes) {
    case 0: return launch<0>(k, kok, m, n, mode, base, capacity, n_slots, lanes, c, s);
    case 1: return launch<1>(k, kok, m, n, mode, base, capacity, n_slots, lanes, c, s);
    case 2: return launch<2>(k, kok, m, n, mode, base, capacity, n_slots, lanes, c, s);
    case 3: return launch<3>(k, kok, m, n, mode, base, capacity, n_slots, lanes, c, s);
    case 4: return launch<4>(k, kok, m, n, mode, base, capacity, n_slots, lanes, c, s);
    case 5: return launch<5>(k, kok, m, n, mode, base, capacity, n_slots, lanes, c, s);
    case 6: return launch<6>(k, kok, m, n, mode, base, capacity, n_slots, lanes, c, s);
    case 7: return launch<7>(k, kok, m, n, mode, base, capacity, n_slots, lanes, c, s);
    default: return launch<8>(k, kok, m, n, mode, base, capacity, n_slots, lanes, c, s);
  }
}

// Largest dynamic shared memory one block may opt into on `device`.
int hash_agg_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

const char* hash_agg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

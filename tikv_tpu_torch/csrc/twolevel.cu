// Two-level one-hot GROUP BY contraction for Hopper.
//
// Replaces the TPU kernels that compute kernels.twolevel_partial's function
// (tikv_tpu/device/kernels.py:182): the Pallas prototypes
// prof/prof_pl.py:44 `make_v1`, prof/prof_pl2.py:43 `make` and
// prof/prof_pallas.py:92/147 `run_a`/`run_b`, and the XLA two-level body
// the reference runner uses outside the fused kernel's gate
// (tikv_tpu/device/runner.py:2743).  For slot ids idx[row] and planes
// L8[p][row] (int8) and Lf[p][row] (float32) it computes, summed over every
// row of the call,
//
//   S8[hi][p*LO + lo] = sum over rows with idx == hi*LO + lo of L8[p][row]
//   Sf[hi][p*LO + lo] = the same over Lf, in float64
//
// in the reference carry's layout: S8 is (HI, p8*LO) int64, Sf is
// (HI, pf*LO) float64.  A row whose idx lies outside [0, HI*LO) adds
// nowhere, as in the one-hot product.
//
// Bound: bytes read.  Each row reads a 4-byte slot id, p8 int8 bytes and
// 4*pf float bytes once; config 4n (8 int8 planes) reads 12 B/row, about
// 0.38 ms at 3.35 TB/s for 100 * 2^20 rows.  The work is one add per
// non-zero plane value.
//
// Design (right and simple first): a grid-stride pass over the rows.
//  - shared route: when the whole table (4 B per int8 cell, 8 B per float
//    cell) fits the opted-in shared memory, each block keeps a private
//    table: int32 cells for the int8 planes, float64 cells for the float
//    planes, updated with shared atomics.  |L8| <= 128, so an int32 cell
//    is exact while a block sees at most 2^23 + THREADS rows (|cell| <
//    2^30 + 2^15); the launcher sizes the grid so it does.  At the end each non-zero cell is added into the
//    global output with one 64-bit atomic.
//  - global route: beyond that size (65,536 groups need ~790 KB of cells),
//    every non-zero plane value is added straight into the global int64 /
//    float64 outputs with device atomics.
// Two's-complement wraparound of the unsigned 64-bit atomics equals int64
// arithmetic, so the integer cells are exact.  The float cells add float32
// values in float64, in an order that varies between runs.  Building the
// planes inside the kernel (they are torch ops today) and an int8
// tensor-core contraction are for a later revision.

#include <cuda_runtime.h>

#define THREADS 256
// rows a block may see, give or take one stride, while its int32 shared
// cells stay exact (|L8| <= 128)
#define MAX_ROWS_PER_BLOCK (1LL << 23)

__device__ __forceinline__ void add_i64(unsigned long long* cell, int v) {
  atomicAdd(cell, (unsigned long long)(long long)v);
}

__global__ void __launch_bounds__(THREADS)
twolevel_shared_kernel(const int* __restrict__ idx,
                       const signed char* __restrict__ L8,
                       const float* __restrict__ Lf, long long n, int p8,
                       int pf, int lo_shift, int HI,
                       unsigned long long* __restrict__ S8,
                       double* __restrict__ Sf) {
  extern __shared__ double smem[];
  const int LO = 1 << lo_shift;
  const int w8 = p8 * LO, wf = pf * LO;
  const int cells8 = HI * w8, cellsf = HI * wf;
  double* s_f = smem;                       // cellsf float64 cells
  int* s_8 = (int*)(smem + cellsf);         // cells8 int32 cells
  for (int j = threadIdx.x; j < cells8; j += blockDim.x) s_8[j] = 0;
  for (int j = threadIdx.x; j < cellsf; j += blockDim.x) s_f[j] = 0.0;
  __syncthreads();

  const long long slots = (long long)HI * LO;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = idx[i];
    if (s < 0 || s >= slots) continue;
    const int hi = s >> lo_shift, lo = s & (LO - 1);
    int* row8 = s_8 + hi * w8 + lo;
    for (int p = 0; p < p8; ++p) {
      const int v = L8[(long long)p * n + i];
      if (v != 0) atomicAdd(row8 + p * LO, v);
    }
    double* rowf = s_f + hi * wf + lo;
    for (int p = 0; p < pf; ++p) {
      const float v = Lf[(long long)p * n + i];
      if (v != 0.0f) atomicAdd(rowf + p * LO, (double)v);
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < cells8; j += blockDim.x) {
    const int v = s_8[j];
    if (v != 0) add_i64(&S8[j], v);
  }
  for (int j = threadIdx.x; j < cellsf; j += blockDim.x) {
    const double v = s_f[j];
    if (v != 0.0) atomicAdd(&Sf[j], v);
  }
}

__global__ void __launch_bounds__(THREADS)
twolevel_global_kernel(const int* __restrict__ idx,
                       const signed char* __restrict__ L8,
                       const float* __restrict__ Lf, long long n, int p8,
                       int pf, int lo_shift, int HI,
                       unsigned long long* __restrict__ S8,
                       double* __restrict__ Sf) {
  const int LO = 1 << lo_shift;
  const int w8 = p8 * LO, wf = pf * LO;
  const long long slots = (long long)HI * LO;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = idx[i];
    if (s < 0 || s >= slots) continue;
    const int hi = s >> lo_shift, lo = s & (LO - 1);
    unsigned long long* row8 = S8 + (long long)hi * w8 + lo;
    for (int p = 0; p < p8; ++p) {
      const int v = L8[(long long)p * n + i];
      if (v != 0) add_i64(row8 + p * LO, v);
    }
    double* rowf = Sf + (long long)hi * wf + lo;
    for (int p = 0; p < pf; ++p) {
      const float v = Lf[(long long)p * n + i];
      if (v != 0.0f) atomicAdd(rowf + p * LO, (double)v);
    }
  }
}

// Shared memory the shared route needs for one block's table.
static long long smem_bytes(int p8, int pf, int LO, int HI) {
  return (long long)HI * LO * (4LL * p8 + 8LL * pf);
}

extern "C" {

// Largest dynamic shared memory one block may opt into on `device`.
int twolevel_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// Add the contraction of rows [0, n) into S8/Sf on `stream` (asynchronous;
// no allocation; the caller zeroes the outputs).  `shared` picks the route.
// Returns cudaGetLastError() after the launch: 0 on success.
int twolevel_launch(int device, const void* idx, const void* L8,
                    const void* Lf, long long n, int p8, int pf, int lo_shift,
                    int HI, void* S8, void* Sf, int shared, void* stream) {
  if (n < 0 || p8 < 1 || pf < 0 || lo_shift < 0 || lo_shift > 10 || HI < 1 ||
      (pf > 0 && (Lf == nullptr || Sf == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n == 0) return cudaSuccess;
  int sms = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return e;
  const int* ix = (const int*)idx;
  const signed char* l8 = (const signed char*)L8;
  const float* lf = (const float*)Lf;
  unsigned long long* s8 = (unsigned long long*)S8;
  double* sf = (double*)Sf;
  cudaStream_t st = (cudaStream_t)stream;
  long long grid = (n + THREADS - 1) / THREADS;
  if (shared) {
    const size_t smem =
        (size_t)smem_bytes(p8, pf, 1 << lo_shift, HI);
    auto kern = twolevel_shared_kernel;
    if ((e = cudaFuncSetAttribute(kern,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return e;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, THREADS, smem)) != cudaSuccess)
      return e;
    if (per_sm < 1) per_sm = 1;  // an oversized table is refused at launch
    if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
    // more blocks (run in waves) rather than a block that could overflow
    // an int32 cell
    const long long need = (n + MAX_ROWS_PER_BLOCK - 1) / MAX_ROWS_PER_BLOCK;
    if (grid < need) grid = need;
    if (grid < 1) grid = 1;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    kern<<<(unsigned int)grid, THREADS, smem, st>>>(ix, l8, lf, n, p8, pf,
                                                   lo_shift, HI, s8, sf);
  } else {
    auto kern = twolevel_global_kernel;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                           THREADS, 0)) !=
        cudaSuccess)
      return e;
    if (per_sm < 1) per_sm = 1;
    if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
    if (grid < 1) grid = 1;
    kern<<<(unsigned int)grid, THREADS, 0, st>>>(ix, l8, lf, n, p8, pf,
                                                lo_shift, HI, s8, sf);
  }
  return cudaGetLastError();
}

const char* twolevel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

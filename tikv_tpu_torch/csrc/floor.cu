// An empty kernel: the least time one launch takes on the card when it is
// queued behind others.  It replaces no TPU kernel and the port never
// launches it; chip_smoke.py times it beside the launch-bound kernels
// (sel_compact, shard_psum, shard_bucket_merge, patch_rows) as their
// floor, bare and with a parameter block of a launch-bound kernel's size
// (shard_psum's MergeArgs<4> of 256 bytes and its earlier single block of
// 1,880; patch_rows's PatchArgs<N> of 64, 256 and 4,096), launched as
// that kernel is (programmatically or not), so a row can say what its
// parameter bytes and its launch cost.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

template <int N>
struct Blob {
  alignas(8) unsigned char b[N];
};

template <int N>
__global__ void params_kernel(const Blob<N> p) {}

template <int N>
cudaError_t launch_params(int dependent, cudaStream_t s) {
  Blob<N> p = {};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, params_kernel<N>, p);
}

}  // namespace

extern "C" {

int floor_launch(int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// the empty kernel with a parameter block of `bytes` bytes (one of the
// sizes above), programmatic when `dependent`
int floor_params_launch(int device, int bytes, int dependent, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bytes) {
    case 64:
      e = launch_params<64>(dependent, s);
      break;
    case 256:
      e = launch_params<256>(dependent, s);
      break;
    case 1880:
      e = launch_params<1880>(dependent, s);
      break;
    case 4096:
      e = launch_params<4096>(dependent, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

const char* floor_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

// An empty kernel: the least time one launch takes on the card when it is
// queued behind others.  It replaces no TPU kernel and the port never
// launches it; chip_smoke.py times it beside the launch-bound kernels
// (sel_compact, shard_psum, shard_bucket_merge, patch_rows) as their
// floor.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int floor_launch(int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

const char* floor_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

// The device's limits that the launch plans of K2 and K5 are sized by
// (ops/kernels.py topk_plan, match_plan).
#include "common.cuh"

// sms: the device's multiprocessors; smem: the bytes of dynamic shared
// memory one block can opt into.
PISLAM_API int pislam_device_limits(int device, int* sms, int* smem) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One launch of a kernel that does nothing: the fixed cost of a launch on
// the device, the floor that the shortest kernels are measured against.
PISLAM_API int pislam_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

// Shared by the port's Hopper kernels: the C interface they export, and the
// atan2 angle bin that K4 and K4d both compute.
//
// Every entry point is extern "C", takes device pointers and the caller's
// stream, launches asynchronously, allocates nothing, and returns the
// cudaError_t of its launches (cudaGetLastError), 0 on success. The one
// exception, pislam_device_limits (device_limits.cu), reads the device's
// attributes and launches nothing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PISLAM_API extern "C" __attribute__((visibility("default")))

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxDevices = 64;

// Let a kernel use `bytes` of dynamic shared memory on the current device.
// The attribute belongs to the device, so it is set once per device; `have`
// is the kernel's record of what each device has been given.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes, int (&have)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= have[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have[dev] = bytes;
  return err;
}

// float32 values of orientation.py:86-88 (256 * 60/pi-scaled polynomial)
constexpr float kAtanC0 = 256.0f * 14.999998f;
constexpr float kAtanC1 = 256.0f * 4.723436f;
constexpr float kAtanC2 = 256.0f * 1.266240f;

// atan2_bins (pislam_tpu/ops/orientation.py:91) of one moment pair: the
// orientation bin in [0, 30). It truncates a float polynomial, so a
// contracted FMA could move a bin: every float step uses an explicitly
// rounded intrinsic, and the divide is IEEE (__fdiv_rn).
__device__ __forceinline__ int atan2_bin(int x, int y) {
  const float xf = fabsf(__int2float_rn(x));
  const float yf = fabsf(__int2float_rn(y));
  const float zmax = fmaxf(xf, yf);
  const float zmin = fminf(xf, yf);
  const float z = __fdiv_rn(zmin, fmaxf(zmax, 1e-30f));
  const float poly = __fadd_rn(kAtanC1, __fmul_rn(kAtanC2, z));
  const float inner = __fsub_rn(kAtanC0, __fmul_rn(__fsub_rn(z, 1.0f), poly));
  const int angle = __float2int_rz(__fmul_rn(z, inner));

  const bool signs_differ = (x < 0) != (y < 0);
  const bool xdom = abs(x) > abs(y);
  int a1 = signs_differ ? -angle : angle;               // Orb.h:357-365
  a1 = x < 0 ? a1 + 256 * 60 : (a1 < 0 ? a1 + 256 * 120 : a1);
  int a2 = signs_differ ? angle : -angle;               // Orb.h:366-375
  a2 = y >= 0 ? a2 + 256 * 30 : a2 + 256 * 90;
  const int out = (xdom ? a1 : a2) >> 10;
  return (out >= 0 && out < 30 && zmax > 0.0f) ? out : 0;
}

// Shared by the frontend's Hopper kernels: the C interface they export.
//
// Every entry point is extern "C", takes device pointers and the caller's
// stream, launches asynchronously, allocates nothing, and returns the
// cudaError_t of its launches (cudaGetLastError), 0 on success.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PISLAM_API extern "C" __attribute__((visibility("default")))

constexpr unsigned kFullWarp = 0xffffffffu;

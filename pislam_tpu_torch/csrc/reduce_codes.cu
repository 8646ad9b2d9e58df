// K6: scored NMS survivors -> the 2x2 maximum of their packed codes.
//
// Replaces reduce_codes_4x / _vmerge_kernel and the XLA reduce_keys_2x after
// it (pislam_tpu/ops/pallas_kernels.py:949, :917, :936). Input: an (H, W)
// uint8 grid, the Harris score of each NMS survivor and 0 elsewhere. Output
// (ceil(H/2), ceil(W/2)) codes, each the u32 bit pattern (score << 24 |
// x << 12 | y) of the sole survivor of pixel block (2r..2r+1, 2c..2c+1), or 0:
// 3x3 NMS leaves at most one survivor per 2x2 block, so the unsigned block
// maximum keeps every survivor. Codes come out in true row order; the TPU's
// came out with even and odd output rows in two planes.
//
// Bound: bytes, 1 read + 2 written per input pixel (0.3 + 0.6 MB at the eval
// pyramid's 800x384); no arithmetic to speak of. Design: one thread per
// output code, a warp reading 64 neighbouring bytes of each of two rows and
// writing 32 neighbouring codes; out-of-image pixels of a ragged edge read
// as 0.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t encode(uint32_t b, uint32_t x, uint32_t y) {
  return b ? (b << 24) | (x << 12) | y : 0u;
}

__global__ void __launch_bounds__(256)
reduce_codes_kernel(const uint8_t* __restrict__ scored, int h, int w,
                    uint32_t* __restrict__ out, int h2, int w2) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w2) return;
  uint32_t best = 0;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int y = 2 * r + dy;
    if (y >= h) break;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int x = 2 * c + dx;
      if (x < w) best = max(best, encode(scored[(size_t)y * w + x], x, y));
    }
  }
  out[(size_t)r * w2 + c] = best;
}

}  // namespace

PISLAM_API int pislam_reduce_codes(const uint8_t* scored, int h, int w,
                                   int32_t* out, cudaStream_t stream) {
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  if (h2 > 0 && w2 > 0) {
    const dim3 grid((w2 + 255) / 256, h2);
    reduce_codes_kernel<<<grid, 256, 0, stream>>>(
        scored, h, w, reinterpret_cast<uint32_t*>(out), h2, w2);
  }
  return (int)cudaGetLastError();
}

// K3a: image rows packed 4 to a u32, in 256-column strips.
//
// Replaces pack_row_strips (pislam_tpu/ops/pallas_kernels.py:73, its
// pallas_call :79), which builds the strip rows of realign_windows (K3c).
// Output (W / 128 - 1, H / 4, 256) u32: strip s, row r, column c holds image
// rows 4r..4r+3 of column 128 s + c, little-endian. Strips overlap by 128
// columns, so every image column but the first and last 128 is written twice.
//
// Bound on this card: bytes, H * W in and (W / 128 - 1) * (H / 4) * 1 KB out
// over 3.35 TB/s. There is no arithmetic to speak of.
//
// Design: one thread per output word; a warp writes 32 consecutive columns
// of one strip row (128 bytes) and reads 4 image rows of 32 bytes each, both
// coalesced. The TPU packed rows by bitcasting sublanes; here the 4 bytes are
// combined in registers.
#include "common.cuh"

namespace {

constexpr int kStrip = 256;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_row_strips_kernel(const uint8_t* __restrict__ img, int h, int w,
                       uint32_t* __restrict__ out) {
  const int h4 = h / 4;
  const int ns = w / 128 - 1;
  const long long total = (long long)ns * h4 * kStrip;
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < total;
       o += (long long)gridDim.x * kThreads) {
    const int c = (int)(o % kStrip);
    const long long sr = o / kStrip;
    const int r = (int)(sr % h4);
    const int s = (int)(sr / h4);
    const uint8_t* p = img + (size_t)(4 * r) * w + 128 * s + c;
    out[o] = (uint32_t)p[0] | ((uint32_t)p[w] << 8) | ((uint32_t)p[2 * w] << 16) |
             ((uint32_t)p[3 * w] << 24);
  }
}

}  // namespace

// img (h, w) u8 with h % 4 == 0, w % 128 == 0, w >= 256; out (w/128 - 1, h/4, 256).
PISLAM_API int pislam_pack_row_strips(const uint8_t* img, int h, int w, int32_t* out,
                                      cudaStream_t stream) {
  if (h < 4 || h % 4 || w % 128 || w < 256) return (int)cudaErrorInvalidValue;
  const long long total = (long long)(w / 128 - 1) * (h / 4) * kStrip;
  const long long need = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(need < 132 * 16 ? need : 132 * 16);
  pack_row_strips_kernel<<<blocks, kThreads, 0, stream>>>(
      img, h, w, reinterpret_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

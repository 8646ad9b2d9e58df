// K3: per-keypoint 32x32 window gather into the packed int8 layout.
//
// Replaces pack_row_strips + the row take + realign_windows2d inside
// gather_windows_packed (pislam_tpu/ops/pallas_kernels.py:73, :145, :195),
// and the XOR to int8 after it (pislam_tpu/ops/patches.py:118). The 3-D
// realign_windows (:172) gives the same bytes. The TPU needed strips and
// lane rotates because any per-keypoint dynamic access cost it ~1.2 us; on
// Hopper a direct gather through L1/L2 is the natural form.
//
// Window rows y-15..y+16, cols x-15..x+16. Byte (r, c) lands at
// (r >> 2) * 128 + c * 4 + (r & 3): output word a*32 + c holds rows
// 4a..4a+3 of column c, little-endian. One block per keypoint, one thread
// per output word; a warp reads 32 neighbouring bytes of each of 4 rows.
// Invalid keypoints go to (16, 16); every keypoint clips to
// [15, w-17] x [15, h-17] (pallas_kernels.py:219-220).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
gather_windows_kernel(const uint8_t* __restrict__ img, int h, int w,
                      const int32_t* __restrict__ xs,
                      const int32_t* __restrict__ ys,
                      const uint8_t* __restrict__ valid,
                      uint32_t* __restrict__ out) {
  const int kp = blockIdx.x;
  const int t = threadIdx.x;
  const bool v = valid[kp] != 0;
  const int x = min(max(v ? xs[kp] : 16, 15), w - 17);
  const int y = min(max(v ? ys[kp] : 16, 15), h - 17);
  const int a = t >> 5, c = t & 31;
  const uint8_t* p = img + (size_t)(y - 15 + 4 * a) * w + (x - 15 + c);
  const uint32_t word = (uint32_t)p[0] | ((uint32_t)p[w] << 8) |
                        ((uint32_t)p[2 * w] << 16) |
                        ((uint32_t)p[3 * w] << 24);
  out[(size_t)kp * 256 + t] = word ^ 0x80808080u;   // pixel - 128 as int8
}

}  // namespace

PISLAM_API int pislam_gather_windows(const uint8_t* img, int h, int w,
                                     const int32_t* xs, const int32_t* ys,
                                     const uint8_t* valid, int k, int8_t* out,
                                     cudaStream_t stream) {
  if (k > 0) {
    gather_windows_kernel<<<k, 256, 0, stream>>>(
        img, h, w, xs, ys, valid, reinterpret_cast<uint32_t*>(out));
  }
  return (int)cudaGetLastError();
}

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
// 4a..4a+3 of column c, little-endian. Invalid keypoints go to (16, 16);
// every keypoint clips to [15, w-17] x [15, h-17] (pallas_kernels.py:219-220).
//
// Bound: bytes, 1 KB written a keypoint (and the window's bytes, from L2);
// what costs is two dependent trips, the keypoint's coordinates and then
// its window, and the stores. Design: two warps a keypoint, four keypoints
// (256 threads) a block. Every lane loads the keypoint's x, y and valid
// (one request each for the warp: no shuffle, no lane branch, which cost
// ~0.2 us more); lane c of half h then issues its 16 byte loads of column
// c, rows 16h..16h+15, at once and stores words a*32 + c for its 4 row
// groups, a warp's store a whole 128-byte line. A byte load needs no
// alignment, so any image base, width and window origin take the same
// path. Of one or two warps a keypoint reading columns, or four, or lanes
// reading aligned row words joined by funnel shifts and transposed by byte
// permutes, at 2 to 16 warps a block, this was the fastest at eval among
// the builds within 10 % of the fastest at VGA (PERF.md §6): with one warp,
// ptxas issues a lane's 32 loads in two batches, two trips, and the row
// words cost more instructions than they save.
#include "common.cuh"

namespace {

constexpr int kSplit = 2;                        // warps a keypoint
constexpr int kPerBlock = 4;                     // keypoints a block
constexpr int kGroups = 8 / kSplit;              // 4-row groups a warp

__global__ void __launch_bounds__(32 * kSplit * kPerBlock)
gather_windows_kernel(const uint8_t* __restrict__ img, int h, int w,
                      const int32_t* __restrict__ xs,
                      const int32_t* __restrict__ ys,
                      const uint8_t* __restrict__ valid, int k,
                      uint32_t* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kPerBlock + warp / kSplit;
  const int a0 = warp % kSplit * kGroups;
  if (kp >= k) return;
  // three loads issued together: none waits on valid
  const bool ok = valid[kp] != 0;
  const int sx = xs[kp], sy = ys[kp];
  const int x0 = min(max(ok ? sx : 16, 15), w - 17) - 15;
  const int y0 = min(max(ok ? sy : 16, 15), h - 17) - 15;

  const uint8_t* col = img + (size_t)(y0 + 4 * a0) * w + x0 + lane;
  uint32_t win[kGroups];
#pragma unroll
  for (int a = 0; a < kGroups; ++a) {
    const uint8_t* p = col + (size_t)(4 * a) * w;
    win[a] = (uint32_t)p[0] | ((uint32_t)p[w] << 8) | ((uint32_t)p[2 * w] << 16) |
             ((uint32_t)p[3 * w] << 24);
  }
  uint32_t* o = out + (size_t)kp * 256 + a0 * 32 + lane;
#pragma unroll
  for (int a = 0; a < kGroups; ++a) o[a * 32] = win[a] ^ 0x80808080u;   // pixel - 128
}

}  // namespace

// img (h, w) u8 with h, w >= 32; out (k, 1024).
PISLAM_API int pislam_gather_windows(const uint8_t* img, int h, int w,
                                     const int32_t* xs, const int32_t* ys,
                                     const uint8_t* valid, int k, int8_t* out,
                                     cudaStream_t stream) {
  if (h < 32 || w < 32) return (int)cudaErrorInvalidValue;
  if (k > 0) {
    gather_windows_kernel<<<(k + kPerBlock - 1) / kPerBlock, 32 * kSplit * kPerBlock, 0,
                            stream>>>(img, h, w, xs, ys, valid, k,
                                      reinterpret_cast<uint32_t*>(out));
  }
  return (int)cudaGetLastError();
}

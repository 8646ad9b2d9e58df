// K3a: image rows packed 4 to a u32, in 256-column strips.
//
// Replaces pack_row_strips (pislam_tpu/ops/pallas_kernels.py:73, its
// pallas_call :79), which builds the strip rows of realign_windows (K3c).
// Output (W / 128 - 1, H / 4, 256) u32: strip s, row r, column c holds image
// rows 4r..4r+3 of column 128 s + c, little-endian. Strips overlap by 128
// columns, so every image column but the first and last 128 is written twice.
//
// Bound on this card: bytes, H * W in and (W / 128 - 1) * (H / 4) * 1 KB out
// over 3.35 TB/s. There is no arithmetic to speak of; at the pyramids' sizes
// the image sits in L2, so what costs is instructions and latency.
//
// Design: a thread per 4-row x 4-column tile of the image, on a grid of
// (blocks of 8 row groups, 128-column segments) of 256 threads: a thread's
// row group and columns come from its indices by shifts and masks. It loads
// its tile once, one 4-byte load per row (a warp's loads cover a whole 128-
// byte line of each row), transposes the 4x4 bytes in registers with 8 byte
// permutes, and writes its 4 words with one 16-byte store (a warp's store a
// whole 512-byte strip row) to every strip that holds those columns: strip
// x / 128 at column x % 128 (all but the last segment) and strip x / 128 - 1
// at column 128 + x % 128 (all but the first). So the image is read once.
// W % 128 == 0 keeps every row aligned when the base is; where the base is
// not 4-byte aligned (a contiguous view can start at any byte), the same
// launch loads the tile byte by byte. 4-column tiles and 256 threads were the
// fastest at eval among the builds within 10 % of the fastest at VGA (tiles
// of 4, 8 and 16 columns x 64, 128, 256 and 512 threads; PERF.md §6): wider
// tiles leave a warp's stores strided. The TPU packed rows by bitcasting
// sublanes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;                      // threads per segment and row group
constexpr int kRows = kThreads / kLanes;        // row groups per block

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
pack_row_strips_kernel(const uint8_t* __restrict__ img, int h4, int w,
                       uint32_t* __restrict__ out) {
  const int r = blockIdx.x * kRows + threadIdx.x / kLanes;
  if (r >= h4) return;
  const int seg = blockIdx.y;
  const int col = threadIdx.x % kLanes * 4;     // column within the segment
  const uint8_t* p = img + 4 * r * w + 128 * seg + col;
  uint32_t row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint8_t* q = p + i * w;
    row[i] = kAligned ? __ldg(reinterpret_cast<const uint32_t*>(q))
                      : (uint32_t)q[0] | ((uint32_t)q[1] << 8) | ((uint32_t)q[2] << 16) |
                            ((uint32_t)q[3] << 24);
  }
  // rows a, b, c, d -> columns: t0 = a0 b0 a1 b1, t1 = c0 d0 c1 d1,
  // t2 = a2 b2 a3 b3, t3 = c2 d2 c3 d3 (bytes from the low end)
  const uint32_t t0 = __byte_perm(row[0], row[1], 0x5140);
  const uint32_t t1 = __byte_perm(row[2], row[3], 0x5140);
  const uint32_t t2 = __byte_perm(row[0], row[1], 0x7362);
  const uint32_t t3 = __byte_perm(row[2], row[3], 0x7362);
  const uint4 words = make_uint4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                                 __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
  const int strips = gridDim.y - 1;
  if (seg < strips) *reinterpret_cast<uint4*>(out + (seg * h4 + r) * 256 + col) = words;
  if (seg > 0) *reinterpret_cast<uint4*>(out + ((seg - 1) * h4 + r) * 256 + 128 + col) = words;
}

}  // namespace

// img (h, w) u8 with h % 4 == 0, w % 128 == 0, w >= 256, fewer than 2^30
// pixels (32-bit indices) and at most 65,535 segments; out (w/128 - 1, h/4,
// 256), 16-byte aligned.
PISLAM_API int pislam_pack_row_strips(const uint8_t* img, int h, int w, int32_t* out,
                                      cudaStream_t stream) {
  if (h < 4 || h % 4 || w % 128 || w < 256 || (long long)h * w >= (1LL << 30) ||
      w / 128 > 65535 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const int h4 = h / 4;
  const dim3 grid((h4 + kRows - 1) / kRows, w / 128);
  uint32_t* strips = reinterpret_cast<uint32_t*>(out);
  if (reinterpret_cast<uintptr_t>(img) % 4 == 0)
    pack_row_strips_kernel<true><<<grid, kThreads, 0, stream>>>(img, h4, w, strips);
  else
    pack_row_strips_kernel<false><<<grid, kThreads, 0, stream>>>(img, h4, w, strips);
  return (int)cudaGetLastError();
}

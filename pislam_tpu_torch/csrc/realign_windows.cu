// K3c: per-keypoint realignment of gathered strip rows into packed 32x32
// windows, under realign_windows' contract.
//
// Replaces realign_windows / _realign_kernel (pislam_tpu/ops/
// pallas_kernels.py:172, :92), the 3-D form of K3b. Input: (K, 9, 256) u32
// words, each 4 image rows of one column little-endian (pack_row_strips),
// psi (K,) in [0, 4), the window's first row within its pack, and phi (K,)
// in [0, 225), its first column within the strip. The TPU composed 8 lane
// rotates and 2 byte-shift rounds selected by the bits of phi and psi; their
// composition is one funnel shift per output word:
//
//   out[k, p, c] = (rows[k, p+1, phi+c] : rows[k, p, phi+c]) >> (8 psi)
//
// phi + c <= 255, so nothing wraps.
//
// Bound: bytes, 1 KB written and at most 2.3 KB read per keypoint (two
// 32-word runs of each of 9 rows). Design: one block of 256 threads per
// keypoint, one thread per output word; a warp reads 32 neighbouring words
// of two rows and writes 32 neighbouring words.
#include "common.cuh"

namespace {

constexpr int kRows = 9;

__global__ void __launch_bounds__(256)
realign_windows_kernel(const uint32_t* __restrict__ rows,
                       const int32_t* __restrict__ psi,
                       const int32_t* __restrict__ phi,
                       uint32_t* __restrict__ out) {
  const int kp = blockIdx.x;
  const int p = threadIdx.x >> 5, c = threadIdx.x & 31;
  const uint32_t* base = rows + (size_t)kp * kRows * 256 + phi[kp] + c;
  const uint32_t lo = base[p * 256];
  const uint32_t hi = base[(p + 1) * 256];
  out[(size_t)kp * 256 + threadIdx.x] = __funnelshift_r(lo, hi, 8 * psi[kp]);
}

}  // namespace

PISLAM_API int pislam_realign_windows(const int32_t* rows, const int32_t* psi,
                                      const int32_t* phi, int k, int32_t* out,
                                      cudaStream_t stream) {
  if (k > 0) {
    realign_windows_kernel<<<k, 256, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(rows), psi, phi,
        reinterpret_cast<uint32_t*>(out));
  }
  return (int)cudaGetLastError();
}

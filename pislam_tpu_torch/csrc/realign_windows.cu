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
// 32-word runs of each of 9 rows); what costs is two dependent trips, psi
// and phi and then the row words, and the stores. Design: two warps a
// keypoint, four keypoints (256 threads) a block, so the card holds VGA's
// 2048 keypoints in one wave. Every lane loads the keypoint's psi and phi
// (one request each for the warp: no shuffle, no lane branch); lane c of
// half h then issues its five 4-byte loads of column phi + c, rows 4h..4h+4,
// at once (phi is any column and rows may start at any int32 offset, so no
// wider load), does four funnel shifts and stores words (p, c) for p =
// 4h..4h+3, a warp's store a whole 128-byte line. Of 1, 2 and 4 warps a
// keypoint at 2 to 16 keypoints a block, this was the fastest at eval among
// the builds within 10 % of the fastest at VGA (PERF.md §6): every
// build issues its row loads in one batch; four warps read 12 row words a
// column for 8 outputs and lose at VGA, 16 keypoints a block leaves SMs idle
// at eval.
#include "common.cuh"

namespace {

constexpr int kRows = 9;
constexpr int kSplit = 2;                        // warps a keypoint
constexpr int kPerBlock = 4;                     // keypoints a block
constexpr int kOut = 8 / kSplit;                 // output rows a warp

__global__ void __launch_bounds__(32 * kSplit * kPerBlock)
realign_windows_kernel(const uint32_t* __restrict__ rows,
                       const int32_t* __restrict__ psi,
                       const int32_t* __restrict__ phi, int k,
                       uint32_t* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kPerBlock + warp / kSplit;
  const int p0 = warp % kSplit * kOut;
  if (kp >= k) return;
  // two loads issued together; the rows wait on phi alone
  const int shift = 8 * psi[kp];
  const uint32_t* col = rows + ((size_t)kp * kRows + p0) * 256 + phi[kp] + lane;
  uint32_t r[kOut + 1];
#pragma unroll
  for (int i = 0; i <= kOut; ++i) r[i] = col[i * 256];
  uint32_t* o = out + (size_t)kp * 256 + p0 * 32 + lane;
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i * 32] = __funnelshift_r(r[i], r[i + 1], shift);
}

}  // namespace

PISLAM_API int pislam_realign_windows(const int32_t* rows, const int32_t* psi,
                                      const int32_t* phi, int k, int32_t* out,
                                      cudaStream_t stream) {
  if (k > 0) {
    realign_windows_kernel<<<(k + kPerBlock - 1) / kPerBlock, 32 * kSplit * kPerBlock, 0,
                             stream>>>(reinterpret_cast<const uint32_t*>(rows), psi, phi, k,
                                       reinterpret_cast<uint32_t*>(out));
  }
  return (int)cudaGetLastError();
}

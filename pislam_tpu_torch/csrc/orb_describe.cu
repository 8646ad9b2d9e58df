// orb_describe: K3's window gather and K4's rotated BRIEF in one kernel, from
// the stacked pyramid and K2's codes straight to masked angles and
// descriptors.
//
// Replaces gather_windows_packed (pislam_tpu/ops/pallas_kernels.py:195:
// pack_row_strips :79 + realign_windows2d :154) followed by
// orb_select_bits_sorted (:528, its pallas_call at :555), and the glue
// around them in the frontend (decode of the codes, the masks by valid).
// Per keypoint: x = code >> 12 & 0xFFF, y = code & 0xFFF, clipped to
// [15, w-17] x [15, h-17] (pallas_kernels.py:219-220); the 32x32 window
// (rows y-15..y+16, cols x-15..x+16) as int8 pixel ^ 0x80 in K3's packed
// layout (byte (r, c) at (r >> 2) * 128 + c * 4 + (r & 3)); the disc
// moments against mom_w and common.cuh's FMA-free atan2_bin; bit i of word
// i / 32 = p[idx1[bin][i]] > p[idx0[bin][i]]. An invalid keypoint gets
// angle 0 and zero words, as the frontend's masks gave.
//
// Bound: bytes, the touched windows (1 KB per keypoint at most, from L2,
// where K1 has just read the pyramid), the table rows of the bins used and
// the codes and outputs: at most ~0.17 us at 512 keypoints on 3.35 TB/s
// (0.06 us on eval_seq's overlapping windows), so one launch's fixed cost
// (~2 us) is what remains. K3 and K4 took a launch each plus ~10 small
// operations of glue, and each spent its time on a chain of dependent trips
// (K4: window reload, shuffles, __syncthreads, one thread's bin,
// __syncthreads, table loads). Design: one warp per keypoint. Lane c issues
// its 32 byte loads of column c at once and so holds exactly K3's packed
// words c, 32 + c, ..., 224 + c; it multiplies them with its column's mom_w
// bytes by dp4a, butterfly shuffles give every lane both moments, and every
// lane computes the bin itself. The window goes to a 1 KB shared slot of
// the warp for the random-access compares; lane l compares pairs l + 32 j,
// one ballot per word j, and lane j stores word j. The whole 30 KB of
// idx0/idx1 is staged into the block's shared memory by two bulk copies
// (TMA) completing on an mbarrier, overlapped with the window gather, so
// the bin-dependent table loads come off the chain; the block's one
// __syncthreads publishes the barrier's initialisation. Four warps
// (keypoints) per block: of 1, 2, 4 and 8, staged or not, this was the
// fastest at the eval shape and within 10 % of the fastest at VGA
// (PERF.md).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;                        // keypoints per block
constexpr int kTable = 30 * 256;                 // int16 entries of idx0 or idx1
constexpr int kTableBytes = kTable * 2;          // 15,360: a multiple of 16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__global__ void __launch_bounds__(32 * kWarps)
orb_describe_kernel(const uint8_t* __restrict__ img, int h, int w,
                    const int64_t* __restrict__ codes,
                    const uint8_t* __restrict__ valid, int k,
                    const int16_t* __restrict__ idx0,
                    const int16_t* __restrict__ idx1,
                    const int8_t* __restrict__ mom_w, int words,
                    uint8_t* __restrict__ angles, uint32_t* __restrict__ desc) {
  __shared__ uint32_t s_win[kWarps][256];
  __shared__ __align__(16) int16_t s_tab[2 * kTable];
  __shared__ __align__(8) uint64_t s_bar;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarps + warp;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(&s_bar)),
                 "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bar = smem_addr(&s_bar);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(2 * kTableBytes) : "memory");
    const int16_t* src[2] = {idx0, idx1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          :: "r"(smem_addr(s_tab + i * kTable)), "l"(reinterpret_cast<uint64_t>(src[i])),
             "r"(kTableBytes), "r"(bar)
          : "memory");
    }
  }

  if (kp >= k || valid[kp] == 0) {
    if (kp < k) {
      if (lane < words) desc[(size_t)kp * words + lane] = 0u;
      if (lane == 0) angles[kp] = 0;
    }
    mbar_wait(&s_bar, 0);      // no warp leaves while the bulk copies may still write
    return;
  }

  const int64_t code = codes[kp];
  const int x = min(max((int)((code >> 12) & 0xFFF), 15), w - 17);
  const int y = min(max((int)(code & 0xFFF), 15), h - 17);
  const uint8_t* col = img + (size_t)(y - 15) * w + (x - 15 + lane);
  uint32_t win[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const uint8_t* p = col + (size_t)(4 * a) * w;
    win[a] = ((uint32_t)p[0] | ((uint32_t)p[w] << 8) | ((uint32_t)p[2 * w] << 16) |
              ((uint32_t)p[3 * w] << 24)) ^ 0x80808080u;     // pixel - 128 as int8
  }

  // disc moments: packed index a*128 + 4*lane + b holds row 4a+b of this
  // column; its (m10, m01) weights are 8 neighbouring bytes of mom_w
  const uint2* mw = reinterpret_cast<const uint2*>(mom_w);
  int m10 = 0, m01 = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const uint2 wt = mw[a * 32 + lane];
    s_win[warp][a * 32 + lane] = win[a];
    m10 = __dp4a((int)win[a], (int)__byte_perm(wt.x, wt.y, 0x6420), m10);
    m01 = __dp4a((int)win[a], (int)__byte_perm(wt.x, wt.y, 0x7531), m01);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(kFullWarp, m10, off);
    m01 += __shfl_xor_sync(kFullWarp, m01, off);
  }
  const int bin = atan2_bin(m10, m01);
  __syncwarp();

  mbar_wait(&s_bar, 0);
  int i0[8], i1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < words) {
      i0[j] = s_tab[bin * 256 + 32 * j + lane];
      i1[j] = s_tab[kTable + bin * 256 + 32 * j + lane];
    }
  }
  const int8_t* p = reinterpret_cast<const int8_t*>(s_win[warp]);
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < words) {
      const unsigned bits = __ballot_sync(kFullWarp, p[i1[j]] > p[i0[j]]);
      if (lane == j) mine = bits;
    }
  }
  if (lane < words) desc[(size_t)kp * words + lane] = mine;
  if (lane == 0) angles[kp] = (uint8_t)bin;
}

}  // namespace

// idx0 and idx1 must be 16-byte aligned (bulk copies), mom_w 8-byte aligned.
PISLAM_API int pislam_orb_describe(const uint8_t* img, int h, int w, const int64_t* codes,
                                   const uint8_t* valid, int k, const int16_t* idx0,
                                   const int16_t* idx1, const int8_t* mom_w, int words,
                                   uint8_t* angles, int32_t* desc, cudaStream_t stream) {
  if (k > 0) {
    orb_describe_kernel<<<(k + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
        img, h, w, codes, valid, k, idx0, idx1, mom_w, words, angles,
        reinterpret_cast<uint32_t*>(desc));
  }
  return (int)cudaGetLastError();
}

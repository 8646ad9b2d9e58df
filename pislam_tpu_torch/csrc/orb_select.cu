// K4: disc moments -> atan2 angle bin -> the 256 rotated-BRIEF bits of that
// bin, per keypoint, from its packed 32x32 int8 window.
//
// Replaces orb_select_bits_sorted / _orb_sorted_kernel (pislam_tpu/ops/
// pallas_kernels.py:528, :503); the dense variant, orb_select_bits (:465),
// gives identical bits and has its own kernel (orb_select_dense.cu). The TPU ran
// (K, 1024) x (1024, 7808) int8 dots against GDIFF, whose column (rot, i) is
// onehot(idx1) - onehot(idx0); the sign of that dot is p[idx1] - p[idx0], so
// here bit i is the direct compare p[idx1[bin][i]] > p[idx0[bin][i]] (equal
// indices give 0 either way).
//
// Bound: bytes, the windows (1 KB a keypoint) and the 32 KB of tables read
// once, at most ~0.17 us at 512 keypoints; the windows sit in L2, so what
// costs is the chain of dependent steps in each keypoint. Design:
// orb_describe's second half, one warp per keypoint and no block-wide
// barrier between the window load and the descriptor store. Lane c loads
// packed words c, 32 + c, ..., 224 + c (a 128-byte line per warp load) and
// the 8 mom_w bytes beside each, multiplies them by dp4a, and one redux
// per moment gives every lane both sums, so every lane computes
// common.cuh's atan2_bin itself. The window goes to a 1 KB shared slot of
// the warp for the random-access compares: lane l compares pairs l + 32 j
// of all 8 words at once (no branch on `words` keeps their loads apart),
// one ballot per word, and lane j stores word j for j < words. The 30 KB of
// idx0/idx1 reach the block's shared memory by two bulk copies (TMA) on an
// mbarrier while the windows load; the block's one __syncthreads, before
// any load, publishes the barrier's initialisation. Four keypoints a block:
// of 2, 4, 8 and 16, tables staged or read through L1, this was the fastest
// at eval among the builds within 10 % of the fastest at VGA (PERF.md §6).
// Where idx0 or idx1 is not 16-byte aligned the same launch reads the tables
// through L1; where the windows are not 4-byte aligned or mom_w not 8-byte
// aligned, it loads them byte by byte.
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

// the 4 bytes at p, p + stride, p + 2 stride, p + 3 stride as a
// little-endian word
__device__ __forceinline__ uint32_t bytes4(const int8_t* p, int stride) {
  return (uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[stride] << 8) |
         ((uint32_t)(uint8_t)p[2 * stride] << 16) | ((uint32_t)(uint8_t)p[3 * stride] << 24);
}

template <bool kStaged>
struct SelectSmem {
  uint32_t win[kWarps][256];
};

template <>
struct SelectSmem<true> {
  uint32_t win[kWarps][256];
  __align__(16) int16_t tab[2 * kTable];
  __align__(8) uint64_t bar;
};

template <bool kStaged, bool kVector>
__global__ void __launch_bounds__(32 * kWarps)
orb_select_kernel(const int8_t* __restrict__ flat, int k,
                  const int16_t* __restrict__ idx0,
                  const int16_t* __restrict__ idx1,
                  const int8_t* __restrict__ mom_w, int words,
                  uint8_t* __restrict__ angles, uint32_t* __restrict__ desc) {
  __shared__ SelectSmem<kStaged> s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarps + warp;

  if constexpr (kStaged) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(&s.bar)),
                   "r"(1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t bar = smem_addr(&s.bar);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(2 * kTableBytes) : "memory");
      const int16_t* tables[2] = {idx0, idx1};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];"
            :: "r"(smem_addr(s.tab + i * kTable)),
               "l"(reinterpret_cast<uint64_t>(tables[i])), "r"(kTableBytes), "r"(bar)
            : "memory");
      }
    }
  }
  if (kp >= k) {
    if constexpr (kStaged) mbar_wait(&s.bar, 0);   // the bulk copies may still write
    return;
  }

  // lane c holds packed words c, 32 + c, ..., 224 + c: rows 4a..4a+3 of
  // column c; their (m10, m01) weights are 8 neighbouring bytes of mom_w
  const int8_t* src = flat + (size_t)kp * 1024;
  uint32_t win[8], wx[8], wy[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = a * 32 + lane;
    if constexpr (kVector) {
      win[a] = __ldg(reinterpret_cast<const uint32_t*>(src) + i);
      const uint2 wt = __ldg(reinterpret_cast<const uint2*>(mom_w) + i);
      wx[a] = __byte_perm(wt.x, wt.y, 0x6420);
      wy[a] = __byte_perm(wt.x, wt.y, 0x7531);
    } else {
      win[a] = bytes4(src + 4 * i, 1);
      wx[a] = bytes4(mom_w + 8 * i, 2);
      wy[a] = bytes4(mom_w + 8 * i + 1, 2);
    }
  }
  int m10 = 0, m01 = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    s.win[warp][a * 32 + lane] = win[a];
    m10 = __dp4a((int)win[a], (int)wx[a], m10);
    m01 = __dp4a((int)win[a], (int)wy[a], m01);
  }
  m10 = (int)__reduce_add_sync(kFullWarp, (unsigned)m10);
  m01 = (int)__reduce_add_sync(kFullWarp, (unsigned)m01);
  const int bin = atan2_bin(m10, m01);
  __syncwarp();

  int i0[8], i1[8];
  if constexpr (kStaged) mbar_wait(&s.bar, 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int at = bin * 256 + 32 * j + lane;
    if constexpr (kStaged) {
      i0[j] = s.tab[at];
      i1[j] = s.tab[kTable + at];
    } else {
      i0[j] = __ldg(idx0 + at);
      i1[j] = __ldg(idx1 + at);
    }
  }
  const int8_t* p = reinterpret_cast<const int8_t*>(s.win[warp]);
  bool gt[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) gt[j] = p[i1[j]] > p[i0[j]];
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned bits = __ballot_sync(kFullWarp, gt[j]);
    if (lane == j) mine = bits;
  }
  if (lane < words) desc[(size_t)kp * words + lane] = mine;
  if (lane == 0) angles[kp] = (uint8_t)bin;
}

__global__ void atan2_bins_kernel(const int32_t* __restrict__ m10,
                                  const int32_t* __restrict__ m01, int n,
                                  uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (uint8_t)atan2_bin(m10[i], m01[i]);
}

}  // namespace

PISLAM_API int pislam_orb_select(const int8_t* flat, int k, const int16_t* idx0,
                                 const int16_t* idx1, const int8_t* mom_w,
                                 int words, uint8_t* angles, int32_t* desc,
                                 cudaStream_t stream) {
  if (k <= 0) return (int)cudaGetLastError();
  const int blocks = (k + kWarps - 1) / kWarps;
  uint32_t* out = reinterpret_cast<uint32_t*>(desc);
  const bool staged = reinterpret_cast<uintptr_t>(idx0) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(idx1) % 16 == 0;
  const bool vector = reinterpret_cast<uintptr_t>(flat) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(mom_w) % 8 == 0;
  if (staged && vector)
    orb_select_kernel<true, true><<<blocks, 32 * kWarps, 0, stream>>>(
        flat, k, idx0, idx1, mom_w, words, angles, out);
  else if (staged)
    orb_select_kernel<true, false><<<blocks, 32 * kWarps, 0, stream>>>(
        flat, k, idx0, idx1, mom_w, words, angles, out);
  else if (vector)
    orb_select_kernel<false, true><<<blocks, 32 * kWarps, 0, stream>>>(
        flat, k, idx0, idx1, mom_w, words, angles, out);
  else
    orb_select_kernel<false, false><<<blocks, 32 * kWarps, 0, stream>>>(
        flat, k, idx0, idx1, mom_w, words, angles, out);
  return (int)cudaGetLastError();
}

PISLAM_API int pislam_atan2_bins(const int32_t* m10, const int32_t* m01, int n,
                                 uint8_t* out, cudaStream_t stream) {
  if (n > 0) {
    atan2_bins_kernel<<<(n + 255) / 256, 256, 0, stream>>>(m10, m01, n, out);
  }
  return (int)cudaGetLastError();
}

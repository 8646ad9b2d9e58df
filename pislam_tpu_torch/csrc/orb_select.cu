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
// One block of 256 threads per keypoint: the window goes to shared memory,
// each thread adds the moment products of 4 bytes (exact in int32), a warp
// shuffle and shared-memory sum reduce them, thread 0 computes the bin, and
// thread i computes bit i; a warp ballot packs word i / 32, bit i % 32. The
// bin is common.cuh's FMA-free atan2_bin, shared with K4d.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
orb_select_kernel(const int8_t* __restrict__ flat,
                  const int16_t* __restrict__ idx0,
                  const int16_t* __restrict__ idx1,
                  const int8_t* __restrict__ mom_w, int words,
                  uint8_t* __restrict__ angles, uint32_t* __restrict__ desc) {
  __shared__ int32_t s_win[256];          // the 1024-byte window
  __shared__ int32_t s_m10[8], s_m01[8];
  __shared__ int s_bin;
  const int kp = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  const int32_t word = reinterpret_cast<const int32_t*>(flat)[(size_t)kp * 256 + t];
  s_win[t] = word;
  int m10 = 0, m01 = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int v = (int8_t)(word >> (8 * b));
    const int i = 4 * t + b;
    m10 += v * mom_w[2 * i];
    m01 += v * mom_w[2 * i + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_down_sync(kFullWarp, m10, off);
    m01 += __shfl_down_sync(kFullWarp, m01, off);
  }
  if (lane == 0) {
    s_m10[warp] = m10;
    s_m01[warp] = m01;
  }
  __syncthreads();
  if (t == 0) {
    int x = 0, y = 0;
    for (int i = 0; i < 8; ++i) {
      x += s_m10[i];
      y += s_m01[i];
    }
    const int bin = atan2_bin(x, y);
    s_bin = bin;
    angles[kp] = (uint8_t)bin;
  }
  __syncthreads();

  const int8_t* p = reinterpret_cast<const int8_t*>(s_win);
  const int bin = s_bin;
  const bool bit = p[idx1[bin * 256 + t]] > p[idx0[bin * 256 + t]];
  const unsigned bits = __ballot_sync(kFullWarp, bit);
  if (lane == 0 && warp < words) desc[(size_t)kp * words + warp] = bits;
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
  if (k > 0) {
    orb_select_kernel<<<k, 256, 0, stream>>>(flat, idx0, idx1, mom_w, words,
                                             angles,
                                             reinterpret_cast<uint32_t*>(desc));
  }
  return (int)cudaGetLastError();
}

PISLAM_API int pislam_atan2_bins(const int32_t* m10, const int32_t* m01, int n,
                                 uint8_t* out, cudaStream_t stream) {
  if (n > 0) {
    atan2_bins_kernel<<<(n + 255) / 256, 256, 0, stream>>>(m10, m01, n, out);
  }
  return (int)cudaGetLastError();
}

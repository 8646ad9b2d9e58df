// K4d: the dense rotation-select of rotated BRIEF, under orb_select_bits'
// contract: packed int8 windows and any (1024, 7808) int8 weight matrix in,
// an angle bin and 256 sign bits per keypoint out.
//
// Replaces orb_select_bits / _orb_select_kernel (pislam_tpu/ops/
// pallas_kernels.py:465, :444). The TPU ran all 30 (B, 1024) x (1024, 256)
// int8 dots of a block of keypoints and kept each keypoint's slab with a
// where; only the selected slab reaches the output, so this kernel computes
// that slab alone. Columns 7680 and 7681 of gm are the disc-moment weights
// (pallas_kernels.py:449-453); the bin is common.cuh's FMA-free atan2_bin,
// the same as K4's. Bit j of a keypoint with bin a is dot(window,
// gm[:, 256 a + j]) > 0.
//
// Bound: bytes, the slabs the keypoints select (at most 30 x 256 KB, 7.9 MB,
// read once) against 2 x 1024 x 256 int8 operations per keypoint on the
// tensor cores (0.14 us at K = 512). Design: one block of 256 threads per
// keypoint; the window goes to shared memory, the moments reduce through warp
// shuffles, then thread j forms the int32 dot with column 256 a + j: each
// row of gm is read as 256 neighbouring bytes, through L2, where the slab
// stays for the other keypoints of that bin.
#include "common.cuh"

namespace {

constexpr int kMomentCol = 30 * 256;

__global__ void __launch_bounds__(256)
orb_select_dense_kernel(const int8_t* __restrict__ flat,
                        const int8_t* __restrict__ gm, int gcols,
                        int32_t* __restrict__ angles,
                        uint8_t* __restrict__ bits) {
  __shared__ int8_t s_win[1024];
  __shared__ int32_t s_m10[8], s_m01[8];
  __shared__ int s_bin;
  const int kp = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  const int32_t word = reinterpret_cast<const int32_t*>(flat)[(size_t)kp * 256 + t];
  reinterpret_cast<int32_t*>(s_win)[t] = word;
  int m10 = 0, m01 = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int v = (int8_t)(word >> (8 * b));
    const int8_t* row = gm + (size_t)(4 * t + b) * gcols + kMomentCol;
    m10 += v * row[0];
    m01 += v * row[1];
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
    angles[kp] = bin;
  }
  __syncthreads();

  const int8_t* col = gm + s_bin * 256 + t;
  int dot = 0;
#pragma unroll 8
  for (int r = 0; r < 1024; ++r) dot += (int)s_win[r] * (int)col[(size_t)r * gcols];
  bits[(size_t)kp * 256 + t] = dot > 0;
}

}  // namespace

PISLAM_API int pislam_orb_select_dense(const int8_t* flat, int k, const int8_t* gm,
                                       int gcols, int32_t* angles, uint8_t* bits,
                                       cudaStream_t stream) {
  if (k > 0) {
    orb_select_dense_kernel<<<k, 256, 0, stream>>>(flat, gm, gcols, angles, bits);
  }
  return (int)cudaGetLastError();
}

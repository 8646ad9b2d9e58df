// K6: scored NMS survivors -> the 2x2 maximum of their packed codes.
//
// Replaces reduce_codes_4x / _vmerge_kernel and the XLA reduce_keys_2x after
// it (pislam_tpu/ops/pallas_kernels.py:949, :917, :936). Input: an (H, W)
// uint8 grid, the Harris score of each NMS survivor and 0 elsewhere. Output
// (ceil(H/2), ceil(W/2)) codes, each the u32 bit pattern (score << 24 |
// x << 12 | y) of the sole survivor of pixel block (2r..2r+1, 2c..2c+1), or 0:
// 3x3 NMS leaves at most one survivor per 2x2 block, so the unsigned block
// maximum keeps every survivor. Codes come out in true row and column order
// with the true coordinates; the TPU's came out with even and odd output
// rows in two planes.
//
// Bound: bytes, 1 read + 2 written per input pixel (0.3 + 0.6 MB at the eval
// pyramid's 800x384, 0.18 us); no arithmetic to speak of. At these sizes the
// grid sits in L2, so what costs is instructions and latency: load and store
// instructions, idle lanes and index arithmetic.
//
// Design: a thread per row pair x 8-column chunk, on a flat grid of
// ceil(H/2) * ceil(W/8) threads in 256-thread blocks, which the card holds
// in one wave; its row pair comes from a multiply-high by a constant the
// host computes, not a division. Where the grid's base and the output are
// 16-byte aligned and W % 16 == 0, a thread makes one 8-byte load per row,
// builds its 8 codes and their 4 2x2 maxima in registers and writes them
// with one 16-byte store, so a warp's loads and stores each cover whole
// lines. Otherwise (any contiguous view can start at any byte, and W need
// not be a multiple of 16) every thread of the same launch reads its columns
// byte by byte, which covers the tail columns and an odd last column. An
// odd last row reads as 0 on both paths; the input is neither rounded nor
// padded. 8 columns and 256 threads were the fastest at eval among the
// builds within 10 % of the fastest at VGA (chunks of 4, 8, 16 columns x
// 128, 256, 512 threads; PERF.md §6).
#include "common.cuh"

namespace {

constexpr int kCols = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t encode(uint32_t b, uint32_t x, uint32_t y) {
  return b ? (b << 24) | (x << 12) | y : 0u;
}

// t / d for 0 <= t < 2^31 by a multiply-high: mul = ceil(2^(31 + l) / d),
// l = ceil(log2 d), shift = l - 1 (d = 1: mul = 0, t itself)
struct Divisor {
  uint32_t mul, shift;
};

Divisor make_divisor(uint32_t d) {
  uint32_t l = 0;
  while ((1u << l) < d) ++l;
  if (d == 1) return {0u, 0u};
  return {(uint32_t)(((1ull << (31 + l)) + d - 1) / d), l - 1};
}

__device__ __forceinline__ int divide(int t, Divisor d) {
  return d.mul ? (int)(__umulhi((uint32_t)t, d.mul) >> d.shift) : t;
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
reduce_codes_kernel(const uint8_t* __restrict__ scored, int h, int w,
                    uint32_t* __restrict__ out, int w2, int chunks, Divisor by_chunks,
                    int threads) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  const int r = divide(t, by_chunks);
  const int x0 = (t - r * chunks) * kCols;
  const int y0 = 2 * r;
  uint32_t* o = out + r * w2 + x0 / 2;
  if constexpr (kVector) {
    const uint2 top = __ldg(reinterpret_cast<const uint2*>(scored + y0 * w + x0));
    const uint2 bottom = y0 + 1 < h
        ? __ldg(reinterpret_cast<const uint2*>(scored + (y0 + 1) * w + x0))
        : make_uint2(0u, 0u);
    uint32_t codes[kCols / 2];
#pragma unroll
    for (int k = 0; k < kCols / 2; ++k) {
      // bytes 2k and 2k + 1 of each row
      const uint32_t a = (k < 2 ? top.x : top.y) >> (16 * (k % 2));
      const uint32_t b = (k < 2 ? bottom.x : bottom.y) >> (16 * (k % 2));
      const uint32_t x = x0 + 2 * k;
      codes[k] = max(max(encode(a & 0xFFu, x, y0), encode((a >> 8) & 0xFFu, x + 1, y0)),
                     max(encode(b & 0xFFu, x, y0 + 1), encode((b >> 8) & 0xFFu, x + 1, y0 + 1)));
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(codes[0], codes[1], codes[2], codes[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kCols / 2; ++k) {
      const int x = x0 + 2 * k;
      if (x >= w) break;
      uint32_t best = 0;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int y = y0 + dy;
        if (y >= h) break;
        best = max(best, encode(scored[y * w + x], x, y));
        if (x + 1 < w) best = max(best, encode(scored[y * w + x + 1], x + 1, y));
      }
      o[k] = best;
    }
  }
}

}  // namespace

// scored (h, w) u8 with h, w <= 4096 (12-bit coordinates); out (ceil(h/2), ceil(w/2)).
PISLAM_API int pislam_reduce_codes(const uint8_t* scored, int h, int w,
                                   int32_t* out, cudaStream_t stream) {
  if (h < 0 || w < 0 || h > 4096 || w > 4096) return (int)cudaErrorInvalidValue;
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  if (h2 > 0 && w2 > 0) {
    const int chunks = (w + kCols - 1) / kCols;
    const int threads = h2 * chunks;
    const int blocks = (threads + kThreads - 1) / kThreads;
    uint32_t* codes = reinterpret_cast<uint32_t*>(out);
    const bool vector = reinterpret_cast<uintptr_t>(scored) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(out) % 16 == 0 && w % 16 == 0;
    if (vector)
      reduce_codes_kernel<true><<<blocks, kThreads, 0, stream>>>(
          scored, h, w, codes, w2, chunks, make_divisor(chunks), threads);
    else
      reduce_codes_kernel<false><<<blocks, kThreads, 0, stream>>>(
          scored, h, w, codes, w2, chunks, make_divisor(chunks), threads);
  }
  return (int)cudaGetLastError();
}

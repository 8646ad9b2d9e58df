// K5: Hamming match reductions over packed descriptors.
//
// Replaces match_reduce / _match_reduce_kernel / _match_reduce_gated_kernel
// (pislam_tpu/ops/pallas_kernels.py:688, :667, :673, with
// _match_distance_tile :657 and _match_accumulate :610). The TPU expanded
// each 256-bit descriptor to 256 int8 +-1 values to feed its matrix unit;
// here the distance is the popcount of a XOR b over the packed u32 words,
// which reads 8x fewer bytes.
//
// Outputs, exactly those of the dense reductions (matching.py:36-65, 101):
//   best[r], second[r], idx[r]  per query row: the least distance, the least
//                               distance over every other column (a duplicate
//                               of the best counts), the first column at best
//   col_argmin[c]               per database column: the first row at the
//                               column's least distance
// Invalid rows and columns, and with the gate pairs farther than the radius
// on the normalised plane, have distance kMaxDist = 1 << 14.
//
// Row pass: one thread per query row, its words in registers; a block of
// kRows rows walks one segment of the database, staged through shared memory
// kTile columns at a time, with the sequential rule
//     d < best:    second = best; best = d; idx = j
//     d < second:  second = d
// which keeps the first occurrence and counts a duplicate best as second.
// The database is split into segments across blockIdx.y so that a frame-size
// K1 still fills the card; the finish kernel merges the segments in order
// with the TPU's rule (pallas_kernels.py:635-639):
//     best = min(bA, bB); idx = bB < bA ? iB : iA;
//     second = min(sA, sB, max(bA, bB))
//
// Column pass, in the same loop: the key (d << 16) | row is unique per row
// and orders by distance, then row, so its minimum names the first row at
// the least distance whatever order the atomics land in. A warp reduces it
// with redux.sync, lane 0 takes the shared-memory atomicMin of its block,
// and each tile's block minima go to device memory with one atomicMin per
// column. The buffer starts at 0x7f7f7f7f (above every key); rows past K1
// contribute nothing, and an all-kMaxDist column keeps row 0, as
// jnp.argmin does. K1 <= 65536 so that the row fits 16 bits.
//
// The gate (pallas_kernels.py:682-684, matching.py:147-148) is
// dx*dx + dy*dy <= r2 in float32 with r2 the float32 rounding of the double
// radius*radius; every float step is an explicitly rounded intrinsic, so no
// FMA contraction can move a pair across the radius. inf and 1e6
// coordinates fail the test (NaN compares false).
//
// Bound: 8 popcounts per pair, 16 per SM per clock on sm_90: 8*K1*K2 /
// (132 * 16 * 1.98e9/s) = 8.0 us at 2048 x 2048, 64 us at 2048 x 16384. An
// int8 tensor-core product of the +-1 expansions would need 2*K1*K2*256 ops
// at 1,979 TOP/s = 1.1 us at 2048 x 2048: that is the card's bound, and the
// route of a later kernel. The bytes, (K1 + K2) * 32 in and 16 per row or
// column out, are negligible.
#include "common.cuh"

namespace {

constexpr int kRows = 128;            // query rows per block, one per thread
constexpr int kTile = 128;            // database columns per shared tile
constexpr int kMaxDist = 1 << 14;     // matching.MAX_DIST
constexpr int kMaxWords = 8;
static_assert(kTile == kRows, "each thread stages one column of a tile");

__global__ void __launch_bounds__(kRows)
match_rows_kernel(const uint32_t* __restrict__ d1, const uint32_t* __restrict__ d2,
                  int k1, int k2, int words,
                  const uint8_t* __restrict__ v1, const uint8_t* __restrict__ v2,
                  const float* __restrict__ uv1, const float* __restrict__ uv2,
                  float r2, int gated, int seg, int* __restrict__ part,
                  int* __restrict__ colkey) {
  __shared__ __align__(16) uint32_t s_desc[kTile][kMaxWords];
  __shared__ int s_valid[kTile];
  __shared__ float2 s_uv[kTile];
  __shared__ int s_col[kTile];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int row = blockIdx.x * kRows + t;
  const bool in = row < k1;
  uint32_t a[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    a[w] = (in && w < words) ? d1[(size_t)row * words + w] : 0u;
  }
  const bool rvalid = in && v1[row] != 0;
  float x1 = 0.0f, y1 = 0.0f;
  if (gated && in) {
    x1 = uv1[2 * row];
    y1 = uv1[2 * row + 1];
  }

  const int c0 = blockIdx.y * seg;
  const int c1 = min(k2, c0 + seg);
  int best = kMaxDist, second = kMaxDist, idx = c0;

  for (int base = c0; base < c1; base += kTile) {
    const int n = min(kTile, c1 - base);
    if (t < n) {
      const int col = base + t;
#pragma unroll
      for (int w = 0; w < kMaxWords; ++w) {
        s_desc[t][w] = w < words ? d2[(size_t)col * words + w] : 0u;
      }
      s_valid[t] = v2[col];
      if (gated) s_uv[t] = make_float2(uv2[2 * col], uv2[2 * col + 1]);
    }
    s_col[t] = 0x7fffffff;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const uint4 lo = *reinterpret_cast<const uint4*>(&s_desc[j][0]);
      const uint4 hi = *reinterpret_cast<const uint4*>(&s_desc[j][4]);
      int d = __popc(a[0] ^ lo.x) + __popc(a[1] ^ lo.y) + __popc(a[2] ^ lo.z) +
              __popc(a[3] ^ lo.w) + __popc(a[4] ^ hi.x) + __popc(a[5] ^ hi.y) +
              __popc(a[6] ^ hi.z) + __popc(a[7] ^ hi.w);
      if (!rvalid || s_valid[j] == 0) d = kMaxDist;
      if (gated) {
        const float dx = __fsub_rn(x1, s_uv[j].x);
        const float dy = __fsub_rn(y1, s_uv[j].y);
        if (!(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r2)) d = kMaxDist;
      }
      if (d < best) {
        second = best;
        best = d;
        idx = base + j;
      } else if (d < second) {
        second = d;
      }
      const int key = in ? (d << 16) | row : 0x7fffffff;
      const int wmin = __reduce_min_sync(kFullWarp, key);
      if (lane == 0) atomicMin(&s_col[j], wmin);
    }
    __syncthreads();
    if (t < n) atomicMin(&colkey[base + t], s_col[t]);
    __syncthreads();
  }

  if (in) {
    int* p = part + ((size_t)blockIdx.y * k1 + row) * 3;
    p[0] = best;
    p[1] = second;
    p[2] = idx;
  }
}

// Merge the segments of each row in order; turn column keys into rows.
__global__ void __launch_bounds__(256)
match_finish_kernel(const int* __restrict__ part, int nseg, int k1, int k2,
                    int* __restrict__ best_out, int* __restrict__ second_out,
                    int* __restrict__ idx_out, int* __restrict__ col) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < k1) {
    int best = part[(size_t)i * 3];
    int second = part[(size_t)i * 3 + 1];
    int idx = part[(size_t)i * 3 + 2];
    for (int s = 1; s < nseg; ++s) {
      const int* p = part + ((size_t)s * k1 + i) * 3;
      second = min(min(second, p[1]), max(best, p[0]));
      if (p[0] < best) {
        best = p[0];
        idx = p[2];
      }
    }
    best_out[i] = best;
    second_out[i] = second;
    idx_out[i] = idx;
  }
  if (i < k2) col[i] &= 0xffff;
}

}  // namespace

// d1 (k1, words), d2 (k2, words) u32; v1, v2 bytes; uv1 (k1, 2), uv2 (k2, 2)
// float32 or null when gated == 0. part: nseg * k1 * 3 ints of scratch; col
// (k2,) is the key buffer and then col_argmin.
PISLAM_API int pislam_match_reduce(const int32_t* d1, const int32_t* d2, int k1,
                                   int k2, int words, const uint8_t* v1,
                                   const uint8_t* v2, const float* uv1,
                                   const float* uv2, float r2, int gated,
                                   int seg, int nseg, int32_t* best,
                                   int32_t* second, int32_t* idx, int32_t* col,
                                   int32_t* part, cudaStream_t stream) {
  if (k1 <= 0 || k2 <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(col, 0x7f, sizeof(int32_t) * (size_t)k2, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((k1 + kRows - 1) / kRows, nseg);
  match_rows_kernel<<<grid, kRows, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(d1), reinterpret_cast<const uint32_t*>(d2),
      k1, k2, words, v1, v2, uv1, uv2, r2, gated, seg, part, col);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = max(k1, k2);
  match_finish_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, nseg, k1, k2, best,
                                                           second, idx, col);
  return (int)cudaGetLastError();
}

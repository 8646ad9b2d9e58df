// K1: FAST-9 + exact integer Harris + level mask + 3x3 NMS + code encode +
// 2x2 code max, in one pass over the stacked pyramid.
//
// Replaces fused_frontend_keys / _fused_frontend_kernel
// (pislam_tpu/ops/pallas_kernels.py:387, :260) and the XLA reduce_keys_2x
// after it (:936). Semantics: pislam_tpu/ops/{fast,harris,nms}.py.
//
// Each block owns a TH x TW pixel tile and writes its TH/2 x TW/2 codes.
// The tile's score depends on image rows/cols -4..+4 around it (Harris reads
// -3..+4 around a pixel, NMS one more score on each side), so the block
// stages an (TH+9) x (TW+9) image region in shared memory, then derivative,
// window-sum and score planes, each in shared memory: nothing but the codes
// reaches device memory. Reads outside the image clamp to the edge; the
// level mask zeroes every score within 16 px of an image edge, so clamped
// values never reach a surviving code. The score phase runs FAST's ring and
// Harris only on the pixels that the mask keeps and that pass FAST's compass
// pretest, gathered into a list per block, so no warp pays for the rest.
//
// The tile is a template parameter, built at 32x64 (about 47 KB of static
// shared memory, the fewest halo pixels) and 16x32 (about 15 KB, four times
// the blocks): kernels.frontend_plan picks the one whose grid fills the
// card. Both are even, so no 2x2 code block straddles two tiles.
//
// Exactness: Harris runs in uint32_t with wrap (det and trace^2), Ixy is an
// arithmetic shift, the score converts to float with round-to-nearest
// (__int2float_rn; scores exceed 2^24), and the quarter float is
// (bits >> 20) & 0xff.
#include "common.cuh"

namespace {

constexpr int NT = 256;

// FAST ring offsets (dy, dx), circular order (pislam_tpu/ops/fast.py:RING)
__constant__ int8_t kRingDy[16] = {-3, -3, -3, -2, -1, 0, 1, 2,
                                   3, 3, 3, 2, 1, 0, -1, -2};
__constant__ int8_t kRingDx[16] = {-1, 0, 1, 2, 3, 3, 3, 2,
                                   1, 0, -1, -2, -3, -3, -3, -2};

__device__ __forceinline__ bool has_run9(uint32_t bits) {
  uint32_t r = bits | (bits << 16);
  r &= r >> 1;
  r &= r >> 2;
  r &= r >> 4;
  r &= r >> 1;
  return (r & 0xffffu) != 0;
}

template <int TH, int TW>
__global__ void __launch_bounds__(NT)
fused_frontend_kernel(const uint8_t* __restrict__ img,
                      const uint8_t* __restrict__ mask,
                      int32_t* __restrict__ out, int h, int w, int fast_t,
                      int harris_t) {
  static_assert(TH % 2 == 0 && TW % 2 == 0, "2x2 code blocks must not straddle tiles");
  constexpr int IH = TH + 9;    // image rows [y0-4, y0+TH+5)
  constexpr int IW = TW + 9;
  constexpr int DH = TH + 7;    // dx/dy rows [y0-3, y0+TH+4)
  constexpr int DW = TW + 7;
  constexpr int SH = TH + 2;    // score rows [y0-1, y0+TH+1)
  constexpr int SW = TW + 2;
  __shared__ uint8_t s_img[IH][IW];
  __shared__ int16_t s_dx[DH][DW];
  __shared__ int16_t s_dy[DH][DW];
  __shared__ int32_t s_hxx[DH][SW];
  __shared__ int32_t s_hyy[DH][SW];
  __shared__ int32_t s_hxy[DH][SW];
  __shared__ uint8_t s_score[SH][SW];
  __shared__ int s_ncand;                 // pixels in the score phase's list
  static_assert(IH * IW + 4 * DH * DW + 12 * DH * SW + SH * SW <= 48 * 1024,
                "static shared memory above 48 KB");

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  if (tid == 0) s_ncand = 0;

  // image region, local (0, 0) = image (y0-4, x0-4), clamped at the edges
  for (int i = tid; i < IH * IW; i += NT) {
    const int r = i / IW, c = i % IW;
    const int gy = min(max(y0 - 4 + r, 0), h - 1);
    const int gx = min(max(x0 - 4 + c, 0), w - 1);
    s_img[r][c] = img[(size_t)gy * w + gx];
  }
  __syncthreads();

  // halving-add Sobel derivatives; local (r, c) = image-local (r+1, c+1)
  for (int i = tid; i < DH * DW; i += NT) {
    const int r = i / DW + 1, c = i % DW + 1;
    const int hd_u = (s_img[r - 1][c + 1] - s_img[r - 1][c - 1]) >> 1;
    const int hd_c = (s_img[r][c + 1] - s_img[r][c - 1]) >> 1;
    const int hd_d = (s_img[r + 1][c + 1] - s_img[r + 1][c - 1]) >> 1;
    const int vd_l = (s_img[r + 1][c - 1] - s_img[r - 1][c - 1]) >> 1;
    const int vd_c = (s_img[r + 1][c] - s_img[r - 1][c]) >> 1;
    const int vd_r = (s_img[r + 1][c + 1] - s_img[r - 1][c + 1]) >> 1;
    s_dx[r - 1][c - 1] = (int16_t)((((hd_u + hd_d) >> 1) + hd_c) >> 1);
    s_dy[r - 1][c - 1] = (int16_t)((((vd_l + vd_r) >> 1) + vd_c) >> 1);
  }
  __syncthreads();

  // horizontal 6-sums of the structure-tensor products at score columns:
  // score col sc (image col x0-1+sc) sums derivative cols sc..sc+5
  for (int i = tid; i < DH * SW; i += NT) {
    const int r = i / SW, c = i % SW;
    int sxx = 0, syy = 0, sxy = 0;
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      const int dx = s_dx[r][c + u], dy = s_dy[r][c + u];
      sxx += dx * dx;
      syy += dy * dy;
      sxy += dx * dy;
    }
    s_hxx[r][c] = sxx;
    s_hyy[r][c] = syy;
    s_hxy[r][c] = sxy;
  }
  __syncthreads();

  // score = FAST corner & Harris > threshold & level mask ? quarter float : 0.
  // Pass 1 zeroes every score and lists the pixels that the mask keeps and
  // whose compass points pass FAST's pretest; pass 2 runs the 16-sample test
  // on the listed pixels alone, and Harris's window sums on its corners.
  // Pretest: 9 consecutive ring samples hold two cyclically adjacent ones of
  // ring points 1, 5, 9, 13, so a pixel without such a pair, dark or light,
  // is no corner. The list lives in s_dx, which the window sums have used up.
  int16_t* s_cand = &s_dx[0][0];
  static_assert(DH * DW >= SH * SW, "candidate list outgrows s_dx");
  const int lane = tid & 31;
  for (int base = 0; base < SH * SW; base += NT) {     // uniform: whole warps
    const int i = base + tid;
    bool cand = false;
    if (i < SH * SW) {
      const int sr = i / SW, sc = i % SW;
      const int gy = y0 - 1 + sr, gx = x0 - 1 + sc;
      s_score[sr][sc] = 0;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w && mask[(size_t)gy * w + gx]) {
        const int ir = sr + 3, ic = sc + 3;        // image-local position
        const int c = s_img[ir][ic];
        const int p1 = s_img[ir - 3][ic], p5 = s_img[ir][ic + 3];
        const int p9 = s_img[ir + 3][ic], p13 = s_img[ir][ic - 3];
        const uint32_t dark = (uint32_t)(p1 < c - fast_t) | (uint32_t)(p5 < c - fast_t) << 1 |
                              (uint32_t)(p9 < c - fast_t) << 2 | (uint32_t)(p13 < c - fast_t) << 3;
        const uint32_t light = (uint32_t)(p1 > c + fast_t) | (uint32_t)(p5 > c + fast_t) << 1 |
                               (uint32_t)(p9 > c + fast_t) << 2 | (uint32_t)(p13 > c + fast_t) << 3;
        cand = ((dark & (dark >> 1 | dark << 3)) | (light & (light >> 1 | light << 3))) & 0xfu;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, cand);
    int first = 0;
    if (lane == 0 && ballot) first = atomicAdd(&s_ncand, __popc(ballot));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (cand) s_cand[first + __popc(ballot & ((1u << lane) - 1u))] = (int16_t)i;
  }
  __syncthreads();

  const int ncand = s_ncand;
  for (int k = tid; k < ncand; k += NT) {
    const int sr = s_cand[k] / SW, sc = s_cand[k] % SW;
    const int ir = sr + 3, ic = sc + 3;
    const int c = s_img[ir][ic];
    uint32_t dark = 0, light = 0;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int s = s_img[ir + kRingDy[p]][ic + kRingDx[p]];
      dark |= (uint32_t)(s < c - fast_t) << p;
      light |= (uint32_t)(s > c + fast_t) << p;
    }
    if (!has_run9(dark) && !has_run9(light)) continue;
    int sxx = 0, syy = 0, sxy = 0;
#pragma unroll
    for (int v = 0; v < 6; ++v) {
      sxx += s_hxx[sr + v][sc];
      syy += s_hyy[sr + v][sc];
      sxy += s_hxy[sr + v][sc];
    }
    const uint32_t ixx = (uint32_t)(sxx >> 4);
    const uint32_t iyy = (uint32_t)(syy >> 4);
    const uint32_t ixy = (uint32_t)(sxy >> 4);     // arithmetic shift first
    const uint32_t trace = ixx + iyy;
    const uint32_t trace2 = (trace * trace) >> 4;
    const uint32_t det = ixx * iyy - ixy * ixy;
    const int32_t hs = (int32_t)(det - trace2);
    if (hs > harris_t) {
      s_score[sr][sc] = (uint8_t)((__float_as_uint(__int2float_rn(hs)) >> 20) & 0xffu);
    }
  }
  __syncthreads();

  // 3x3 NMS (>= up/left, > down/right), encode, max over each 2x2 block
  const int ho = (h + 1) >> 1, wo = (w + 1) >> 1;
  for (int i = tid; i < (TH / 2) * (TW / 2); i += NT) {
    const int orow = i / (TW / 2), ocol = i % (TW / 2);
    const int oy = (y0 >> 1) + orow, ox = (x0 >> 1) + ocol;
    if (oy >= ho || ox >= wo) continue;
    uint32_t best = 0;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int sr = 2 * orow + a + 1, sc = 2 * ocol + b + 1;
        const int s = s_score[sr][sc];
        const bool keep = s > 0 &&
            s >= s_score[sr - 1][sc - 1] && s >= s_score[sr - 1][sc] &&
            s >= s_score[sr - 1][sc + 1] && s >= s_score[sr][sc - 1] &&
            s > s_score[sr][sc + 1] && s > s_score[sr + 1][sc - 1] &&
            s > s_score[sr + 1][sc] && s > s_score[sr + 1][sc + 1];
        if (keep) {
          const uint32_t code = ((uint32_t)s << 24) |
                                ((uint32_t)(x0 + 2 * ocol + b) << 12) |
                                (uint32_t)(y0 + 2 * orow + a);
          best = max(best, code);
        }
      }
    }
    out[(size_t)oy * wo + ox] = (int32_t)best;
  }
}

template <int TH, int TW>
cudaError_t launch(const uint8_t* img, const uint8_t* mask, int32_t* out, int h,
                   int w, int fast_t, int harris_t, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  fused_frontend_kernel<TH, TW><<<grid, NT, 0, stream>>>(img, mask, out, h, w,
                                                         fast_t, harris_t);
  return cudaGetLastError();
}

}  // namespace

// (th, tw): the tile, 32x64 or 16x32 (kernels.FRONTEND_TILES); any other
// gives cudaErrorInvalidValue.
PISLAM_API int pislam_fused_frontend(const uint8_t* img, const uint8_t* mask,
                                     int32_t* out, int h, int w, int fast_t,
                                     int harris_t, int th, int tw,
                                     cudaStream_t stream) {
  if (th == 32 && tw == 64)
    return (int)launch<32, 64>(img, mask, out, h, w, fast_t, harris_t, stream);
  if (th == 16 && tw == 32)
    return (int)launch<16, 32>(img, mask, out, h, w, fast_t, harris_t, stream);
  return (int)cudaErrorInvalidValue;
}

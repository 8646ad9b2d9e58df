// K4d: the dense rotation-select of rotated BRIEF, as a bin-grouped int8
// tensor-core product, under two entry points that share it.
//
// pislam_orb_select_dense keeps orb_select_bits' contract: packed int8
// windows and any (1024, 7808) int8 weight matrix gm in, an angle bin and 256
// sign bits per keypoint out. It replaces orb_select_bits / _orb_select_kernel
// (pislam_tpu/ops/pallas_kernels.py:465, its pallas_call at :480). The bin
// comes from the moments against gm's columns 7680 and 7681
// (pallas_kernels.py:449-453) through common.cuh's FMA-free atan2_bin; bit j
// of a keypoint with bin a is dot(window, gm[:, 256 a + j]) > 0. Nothing
// relies on the structure of brief's weights: any gm gives its own bits.
//
// pislam_orb_describe_dense is the dense-BRIEF frontend's describe stage, the
// counterpart of orb_describe.cu: K2's codes and the stacked pyramid in,
// masked angles and descriptor words out. It replaces the JAX dense branch
// (pislam_tpu/frontend.py:117-124): gather_windows_packed
// (pallas_kernels.py:195: K3a :79 + K3b :154), orb_select_bits, the bit
// packing and the masks by valid. An invalid keypoint gets angle 0 and zero
// words.
//
// Bound: bytes, the slabs of gm the keypoints' bins select (256 KB each, at
// most 30 of them, 7.9 MB) read once, against 2 x 1024 x 256 int8 operations
// per keypoint on the tensor cores (0.14 us at 512 keypoints): about 2.5 us
// at eval's 512 keypoints, 3.1 us at VGA's 2048. The one-block-per-keypoint
// design this replaces formed each dot as a serial loop, read a whole slab
// per keypoint from L2 (K x 256 KB) and never used the tensor cores.
//
// Design, two launches.
// 1. The prologue, a keypoint a warp, 32 a block: the bin from the window's
//    moments (dp4a against gm's two moment columns, staged once per block,
//    then butterfly shuffles), and the window written to a 1 KB scratch slot
//    in the product's byte order (mma_order). The describe entry first
//    gathers the window from the pyramid as orb_describe does (lane c loads
//    column c, so it holds K3's packed words c, 32 + c, ...); an invalid
//    keypoint gets angle 0, zero words and the key kNone. Each keypoint's
//    bin, or kNone, goes to a (K,) byte key.
// 2. The product, on a fixed grid of (ceil(K / kTile) + 29) keypoint tiles x
//    the slab's column chunks of kCols: enough for any histogram of 30 bins,
//    from all K in one bin to 30 bins of one. Each block counts the bins of
//    all K keys (shared atomics), finds its (bin, tile) by prefix over the
//    30 tile counts, exits if it has none, then ranks the bin's members in
//    index order by a block scan. No host sync, no atomics in device
//    memory, and nothing depends on the order in which blocks run: the
//    result repeats bit for bit. The block loads its 128 columns of the bin's
//    slab, all 1024 rows, by TMA (on one mbarrier; the bin alone decides
//    them, so they start before the member search) and its members' whole
//    windows by cp.async into shared memory, then runs mma.sync
//    m16n8k32 s8 x s8 -> s32 with the slab's columns as M (two 16-row tiles a
//    warp, 32 columns: one descriptor word) and the keypoints as N (8 a
//    tile), skipping n-tiles past the tile's members. Both operands must be
//    K-major; gm's rows hold its columns side by side, so each thread loads
//    4 x 4 byte blocks of the slab and transposes them with __byte_perm into
//    A fragments. The k order inside a 32-step is permuted so that a B
//    fragment is one 8-byte load of a window and the A loads of a quad fall
//    in distinct banks under TMA's swizzle (mma_order). With 128 columns a
//    block its eight warps also split k and sum through shared memory. The
//    epilogue takes each sum's sign; a thread holds 4 neighbouring columns of
//    a keypoint, and three xor shuffles gather the 32 columns of a word in
//    _pack_bits_u8's order (bit i of word i / 32 at position i % 32).
// What remains is latency, not bytes or operations (PERF.md): the launch of
// each kernel, the prologue's round trips, and the product block's chain of
// key loads, histogram, member ranking, loads and fragment building.
#include <cuda.h>   // CUtensorMap and its enums; the encoder is found at run time

#include "common.cuh"

namespace {

constexpr int kBins = 30;
constexpr int kMomentCol = kBins * 256;
constexpr int kNone = 0xFF;              // the key of a keypoint no tile takes
constexpr int kThreads = 256;            // the product's block
constexpr int kWarps = kThreads / 32;
constexpr int kPrologueWarps = 32;       // the prologue's block: a keypoint a warp
constexpr int kPrologueThreads = 32 * kPrologueWarps;
constexpr int kKeyRegs = 32;             // keys a product thread holds at once

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// this thread's arrival on the barrier's current phase, announcing `bytes`
// that its TMA loads will deliver
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
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

// a TMA load of the tensor map's box at (x, y) to dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// byte j of v[c] = byte c of w[j]: a 4 x 4 byte block transposed
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t* v) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  v[0] = __byte_perm(t0, t2, 0x5410);
  v[1] = __byte_perm(t0, t2, 0x7632);
  v[2] = __byte_perm(t1, t3, 0x5410);
  v[3] = __byte_perm(t1, t3, 0x7632);
}

// gm's moment columns as packed words: s_m10[i] holds column 7680's bytes of
// rows 4i..4i+3, the rows of a window's packed word i. All threads call it.
__device__ __forceinline__ void stage_moment_weights(const int8_t* __restrict__ gm, int gcols,
                                                     uint32_t* s_m10, uint32_t* s_m01) {
  for (int r = threadIdx.x; r < 1024; r += blockDim.x) {
    const int8_t* row = gm + (size_t)r * gcols + kMomentCol;
    reinterpret_cast<int8_t*>(s_m10)[r] = row[0];
    reinterpret_cast<int8_t*>(s_m01)[r] = row[1];
  }
  __syncthreads();
}

// the bin of lane-distributed packed words win[a] = word 32a + lane
__device__ __forceinline__ int window_bin(const uint32_t (&win)[8], const uint32_t* s_m10,
                                          const uint32_t* s_m01, int lane) {
  int m10 = 0, m01 = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m10 = __dp4a((int)win[a], (int)s_m10[32 * a + lane], m10);
    m01 = __dp4a((int)win[a], (int)s_m01[32 * a + lane], m01);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(kFullWarp, m10, off);
    m01 += __shfl_xor_sync(kFullWarp, m01, off);
  }
  return atan2_bin(m10, m01);
}

// The product's order of a window's bytes. Within each 32-byte k-step, the
// 8 bytes that lane t of an mma quad (t = lane & 3) feeds as its B fragment,
// packed bytes {2t, 2t+1, 8+2t, 9+2t, 16+2t, 17+2t, 24+2t, 25+2t}, are
// stored together at 8t .. 8t+7, so the fragment is one 8-byte load; the
// slab rows the same lane reads for its A fragment are those 8 rows, which
// under TMA's 128-byte swizzle fall in distinct banks. Output word u of a
// step takes 16 bits of input word 4(u&1) + (u>>2) and of the one 2 later:
// lanes 8q..8q+7 hold a step's 8 words, so two shuffles and a byte permute.
__device__ __forceinline__ uint32_t mma_order(uint32_t word, int lane) {
  const int p = lane & 7;
  const int src = (lane & ~7) + 4 * (p & 1) + (p >> 2);
  const uint32_t lo = __shfl_sync(kFullWarp, word, src);
  const uint32_t hi = __shfl_sync(kFullWarp, word, src + 2);
  return __byte_perm(lo, hi, (p >> 1) & 1 ? 0x7632 : 0x5410);
}

// prologue of orb_select_bits: (K, 1024) windows -> int32 bins, keys and
// the windows in the product's order (scratch), a keypoint a warp; the
// window loads are in flight while the block stages the moment columns
__global__ void __launch_bounds__(kPrologueThreads)
dense_bins_kernel(const int8_t* __restrict__ flat, int k, const int8_t* __restrict__ gm,
                  int gcols, int32_t* __restrict__ angles, uint8_t* __restrict__ key,
                  uint32_t* __restrict__ wins) {
  __shared__ uint32_t s_m10[256], s_m01[256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kPrologueWarps + warp;
  uint32_t win[8];
  if (kp < k) {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(flat) + (size_t)kp * 256;
#pragma unroll
    for (int a = 0; a < 8; ++a) win[a] = row[32 * a + lane];
  }
  stage_moment_weights(gm, gcols, s_m10, s_m01);
  if (kp < k) {
    uint32_t* out = wins + (size_t)kp * 256;
#pragma unroll
    for (int a = 0; a < 8; ++a) out[32 * a + lane] = mma_order(win[a], lane);
    const int bin = window_bin(win, s_m10, s_m01, lane);
    if (lane == 0) {
      angles[kp] = bin;
      key[kp] = (uint8_t)bin;
    }
  }
}

// prologue of orb_describe_dense: codes -> windows in the product's order
// (scratch), masked angles, zero words for invalid keypoints and keys, a
// keypoint a warp
__global__ void __launch_bounds__(kPrologueThreads)
describe_dense_gather_kernel(const uint8_t* __restrict__ img, int h, int w,
                             const int64_t* __restrict__ codes,
                             const uint8_t* __restrict__ valid, int k,
                             const int8_t* __restrict__ gm, int gcols, int words,
                             uint8_t* __restrict__ angles, uint32_t* __restrict__ desc,
                             uint8_t* __restrict__ key, uint32_t* __restrict__ wins) {
  __shared__ uint32_t s_m10[256], s_m01[256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kPrologueWarps + warp;
  const bool ok = kp < k && valid[kp] != 0;
  uint32_t win[8];
  if (ok) {
    const int64_t code = codes[kp];
    const int x = min(max((int)((code >> 12) & 0xFFF), 15), w - 17);
    const int y = min(max((int)(code & 0xFFF), 15), h - 17);
    const uint8_t* col = img + (size_t)(y - 15) * w + (x - 15 + lane);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const uint8_t* p = col + (size_t)(4 * a) * w;
      win[a] = ((uint32_t)p[0] | ((uint32_t)p[w] << 8) | ((uint32_t)p[2 * w] << 16) |
                ((uint32_t)p[3 * w] << 24)) ^ 0x80808080u;     // pixel - 128 as int8
    }
  }
  stage_moment_weights(gm, gcols, s_m10, s_m01);
  if (ok) {
    uint32_t* out = wins + (size_t)kp * 256;
#pragma unroll
    for (int a = 0; a < 8; ++a) out[32 * a + lane] = mma_order(win[a], lane);
    const int bin = window_bin(win, s_m10, s_m01, lane);
    if (lane == 0) {
      angles[kp] = (uint8_t)bin;
      key[kp] = (uint8_t)bin;
    }
  } else if (kp < k) {
    if (lane < words) desc[(size_t)kp * words + lane] = 0u;
    if (lane == 0) {
      angles[kp] = 0;
      key[kp] = kNone;
    }
  }
}

// The product's block: kTile keypoints x kCols slab columns over all 1024
// rows of k at once: the slab's columns as kCols / 128 x 4 TMA boxes of 256
// rows x 128 bytes (128-byte swizzle; the boxes of a column half lie one
// after another, so its rows are contiguous), then the members' whole
// windows. Of the builds swept (keypoints 16, 32, 64; columns 128, 256;
// k in stages of 128, 256 or 512 rows or all at once), this was the fastest
// at VGA's 2048 keypoints and, of those within 10 % of it there, the
// fastest at eval's 512 (PERF.md).
constexpr int kTile = 64, kCols = 128, kBoxRows = 256;
struct Plan {
  static constexpr int G = kCols / 32;           // 32-column groups: warps along M
  static constexpr int KS = kWarps / G;          // warps splitting k
  static constexpr int kHalf = 1024 * 128;       // bytes of 128 slab columns
  static constexpr int kSlabBytes = (kCols / 128) * kHalf;
  static constexpr int kWinStride = 1024 + 32;   // bytes of a staged window
  static constexpr int kWinBytes = kTile * kWinStride;
  static constexpr int kRedBytes = (KS - 1) * G * kTile * 32 * 4;
  static constexpr int kInBytes = kSlabBytes + kWinBytes;
  static constexpr int kSmem = (kInBytes > kRedBytes ? kInBytes : kRedBytes) + 1024;
  static_assert(kCols % 128 == 0 && G * KS == kWarps && 32 % KS == 0, "warps must tile M and k");
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

// bits != nullptr: orb_select_bits' (K, 256) bytes for every keypoint;
// else desc's (K, words) words for the keypoints whose key is a bin
__global__ void __launch_bounds__(kThreads)
dense_product_kernel(const __grid_constant__ CUtensorMap gm_map,
                     const int8_t* __restrict__ wins, const uint8_t* __restrict__ key, int k,
                     int ncols, uint8_t* __restrict__ bits, uint32_t* __restrict__ desc,
                     int words) {
  using P = Plan;
  constexpr int G = P::G, KS = P::KS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_hist[32];
  __shared__ int s_members[kTile];
  __shared__ int s_warp[kWarps];
  // the 128-byte swizzle repeats every 1024 bytes: align the boxes to it
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.y * kCols;

  if (tid == 0) mbar_init(&s_bar, 1);
  if (tid < 32) s_hist[tid] = 0;
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  // every bin's count; thread tid owns keys lo..hi-1, read kKeyRegs at once
  const int per = (k + kThreads - 1) / kThreads;
  const int lo = min(tid * per, k), hi = min(lo + per, k);
  for (int base = 0; base < per; base += kKeyRegs) {
    int kv[kKeyRegs];
#pragma unroll
    for (int i = 0; i < kKeyRegs; ++i)
      kv[i] = base + i < per && lo + base + i < hi ? key[lo + base + i] : kNone;
#pragma unroll
    for (int i = 0; i < kKeyRegs; ++i) {
      if (base + i >= per) break;
      if (kv[i] < kBins) atomicAdd(&s_hist[kv[i]], 1);
    }
  }
  __syncthreads();

  // this block's (bin, tile): slot blockIdx.x of the tiles laid out bin by bin
  int bin = -1, tile = 0;
  for (int b = 0, start = 0; b < kBins; ++b) {
    const int n = (s_hist[b] + kTile - 1) / kTile;
    if (bin < 0 && (int)blockIdx.x < start + n) {
      bin = b;
      tile = blockIdx.x - start;
    }
    start += n;
  }
  if (bin < 0) return;
  const int first = tile * kTile;
  const int count = min(kTile, s_hist[bin] - first);    // members: n-tiles past them idle

  // the slab's columns depend on the bin alone: one thread starts them now
  if (tid == 0) {
    mbar_arrive_tx(&s_bar, P::kSlabBytes);
#pragma unroll
    for (int h = 0; h < kCols / 128; ++h)
#pragma unroll
      for (int v = 0; v < 1024 / kBoxRows; ++v)
        tma_load_2d(smem + h * P::kHalf + v * kBoxRows * 128, &gm_map,
                    256 * bin + col0 + 128 * h, v * kBoxRows, &s_bar);
  }

  // the members: the bin's keys of rank first..first+kTile-1, in index order
  int mine = 0;
  for (int base = 0; base < per; base += kKeyRegs) {
#pragma unroll
    for (int i = 0; i < kKeyRegs; ++i)
      mine += base + i < per && lo + base + i < hi && key[lo + base + i] == bin;
  }
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFullWarp, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  if (tid < kTile) s_members[tid] = -1;
  __syncthreads();
  int rank = incl - mine;
  for (int i = 0; i < warp; ++i) rank += s_warp[i];
  if (mine > 0 && rank < first + kTile && rank + mine > first) {
    for (int i = lo; i < hi; ++i) {
      if (key[i] == bin) {
        if (rank >= first && rank < first + kTile) s_members[rank - first] = i;
        ++rank;
      }
    }
  }
  __syncthreads();

  // the members' windows by cp.async
  uint8_t* sw = smem + P::kSlabBytes;
#pragma unroll
  for (int p = tid; p < kTile * 64; p += kThreads) {
    const int n = p >> 6, c16 = p & 63;
    const int m = s_members[n];
    if (m >= 0) cp_async16(sw + n * P::kWinStride + 16 * c16, wins + (size_t)m * 1024 + 16 * c16);
  }
  cp_async_commit();

  const int cg = warp % G, ks = warp / G;
  const int g = lane >> 2, t = lane & 3;
  const bool active = col0 + 32 * cg < ncols;
  // this thread's 4 slab columns: 32-byte group cg % 4 of column half cg / 4
  const uint8_t* sg = smem + (cg >> 2) * P::kHalf;
  const int grp = 2 * (cg & 3) + (g >> 2);
  int acc[kTile / 8][2][4];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][mt][r] = 0;

  cp_async_wait<0>();
  __syncthreads();
  if (active) {
    mbar_wait(&s_bar, 0);
#pragma unroll
    for (int j = 0; j < 32 / KS; ++j) {
      const int st = ks + KS * j;     // a fixed trip count: the steps' loads overlap
      // rows 32 st + {2t, 2t+1, 8+2t, 9+2t | 16+2t, 17+2t, 24+2t, 25+2t} of
      // this thread's 4 columns; a 128-byte row r keeps its 16-byte chunk q
      // at q ^ (r & 7), and r & 7 = 2t + (i & 1) puts the quad's rows in
      // distinct banks
      uint32_t w8[8], v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 32 * st + 2 * t + (i & 1) + 8 * (i >> 1);
        w8[i] = *reinterpret_cast<const uint32_t*>(sg + r * 128 + ((grp ^ (r & 7)) << 4) +
                                                   4 * (g & 3));
      }
      transpose4(w8, v);          // v[c]: column 4g + c, logical k 4t .. 4t + 3
      transpose4(w8 + 4, v + 4);  // v[4 + c]: logical k 16 + 4t .. 16 + 4t + 3
      const uint32_t a0[4] = {v[0], v[1], v[4], v[5]};   // columns 4g, 4g + 1
      const uint32_t a1[4] = {v[2], v[3], v[6], v[7]};   // columns 4g + 2, 4g + 3
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        if (8 * nt >= count) break;
        const uint2 b = *reinterpret_cast<const uint2*>(
            sw + (nt * 8 + g) * P::kWinStride + 32 * st + 8 * t);
        mma_s8(acc[nt][0], a0, b);
        mma_s8(acc[nt][1], a1, b);
      }
    }
  }

  if constexpr (KS > 1) {
    __syncthreads();              // the inputs are read: the space holds the sums
    int32_t* red = reinterpret_cast<int32_t*>(smem);
    if (ks > 0 && active) {
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            red[((((ks - 1) * G + cg) * kTile) + (nt * 2 + mt) * 4 + r) * 32 + lane] =
                acc[nt][mt][r];
    }
    __syncthreads();
    if (ks > 0 || !active) return;
    for (int s = 1; s < KS; ++s) {
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[nt][mt][r] +=
                red[((((s - 1) * G + cg) * kTile) + (nt * 2 + mt) * 4 + r) * 32 + lane];
    }
  } else if (!active) {
    return;
  }

  // accumulator (row g | g + 8 of m-tile mt, keypoint 2t + e) is column
  // 4g + 2 mt + (0 | 1) of this warp's 32
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    if (8 * nt >= count) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = s_members[nt * 8 + 2 * t + e];
      const uint32_t nib = (uint32_t)(acc[nt][0][e] > 0) | (uint32_t)(acc[nt][0][2 + e] > 0) << 1 |
                           (uint32_t)(acc[nt][1][e] > 0) << 2 | (uint32_t)(acc[nt][1][2 + e] > 0) << 3;
      if (bits != nullptr) {
        const uint32_t bytes = (nib & 1u) | (nib >> 1 & 1u) << 8 | (nib >> 2 & 1u) << 16 |
                               (nib >> 3 & 1u) << 24;
        if (m >= 0)
          *reinterpret_cast<uint32_t*>(bits + (size_t)m * 256 + col0 + 32 * cg + 4 * g) = bytes;
      } else {
        uint32_t word = nib << (4 * g);
        word |= __shfl_xor_sync(kFullWarp, word, 4);
        word |= __shfl_xor_sync(kFullWarp, word, 8);
        word |= __shfl_xor_sync(kFullWarp, word, 16);
        const int wi = col0 / 32 + cg;
        if (g == 0 && m >= 0 && wi < words) desc[(size_t)m * words + wi] = word;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// gm (1024 rows of gcols bytes) as a TMA tensor map of rows x 128 boxes with
// the 128-byte swizzle
cudaError_t gm_tensor_map(CUtensorMap* map, const int8_t* gm, int gcols, int rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)gcols, 1024};
  const cuuint64_t strides[1] = {(cuuint64_t)gcols};
  const cuuint32_t box[2] = {128, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(gm),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t product(const int8_t* wins, const uint8_t* key, int k, const int8_t* gm,
                    int gcols, int ncols, uint8_t* bits, uint32_t* desc, int words,
                    cudaStream_t stream) {
  static int have[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(dense_product_kernel, Plan::kSmem, have);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = gm_tensor_map(&map, gm, gcols, kBoxRows);
  if (err != cudaSuccess) return err;
  const dim3 grid((k + kTile - 1) / kTile + kBins - 1, (ncols + kCols - 1) / kCols);
  dense_product_kernel<<<grid, kThreads, Plan::kSmem, stream>>>(map, wins, key, k, ncols, bits,
                                                               desc, words);
  return cudaGetLastError();
}

}  // namespace

// gm: 16-byte aligned; key: (k,) and wins: (k, 1024) scratch bytes
PISLAM_API int pislam_orb_select_dense(const int8_t* flat, int k, const int8_t* gm, int gcols,
                                       int32_t* angles, uint8_t* bits, uint8_t* key,
                                       int8_t* wins, cudaStream_t stream) {
  if (k <= 0) return (int)cudaGetLastError();
  dense_bins_kernel<<<(k + kPrologueWarps - 1) / kPrologueWarps, kPrologueThreads, 0, stream>>>(
      flat, k, gm, gcols, angles, key, reinterpret_cast<uint32_t*>(wins));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)product(wins, key, k, gm, gcols, 256, bits, nullptr, 0, stream);
}

// the same scratch as pislam_orb_select_dense
PISLAM_API int pislam_orb_describe_dense(const uint8_t* img, int h, int w, const int64_t* codes,
                                         const uint8_t* valid, int k, const int8_t* gm,
                                         int gcols, int words, uint8_t* angles, int32_t* desc,
                                         uint8_t* key, int8_t* wins, cudaStream_t stream) {
  if (k <= 0) return (int)cudaGetLastError();
  describe_dense_gather_kernel<<<(k + kPrologueWarps - 1) / kPrologueWarps, kPrologueThreads,
                                 0, stream>>>(
      img, h, w, codes, valid, k, gm, gcols, words, angles,
      reinterpret_cast<uint32_t*>(desc), key, reinterpret_cast<uint32_t*>(wins));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)product(wins, key, k, gm, gcols, 32 * words, nullptr,
                      reinterpret_cast<uint32_t*>(desc), words, stream);
}

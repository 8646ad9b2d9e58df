// K5: Hamming match reductions over packed descriptors, on the int8 tensor
// cores.
//
// Replaces match_reduce / _match_reduce_kernel / _match_reduce_gated_kernel
// (pislam_tpu/ops/pallas_kernels.py:688, :667, :673, with
// _match_distance_tile :657 and _match_accumulate :610), the way the TPU
// computed it: a dense int8 product of the +-1 expansions of the descriptors,
// d = (32 * words - dot) >> 1, with every reduction in the epilogue and no
// (K1, K2) matrix in device memory.
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
// Bound on this card: the product, 2 * K1 * K2 * 32 * words int8 operations
// at 1,979 TOP/s (1.085 us at 512 x 8192, 8.68 us at 2048 x 16384, 256-bit
// descriptors); the bytes, (K1 + K2) * 32 in and 16 per row or column out,
// are far below it. The epilogue has a floor of its own: about 10-20 integer
// and float operations per pair (distance, masks, gate, the row rule, the
// column key) on 64 int32 lanes per SM, ~2.5 us at 512 x 8192 gated and
// ~20 us at 2048 x 16384. That floor, not the tensor cores, bounds the kernel.
//
// Design.
// - One launch. A CTA owns 64 * nwg query rows (nwg consumer warpgroups of
//   64 rows, 1 or 2, from the plan) and walks one segment of the database in
//   tiles of 128 columns; the plan (kernels.match_plan) picks the segments so
//   that the map shapes give at least one CTA per SM (132 on an H100 SXM).
// - Operands. The query rows are expanded once to +-1 bytes in shared memory
//   (bit set -> -1, clear -> +1), K-major, in 8x16-byte core matrices with no
//   swizzle: byte (n, k) of a 256-byte row lies at
//       (n / 8) * 2048 + (k / 16) * 128 + (n % 8) * 16 + k % 16,
//   so the two core matrices of one 32-byte k-step are 128 bytes apart (the
//   descriptor's leading byte offset) and 8-row groups 2048 bytes apart (its
//   stride byte offset); word w of a descriptor is k-step w. The database
//   tiles are expanded the same way into a ring of two stages: the packed
//   words (32 bytes a descriptor) are read from device memory and expanded
//   by all threads while the tensor cores work on the other stage. Expanding
//   in shared memory, rather than a prologue pass into a K2 x 256-byte
//   scratch buffer, keeps the call at one launch and reads the database 8x
//   fewer bytes; the expansion costs ~1 instruction per 4 bytes, far below
//   the epilogue's per-pair work.
// - The product: wgmma.mma_async m64n128k32 .s32.s8.s8, one per descriptor
//   word, both operands from shared memory.
// - The epilogue works on the accumulator registers. Thread (warp w, lane l)
//   of a warpgroup holds rows 16w + l/4 and 16w + l/4 + 8 of its 64, at
//   columns 8i + 2(l%4) + {0, 1}, i < 16 (the wgmma D fragment). Each keeps a
//   running (best, second) per row over its columns as keys
//   (d << 16) | (column - segment start), one IMAD from the accumulator:
//       best = min(best, key); second = min(second, max(best, key))
//   which is the sequential rule (d < best: second = best, best = d,
//   idx = j; else d < second: second = d) with the first column kept on
//   equal distance. Invalid columns and gated-out pairs raise the key's
//   distance to kMaxDist by one max; an invalid row's triple is set at the
//   end. The quad (lanes xor 1, 2) merges on the same keys, and the segments
//   with the TPU's rule (pallas_kernels.py:635-639), which holds in any
//   order:
//       best = min(bA, bB); idx = the lower column on equal best;
//       second = min(sA, sB, max(bA, bB))
// - Column pass: the key (d << 16) | row is unique per row and orders by
//   distance, then row, so its minimum names the first row at the least
//   distance in any order. Keys are reduced over a thread's two rows, over
//   the 8 lanes that share l % 4 (shuffles), over the warps by shared-memory
//   atomicMin, and over the CTAs by one device atomicMin per column per CTA
//   into a key buffer. An all-kMaxDist column keeps row 0, as jnp.argmin
//   does. K1 <= 65536 so that the row fits 16 bits.
// - Loads: every device-memory load of a tile is issued before the tile's
//   bytes are stored, one tile ahead, so its latency hides behind the
//   current tile's epilogue.
// - Merge in the same launch, by atomics: each CTA puts each row's segment
//   triple into the row's merge words (merge_row: a 64-bit atomicMin on
//   (best << 32) | idx, and the value it displaces and the segment's second
//   into an atomicMin of second, which is the TPU's rule in any order), and
//   each tile's column keys into a key buffer by one atomicMin per column.
//   The last CTA of each row tile and of each segment (ticket counters)
//   writes the outputs and resets what it read: merge words to all ones,
//   keys to 0x7fffffff, tickets to 0. So the wrapper initialises this state
//   once, when it allocates it, and no memset runs per call. Calls that run
//   one after another may share it, so the wrapper keeps one per stream:
//   calls on two streams would mix their atomics and tickets.
// - The gate (pallas_kernels.py:682-684, matching.py:147-148) is
//   dx*dx + dy*dy <= r2 in float32 with r2 the float32 rounding of the
//   double radius*radius; every float step is an explicitly rounded
//   intrinsic, so no FMA contraction can move a pair across the radius. inf
//   and 1e6 coordinates fail the test (NaN compares false).
//
// The design it replaced (PR 3): XOR + __popc on the packed words, one
// thread per query row over shared-memory tiles, a warp min and a
// shared-memory atomicMin per column inside the inner loop, and three
// launches (memset, rows, finish). On an NVIDIA H100 80GB HBM3 at 700 W it
// took 14.79 us of device time at 512 x 512, 170.27 us at 2048 x 16384 and
// 60.97 us at 512 x 16384 gated (chip_smoke.py, PERF.md).
#include "common.cuh"

namespace {

constexpr int kMaxDist = 1 << 14;        // matching.MAX_DIST
constexpr int kAbsent = 0x7fff;          // a column past the segment: never a best
constexpr int kNoKey = 0x7fffffff;       // above every column key
constexpr int kTileN = 128;              // database columns per tile (wgmma N)
constexpr int kWgRows = 64;              // query rows per warpgroup (wgmma M)
constexpr int kRowBytes = 256;           // one 256-bit descriptor as +-1 bytes
constexpr int kTileBytes = kTileN * kRowBytes;
constexpr int kLbo = 128;                // next core matrix along K
constexpr int kSbo = 8 * kRowBytes;      // next 8-row group
constexpr int kMaxWarpgroups = 2;

struct MatchArgs {
  const uint32_t* d1;
  const uint32_t* d2;
  const uint8_t* v1;
  const uint8_t* v2;
  const float* uv1;
  const float* uv2;
  unsigned long long* rowbest;   // k1 (best << 32) | idx, ~0 between calls
  unsigned* rowsecond;           // k1 least second, ~0 between calls
  int* colkey;        // k2 least column keys, kNoKey between calls
  int* tickets;       // nrt + nseg counters, 0 between calls
  int* best;
  int* second;
  int* idx;
  int* col;
  float r2;
  int k1, k2, words, tiles_per_seg, nrt, nseg;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bits -> 4 bytes, byte j = bit j ? -1 : +1
__device__ __forceinline__ uint32_t expand4(uint32_t n) {
  return 0x01010101u + ((n * 0x00204081u) & 0x01010101u) * 0xFEu;
}

__device__ __forceinline__ uint4 expand16(uint32_t b) {
  return make_uint4(expand4(b & 0xfu), expand4((b >> 4) & 0xfu),
                    expand4((b >> 8) & 0xfu), expand4((b >> 12) & 0xfu));
}

// word w of row n -> k-bytes [32w, 32w + 32): core matrices 2w and 2w + 1
__device__ __forceinline__ void store_word(uint8_t* tile, int n, int w, uint32_t word) {
  uint8_t* p = tile + (n >> 3) * kSbo + (2 * w) * kLbo + (n & 7) * 16;
  *reinterpret_cast<uint4*>(p) = expand16(word & 0xffffu);
  *reinterpret_cast<uint4*>(p + kLbo) = expand16(word >> 16);
}

// generic-proxy writes to shared memory -> visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K-major, no swizzle (layout type 0), base offset 0
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads across the async product
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 128, s32) = A (64 x 32 s8) * B (128 x 32 s8)^T (+ D if accumulate)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ bool inside(float x1, float y1, float2 c, float r2) {
  const float dx = __fsub_rn(x1, c.x);
  const float dy = __fsub_rn(y1, c.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r2;
}

// One thread's share of a database tile, fetched into registers a tile
// ahead so that the loads' latency hides behind the current tile's
// epilogue: its descriptor words, and (threads < 128) its column's penalty
// key and, gated, point.
template <int kItems>
struct TileRegs {
  uint32_t w[kItems];
  int pen;
  float2 uv;
};

template <bool kGated, int kThreads, int kItems>
__device__ __forceinline__ void fetch_tile(const MatchArgs& p, int base, int c0, int c1,
                                           TileRegs<kItems>& r) {
  const int n_items = min(c1 - base, kTileN) * p.words;
  const uint32_t* src = p.d2 + static_cast<size_t>(base) * p.words;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int it = threadIdx.x + j * kThreads;
    r.w[j] = it < n_items ? __ldg(src + it) : 0u;
  }
  const int n = threadIdx.x;
  if (n < kTileN) {
    const int col = base + n;
    const int jl = col - c0;
    r.pen = col < c1 ? (p.v2[col] ? 0 : (kMaxDist << 16) | jl) : (kAbsent << 16) | jl;
    if (kGated && col < c1) r.uv = make_float2(p.uv2[2 * col], p.uv2[2 * col + 1]);
  }
}

template <bool kGated, int kThreads, int kItems>
__device__ __forceinline__ void store_tile(const MatchArgs& p, const TileRegs<kItems>& r,
                                           int base, int c1, uint8_t* tile, int* pen,
                                           float2* uv) {
  const int n_items = min(c1 - base, kTileN) * p.words;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int it = threadIdx.x + j * kThreads;
    if (it < n_items) {
      const int n = it / p.words;
      store_word(tile, n, it - n * p.words, r.w[j]);
    }
  }
  if (threadIdx.x < kTileN) {
    pen[threadIdx.x] = r.pen;
    if (kGated) uv[threadIdx.x] = r.uv;
  }
}

// Row keys: (d << 16) | (column - segment start), so that one min keeps the
// least distance and, on equal distance, the first column; the second
// distance is min(second, max(best, d)) on the same keys (a duplicate best
// counts). Segments hold at most 65536 columns (the plan).
__device__ __forceinline__ void key_rule(int& bk, int& sk, int rk) {
  sk = min(sk, max(bk, rk));
  bk = min(bk, rk);
}

__device__ __forceinline__ void key_merge_lanes(int& bk, int& sk, int mask) {
  const int b2 = __shfl_xor_sync(kFullWarp, bk, mask);
  const int s2 = __shfl_xor_sync(kFullWarp, sk, mask);
  sk = min(min(sk, s2), max(bk, b2));
  bk = min(bk, b2);
}

// One segment's (best, second, idx) of a row into the row's merge words:
// best and idx by a 64-bit atomicMin on (best << 32) | idx, which keeps the
// lower column on equal best; the pair it displaces and the segment's second
// go to second by atomicMin. Each value but the final best is displaced
// once, so second ends as the least of them: the TPU's rule over all
// segments, in whatever order the atomics land.
__device__ __forceinline__ void merge_row(const MatchArgs& p, int row, int best, int second,
                                          int idx) {
  const unsigned long long mine =
      (static_cast<unsigned long long>(best) << 32) | static_cast<unsigned>(idx);
  const unsigned long long old = atomicMin(p.rowbest + row, mine);
  const unsigned loser = static_cast<unsigned>(max(old, mine) >> 32);
  atomicMin(p.rowsecond + row, min(loser, static_cast<unsigned>(second)));
}

template <bool kGated, int kNwg>
__global__ void __launch_bounds__(kNwg * 128, 2)
match_wgmma_kernel(const MatchArgs p) {
  constexpr int kThreads = kNwg * 128;
  constexpr int kRows = kNwg * kWgRows;
  constexpr int kItems = kTileN * 8 / kThreads;     // words a thread fetches
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  uint8_t* s_a = smem;
  uint8_t* s_b = s_a + kRows * kRowBytes;          // two stages
  int* s_pen = reinterpret_cast<int*>(s_b + 2 * kTileBytes);      // [2][128]
  float2* s_uv = reinterpret_cast<float2*>(s_pen + 2 * kTileN);   // [2][128]
  int* s_colmin = reinterpret_cast<int*>(s_uv + 2 * kTileN);      // [2][128]
  int* s_last = s_colmin + 2 * kTileN;                            // [2]

  const int rt = blockIdx.x, sg = blockIdx.y;
  const int row0 = rt * kRows;
  const int c0 = sg * p.tiles_per_seg * kTileN;
  const int c1 = min(p.k2, c0 + p.tiles_per_seg * kTileN);
  const int ntiles = (c1 - c0 + kTileN - 1) / kTileN;

  // every load of the prologue is issued before any store: this CTA's query
  // rows (expanded once; rows past K1 stay out of every reduction, so their
  // bytes are left as they are), the first database tile, the rows' masks
  const int a_items = min(p.k1 - row0, kRows) * p.words;
  const uint32_t* a_src = p.d1 + static_cast<size_t>(row0) * p.words;
  uint32_t aw[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int it = tid + j * kThreads;
    aw[j] = it < a_items ? __ldg(a_src + it) : 0u;
  }
  TileRegs<kItems> next;
  fetch_tile<kGated, kThreads>(p, c0, c0, c1, next);

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q = lane & 3, g = lane >> 2;
  const int row_a = row0 + wg * kWgRows + warp * 16 + g;
  const int row_b = row_a + 8;
  const bool in_a = row_a < p.k1, in_b = row_b < p.k1;
  const bool ok_a = in_a && p.v1[row_a] != 0;
  const bool ok_b = in_b && p.v1[row_b] != 0;
  float xa = 0.0f, ya = 0.0f, xb = 0.0f, yb = 0.0f;
  if (kGated) {
    if (in_a) { xa = p.uv1[2 * row_a]; ya = p.uv1[2 * row_a + 1]; }
    if (in_b) { xb = p.uv1[2 * row_b]; yb = p.uv1[2 * row_b + 1]; }
  }
  // column keys (d << 16) | row: an invalid row's are (kMaxDist << 16) | row
  // whatever the column, a row past K1 gives none
  const int rowpen_a = !in_a ? kNoKey : ok_a ? 0 : (kMaxDist << 16) | row_a;
  const int rowpen_b = !in_b ? kNoKey : ok_b ? 0 : (kMaxDist << 16) | row_b;

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int it = tid + j * kThreads;
    if (it < a_items) {
      const int r = it / p.words;
      store_word(s_a, r, it - r * p.words, aw[j]);
    }
  }
  store_tile<kGated, kThreads>(p, next, c0, c1, s_b, s_pen, s_uv);
  for (int i = tid; i < 2 * kTileN; i += kThreads) s_colmin[i] = kNoKey;
  fence_proxy_async();
  __syncthreads();

  int bk_a = kMaxDist << 16, sk_a = kMaxDist << 16;
  int bk_b = kMaxDist << 16, sk_b = kMaxDist << 16;
  const int nbits = 32 * p.words;
  const uint64_t desc_a = smem_desc(smem_u32(s_a + wg * kWgRows * kRowBytes));
  const uint32_t b_addr = smem_u32(s_b);

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    const int base = c0 + t * kTileN;
    const uint64_t desc_b = smem_desc(b_addr + st * kTileBytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int w = 0; w < 8; ++w) {          // one k-step of 32 bytes per word
      if (w < p.words) wgmma_s8(acc, desc_a + 16 * w, desc_b + 16 * w, w > 0);
    }
    wgmma_commit();
    const bool more = t + 1 < ntiles;
    if (more) fetch_tile<kGated, kThreads>(p, base + kTileN, c0, c1, next);
    wgmma_wait_all();
    fence_acc(acc);

    // row key of column n before penalties: ((nbits - dot) << 15) | jl
    const int key0 = (nbits << 15) + (base - c0);
    const int* pen = s_pen + st * kTileN;
    const float2* cuv = s_uv + st * kTileN;
    int* colmin = s_colmin + st * kTileN;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int key[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 8 * i + 2 * q + h;
        const int pn = pen[n];
        int ra = max(key0 + n - (acc[4 * i + h] << 15), pn);
        int rb = max(key0 + n - (acc[4 * i + 2 + h] << 15), pn);
        if (kGated) {
          const float2 c = cuv[n];
          const int out = (kMaxDist << 16) + (base - c0) + n;
          if (!inside(xa, ya, c, p.r2)) ra = max(ra, out);
          if (!inside(xb, yb, c, p.r2)) rb = max(rb, out);
        }
        key_rule(bk_a, sk_a, ra);
        key_rule(bk_b, sk_b, rb);
        key[h] = min(max((ra & 0xffff0000) | row_a, rowpen_a),
                     max((rb & 0xffff0000) | row_b, rowpen_b));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        key[h] = min(key[h], __shfl_xor_sync(kFullWarp, key[h], 4));
        key[h] = min(key[h], __shfl_xor_sync(kFullWarp, key[h], 8));
        key[h] = min(key[h], __shfl_xor_sync(kFullWarp, key[h], 16));
      }
      if ((i & 7) == g) {
        atomicMin(&colmin[8 * i + 2 * q], key[0]);
        atomicMin(&colmin[8 * i + 2 * q + 1], key[1]);
      }
    }
    if (more) {
      store_tile<kGated, kThreads>(p, next, base + kTileN, c1, s_b + (st ^ 1) * kTileBytes,
                                   s_pen + (st ^ 1) * kTileN, s_uv + (st ^ 1) * kTileN);
      fence_proxy_async();      // the next stage's bytes, for the next product
    }
    __syncthreads();
    for (int n = tid; n < kTileN; n += kThreads) {
      if (base + n < c1) atomicMin(&p.colkey[base + n], colmin[n]);
      colmin[n] = kNoKey;
    }
  }

  // the quad's columns, then this segment's triple per row into the row's
  // merge words
  key_merge_lanes(bk_a, sk_a, 1);
  key_merge_lanes(bk_a, sk_a, 2);
  key_merge_lanes(bk_b, sk_b, 1);
  key_merge_lanes(bk_b, sk_b, 2);
  if (q == 0) {
    if (in_a) {
      merge_row(p, row_a, ok_a ? bk_a >> 16 : kMaxDist, ok_a ? sk_a >> 16 : kMaxDist,
                c0 + (ok_a ? bk_a & 0xffff : 0));
    }
    if (in_b) {
      merge_row(p, row_b, ok_b ? bk_b >> 16 : kMaxDist, ok_b ? sk_b >> 16 : kMaxDist,
                c0 + (ok_b ? bk_b & 0xffff : 0));
    }
  }

  // the last CTA of a row tile, and of a segment, turns the merge words
  // into outputs and resets them for the next call
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last[0] = atomicAdd(&p.tickets[rt], 1) == p.nseg - 1;
    s_last[1] = atomicAdd(&p.tickets[p.nrt + sg], 1) == p.nrt - 1;
  }
  __syncthreads();
  if (s_last[0]) {
    __threadfence();
    for (int row = row0 + tid; row < min(p.k1, row0 + kRows); row += kThreads) {
      const unsigned long long b = __ldcg(p.rowbest + row);
      p.best[row] = static_cast<int>(b >> 32);
      p.idx[row] = static_cast<int>(b & 0xffffffffu);
      p.second[row] = static_cast<int>(__ldcg(p.rowsecond + row));
      p.rowbest[row] = ~0ull;
      p.rowsecond[row] = ~0u;
    }
    if (tid == 0) p.tickets[rt] = 0;
  }
  if (s_last[1]) {
    __threadfence();
    for (int c = c0 + tid; c < c1; c += kThreads) {
      p.col[c] = __ldcg(p.colkey + c) & 0xffff;
      p.colkey[c] = kNoKey;
    }
    if (tid == 0) p.tickets[p.nrt + sg] = 0;
  }
}

int smem_bytes(int nwg) {
  return 1024 + nwg * kWgRows * kRowBytes + 2 * kTileBytes +
         2 * kTileN * (4 + 8 + 4) + 2 * 4;
}

template <bool kGated, int kNwg>
cudaError_t launch(const MatchArgs& args, cudaStream_t stream) {
  static int attr_bytes[kMaxDevices] = {};
  const cudaError_t err =
      allow_dynamic_smem(match_wgmma_kernel<kGated, kNwg>, smem_bytes(kNwg), attr_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(args.nrt, args.nseg);
  match_wgmma_kernel<kGated, kNwg><<<grid, kNwg * 128, smem_bytes(kNwg), stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// d1 (k1, words), d2 (k2, words) u32; v1, v2 bytes; uv1 (k1, 2), uv2 (k2, 2)
// float32 or null when gated == 0. The plan (kernels.match_plan): nwg
// warpgroups of 64 rows per CTA, nrt row tiles, nseg segments of
// tiles_per_seg 128-column tiles (at most 512). State the caller keeps
// between calls on one stream, which the kernel leaves as it found it (no
// other stream may use it meanwhile): rowbest k1 u64 and
// rowsecond k1 u32 all ones, colkey k2 ints 0x7fffffff, tickets nrt + nseg
// ints 0.
PISLAM_API int pislam_match_reduce(const int32_t* d1, const int32_t* d2, int k1,
                                   int k2, int words, const uint8_t* v1,
                                   const uint8_t* v2, const float* uv1,
                                   const float* uv2, float r2, int gated, int nwg,
                                   int tiles_per_seg, int nrt, int nseg,
                                   int32_t* best, int32_t* second, int32_t* idx,
                                   int32_t* col, uint64_t* rowbest, uint32_t* rowsecond,
                                   int32_t* colkey, int32_t* tickets, cudaStream_t stream) {
  if (k1 <= 0 || k2 <= 0 || k1 > 65536 || words < 1 || words > 8 || nwg < 1 ||
      nwg > kMaxWarpgroups || (long long)nrt * nwg * kWgRows < k1 ||
      (long long)nseg * tiles_per_seg * kTileN < k2 || tiles_per_seg > 512)
    return (int)cudaErrorInvalidValue;
  MatchArgs args;
  args.d1 = reinterpret_cast<const uint32_t*>(d1);
  args.d2 = reinterpret_cast<const uint32_t*>(d2);
  args.v1 = v1;
  args.v2 = v2;
  args.uv1 = uv1;
  args.uv2 = uv2;
  args.rowbest = reinterpret_cast<unsigned long long*>(rowbest);
  args.rowsecond = rowsecond;
  args.colkey = colkey;
  args.tickets = tickets;
  args.best = best;
  args.second = second;
  args.idx = idx;
  args.col = col;
  args.r2 = r2;
  args.k1 = k1;
  args.k2 = k2;
  args.words = words;
  args.tiles_per_seg = tiles_per_seg;
  args.nrt = nrt;
  args.nseg = nseg;
  const cudaError_t err =
      gated ? (nwg == 2 ? launch<true, 2>(args, stream) : launch<true, 1>(args, stream))
            : (nwg == 2 ? launch<false, 2>(args, stream) : launch<false, 1>(args, stream));
  return (int)err;
}

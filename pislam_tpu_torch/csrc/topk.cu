// K2: exact, descending, fully sorted top-k of int32 keys (k <= 8192), in one
// launch of one thread-block cluster.
//
// Replaces topk_keys / _bitonic_topk_kernel (pislam_tpu/ops/pallas_kernels.py
// :892, :864). Keys are code ^ 0x80000000 as int32, so zero codes are
// INT32_MIN; nonzero keys are unique, but any keys are handled exactly.
//
// Bound on this card: bytes, n * 4 in and k * 4 out over 3.35 TB/s (0.092 us
// for the eval pyramid's 76,800 keys, 0.426 us for VGA's 354,560). The work
// is a handful of operations per key. What costs is latency: the launch,
// the cluster barriers, and the sort.
//
// Design: one cluster of kCluster CTAs (portable size) of kThreads threads,
// one launch, no memset.
// - Each CTA owns a share of the keys: groups of 8 keys (32 bytes) go to the
//   CTAs in turn, so that survivors that crowd one part of the image spread
//   over the cluster. Where the shares fit shared memory (up to ~456,000 keys
//   at k = 512: the VGA and eval pyramids), each CTA copies its share there
//   once, as unsigned order keys (key ^ 0x80000000), and device memory is
//   read once. Larger inputs (KITTI's 555,520 keys, 720p's 1,062,400, any n)
//   stay in device memory and every pass reads the CTA's groups again, from
//   L2 after the first; only where the keys come from changes.
// - 8-bit radix passes from the top find the digits of the k-th largest
//   key. Each CTA builds a 256-bin histogram of its keys that match the
//   prefix found so far (shared-memory atomics; the common all-zero key is
//   counted in registers first), then one cluster barrier, then every CTA
//   reads all the histograms through distributed shared memory, scans them
//   and picks the same digit. The histograms are double-buffered by pass,
//   so a CTA clears the next pass's buffer without waiting for the others:
//   one cluster barrier a pass. The passes stop as soon as the keys at or
//   above the prefix number at most the sort's capacity (cap, twice k where
//   shared memory allows): on the frontend's keys, whose top byte is the
//   corner score, that is usually after the first pass.
// - The sort is spread over the cluster. Each CTA keeps its own survivors
//   (the keys at or above the prefix; after all four passes, the keys above
//   the k-th key, the places after them holding the k-th key itself) and
//   sorts them descending in its shared memory: a list of up to 128 by
//   counting each key's rank (8-32 lanes a key), a longer one by a
//   bitonic network in registers (E keys a thread, every step unrolled;
//   from size E on a step's direction depends on the thread alone, so it
//   is one predicated min or max per key). After a cluster barrier each CTA
//   copies the other lists through distributed shared memory, and a second
//   barrier frees them. A key's place in the output is its index in its own
//   list plus, found by binary searches run in lockstep over the other
//   lists, the keys above it there (and the keys equal to it in lower
//   CTAs' lists). The first k places are the result.
//
// The design it replaced (PR 3): ten dependent operations per call (a
// memset, four histogram + one-block digit-select kernel pairs, a compaction
// kernel, a one-block shared-memory bitonic sort), reading the keys five
// times; 25.32 us of device time at the eval shape and 42.04 us at VGA on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 1024;
constexpr int kCluster = 8;
constexpr int kMaxSort = 8192;          // 8 keys a thread, 1024 threads
constexpr int kRankSort = 128;          // lists this short are sorted by counting
constexpr int kGroup = 8;               // keys per 32-byte group of the input
constexpr int kLoads = 4;               // 16-byte loads a thread has in flight

struct SelectState {
  uint32_t prefix;   // digits of the k-th key (as an order key) so far
  uint32_t mask;     // bits of prefix that are set
  int32_t k_rem;     // keys still to take at or below the prefix
  uint32_t n_cand;   // keys at or above the prefix (its lower bits 0)
  uint32_t cnt;      // this CTA's survivors
};

// Every CTA reads the cluster's histograms of this pass through distributed
// shared memory and scans them from the top digit down; the thread whose
// digit holds the k_rem-th key advances the prefix, and records how many
// keys lie at or above it.
__device__ void select_digit(cg::cluster_group& cluster, uint32_t* hist, int pass, int k,
                             SelectState* st, uint32_t* s_warp) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const uint32_t k_rem = (uint32_t)st->k_rem;      // before anyone updates it
  uint32_t count = 0, incl = 0;
  if (t < kBins) {
    const int d = kBins - 1 - t;
    uint32_t part[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) part[r] = cluster.map_shared_rank(hist, r)[d];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) count += part[r];
    incl = count;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t v = __shfl_up_sync(kFullWarp, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
  }
  __syncthreads();
  if (t < kBins) {
    for (int w = 0; w < warp; ++w) incl += s_warp[w];
    const uint32_t above = incl - count;
    if (above < k_rem && incl >= k_rem) {          // exactly one digit
      const int shift = 24 - 8 * pass;
      st->prefix |= (uint32_t)(kBins - 1 - t) << shift;
      st->mask |= 0xffu << shift;
      st->k_rem = (int32_t)(k_rem - above);
      st->n_cand = (uint32_t)k - k_rem + incl;
    }
  }
  __syncthreads();
}

// compare-exchange: the larger first where desc
__device__ __forceinline__ void cex(int32_t& a, int32_t& b, bool desc) {
  const int32_t hi = max(a, b), lo = min(a, b);
  a = desc ? hi : lo;
  b = desc ? lo : hi;
}

// Bitonic sort, descending, of PP keys (src holds n_src, the rest are
// INT32_MIN) held E per thread at index E t + e, on PP / E threads, every
// step unrolled. Sizes below E run inside a thread in directions fixed by
// e. From size E on, a merge's direction and which of a pair is the lower
// index depend on t alone, so each step across threads is one predicated
// min or max per key: partners t ^ (s / E) by warp shuffles while s / E <
// 32, else through shared memory (two buffers alternating, one barrier a
// step); then strides below E inside a thread. Writes the n_src sorted
// keys to dst (which may be a buffer of the network).
template <int PP, int E>
__device__ void sort_desc(const int32_t* src, int n_src, int32_t* buf0, int32_t* buf1,
                          int32_t* dst) {
  constexpr int kNt = PP / E;
  const int t = threadIdx.x;
  const bool holds = t < kNt;
  const bool in_warp = (t >> 5) < ((kNt + 31) >> 5);
  int32_t v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    v[e] = holds && i < n_src ? src[i] : INT32_MIN;
  }
#pragma unroll
  for (int size = 2; size < E; size <<= 1) {
#pragma unroll
    for (int s = size >> 1; s > 0; s >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((e ^ s) > e) cex(v[e], v[e ^ s], (e & size) == 0);
      }
    }
  }
  int flip = 0;
#pragma unroll
  for (int size = (E > 2 ? E : 2); size <= PP; size <<= 1) {
    const bool desc = (t & (size / E)) == 0;
#pragma unroll
    for (int s = size >> 1; s >= E; s >>= 1) {
      const int m = s / E;
      const bool take_max = desc == ((t & m) == 0);
      if (m >= 32) {
        int32_t* buf = flip ? buf1 : buf0;
        flip ^= 1;
        if (holds) {
#pragma unroll
          for (int e = 0; e < E; ++e) buf[E * t + e] = v[e];
        }
        __syncthreads();
        if (holds) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int32_t w = buf[E * (t ^ m) + e];
            v[e] = take_max ? max(v[e], w) : min(v[e], w);
          }
        }
      } else if (in_warp) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int32_t w = __shfl_xor_sync(kFullWarp, v[e], m);
          v[e] = take_max ? max(v[e], w) : min(v[e], w);
        }
      }
    }
#pragma unroll
    for (int s = E >> 1; s > 0; s >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((e ^ s) > e) cex(v[e], v[e ^ s], desc);
      }
    }
  }
  __syncthreads();
  if (holds) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = E * t + e;
      if (i < n_src) dst[i] = v[e];
    }
  }
}

// Shared memory (32-bit words): keys[max(chunk, cap)] | survivors[cap] |
// hist[2][256] | warp sums[8] | state[8]; chunk = 0 where the keys stay in
// device memory. After compaction each CTA reuses the keys region for its
// sorted list (a buffer of the network) and the copies of the others' lists
// after it.
__global__ void __launch_bounds__(kThreads)
topk_cluster_kernel(const int32_t* __restrict__ keys, int n, int k, int cap, int chunk,
                    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int region = max(chunk, cap);
  uint32_t* s_keys = smem;
  int32_t* s_surv = reinterpret_cast<int32_t*>(smem + region);
  uint32_t* s_hist = smem + region + cap;                // [2][256]
  uint32_t* s_warp = s_hist + 2 * kBins;                 // [8]
  SelectState* st = reinterpret_cast<SelectState*>(s_warp + 8);

  // this CTA's keys: groups of kGroup keys (32 bytes) go to the CTAs in
  // turn, so that survivors that cluster in one part of the image (the
  // full-resolution level) spread over the cluster. Where they fit
  // (resident), a CTA copies its groups into shared memory once, one after
  // another, the short last group of the keys last; else each pass reads
  // them from device memory again.
  const bool resident = chunk > 0;
  const int ngroups = (n + kGroup - 1) / kGroup;
  const int mine = ngroups > rank ? (ngroups - rank + kCluster - 1) / kCluster : 0;
  const int m = mine * kGroup -
                (rank == (ngroups - 1) % kCluster ? ngroups * kGroup - n : 0);
  const bool aligned = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  // the CTA's groups in device memory, by half groups of 4 keys, as order
  // keys: f(index in the CTA's share, 4 keys, how many of them are keys).
  // Each thread issues kLoads loads before it uses one, so that enough bytes
  // are in flight for 8 SMs to stream the keys.
  auto each_global = [&](auto&& f) {
    for (int h0 = t; h0 < 2 * mine; h0 += kLoads * kThreads) {
      uint4 u[kLoads];
      int cnt[kLoads];
#pragma unroll
      for (int b = 0; b < kLoads; ++b) {
        const int h = h0 + b * kThreads;
        const int i0 = ((h >> 1) * kCluster + rank) * kGroup + (h & 1) * 4;
        cnt[b] = h < 2 * mine ? min(4, n - i0) : 0;
        if (aligned && cnt[b] == 4) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(keys + i0));
          u[b] = make_uint4(v.x ^ 0x80000000u, v.y ^ 0x80000000u, v.z ^ 0x80000000u,
                            v.w ^ 0x80000000u);
        } else {
          auto ld = [&](int q) {
            return q < cnt[b] ? (uint32_t)__ldg(keys + i0 + q) ^ 0x80000000u : 0u;
          };
          u[b] = make_uint4(ld(0), ld(1), ld(2), ld(3));
        }
      }
#pragma unroll
      for (int b = 0; b < kLoads; ++b) {
        const int h = h0 + b * kThreads;
        if (cnt[b] > 0) f((h >> 1) * kGroup + (h & 1) * 4, u[b], cnt[b]);
      }
    }
  };
  // every key of this CTA, from wherever it lives
  auto each_key = [&](auto&& g) {
    if (resident) {
      for (int i = t; i < m / 4; i += kThreads) {
        const uint4 u = reinterpret_cast<const uint4*>(s_keys)[i];
        g(u.x);
        g(u.y);
        g(u.z);
        g(u.w);
      }
      if (t < m % 4) g(s_keys[m - m % 4 + t]);
    } else {
      each_global([&](int, uint4 u, int cnt) {
        g(u.x);
        if (cnt > 1) g(u.y);
        if (cnt > 2) g(u.z);
        if (cnt > 3) g(u.w);
      });
    }
  };
  if (resident) {
    each_global([&](int at, uint4 u, int cnt) {
      if (cnt == 4) {
        *reinterpret_cast<uint4*>(s_keys + at) = u;
      } else {
        s_keys[at] = u.x;
        if (cnt > 1) s_keys[at + 1] = u.y;
        if (cnt > 2) s_keys[at + 2] = u.z;
      }
    });
  }
  for (int i = t; i < 2 * kBins; i += kThreads) s_hist[i] = 0;
  if (t == 0) {
    st->prefix = 0;
    st->mask = 0;
    st->k_rem = k;
    st->n_cand = (uint32_t)n;
    st->cnt = 0;
  }
  __syncthreads();

  // radix passes until the keys at or above the prefix fit the sort
  bool exact = true;
  for (int pass = 0; pass < 4; ++pass) {
    uint32_t* hist = s_hist + (pass & 1) * kBins;
    const uint32_t prefix = st->prefix, mask = st->mask;
    const int shift = 24 - 8 * pass;
    uint32_t zeros = 0;                     // digit 0 counted in a register
    auto count = [&](uint32_t u) {
      if ((u & mask) == prefix) {
        const uint32_t dgt = (u >> shift) & 0xffu;
        if (dgt == 0) ++zeros;
        else atomicAdd(&hist[dgt], 1u);
      }
    };
    each_key(count);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) zeros += __shfl_xor_sync(kFullWarp, zeros, off);
    if ((t & 31) == 0 && zeros) atomicAdd(&hist[0], zeros);
    cluster.sync();                         // every histogram of this pass is whole
    for (int i = t; i < kBins; i += kThreads) s_hist[((pass + 1) & 1) * kBins + i] = 0;
    select_digit(cluster, hist, pass, k, st, s_warp);
    if (st->n_cand <= (uint32_t)cap) {      // the same in every CTA
      exact = false;
      break;
    }
  }

  // Each CTA keeps its own survivors: the keys above the k-th key (exact;
  // the k - n_gt places after them hold the k-th key itself) or every key
  // at or above the prefix (n_cand <= cap of them in the cluster). They are
  // few, so each takes its slot with a shared-memory atomic.
  const uint32_t thr = st->prefix;
  auto take = [&](uint32_t u) {
    if (exact ? u > thr : u >= thr) s_surv[atomicAdd(&st->cnt, 1u)] = (int32_t)(u ^ 0x80000000u);
  };
  each_key(take);
  __syncthreads();

  // this CTA's list, sorted descending, into the keys region: a short list
  // by counting each key's rank, a long one by the bitonic network
  const int len = (int)st->cnt;
  int32_t* s_list = reinterpret_cast<int32_t*>(s_keys);
  if (len <= kRankSort) {
    // lanes per key (8-32, a power of two), each counting the keys above it
    // in a slice of the list (and the equal ones before it), summed by
    // shuffles
    int lanes = kThreads / kRankSort;
    while (lanes < 32 && lanes * 2 * len <= kThreads) lanes <<= 1;
    const int j = t / lanes, part = t % lanes;
    const int32_t x = j < len ? s_surv[j] : 0;
    const int lo = len * part / lanes, hi = len * (part + 1) / lanes;
    int r = 0;
    if (j < len) {
      for (int i = lo; i < hi; ++i) {
        const int32_t y = s_surv[i];
        r += (y > x) || (y == x && i < j);
      }
    }
    for (int o = 1; o < lanes; o <<= 1) r += __shfl_xor_sync(kFullWarp, r, o);
    if (j < len && part == 0) s_list[r] = x;
  } else if (len <= 256) {
    sort_desc<256, 2>(s_surv, len, s_list, s_surv, s_list);
  } else if (len <= 512) {
    sort_desc<512, 2>(s_surv, len, s_list, s_surv, s_list);
  } else if (len <= 1024) {
    sort_desc<1024, 2>(s_surv, len, s_list, s_surv, s_list);
  } else if (len <= 2048) {
    sort_desc<2048, 2>(s_surv, len, s_list, s_surv, s_list);
  } else if (len <= 4096) {
    sort_desc<4096, 4>(s_surv, len, s_list, s_surv, s_list);
  } else {
    sort_desc<8192, 8>(s_surv, len, s_list, s_surv, s_list);
  }
  cluster.sync();                           // every CTA's list is sorted

  // the other CTAs' lists, copied after this one's, in rank order
  if (t < kCluster) s_warp[t] = cluster.map_shared_rank(&st->cnt, t)[0];
  __syncthreads();
  int off[kCluster];
  int total = len, longest = 0;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    off[r] = r == rank ? 0 : total;
    total += r == rank ? 0 : (int)s_warp[r];
    longest = r == rank ? longest : max(longest, (int)s_warp[r]);
  }
  for (int base = 0; base < longest; base += kThreads) {   // loads first, then stores
    int32_t got[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const int i = base + t;
      got[r] = r != rank && i < (int)s_warp[r] ? cluster.map_shared_rank(s_list, r)[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const int i = base + t;
      if (r != rank && i < (int)s_warp[r]) s_list[off[r] + i] = got[r];
    }
  }
  cluster.sync();                           // no CTA reads another's memory after this

  // a key's rank: its place in its own list, plus the keys above it in the
  // others' (and the keys equal to it in the lists of lower CTAs)
  int steps = 0;                            // binary-search steps for the longest list
  while ((1 << steps) <= longest) ++steps;
  for (int j = t; j < len; j += kThreads) {
    const int32_t x = s_list[j];
    int lo[kCluster], hi[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      lo[r] = 0;
      hi[r] = r == rank ? 0 : (int)s_warp[r];
    }
    for (int step = 0; step < steps; ++step) {   // all lists at once, branch-free
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const int mid = (lo[r] + hi[r]) >> 1;
        const int32_t y = s_list[off[r] + min(mid, max(hi[r] - 1, 0))];
        const bool go = lo[r] < hi[r];
        const bool above = y > x || (r < rank && y == x);
        lo[r] = go && above ? mid + 1 : lo[r];
        hi[r] = go && !above ? mid : hi[r];
      }
    }
    int place = j;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) place += lo[r];
    if (place < k) out[place] = x;
  }
  if (exact && rank == 0) {
    const int n_gt = k - st->k_rem;
    for (int i = n_gt + t; i < k; i += kThreads) out[i] = (int32_t)(thr ^ 0x80000000u);
  }
}

}  // namespace

// keys (n,), k <= n, k <= 8192, n < 2^31 - 2^10; the plan
// (kernels.topk_plan): cap = the sort's capacity, a power of two
// >= max(k, 32), at most 8192; chunk = keys a CTA holds in shared memory at
// most (a multiple of 8: its share of the 8-key groups), or 0 where the keys
// stay in device memory; smem = dynamic shared-memory bytes. One launch of
// one cluster.
PISLAM_API int pislam_topk_keys(const int32_t* keys, int n, int k, int cap, int chunk,
                                int smem, int32_t* out, cudaStream_t stream) {
  if (k < 1 || k > n || n > 0x7fffffff - 1024 || k > kMaxSort || cap < k ||
      cap < 32 || (cap & (cap - 1)) || cap > kMaxSort || chunk < 0 || chunk % kGroup ||
      (chunk > 0 &&
       (long long)chunk * kCluster < (long long)(n + kGroup - 1) / kGroup * kGroup))
    return (int)cudaErrorInvalidValue;
  static int attr_bytes[kMaxDevices] = {};
  const cudaError_t attr_err = allow_dynamic_smem(topk_cluster_kernel, smem, attr_bytes);
  if (attr_err != cudaSuccess) return (int)attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, topk_cluster_kernel, keys, n, k, cap,
                                             chunk, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

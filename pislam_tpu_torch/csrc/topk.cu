// K2: exact, descending, fully sorted top-k of int32 keys (k <= 8192).
//
// Replaces topk_keys / _bitonic_topk_kernel (pislam_tpu/ops/pallas_kernels.py
// :892, :864). Keys are code ^ 0x80000000 as int32, so zero codes are
// INT32_MIN; nonzero keys are unique.
//
// A radix select finds the k-th largest key, 8 bits per pass from the top:
// each pass builds a 256-bin histogram of the keys that match the prefix
// found so far (shared-memory histograms merged into one in device memory)
// and one block scans it for the digit where the count from the top reaches k.
// The kernel then compacts the k - k_eq keys above the k-th key and k_eq of
// the keys equal to it (warp-aggregated atomics), and one block sorts them
// descending with a bitonic network in shared memory.
//
// Scratch (int32 words): hist[4][256] | state[8] | buf[p], p = pow2 >= k.
#include "common.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kSortThreads = 1024;

struct SelectState {
  uint32_t prefix;   // digits of the k-th key (as uint32 order key) so far
  uint32_t mask;     // bits of prefix that are set
  int32_t k_rem;     // keys still to take at or below the prefix
  uint32_t cnt_gt;   // compaction counters
  uint32_t cnt_eq;
  uint32_t pad[3];
};

__device__ __forceinline__ uint32_t order_key(int32_t key) {
  return (uint32_t)key ^ 0x80000000u;   // signed order -> unsigned order
}

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int32_t* __restrict__ keys, int n, int pass,
                 uint32_t* __restrict__ hist, const SelectState* st) {
  __shared__ uint32_t s_hist[kBins];
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const uint32_t prefix = st->prefix, mask = st->mask;
  const int shift = 24 - 8 * pass;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint32_t u = order_key(keys[i]);
    if ((u & mask) == prefix) atomicAdd(&s_hist[(u >> shift) & 0xffu], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    if (s_hist[i]) atomicAdd(&hist[pass * kBins + i], s_hist[i]);
  }
}

// One block of 256 threads: thread t owns digit d = 255 - t, a shared-memory
// scan gives the count of keys at or above each digit, and the one thread
// whose digit holds the k_rem-th key from the top records it.
__global__ void __launch_bounds__(kBins)
select_digit_kernel(const uint32_t* __restrict__ hist, int pass, int k,
                    SelectState* st) {
  __shared__ uint32_t s_at_or_above[kBins];
  const int t = threadIdx.x;
  const int d = kBins - 1 - t;
  const uint32_t count = hist[pass * kBins + d];
  s_at_or_above[t] = count;
  __syncthreads();
  for (int off = 1; off < kBins; off <<= 1) {
    const uint32_t v = t >= off ? s_at_or_above[t - off] : 0u;
    __syncthreads();
    s_at_or_above[t] += v;
    __syncthreads();
  }
  const uint32_t k_rem = pass == 0 ? (uint32_t)k : (uint32_t)st->k_rem;
  const uint32_t at_or_above = s_at_or_above[t];
  const uint32_t above = at_or_above - count;
  __syncthreads();                   // every thread has read st->k_rem
  if (above < k_rem && at_or_above >= k_rem) {   // n >= k: exactly one digit
    const int shift = 24 - 8 * pass;
    st->prefix |= (uint32_t)d << shift;
    st->mask |= 0xffu << shift;
    st->k_rem = (int32_t)(k_rem - above);
  }
}

__device__ __forceinline__ void append(bool take, uint32_t* counter,
                                       int32_t* dst, int limit, int32_t key) {
  const unsigned ballot = __ballot_sync(kFullWarp, take);
  if (!ballot) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(ballot) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(counter, (uint32_t)__popc(ballot));
  base = __shfl_sync(kFullWarp, base, leader);
  const uint32_t slot = base + __popc(ballot & ((1u << lane) - 1u));
  if (take && slot < (uint32_t)limit) dst[slot] = key;
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const int32_t* __restrict__ keys, int n, int k,
               SelectState* st, int32_t* __restrict__ buf) {
  const uint32_t kth = st->prefix;
  const int k_eq = st->k_rem;
  const int n_gt = k - k_eq;
  // block-uniform trip count: every lane reaches each ballot
  for (int base = blockIdx.x * blockDim.x; base < n;
       base += gridDim.x * blockDim.x) {
    const int i = base + threadIdx.x;
    const int32_t key = i < n ? keys[i] : 0;
    const uint32_t u = order_key(key);
    append(i < n && u > kth, &st->cnt_gt, buf, n_gt, key);
    append(i < n && u == kth, &st->cnt_eq, buf + n_gt, k_eq, key);
  }
}

__global__ void __launch_bounds__(kSortThreads)
sort_desc_kernel(const int32_t* __restrict__ buf, int k, int p,
                 int32_t* __restrict__ out) {
  extern __shared__ int32_t s[];
  for (int i = threadIdx.x; i < p; i += blockDim.x)
    s[i] = i < k ? buf[i] : INT32_MIN;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool desc = (i & size) == 0;
          const int32_t a = s[i], b = s[j];
          if (desc ? a < b : a > b) {
            s[i] = b;
            s[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) out[i] = s[i];
}

}  // namespace

// keys (n,), n >= k; p = smallest power of two >= k, p <= 8192.
PISLAM_API int pislam_topk_keys(const int32_t* keys, int n, int k, int p,
                                int32_t* out, int32_t* scratch,
                                cudaStream_t stream) {
  uint32_t* hist = reinterpret_cast<uint32_t*>(scratch);
  SelectState* st = reinterpret_cast<SelectState*>(scratch + 4 * kBins);
  int32_t* buf = scratch + 4 * kBins + 8;
  cudaMemsetAsync(scratch, 0, (4 * kBins + 8) * sizeof(int32_t), stream);
  const int blocks = min((n + kThreads - 1) / kThreads, kMaxBlocks);
  for (int pass = 0; pass < 4; ++pass) {
    histogram_kernel<<<blocks, kThreads, 0, stream>>>(keys, n, pass, hist, st);
    select_digit_kernel<<<1, kBins, 0, stream>>>(hist, pass, k, st);
  }
  compact_kernel<<<blocks, kThreads, 0, stream>>>(keys, n, k, st, buf);
  sort_desc_kernel<<<1, kSortThreads, p * sizeof(int32_t), stream>>>(buf, k, p,
                                                                      out);
  return (int)cudaGetLastError();
}

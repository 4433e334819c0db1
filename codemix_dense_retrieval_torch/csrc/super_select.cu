// The super level of the two-level bin-max cover (ops/topk.py,
// _select_bins_two_level): for each query row b of the (B, nb) f32 bin
// maxima, the super maxima m[b, s] = max of bins s * M .. s * M + M - 1, then
// the K = min(ks + 1, ns) best supers by (m desc, s asc), ns = nb / M. Writes
// vals (B, K) f32, those supers' maxima in that order, and ids (B, ks) int64,
// the first ks of them sorted ascending.
//
// Replaces no TPU kernel: the JAX package takes this step as a reshape-max
// and a stable sort, and so did the port (torch.amax, then torch.sort over
// the whole row of ns super maxima and a slice). On an H100 at the main path's
// shape (B = 256, nb = 1,105,280, M = 8, ks = 100) that took 4.9 ms a launch
// for a result of 101 values a row: the amax's reduce kernel (2.0 ms), cub's
// segmented radix sort of 138,160 (value, int64 index) pairs a row (1.8 ms)
// and its index fill.
//
// Bit for bit the values and ids of that torch path on the card:
// - a super's maximum folds its M bins as torch.amax does on the card: one
//   lane a bin, a shuffle tree that halves its offsets, so the bins combine
//   in bit-reversed order (0, 4, 2, 6, 1, 5, 3, 7 at M = 8), each step
//   (isnan(a) || a > b) ? a : b: among equal maxima (+0.0, -0.0) the last in
//   that order, among NaNs the first;
// - the order is cub's radix order of the float's bits (sign flipped for
//   positives, all bits for negatives), with -0.0 read as +0.0 as cub's digit
//   extraction does: NaNs with the sign bit clear first, by their bits, those
//   with it set last; ties (+0.0 and -0.0 included) to the lower super id, as
//   the stable sort keeps them.
//
// What bounds it: bytes. The bin maxima are read once (256 x 1,105,280 x 4 B
// = 1.13 GB: 0.338 ms at 3.35 TB/s); the rest is small.
//
// Design: two kernels on the stream (one where K passes MAX_K).
// 1. super_max_kernel streams the rows (one super a lane, M / 4 16-byte loads
//    each, 4 groups of 32 supers in flight a warp) and writes only each
//    group's largest order key, (B, ceil(ns / 32)) u32 (4.4 MB at the main
//    shape): no (B, ns) copy of the super maxima.
// 2. super_select_kernel, one block a row. The K-th largest group maximum lo
//    is at most the K-th largest super key (each of the K groups at or above
//    lo holds a super at or above it), so every super of the answer lies in a
//    group whose maximum is at least lo. A radix select over the row's group
//    maxima (12 + 12 + 8 bits, in shared memory) finds lo; each warp rescans
//    only those groups (about K of 4,318 at the main shape) from the bin
//    maxima and gathers the supers at or above lo, as (key, ~id) u64, into
//    shared memory; a bitonic sort puts the first K in order. Where more than
//    CAP supers reach lo (ties: a row of equal maxima, NEG_INF pad supers when
//    K passes the valid ones), the same radix select runs over all ns supers
//    for the exact K-th key T, and one ordered pass keeps every super above T
//    and the lowest ids among those equal to it (a block-wide prefix count in
//    id order).
// Where K passes MAX_K, super_select_wide_kernel (one block a row, no pass 1)
// takes that exact select alone and sorts the K candidates in a global
// buffer of the wrapper's, (B, width) u64 with width the power of two at or
// above K.
// Requirements (checked by the Python wrapper): bin maxima (B, nb) f32,
// contiguous, 16-byte aligned; M in {4, 8, 16}; nb % M == 0; 1 <= ks <= ns;
// K = min(ks + 1, ns); ns < 2^31 - 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 32;          // supers a group: one a lane
constexpr int P1_THREADS = 256;
constexpr int P1_WARPS = P1_THREADS / 32;
constexpr int P1_UNROLL = 4;       // groups a warp loads before it reduces
constexpr int P2_THREADS = 512;
constexpr int MAX_K = 4096;        // SUPER_SELECT_MAX_K in ops/topk.py: the most K sorted in shared memory
constexpr int CAP = 8192;          // candidates the fast path sorts in shared memory
constexpr int HBINS = 4096;        // radix digits of 12 bits
constexpr int PER = HBINS / P2_THREADS;

// a super's M bins come as M / 4 16-byte loads
constexpr int VEC = 4;
__device__ __forceinline__ float part(float4 v, int c) { return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w; }

// torch.amax's combine on the card (a NaN in a stays; equal values keep b)
__device__ __forceinline__ float amax_combine(float a, float b) { return (isnan(a) || a > b) ? a : b; }

// cub's radix key of a float for an ascending order, -0.0 read as +0.0
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the float of a key; a zero key stands for +0.0 and -0.0 alike
__device__ __forceinline__ float key_value(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

constexpr uint32_t ZERO_KEY = 0x80000000u;

// (key desc, id asc) as one u64 in descending order; 0 sorts below them all
__device__ __forceinline__ unsigned long long candidate(uint32_t u, uint32_t id) {
  return (static_cast<unsigned long long>(u) << 32) | static_cast<uint32_t>(~id);
}

__device__ __forceinline__ uint32_t candidate_id(unsigned long long c) { return ~static_cast<uint32_t>(c); }

// the bin that comes i-th in torch.amax's order over M bins (M a power of
// two): i with its log2(M) bits reversed
__host__ __device__ constexpr int combine_pos(int i, int M) {
  int r = 0;
  for (int b = 1; b < M; b <<= 1) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

// a super's maximum: its M bins folded in torch.amax's order
template <int M>
__device__ __forceinline__ float fold_max(const float4 (&v)[M / VEC]) {
  float m = part(v[0], 0);
#pragma unroll
  for (int i = 1; i < M; ++i) {
    const int j = combine_pos(i, M);
    m = amax_combine(m, part(v[j / VEC], j % VEC));
  }
  return m;
}

template <int M>
__device__ __forceinline__ float super_max(const float* __restrict__ row, long long s) {
  const float4* p = reinterpret_cast<const float4*>(row + s * M);
  float4 v[M / VEC];
#pragma unroll
  for (int l = 0; l < M / VEC; ++l) v[l] = __ldg(p + l);
  return fold_max<M>(v);
}

// pass 1: each group's largest super key, gmax (B, ng)
template <int M>
__global__ void __launch_bounds__(P1_THREADS)
super_max_kernel(const float* __restrict__ bm, uint32_t* __restrict__ gmax, int B, int ns, int ng) {
  constexpr int L = M / VEC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = blockIdx.y; row < B; row += gridDim.y) {
    const float* src = bm + static_cast<long long>(row) * ns * M;
    uint32_t* dst = gmax + static_cast<long long>(row) * ng;
    for (long long g0 = (static_cast<long long>(blockIdx.x) * P1_WARPS + warp) * P1_UNROLL; g0 < ng;
         g0 += static_cast<long long>(gridDim.x) * P1_WARPS * P1_UNROLL) {
      float4 v[P1_UNROLL][L];
#pragma unroll
      for (int u = 0; u < P1_UNROLL; ++u) {
        const long long s = (g0 + u) * GROUP + lane;
        const float4* p = reinterpret_cast<const float4*>(src + s * M);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (s < ns) v[u][l] = __ldcs(p + l);
          else v[u][l] = float4{};
        }
      }
#pragma unroll
      for (int u = 0; u < P1_UNROLL; ++u) {
        const long long g = g0 + u;
        if (g >= ng) break;  // the same for every lane
        const long long s = g * GROUP + lane;
        const uint32_t key = __reduce_max_sync(0xffffffffu, s < ns ? order_key(fold_max<M>(v[u])) : 0u);
        if (lane == 0) dst[g] = key;
      }
    }
  }
}

struct RadixSmem {
  uint32_t hist[HBINS];
  uint32_t warp_sums[32];
  uint32_t vars[4];  // 0: candidates gathered, 1: digit found, 2: its count above
};

struct SelectSmem {
  unsigned long long buf[CAP];
  RadixSmem r;
};

// exclusive prefix sum over the block in thread order; total gets the sum
__device__ uint32_t block_excl_scan(uint32_t v, RadixSmem& sm, uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sm.warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < nw ? sm.warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    sm.warp_sums[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp == 0 ? 0u : sm.warp_sums[warp - 1];
  total = sm.warp_sums[nw - 1];
  __syncthreads();
  return before + x - v;
}

// a slot for each lane that takes one, from the shared counter (the whole
// warp calls it)
__device__ __forceinline__ uint32_t warp_slot(bool take, uint32_t* counter) {
  const uint32_t mask = __ballot_sync(0xffffffffu, take);
  const int lane = threadIdx.x & 31;
  uint32_t base = 0;
  if (lane == 0 && mask) base = atomicAdd(counter, static_cast<uint32_t>(__popc(mask)));
  base = __shfl_sync(0xffffffffu, base, 0);
  return base + __popc(mask & ((1u << lane) - 1u));
}

// the K-th largest of the keys key(0 .. n - 1) (K <= n) and how many lie
// above it: three histogram passes of 12, 12 and 8 bits
template <typename Key>
__device__ void radix_kth(Key key, long long n, uint32_t K, RadixSmem& sm, uint32_t& kth, uint32_t& above) {
  uint32_t prefix = 0, mask = 0, krem = K;
  above = 0;
  const int shifts[3] = {20, 8, 0};
  const int widths[3] = {12, 12, 8};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int shift = shifts[p], bins = 1 << widths[p];
    for (int i = threadIdx.x; i < bins; i += blockDim.x) sm.hist[i] = 0;
    __syncthreads();
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t u = key(i);
      if ((u & mask) == prefix) atomicAdd(&sm.hist[(u >> shift) & (bins - 1)], 1u);
    }
    __syncthreads();
    // this thread's PER digits, from the top down: bins - 1 - PER * tid - j
    uint32_t c[PER], sum = 0;
    const int top = bins - 1 - PER * static_cast<int>(threadIdx.x);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      c[j] = top - j >= 0 ? sm.hist[top - j] : 0u;
      sum += c[j];
    }
    uint32_t total;
    uint32_t r = block_excl_scan(sum, sm, total);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (top - j >= 0 && r < krem && r + c[j] >= krem) {
        sm.vars[1] = static_cast<uint32_t>(top - j);
        sm.vars[2] = r;
      }
      r += c[j];
    }
    __syncthreads();
    const uint32_t digit = sm.vars[1], gt = sm.vars[2];
    __syncthreads();
    above += gt;
    krem -= gt;
    prefix |= digit << shift;
    mask |= static_cast<uint32_t>(bins - 1) << shift;
  }
  kth = prefix;
}

template <typename T, bool DESC>
__device__ void bitonic_sort(T* a, int n) {  // n a power of two
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const T x = a[i], y = a[l];
          const bool up = ((i & k) == 0) != DESC;
          if (up ? (x > y) : (x < y)) {
            a[i] = y;
            a[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// every super of the row above the K-th key and the lowest ids among those
// equal to it, K of them, into buf (unordered): the exact radix select over
// all ns supers, then one pass in id order
template <int M>
__device__ void exact_candidates(const float* __restrict__ src, int ns, uint32_t K, RadixSmem& sm,
                                 unsigned long long* buf) {
  const int tid = threadIdx.x;
  auto key = [&](long long i) { return order_key(super_max<M>(src, i)); };
  uint32_t kth, above;
  radix_kth(key, ns, K, sm, kth, above);
  const uint32_t need = K - above;
  if (tid == 0) sm.vars[0] = 0;
  __syncthreads();
  uint32_t eq_before = 0;  // supers equal to kth at lower ids, the same in every thread
  for (long long base = 0; base < ns; base += blockDim.x) {
    const long long s = base + tid;
    const uint32_t u = s < ns ? key(s) : 0u;
    const bool gt = s < ns && u > kth;
    const bool eq = s < ns && u == kth;
    const uint32_t slot = warp_slot(gt, &sm.vars[0]);
    if (gt) buf[slot] = candidate(u, static_cast<uint32_t>(s));
    uint32_t total;
    const uint32_t r = eq_before + block_excl_scan(eq ? 1u : 0u, sm, total);
    if (eq && r < need) buf[above + r] = candidate(u, static_cast<uint32_t>(s));
    eq_before += total;
  }
  __syncthreads();
}

// the c candidates of buf in order, then the outputs of the row: vals (its
// kout values), ids (its first ks ids, ascending, sorted in buf again); buf
// holds at least the power of two at or above c
template <int M>
__device__ void write_row(unsigned long long* buf, int c, const float* __restrict__ src, float* __restrict__ vals,
                          long long* __restrict__ ids, int row, int ks, int kout) {
  const int tid = threadIdx.x;
  const int n = pow2_at_least(c);
  for (int i = c + tid; i < n; i += blockDim.x) buf[i] = 0ull;
  __syncthreads();
  bitonic_sort<unsigned long long, true>(buf, n);
  for (int j = tid; j < kout; j += blockDim.x) {
    const unsigned long long cj = buf[j];
    const uint32_t u = static_cast<uint32_t>(cj >> 32);
    // a zero's sign is not in its key: read it again
    vals[static_cast<long long>(row) * kout + j] =
        u == ZERO_KEY ? super_max<M>(src, candidate_id(cj)) : key_value(u);
  }
  __syncthreads();
  const int q = pow2_at_least(ks);
  for (int j = tid; j < q; j += blockDim.x) buf[j] = j < ks ? candidate_id(buf[j]) : ~0ull;
  __syncthreads();
  bitonic_sort<unsigned long long, false>(buf, q);
  for (int j = tid; j < ks; j += blockDim.x) ids[static_cast<long long>(row) * ks + j] = buf[j];
}

// pass 2: one block a row, K <= MAX_K
template <int M>
__global__ void __launch_bounds__(P2_THREADS, 2)
super_select_kernel(const float* __restrict__ bm, const uint32_t* __restrict__ gmax, float* __restrict__ vals,
                    long long* __restrict__ ids, int ns, int ng, int ks, int kout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SelectSmem& sm = *reinterpret_cast<SelectSmem*>(smem_raw);
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const float* src = bm + static_cast<long long>(row) * ns * M;
  const uint32_t* rg = gmax + static_cast<long long>(row) * ng;
  const uint32_t K = static_cast<uint32_t>(kout);

  // the bound lo: the K-th largest group maximum, or every super where the
  // row has fewer than K groups
  uint32_t lo = 0, unused;
  if (K <= static_cast<uint32_t>(ng)) radix_kth([&](long long i) { return rg[i]; }, ng, K, sm.r, lo, unused);

  // the supers at or above lo, from the groups that reach it
  if (threadIdx.x == 0) sm.r.vars[0] = 0;
  __syncthreads();
  for (int gb = warp * 32; gb < ng; gb += nw * 32) {
    uint32_t todo = __ballot_sync(0xffffffffu, gb + lane < ng && rg[gb + lane] >= lo);
    while (todo) {
      const int g = gb + __ffs(todo) - 1;
      todo &= todo - 1;
      const long long s = static_cast<long long>(g) * GROUP + lane;
      const uint32_t u = s < ns ? order_key(super_max<M>(src, s)) : 0u;
      const bool take = s < ns && u >= lo;
      const uint32_t slot = warp_slot(take, &sm.r.vars[0]);
      if (take && slot < CAP) sm.buf[slot] = candidate(u, static_cast<uint32_t>(s));
    }
  }
  __syncthreads();
  int c = static_cast<int>(sm.r.vars[0]);
  __syncthreads();

  if (c > CAP) {  // too many ties at lo
    exact_candidates<M>(src, ns, K, sm.r, sm.buf);
    c = static_cast<int>(K);
  }
  write_row<M>(sm.buf, c, src, vals, ids, row, ks, kout);
}

// K > MAX_K: one block a row, the exact select into the row's slice of wide
template <int M>
__global__ void __launch_bounds__(P2_THREADS)
super_select_wide_kernel(const float* __restrict__ bm, float* __restrict__ vals, long long* __restrict__ ids,
                         unsigned long long* __restrict__ wide, int ns, int ks, int kout, int width) {
  __shared__ RadixSmem sm;
  const int row = blockIdx.x;
  const float* src = bm + static_cast<long long>(row) * ns * M;
  unsigned long long* buf = wide + static_cast<long long>(row) * width;
  exact_candidates<M>(src, ns, static_cast<uint32_t>(kout), sm, buf);
  write_row<M>(buf, kout, src, vals, ids, row, ks, kout);
}

template <int M>
int launch_select(const float* bm, uint32_t* gmax, float* vals, long long* ids, unsigned long long* wide, int width,
                  int B, int ns, int ks, int kout, cudaStream_t stream) {
  if (kout > MAX_K) {
    super_select_wide_kernel<M><<<B, P2_THREADS, 0, stream>>>(bm, vals, ids, wide, ns, ks, kout, width);
    return static_cast<int>(cudaGetLastError());
  }
  const int ng = (ns + GROUP - 1) / GROUP;
  const int per_block = P1_WARPS * P1_UNROLL;
  const dim3 grid1((ng + per_block - 1) / per_block, B < 65535 ? B : 65535);
  super_max_kernel<M><<<grid1, P1_THREADS, 0, stream>>>(bm, gmax, B, ns, ng);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(sizeof(SelectSmem));
  err = cudaFuncSetAttribute(super_select_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  super_select_kernel<M><<<B, P2_THREADS, smem, stream>>>(bm, gmax, vals, ids, ns, ng, ks, kout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The K = kout best supers of each row of bin_max (B, nb) on `stream`: vals
// (B, kout) f32 in order, ids (B, ks) int64 ascending. Scratch: where kout <=
// MAX_K, gmax (B, ceil(ns / 32)) u32; else wide (B, width) u64, width the
// power of two at or above kout (the other may be null). Returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for shapes outside
// the requirements above.
extern "C" int super_select_launch(const void* bin_max, void* gmax, void* vals, void* ids, void* wide, int B,
                                   long long nb, int M, int ks, int kout, long long width, void* stream) {
  if (B <= 0 || M <= 0 || nb <= 0 || nb % M != 0) return cudaErrorInvalidValue;
  const long long ns = nb / M;
  if (ns >= (1ll << 31) - GROUP || ks < 1 || ks > ns) return cudaErrorInvalidValue;
  if (kout != (ks + 1 < ns ? ks + 1 : ns)) return cudaErrorInvalidValue;
  long long need = 1;
  while (need < kout) need <<= 1;
  if (kout > MAX_K ? (wide == nullptr || width != need || width >= (1ll << 31)) : gmax == nullptr)
    return cudaErrorInvalidValue;
  const float* bm = static_cast<const float*>(bin_max);
  uint32_t* g = static_cast<uint32_t*>(gmax);
  float* v = static_cast<float*>(vals);
  long long* i = static_cast<long long*>(ids);
  unsigned long long* w = static_cast<unsigned long long*>(wide);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(ns);
  const int wd = static_cast<int>(width);
  switch (M) {
    case 4: return launch_select<4>(bm, g, v, i, w, wd, B, n, ks, kout, s);
    case 8: return launch_select<8>(bm, g, v, i, w, wd, B, n, ks, kout, s);
    case 16: return launch_select<16>(bm, g, v, i, w, wd, B, n, ks, kout, s);
    default: return cudaErrorInvalidValue;
  }
}

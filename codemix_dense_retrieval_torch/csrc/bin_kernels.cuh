// The bin-score kernels' templates, shared by bin_scores.cu (kernels A, 2, 5
// and 7: bf16 operands), bin_scores_f16.cu (A, 2, 5: f16), bin_scores_f32.cu
// (A, 2, 5, 7: f32, 3xTF32) and bin_scores_int8.cu (kernel 4: int8 operands).
// Every one computes S = Q . D^T on the tensor cores, an optional epilogue
// term, rows >= n_valid masked to NEG_INF (float32 min) and the maximum of
// every run of G consecutive rows ("bin max"); some also store S.
//
// Two warp-specialised Hopper kernels on sm90.cuh carry the bf16, f16 and
// int8 instances: a producer thread streams 128-byte chunks of the rows (64
// bf16 or f16 or 128 int8 dims; 128-byte swizzle) by TMA into an mbarrier
// ring, two consumer warpgroups multiply them with wgmma (bf16 or f16 -> f32,
// or s8 -> exact s32), and the blocks are persistent (one per SM), so the next
// tile's chunks load while the current tile's epilogue runs; rows past N and
// dims past d read as zeros. f32 operands (3xTF32) take a third kernel of the
// same shape, bin_scores_f32_kernel (below), in both layouts: doc rows split
// into tf32 hi + lo in registers, the queries split once per call, each
// 32-dim chunk folded into a running sum; its query tiles hold at most 128
// queries.
// Epilogues work on the accumulators in registers. The operand type (Operand
// below) and the epilogue mode (Epi) are template parameters, so the ring, the
// consumer loop and the bin-max code exist once:
// - EPI_NONE: the f32 products as they are (kernels A, 2, 5);
// - EPI_TAIL: ub = __fadd_rn(s, __fmul_rn(d_tail[n], q_tail[q])), the sketch
//   tier's upper bound (kernel 7), before the mask;
// - EPI_RESCALE: __fmul_rn(__fmul_rn(__int2float_rn(acc), d_scale[n]),
//   q_scale[q]) (kernel 4), in the JAX order, before the mask. |acc| <=
//   127^2 d < 2^24 for d <= 1040, so f32(acc) is exact whatever order wgmma
//   sums the integers in, and the result is bit-equal to the plain version.
//   The build uses no --use_fast_math and the multiplies are __fmul_rn, so
//   nothing is contracted into an FMA.
//
// bin_scores_t_kernel (transposed S (N, B), binmax (N/G, B); kernels 2 and
// 4): doc rows are wgmma's M (64 per warpgroup, 128-row tiles) and every query
// (B <= 256) its N (n256; n128 for B <= 128, n64 for B <= 64; 256-query tiles
// past that); a Q chunk rides beside each D chunk in a 4-stage ring; S rows
// are stored from the fragments (a quad writes 32 contiguous bytes) and each
// bin max takes three __shfl_xor_sync. Kernel 4 keeps the thread's two rows'
// d_scale in registers and stages the tile's q_scale in shared memory. Kernel
// 2 over f32 operands runs bin_scores_f32_kernel's main loop with this
// epilogue (TRANS = true).
//
// bin_scores_bm_kernel (bin-major S (B, N), binmax (B, N/G); kernels A, 4, 5
// and 7) turns the roles round: queries are wgmma's M and the tile's 128 doc
// rows its N, so a bin lies along the fragment's columns, inside one quad:
// - tiles of NT queries x 128 rows (NT = 256, 128 or 64 as above); at NT =
//   256 each warpgroup takes 128 queries (two m64 blocks, n128), at 128 each
//   takes 64, at 64 both take the 64 queries and split the rows;
// - Q resident where all of a query tile's chunks fit beside the ring
//   (kernel 7's 64 KB sketch at ds = 128, B = 256; kernel 4 at B <= 128):
//   loaded once per query tile (tiles ordered query tile slowest), and the
//   ring (up to 8 stages) carries D chunks only. Otherwise (kernels A and 5 at
//   d = 1024: Q is 512 KB; kernel 4 at B = 256: 256 KB) a Q chunk rides beside
//   each D chunk in a 4-stage ring, query tile fastest so the tiles of one D
//   tile run side by side and share it in L2;
// - the epilogue term (kernels 7 and 4): the per-query value (q_tail or
//   q_scale) of the thread's queries in registers, the per-row value (d_tail
//   or d_scale) staged in shared memory per tile; then a mask pass only on
//   tiles that reach n_valid;
// - bin maxima: in-thread maxima of each quad lane's pairs, then two
//   shuffles that scatter as they reduce, so even lanes hold query qa's bin
//   maximum and odd lanes qa + 8's; lanes 0 and 1 of each quad write a
//   query's NW / G bins as one run of float4 stores;
// - STORE (kernels A and 4): S (B, N) from the fragments, a quad writing 32
//   contiguous bytes of a query's row (f32); kernels 5 and 7 compile it out.
//
// Every offset into S and binmax is 64-bit: B * N exceeds 2^31 at the main
// path's shape.
#pragma once

#include <cfloat>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -FLT_MAX;
constexpr int T_ROWS = 128;       // doc rows per tile: two consumer warpgroups of 64
constexpr int CHUNK_BYTES = 128;  // a stage's row: one 128-byte swizzled row
constexpr int T_STAGES = 4;
constexpr int T_THREADS = 384;    // producer warpgroup + two consumer warpgroups

enum Epi { EPI_NONE, EPI_TAIL, EPI_RESCALE };

// the shapes every bin kernel takes (the Python wrappers check them first):
// B, N, d > 0, d a multiple of dim_multiple, G in {8, 16}, N a multiple of G
// and below 2^31 (TMA coordinates are 32-bit)
inline bool shape_ok(int B, long long N, int D, int G, int dim_multiple) {
  return B > 0 && N > 0 && D > 0 && D % dim_multiple == 0 && (G == 8 || G == 16) && N % G == 0 &&
         N <= INT_MAX;
}

// what the operand type fixes: the accumulator (f32, or s32 held as raw
// 32-bit registers), the tensor-map element type, the wgmma (f32: see
// Operand<float>) and the largest query tile (MAX_NT)
template <typename T>
struct Operand;

template <>
struct Operand<__nv_bfloat16> {
  using Acc = float;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int MAX_NT = 256;
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
    sm90::Wgmma<N>::template ss<0>(d, da, db, scale_d);
  }
};

// f16 operands: f16 x f16 products are exact in f32, as bf16's are
template <>
struct Operand<__half> {
  using Acc = float;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static constexpr int MAX_NT = 256;
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
    sm90::WgmmaF16<N>::ss(d, da, db, scale_d);
  }
};

// f32 operands, f32-faithful products on tf32 tensor cores (3xTF32): every
// value x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and
// x . y = hi.hi + hi.lo + lo.hi, three wgmmas, to ~3 * 2^-22 of sum |x_i y_i|
// (the dropped lo.lo and lo's rounding are each <= 2^-22 of it). Both layouts
// run bin_scores_f32_kernel, which splits the doc rows in registers and takes
// the queries split once per call. The tensor cores' accumulation does not
// round to nearest and its error grows with the products added into one
// fragment, so every 128-byte chunk of d (32 dims) accumulates into a fresh
// fragment that is then added to a running sum with __fadd_rn; holding both
// caps the query tile at 128.
template <>
struct Operand<float> {
  using Acc = float;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int MAX_NT = 128;
};

template <>
struct Operand<int8_t> {
  using Acc = uint32_t;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int MAX_NT = 256;
  template <int N>
  static __device__ __forceinline__ void mma(uint32_t (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
    sm90::WgmmaS8<N>::ss(d, da, db, scale_d);
  }
};

// f32 operands: fold a chunk's fragment into the running sum
template <int R>
__device__ __forceinline__ void fold_chunk(float (&run)[R], const float (&part)[R], bool first) {
#pragma unroll
  for (int i = 0; i < R; ++i) run[i] = first ? part[i] : __fadd_rn(run[i], part[i]);
}

// an accumulator register read or written as f32: after the rescale pass an
// s32 accumulator holds the bits of its f32 score
__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ void set_f32(float& x, float v) { x = v; }
__device__ __forceinline__ void set_f32(uint32_t& x, float v) { x = __float_as_uint(v); }

// the epilogue term of accumulator x with its row's value dx and its query's
// value qx (see Epi)
template <int EPI, typename A>
__device__ __forceinline__ void apply_epi(A& x, float dx, float qx) {
  if constexpr (EPI == EPI_TAIL) {
    set_f32(x, __fadd_rn(f32(x), __fmul_rn(dx, qx)));
  } else if constexpr (EPI == EPI_RESCALE) {
    set_f32(x, __fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(x)), dx), qx));
  }
}

// calls f(NT, G) (as integral_constants) for G and the query tile that holds
// B queries: the smallest of 64, 128, 256 (at most MAX_NT), and MAX_NT past
// that
template <int MAX_NT, typename F>
int by_tile(int G, int B, F&& f) {
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using I256 = std::integral_constant<int, 256>;
  auto pick = [&](auto g) {
    if (B <= 64) return f(I64{}, g);
    if constexpr (MAX_NT >= 256) {
      if (B > 128) return f(I256{}, g);
    }
    return f(I128{}, g);
  };
  if (G == 8) return pick(std::integral_constant<int, 8>{});
  return pick(std::integral_constant<int, 16>{});
}

// the row-major tensor maps of D (N x d) and Q (B x d): 128-byte boxes of
// T_ROWS and NT rows. q_planes = 2: Q is (2, B, d), the queries' tf32 hi
// and lo planes (bin-major f32), a box from one plane at a time
template <typename T>
int make_maps(CUtensorMap* dmap, CUtensorMap* qmap, const void* q, const void* d, int B, long long N,
              int D, int NT, int q_planes = 1) {
  const uint64_t ddims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N)};
  const uint64_t qdims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(B),
                             static_cast<uint64_t>(q_planes)};
  const uint64_t strides[2] = {static_cast<uint64_t>(D) * sizeof(T),
                               static_cast<uint64_t>(B) * D * sizeof(T)};
  const uint32_t dbox[2] = {CHUNK_BYTES / sizeof(T), T_ROWS};
  const uint32_t qbox[3] = {CHUNK_BYTES / sizeof(T), static_cast<uint32_t>(NT), 1};
  const int rc = sm90::make_tma(dmap, Operand<T>::TMA, d, 2, ddims, strides, dbox);
  return rc != 0 ? rc
                 : sm90::make_tma(qmap, Operand<T>::TMA, q, q_planes == 1 ? 2 : 3, qdims, strides, qbox);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    p[1] = __float2bfloat16(b);
  }
}

// max over the 8 lanes of a warp that share lane % 4 (the fragment's rows)
__device__ __forceinline__ float rows_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

// ---------------------------------------------------------------------------
// the transposed layout (kernels 2 and 4)
// ---------------------------------------------------------------------------

constexpr int W_SMEM_MAX = 227 * 1024;  // a block's dynamic shared memory on an H100

template <int NT, bool RESCALE>
struct TLayout {
  static constexpr int D_BYTES = T_ROWS * CHUNK_BYTES;
  static constexpr int STAGE = D_BYTES + NT * CHUNK_BYTES;              // D chunk, then Q chunk
  static constexpr int QS_OFF = T_STAGES * STAGE;                       // two tiles' q_scale
  static constexpr int BAR_OFF = QS_OFF + (RESCALE ? 2 * NT * 4 : 0);  // full[], empty[]
  static constexpr int BYTES = BAR_OFF + 16 * T_STAGES + 1024;         // + 1024-byte alignment slack
  static_assert(BYTES <= W_SMEM_MAX, "the transposed ring does not fit");
};

template <typename T, int NT, int G, typename OutT, int EPI>
__global__ void __launch_bounds__(T_THREADS, 1)
bin_scores_t_kernel(const __grid_constant__ CUtensorMap dmap,
                    const __grid_constant__ CUtensorMap qmap, OutT* __restrict__ scores,
                    float* __restrict__ binmax, const int* __restrict__ nv_ptr, long long nv_int,
                    const float* __restrict__ q_aux, const float* __restrict__ d_aux, int B,
                    long long N, int D, int q_tiles, long long tiles) {
  static_assert(EPI != EPI_TAIL, "the transposed layout takes no tail term");
  static_assert(std::is_same<T, int8_t>::value == (EPI == EPI_RESCALE), "int8 products are rescaled");
  static_assert(!std::is_same<T, float>::value, "f32 operands take bin_scores_f32_kernel");
  constexpr bool RESCALE = EPI == EPI_RESCALE;
  constexpr int KC = CHUNK_BYTES / sizeof(T);  // dims per stage
  using L = TLayout<NT, RESCALE>;
  constexpr int STAGES = T_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // generic address of base
  const uint32_t bar_full = base + L::BAR_OFF;           // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;      // + 8 * stage
  const int tid = threadIdx.x;
  const int chunks = (D + KC - 1) / KC;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (sm90::warpgroup_index() == 0) {
    // ---- producer: one thread streams (D tile, Q tile) chunks ----
    sm90::setmaxnreg_dec<40>();
    if (tid == 0) {
      sm90::tma_prefetch(&dmap);
      sm90::tma_prefetch(&qmap);
      int it = 0;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int qb = static_cast<int>(tile % q_tiles) * NT;
        const int n0 = static_cast<int>(tile / q_tiles) * T_ROWS;
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(bar_empty + 8 * st, ((it / STAGES) & 1) ^ 1);
          sm90::mbar_expect_tx(bar_full + 8 * st, L::STAGE);
          const uint32_t dst = base + st * L::STAGE;
          sm90::tma_load_2d(dst, &dmap, bar_full + 8 * st, kc * KC, n0);
          sm90::tma_load_2d(dst + L::D_BYTES, &qmap, bar_full + 8 * st, kc * KC, qb);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns doc rows n0 + 64 wg .. + 63 ----
    sm90::setmaxnreg_inc<232>();
    const int wg = sm90::warpgroup_index() - 1;
    const int tc = tid - 128;  // 0 .. 255
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const long long nv = nv_ptr != nullptr ? static_cast<long long>(*nv_ptr) : nv_int;
    const long long nb_total = N / G;
    const bool pair = (B % 2) == 0;  // (row, q) and (row, q + 1) share an aligned pair
    float* s_qs = reinterpret_cast<float*>(gbase + L::QS_OFF);
    typename Operand<T>::Acc acc[NT / 2];
    int it = 0, local = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
      const int qb = static_cast<int>(tile % q_tiles) * NT;
      const long long n0 = (tile / q_tiles) * T_ROWS;
      // kernel 4: the d_scale of the thread's rows ra and ra + 8 (below), and
      // its share of the tile's q_scale (staged at the epilogue), loaded under
      // the main loop
      float ds_a = 0.0f, ds_b = 0.0f, my_qs = 0.0f;
      if (RESCALE) {
        const long long r = n0 + wg * 64 + warp * 16 + g;
        ds_a = r < N ? d_aux[r] : 0.0f;
        ds_b = r + 8 < N ? d_aux[r + 8] : 0.0f;
        my_qs = tc < NT && qb + tc < B ? q_aux[qb + tc] : 0.0f;
      }
      for (int kc = 0; kc < chunks; ++kc, ++it) {
        const int st = it % STAGES;
        sm90::mbar_wait(bar_full + 8 * st, (it / STAGES) & 1);
        const uint32_t d_st = base + st * L::STAGE + wg * 64 * CHUNK_BYTES;
        const uint32_t q_st = base + st * L::STAGE + L::D_BYTES;
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // four k steps of 32 bytes
          const uint64_t da = sm90::desc_sw128(d_st + kk * 32, 16, 1024);
          const uint64_t db = sm90::desc_sw128(q_st + kk * 32, 16, 1024);
          Operand<T>::template mma<NT>(acc, da, db, kc > 0 || kk > 0);
        }
        sm90::wgmma_commit();
        if (kc > 0) {  // the previous chunk's products are done: free its stage
          sm90::wgmma_wait<1>();
          if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));

      const long long r16 = n0 + wg * 64 + warp * 16;  // this warp's 16 rows
      const long long ra = r16 + g;
      const long long rb = ra + 8;
      const float* qs_tile = s_qs + (local & 1) * NT;
      if (RESCALE) {
        if (tc < NT) s_qs[(local & 1) * NT + tc] = my_qs;
        sm90::named_sync(1, 256);
      }
      // epilogue from the fragments: rows ra (acc[4i], acc[4i+1]) and ra + 8
#pragma unroll
      for (int i = 0; i < NT / 8; ++i) {
        const int q = qb + 8 * i + 2 * t;
        if (RESCALE) {
          const float2 qs = *reinterpret_cast<const float2*>(qs_tile + 8 * i + 2 * t);
          apply_epi<EPI>(acc[4 * i + 0], ds_a, qs.x);
          apply_epi<EPI>(acc[4 * i + 1], ds_a, qs.y);
          apply_epi<EPI>(acc[4 * i + 2], ds_b, qs.x);
          apply_epi<EPI>(acc[4 * i + 3], ds_b, qs.y);
        }
        const float v0 = ra < nv ? f32(acc[4 * i + 0]) : NEG_INF;
        const float v1 = ra < nv ? f32(acc[4 * i + 1]) : NEG_INF;
        const float v2 = rb < nv ? f32(acc[4 * i + 2]) : NEG_INF;
        const float v3 = rb < nv ? f32(acc[4 * i + 3]) : NEG_INF;
        if (q + 1 < B) {
          if (ra < N) store2(scores + ra * B + q, v0, v1, pair);
          if (rb < N) store2(scores + rb * B + q, v2, v3, pair);
        } else if (q < B) {
          if (ra < N) store_out(scores + ra * B + q, v0);
          if (rb < N) store_out(scores + rb * B + q, v2);
        }
        if (G == 16) {
          const float m0 = rows_max(fmaxf(v0, v2));
          const float m1 = rows_max(fmaxf(v1, v3));
          const long long bin = r16 / 16;
          if (bin < nb_total) {
            if (g == 0 && q < B) binmax[bin * B + q] = m0;
            if (g == 1 && q + 1 < B) binmax[bin * B + q + 1] = m1;
          }
        } else {
          const float a0 = rows_max(v0), a1 = rows_max(v1);  // bin r16 / 8
          const float b0 = rows_max(v2), b1 = rows_max(v3);  // bin r16 / 8 + 1
          const long long bin = r16 / 8 + g;  // lanes g = 0, 1 write the two bins
          if (g < 2 && bin < nb_total) {
            const float lo = g == 0 ? a0 : b0;
            const float hi = g == 0 ? a1 : b1;
            if (q < B) binmax[bin * B + q] = lo;
            if (q + 1 < B) binmax[bin * B + q + 1] = hi;
          }
        }
      }
    }
  }
}

template <typename T, int NT, int G, typename OutT, int EPI>
int launch_t(const void* q, const void* d, void* scores, void* binmax, const void* nv_ptr,
             long long nv_int, const void* q_aux, const void* d_aux, int B, long long N, int D,
             cudaStream_t stream) {
  using L = TLayout<NT, EPI == EPI_RESCALE>;
  CUtensorMap dmap, qmap;
  const int rc = make_maps<T>(&dmap, &qmap, q, d, B, N, D, NT);
  if (rc != 0) return rc;
  const int q_tiles = (B + NT - 1) / NT;
  const long long tiles = (N + T_ROWS - 1) / T_ROWS * q_tiles;
  const int sms = sm90::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const unsigned int grid = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  const int smem = L::BYTES > sm90::ONE_BLOCK_SMEM ? L::BYTES : sm90::ONE_BLOCK_SMEM;
  auto kernel = bin_scores_t_kernel<T, NT, G, OutT, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, T_THREADS, smem, stream>>>(
      dmap, qmap, static_cast<OutT*>(scores), static_cast<float*>(binmax),
      static_cast<const int*>(nv_ptr), nv_int, static_cast<const float*>(q_aux),
      static_cast<const float*>(d_aux), B, N, D, q_tiles, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the bin-major layout (kernels A, 4, 5 and 7)
// ---------------------------------------------------------------------------

constexpr int W_MAX_STAGES = 8;
constexpr int W_D_CHUNK = T_ROWS * CHUNK_BYTES;  // one chunk of a 128-row D tile: 16 KB

// shared-memory plan, as byte offsets from the 1024-aligned base: resident Q
// chunks (q_resident) at 0, then the ring of `stages` stages (a D chunk, and
// a Q chunk after it unless Q is resident), two tiles' per-row epilogue values
// (kernels 7 and 4), the barriers full[stages], empty[stages], q_full, q_empty
struct WLayout {
  int stages, stage_bytes, load_bytes, ring_off, dx_off, bar_off, bytes, q_resident;
};

// the plan for NT-query tiles of rows of row_bytes bytes, counted in
// 128-byte chunks
inline WLayout w_layout(int nt, long long row_bytes, bool epi) {
  const int chunks = static_cast<int>((row_bytes + CHUNK_BYTES - 1) / CHUNK_BYTES);
  const long long q_bytes = static_cast<long long>(chunks) * nt * CHUNK_BYTES;
  const int aux = epi ? 2 * T_ROWS * 4 : 0;  // this tile's and the next one's
  const int fixed = aux + 16 * W_MAX_STAGES + 16 + 1024;  // + 1024-byte alignment slack
  WLayout L{};
  L.q_resident = q_bytes + 2 * W_D_CHUNK + fixed <= W_SMEM_MAX;
  if (L.q_resident) {
    L.stage_bytes = L.load_bytes = W_D_CHUNK;
    L.ring_off = static_cast<int>(q_bytes);
    L.stages = static_cast<int>((W_SMEM_MAX - fixed - q_bytes) / W_D_CHUNK);
    if (L.stages > W_MAX_STAGES) L.stages = W_MAX_STAGES;
  } else {
    L.load_bytes = W_D_CHUNK + nt * CHUNK_BYTES;
    L.stage_bytes = L.load_bytes;
    L.ring_off = 0;
    L.stages = (W_SMEM_MAX - fixed) / L.stage_bytes;
    if (L.stages > T_STAGES) L.stages = T_STAGES;
  }
  L.dx_off = L.ring_off + L.stages * L.stage_bytes;
  L.bar_off = L.dx_off + aux;
  L.bytes = L.bar_off + 16 * L.stages + 16 + 1024;
  return L;
}

// the split of an NT-query x 128-row tile between the two consumer
// warpgroups: MB m64 blocks of queries (wgmma's M) and NW doc rows (wgmma's
// N) each, starting at query q_off and row r_off of the tile
template <int NT>
struct WSplit {
  static constexpr int MB = NT == 256 ? 2 : 1;
  static constexpr int NW = NT == 64 ? 64 : T_ROWS;
  static __device__ __forceinline__ int q_off(int wg) { return NT == 64 ? 0 : wg * (NT / 2); }
  static __device__ __forceinline__ int r_off(int wg) { return NT == 64 ? wg * 64 : 0; }
};

// STORE: write S (B, N) (kernels A and 4). EPI: the epilogue term, with
// q_aux / d_aux its per-query and per-row values. QRES: Q resident, tiles
// ordered query tile slowest (Q is loaded once per query tile); else Q
// streams beside D, query tile fastest (the query tiles of one D tile run
// side by side and share it in L2).
template <typename T, int NT, int G, typename OutT, int EPI, bool STORE, bool QRES>
__global__ void __launch_bounds__(T_THREADS, 1)
bin_scores_bm_kernel(const __grid_constant__ CUtensorMap dmap,
                     const __grid_constant__ CUtensorMap qmap, const WLayout L,
                     OutT* __restrict__ scores, float* __restrict__ binmax,
                     const int* __restrict__ nv_ptr, long long nv_int,
                     const float* __restrict__ q_aux, const float* __restrict__ d_aux,
                     int B, long long N, int D, int q_tiles, long long n_tiles) {
  static_assert(std::is_same<T, int8_t>::value == (EPI == EPI_RESCALE), "int8 products are rescaled");
  static_assert(!std::is_same<T, float>::value, "f32 operands take bin_scores_f32_kernel");
  using S = WSplit<NT>;
  constexpr int MB = S::MB;
  constexpr int NW = S::NW;
  constexpr int KC = CHUNK_BYTES / sizeof(T);  // dims per stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // generic address of base
  const uint32_t ring = base + L.ring_off;
  const uint32_t bar_full = base + L.bar_off;           // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * L.stages;   // + 8 * stage
  const uint32_t bar_qfull = bar_empty + 8 * L.stages;
  const uint32_t bar_qempty = bar_qfull + 8;
  const int tid = threadIdx.x;
  const int chunks = (D + KC - 1) / KC;
  const long long tiles = n_tiles * q_tiles;
  auto coords = [&](long long tile, int& qt, long long& nt) {
    if (QRES) {
      qt = static_cast<int>(tile / n_tiles);
      nt = tile % n_tiles;
    } else {
      qt = static_cast<int>(tile % q_tiles);
      nt = tile / q_tiles;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_init(bar_qfull, 1);
    sm90::mbar_init(bar_qempty, 8);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (sm90::warpgroup_index() == 0) {
    // ---- producer: one thread streams D chunks (and Q, resident or not) ----
    sm90::setmaxnreg_dec<40>();
    if (tid == 0) {
      sm90::tma_prefetch(&dmap);
      sm90::tma_prefetch(&qmap);
      int st = 0, cur_q = -1, q_loads = 0;
      uint32_t ph = 0;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int qt;
        long long nt;
        coords(tile, qt, nt);
        const int n0 = static_cast<int>(nt * T_ROWS);
        if (QRES && qt != cur_q) {  // every consumer is done with the old Q
          if (q_loads > 0) sm90::mbar_wait(bar_qempty, (q_loads - 1) & 1);
          sm90::mbar_expect_tx(bar_qfull, chunks * NT * CHUNK_BYTES);
          for (int kc = 0; kc < chunks; ++kc)
            sm90::tma_load_2d(base + kc * NT * CHUNK_BYTES, &qmap, bar_qfull, kc * KC, qt * NT);
          cur_q = qt;
          ++q_loads;
        }
        for (int kc = 0; kc < chunks; ++kc) {
          sm90::mbar_wait(bar_empty + 8 * st, ph ^ 1);
          sm90::mbar_expect_tx(bar_full + 8 * st, L.load_bytes);
          const uint32_t dst = ring + st * L.stage_bytes;
          sm90::tma_load_2d(dst, &dmap, bar_full + 8 * st, kc * KC, n0);
          if (!QRES) sm90::tma_load_2d(dst + W_D_CHUNK, &qmap, bar_full + 8 * st, kc * KC, qt * NT);
          if (++st == L.stages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns queries q_off(wg) .. + 64 MB - 1 and
    // rows r_off(wg) .. + NW - 1 of each tile ----
    sm90::setmaxnreg_inc<232>();
    const int wg = sm90::warpgroup_index() - 1;
    const int tc = tid - 128;  // 0 .. 255
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int q_off = S::q_off(wg);
    const int r_off = S::r_off(wg);
    const long long nv = nv_ptr != nullptr ? static_cast<long long>(*nv_ptr) : nv_int;
    const long long nb_total = N / G;
    float* s_dx = reinterpret_cast<float*>(gbase + L.dx_off);
    typename Operand<T>::Acc acc[MB][NW / 2];
    float qxa[MB], qxb[MB];  // EPI: q_aux of this thread's two queries per m block
    int st = 0, prev = 0, cur_q = -1, q_loads = 0, local = 0;
    uint32_t ph = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
      int qt;
      long long nt;
      coords(tile, qt, nt);
      const int qb = qt * NT;
      const long long n0 = nt * T_ROWS;
      if (qt != cur_q) {
        if (QRES) {
          if (cur_q >= 0 && lane == 0) sm90::mbar_arrive(bar_qempty);
          sm90::mbar_wait(bar_qfull, q_loads & 1);
          ++q_loads;
        }
        if (EPI != EPI_NONE) {
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            const int qa = qb + q_off + 64 * mb + 16 * warp + g;
            qxa[mb] = qa < B ? q_aux[qa] : 0.0f;
            qxb[mb] = qa + 8 < B ? q_aux[qa + 8] : 0.0f;
          }
        }
        cur_q = qt;
      }
      // EPI: this tile's d_aux, staged in shared memory at the epilogue
      const float my_dx = EPI != EPI_NONE && tc < T_ROWS && n0 + tc < N ? d_aux[n0 + tc] : 0.0f;
      for (int kc = 0; kc < chunks; ++kc) {
        sm90::mbar_wait(bar_full + 8 * st, ph);
        const uint32_t stage = ring + st * L.stage_bytes;
        const uint32_t d_st = stage + r_off * CHUNK_BYTES;
        const uint32_t q_st =
            (QRES ? base + kc * (NT * CHUNK_BYTES) : stage + W_D_CHUNK) + q_off * CHUNK_BYTES;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) sm90::fence_regs(acc[mb]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // four k steps of 32 bytes
          const uint64_t db = sm90::desc_sw128(d_st + kk * 32, 16, 1024);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            const uint64_t da = sm90::desc_sw128(q_st + mb * 64 * CHUNK_BYTES + kk * 32, 16, 1024);
            Operand<T>::template mma<NW>(acc[mb], da, db, kc > 0 || kk > 0);
          }
        }
        sm90::wgmma_commit();
        if (kc > 0) {  // the previous chunk's products are done: free its stage
          sm90::wgmma_wait<1>();
          if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * prev);
        }
        prev = st;
        if (++st == L.stages) {
          st = 0;
          ph ^= 1;
        }
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) sm90::fence_regs(acc[mb]);
      if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * prev);

      // epilogue from the fragments: in m block mb, this thread holds queries
      // qa and qa + 8 at rows c, c + 1 (acc[mb][4i .. 4i + 3]: (qa, c),
      // (qa, c + 1), (qa + 8, c), (qa + 8, c + 1)), c = cb + 8 i
      const long long cb = n0 + r_off + 2 * t;
      if (EPI != EPI_NONE) {  // the epilogue term, in the JAX order
        const float* dx_tile = s_dx + (local & 1) * T_ROWS;
        if (tc < T_ROWS) s_dx[(local & 1) * T_ROWS + tc] = my_dx;
        sm90::named_sync(1, 256);
#pragma unroll
        for (int i = 0; i < NW / 8; ++i) {
          const float2 dx = *reinterpret_cast<const float2*>(dx_tile + r_off + 8 * i + 2 * t);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            apply_epi<EPI>(acc[mb][4 * i + 0], dx.x, qxa[mb]);
            apply_epi<EPI>(acc[mb][4 * i + 1], dx.y, qxa[mb]);
            apply_epi<EPI>(acc[mb][4 * i + 2], dx.x, qxb[mb]);
            apply_epi<EPI>(acc[mb][4 * i + 3], dx.y, qxb[mb]);
          }
        }
      }
      if (n0 + T_ROWS > nv) {  // a tile that reaches n_valid: the mask pass
#pragma unroll
        for (int i = 0; i < NW / 8; ++i) {
          const long long c = cb + 8 * i;
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            set_f32(acc[mb][4 * i + 0], c < nv ? f32(acc[mb][4 * i + 0]) : NEG_INF);
            set_f32(acc[mb][4 * i + 1], c + 1 < nv ? f32(acc[mb][4 * i + 1]) : NEG_INF);
            set_f32(acc[mb][4 * i + 2], c < nv ? f32(acc[mb][4 * i + 2]) : NEG_INF);
            set_f32(acc[mb][4 * i + 3], c + 1 < nv ? f32(acc[mb][4 * i + 3]) : NEG_INF);
          }
        }
      }
      // bin maxima: a bin is 8 (16) rows of one query, held by the quad's 4
      // lanes over 1 (2) values of i; in-thread maxima, then a butterfly that
      // scatters as it reduces leaves qa's bin max on even lanes and qa + 8's
      // on odd ones; lanes t = 0, 1 write their NW / G bins as one run
      const long long bin0 = (n0 + r_off) / G;
      const bool vec = (nb_total & 3) == 0 && bin0 + NW / G <= nb_total &&
                       (reinterpret_cast<uintptr_t>(binmax) & 15) == 0;
      const bool odd = (t & 1) != 0;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const int qa = qb + q_off + 64 * mb + 16 * warp + g;
        OutT* row_a = scores + static_cast<long long>(qa) * N;
        OutT* row_b = row_a + 8 * N;
        float bm[NW / G];
#pragma unroll
        for (int j = 0; j < NW / G; ++j) {
          float ma = NEG_INF, mb8 = NEG_INF;
#pragma unroll
          for (int h = 0; h < G / 8; ++h) {
            const int i = j * (G / 8) + h;
            const float v0 = f32(acc[mb][4 * i + 0]), v1 = f32(acc[mb][4 * i + 1]);
            const float v2 = f32(acc[mb][4 * i + 2]), v3 = f32(acc[mb][4 * i + 3]);
            if (STORE) {  // a quad writes 32 (16) contiguous bytes of a query's row
              const long long c = cb + 8 * i;
              if (c < N) {
                if (qa < B) store2(row_a + c, v0, v1, true);
                if (qa + 8 < B) store2(row_b + c, v2, v3, true);
              }
            }
            ma = fmaxf(ma, fmaxf(v0, v1));
            mb8 = fmaxf(mb8, fmaxf(v2, v3));
          }
          float keep = odd ? mb8 : ma;
          keep = fmaxf(keep, __shfl_xor_sync(0xffffffffu, odd ? ma : mb8, 1));
          bm[j] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, keep, 2));
        }
        const int qw = qa + (odd ? 8 : 0);
        if (t < 2 && qw < B) {
          float* dst = binmax + static_cast<long long>(qw) * nb_total + bin0;
          if (vec) {
#pragma unroll
            for (int j = 0; j < NW / G; j += 4)
              *reinterpret_cast<float4*>(dst + j) = make_float4(bm[j], bm[j + 1], bm[j + 2], bm[j + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < NW / G; ++j)
              if (bin0 + j < nb_total) dst[j] = bm[j];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 operands, both layouts (kernels A, 5 and 7 bin-major, 2 transposed;
// 3xTF32)
// ---------------------------------------------------------------------------

// Doc rows are wgmma's M (64 per consumer warpgroup, 128-row tiles) and the
// tile's NT queries its N (n128; n64 for B <= 64), so the rows reach the
// tensor cores through registers: each 32-dim chunk of the warp's 16 rows is
// read from the swizzled stage by ldmatrix (tf32 A layout), split there into
// hi + lo, and fed as the register A operand of hi.lo, lo.hi and hi.hi
// against the queries' tf32 planes, which arrive split (tf32_split_kernel,
// once per call) and stream by TMA beside D. Nothing is split or rewritten in
// shared memory, and wgmma reads only the query planes from it: per chunk of
// a 128 x 128 tile 96 KB of wgmma reads, 16 KB of ldmatrix and 48 KB of TMA
// writes, where the queries-as-M layout read 144 KB, wrote 48 and split 48.
// Each chunk accumulates in a fresh fragment, folded into the running sum
// with __fadd_rn (Operand<float>). Both layouts share the ring and this main
// loop; only the epilogue's addresses differ. The fragment holds (row, query)
// pairs: bin-major S rows (TRANS = false; a warp's store covers 32 contiguous
// bytes of each of four queries' rows) or transposed S rows (TRANS; a quad
// writes 32 contiguous bytes of a row), and bins of 8 (16) rows, which lie
// along the fragment's rows: three shuffles over the 8 lanes of a column.
template <int NT>
struct FLayout {
  static constexpr int Q_PLANE = NT * CHUNK_BYTES;           // one plane's chunk
  static constexpr int STAGE = W_D_CHUNK + 2 * Q_PLANE;      // D, Q hi, Q lo
  static constexpr int FIT = (W_SMEM_MAX - 2048) / STAGE;
  static constexpr int STAGES = FIT < T_STAGES ? FIT : T_STAGES;
  static constexpr int BAR_OFF = STAGES * STAGE;             // full[], empty[]
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;  // + 1024-byte alignment slack
  static_assert(STAGES >= 2 && BYTES <= W_SMEM_MAX, "the f32 ring does not fit");
};

// TRANS: the transposed layout (S (N, B), binmax (N/G, B); EPI_NONE, STORE)
template <int NT, int G, typename OutT, int EPI, bool STORE, bool TRANS>
__global__ void __launch_bounds__(T_THREADS, 1)
bin_scores_f32_kernel(const __grid_constant__ CUtensorMap dmap,
                      const __grid_constant__ CUtensorMap qmap, OutT* __restrict__ scores,
                      float* __restrict__ binmax, const int* __restrict__ nv_ptr, long long nv_int,
                      const float* __restrict__ q_aux, const float* __restrict__ d_aux, int B,
                      long long N, int D, int q_tiles, long long tiles) {
  static_assert(EPI != EPI_RESCALE, "f32 products take no rescale");
  static_assert(!TRANS || (EPI == EPI_NONE && STORE),
                "the transposed layout stores S, with no epilogue term");
  using L = FLayout<NT>;
  constexpr int STAGES = L::STAGES;
  constexpr int KC = CHUNK_BYTES / 4;  // dims per stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + L::BAR_OFF;      // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 * stage
  const int tid = threadIdx.x;
  const int chunks = (D + KC - 1) / KC;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (sm90::warpgroup_index() == 0) {
    // ---- producer: one thread streams (D chunk, Q hi chunk, Q lo chunk) ----
    sm90::setmaxnreg_dec<40>();
    if (tid == 0) {
      sm90::tma_prefetch(&dmap);
      sm90::tma_prefetch(&qmap);
      int st = 0;
      uint32_t ph = 0;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int q0 = static_cast<int>(tile % q_tiles) * NT;  // query tile fastest
        const int n0 = static_cast<int>(tile / q_tiles) * T_ROWS;
        for (int kc = 0; kc < chunks; ++kc) {
          sm90::mbar_wait(bar_empty + 8 * st, ph ^ 1);
          sm90::mbar_expect_tx(bar_full + 8 * st, L::STAGE);
          const uint32_t dst = base + st * L::STAGE;
          sm90::tma_load_2d(dst, &dmap, bar_full + 8 * st, kc * KC, n0);
          sm90::tma_load_3d(dst + W_D_CHUNK, &qmap, bar_full + 8 * st, kc * KC, q0, 0);
          sm90::tma_load_3d(dst + W_D_CHUNK + L::Q_PLANE, &qmap, bar_full + 8 * st, kc * KC, q0, 1);
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns doc rows n0 + 64 wg .. + 63 ----
    sm90::setmaxnreg_inc<232>();
    const int wg = sm90::warpgroup_index() - 1;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const long long nv = nv_ptr != nullptr ? static_cast<long long>(*nv_ptr) : nv_int;
    const long long nb_total = N / G;
    // this lane's ldmatrix row (of the warp's 16) and its 16-byte column half
    const int lrow = 64 * wg + 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int lhalf = lane >> 4;
    float acc[NT / 2], run[NT / 2];
    int st = 0;
    uint32_t ph = 0;
    // the warp's 16 rows x 32 dims of stage `stg` as four tf32 A fragments
    uint32_t raw[4][4];
    auto load_rows = [&](int stg) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::ldmatrix_x4(raw[kk], base + stg * L::STAGE + lrow * CHUNK_BYTES +
                                       (((2 * kk + lhalf) ^ (lrow & 7)) << 4));
    };
    // each warpgroup loads its next chunk's rows while its current products
    // run (the two are not synchronised, so one's fold and split run beside
    // the other's products)
    if (blockIdx.x < tiles) {
      sm90::mbar_wait(bar_full, 0);
      load_rows(0);
    }
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int q0 = static_cast<int>(tile % q_tiles) * NT;
      const long long n0 = (tile / q_tiles) * T_ROWS;
      const long long r16 = n0 + 64 * wg + 16 * warp;  // this warp's 16 rows
      const long long ra = r16 + g;                    // this thread's rows ra, ra + 8
      const long long rb = ra + 8;
      const bool last_tile = tile + gridDim.x >= tiles;
      float dxa = 0.0f, dxb = 0.0f;  // EPI: d_aux of the thread's two rows, loaded under the main loop
      if (EPI != EPI_NONE) {
        dxa = ra < N ? d_aux[ra] : 0.0f;
        dxb = rb < N ? d_aux[rb] : 0.0f;
      }
      for (int kc = 0; kc < chunks; ++kc) {
        const uint32_t stage = base + st * L::STAGE;
        // split the rows into tf32 hi + lo, in registers
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = __uint_as_float(raw[kk][j]);
            const float h = sm90::tf32_rna(v);
            hi[kk][j] = __float_as_uint(h);
            lo[kk][j] = __float_as_uint(sm90::tf32_rna(v - h));
          }
        }
        const uint32_t qh = stage + W_D_CHUNK;
        const bool last = last_tile && kc + 1 == chunks;
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // four k steps of 32 bytes
          const uint64_t dqh = sm90::desc_sw128(qh + kk * 32, 16, 1024);
          const uint64_t dql = sm90::desc_sw128(qh + L::Q_PLANE + kk * 32, 16, 1024);
          sm90::WgmmaTF32RS<NT>::rs(acc, hi[kk], dql, kk > 0);
          sm90::WgmmaTF32RS<NT>::rs(acc, lo[kk], dqh, 1);
          sm90::WgmmaTF32RS<NT>::rs(acc, hi[kk], dqh, 1);
        }
        sm90::wgmma_commit();
        const int st_next = st + 1 == STAGES ? 0 : st + 1;
        if (!last) {  // the next chunk's rows, under these products
          sm90::mbar_wait(bar_full + 8 * st_next, st_next == 0 ? ph ^ 1 : ph);
          load_rows(st_next);
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        fold_chunk(run, acc, kc == 0);
        if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);
        st = st_next;
        if (st == 0) ph ^= 1;
      }

      // epilogue from the fragments: this thread holds rows ra (run[4i],
      // run[4i + 1]) and rb (run[4i + 2], run[4i + 3]) of queries q, q + 1,
      // q = q0 + 8 i + 2 t; bin_at is a bin maximum's offset in binmax
      auto bin_at = [&](int qq, long long bin) {
        return TRANS ? bin * B + qq : static_cast<long long>(qq) * nb_total + bin;
      };
      const bool pair = (B % 2) == 0;  // TRANS: (row, q) and (row, q + 1) share an aligned pair
#pragma unroll
      for (int i = 0; i < NT / 8; ++i) {
        const int q = q0 + 8 * i + 2 * t;
        float v0 = run[4 * i + 0], v1 = run[4 * i + 1], v2 = run[4 * i + 2], v3 = run[4 * i + 3];
        if (EPI == EPI_TAIL) {  // the tail term, in the JAX order
          const float qx0 = q < B ? q_aux[q] : 0.0f;
          const float qx1 = q + 1 < B ? q_aux[q + 1] : 0.0f;
          apply_epi<EPI>(v0, dxa, qx0);
          apply_epi<EPI>(v1, dxa, qx1);
          apply_epi<EPI>(v2, dxb, qx0);
          apply_epi<EPI>(v3, dxb, qx1);
        }
        v0 = ra < nv ? v0 : NEG_INF;
        v1 = ra < nv ? v1 : NEG_INF;
        v2 = rb < nv ? v2 : NEG_INF;
        v3 = rb < nv ? v3 : NEG_INF;
        if (TRANS) {  // a quad writes 32 contiguous bytes of rows ra and rb
          if (q + 1 < B) {
            if (ra < N) store2(scores + ra * B + q, v0, v1, pair);
            if (rb < N) store2(scores + rb * B + q, v2, v3, pair);
          } else if (q < B) {
            if (ra < N) store_out(scores + ra * B + q, v0);
            if (rb < N) store_out(scores + rb * B + q, v2);
          }
        } else if (STORE) {  // the 8 lanes of a column write 32 contiguous bytes of a query's row
          OutT* row_q = scores + static_cast<long long>(q) * N;
          if (q < B) {
            if (ra < N) store_out(row_q + ra, v0);
            if (rb < N) store_out(row_q + rb, v2);
          }
          if (q + 1 < B) {
            if (ra < N) store_out(row_q + N + ra, v1);
            if (rb < N) store_out(row_q + N + rb, v3);
          }
        }
        if (G == 16) {  // one bin: the warp's 16 rows
          const float m0 = rows_max(fmaxf(v0, v2));
          const float m1 = rows_max(fmaxf(v1, v3));
          const long long bin = r16 / 16;
          if (bin < nb_total) {
            if (g == 0 && q < B) binmax[bin_at(q, bin)] = m0;
            if (g == 1 && q + 1 < B) binmax[bin_at(q + 1, bin)] = m1;
          }
        } else {  // two bins: rows r16 .. + 7 and r16 + 8 .. + 15
          const float a0 = rows_max(v0), a1 = rows_max(v1);
          const float b0 = rows_max(v2), b1 = rows_max(v3);
          const long long bin = r16 / 8 + (g >> 1);  // lanes g = 0, 1: bin a; g = 2, 3: bin b
          const int qw = q + (g & 1);
          const float m = g == 0 ? a0 : g == 1 ? a1 : g == 2 ? b0 : b1;
          if (g < 4 && qw < B && bin < nb_total) binmax[bin_at(qw, bin)] = m;
        }
      }
    }
  }
}

template <int NT, int G, typename OutT, int EPI, bool STORE, bool TRANS>
int launch_f32(const void* q_split, const void* d, void* scores, void* binmax, const void* nv_ptr,
               long long nv_int, const void* q_aux, const void* d_aux, int B, long long N, int D,
               cudaStream_t stream) {
  using L = FLayout<NT>;
  CUtensorMap dmap, qmap;
  const int rc = make_maps<float>(&dmap, &qmap, q_split, d, B, N, D, NT, 2);
  if (rc != 0) return rc;
  const int q_tiles = (B + NT - 1) / NT;
  const long long tiles = (N + T_ROWS - 1) / T_ROWS * q_tiles;
  const int sms = sm90::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const unsigned int grid = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  const int smem = L::BYTES > sm90::ONE_BLOCK_SMEM ? L::BYTES : sm90::ONE_BLOCK_SMEM;
  auto kernel = bin_scores_f32_kernel<NT, G, OutT, EPI, STORE, TRANS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, T_THREADS, smem, stream>>>(
      dmap, qmap, static_cast<OutT*>(scores), static_cast<float*>(binmax),
      static_cast<const int*>(nv_ptr), nv_int, static_cast<const float*>(q_aux),
      static_cast<const float*>(d_aux), B, N, D, q_tiles, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT, int G, typename OutT, int EPI, bool STORE, bool QRES>
int launch_bm_q(const WLayout& L, const void* q, const void* d, void* scores, void* binmax,
                const void* nv_ptr, long long nv_int, const void* q_aux, const void* d_aux,
                int B, long long N, int D, cudaStream_t stream) {
  CUtensorMap dmap, qmap;
  const int rc = make_maps<T>(&dmap, &qmap, q, d, B, N, D, NT);
  if (rc != 0) return rc;
  const int q_tiles = (B + NT - 1) / NT;
  const long long n_tiles = (N + T_ROWS - 1) / T_ROWS;
  const long long tiles = n_tiles * q_tiles;
  const int sms = sm90::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const unsigned int grid = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  const int smem = L.bytes > sm90::ONE_BLOCK_SMEM ? L.bytes : sm90::ONE_BLOCK_SMEM;
  auto kernel = bin_scores_bm_kernel<T, NT, G, OutT, EPI, STORE, QRES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, T_THREADS, smem, stream>>>(
      dmap, qmap, L, static_cast<OutT*>(scores), static_cast<float*>(binmax),
      static_cast<const int*>(nv_ptr), nv_int, static_cast<const float*>(q_aux),
      static_cast<const float*>(d_aux), B, N, D, q_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// kernels 2 and 4; f32 operands (q: the queries' (2, B, d) tf32 split) take
// bin_scores_f32_kernel with the transposed epilogue
template <typename T, typename OutT, int EPI>
int launch_transposed(int G, const void* q, const void* d, void* scores, void* binmax,
                      const void* nv_ptr, long long nv_int, const void* q_aux, const void* d_aux,
                      int B, long long N, int D, cudaStream_t s) {
  return by_tile<Operand<T>::MAX_NT>(G, B, [&](auto nt, auto g) {
    constexpr int NT = decltype(nt)::value, GG = decltype(g)::value;
    if constexpr (std::is_same<T, float>::value) {
      return launch_f32<NT, GG, OutT, EPI, true, true>(q, d, scores, binmax, nv_ptr, nv_int, q_aux,
                                                       d_aux, B, N, D, s);
    } else {
      return launch_t<T, NT, GG, OutT, EPI>(q, d, scores, binmax, nv_ptr, nv_int, q_aux, d_aux, B, N,
                                            D, s);
    }
  });
}

// kernels A, 4, 5 and 7: scores may be null when STORE is false, q_aux and
// d_aux when EPI is EPI_NONE
template <typename T, typename OutT, int EPI, bool STORE>
int launch_bin_major(int G, const void* q, const void* d, void* scores, void* binmax,
                     const void* nv_ptr, long long nv_int, const void* q_aux, const void* d_aux,
                     int B, long long N, int D, cudaStream_t s) {
  return by_tile<Operand<T>::MAX_NT>(G, B, [&](auto nt, auto g) {
    constexpr int NT = decltype(nt)::value, GG = decltype(g)::value;
    if constexpr (std::is_same<T, float>::value) {  // q: the queries' (2, B, d) tf32 split
      return launch_f32<NT, GG, OutT, EPI, STORE, false>(q, d, scores, binmax, nv_ptr, nv_int, q_aux,
                                                         d_aux, B, N, D, s);
    } else {
      const WLayout L = w_layout(NT, static_cast<long long>(D) * sizeof(T), EPI != EPI_NONE);
      if (L.q_resident)
        return launch_bm_q<T, NT, GG, OutT, EPI, STORE, true>(L, q, d, scores, binmax, nv_ptr,
                                                              nv_int, q_aux, d_aux, B, N, D, s);
      return launch_bm_q<T, NT, GG, OutT, EPI, STORE, false>(L, q, d, scores, binmax, nv_ptr,
                                                             nv_int, q_aux, d_aux, B, N, D, s);
    }
  });
}

// the launchers of kernels A and 2 (bin_scores), 5 (binmax_only) and 7
// (binub) over operand type T, behind the C interfaces of bin_scores.cu
// (bf16), bin_scores_f16.cu and bin_scores_f32.cu; each returns
// cudaGetLastError() (0 = ok) or the tensor-map error
template <typename T>
int bin_scores_any(const void* q, const void* d, void* scores, void* binmax, const void* nv_ptr,
                   long long nv_int, int B, long long N, int D, int G, int bin_major,
                   int score_bf16, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (!shape_ok(B, N, D, G, 32)) return cudaErrorInvalidValue;
  if (!bin_major) {
    if (score_bf16)
      return launch_transposed<T, bf16, EPI_NONE>(G, q, d, scores, binmax, nv_ptr, nv_int, nullptr,
                                                  nullptr, B, N, D, s);
    return launch_transposed<T, float, EPI_NONE>(G, q, d, scores, binmax, nv_ptr, nv_int, nullptr,
                                                 nullptr, B, N, D, s);
  }
  if (score_bf16)
    return launch_bin_major<T, bf16, EPI_NONE, true>(G, q, d, scores, binmax, nv_ptr, nv_int,
                                                     nullptr, nullptr, B, N, D, s);
  return launch_bin_major<T, float, EPI_NONE, true>(G, q, d, scores, binmax, nv_ptr, nv_int,
                                                    nullptr, nullptr, B, N, D, s);
}

template <typename T>
int binmax_only_any(const void* q, const void* d, void* binmax, const void* nv_ptr,
                    long long nv_int, int B, long long N, int D, int G, cudaStream_t s) {
  if (!shape_ok(B, N, D, G, 32)) return cudaErrorInvalidValue;
  return launch_bin_major<T, float, EPI_NONE, false>(G, q, d, nullptr, binmax, nv_ptr, nv_int,
                                                     nullptr, nullptr, B, N, D, s);
}

template <typename T>
int binub_any(const void* q_sketch, const void* q_tail, const void* d_sketch, const void* d_tail,
              void* binmax, const void* nv_ptr, long long nv_int, int B, long long N, int DS,
              int G, cudaStream_t s) {
  if (!shape_ok(B, N, DS, G, 32)) return cudaErrorInvalidValue;
  return launch_bin_major<T, float, EPI_TAIL, false>(G, q_sketch, d_sketch, nullptr, binmax,
                                                     nv_ptr, nv_int, q_tail, d_tail, B, N, DS, s);
}

}  // namespace

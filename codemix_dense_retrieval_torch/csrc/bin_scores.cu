// Fused phase 1 of the exact bin-max-cover top-k: scores S = Q . D^T with
// f32 accumulation, rows >= n_valid masked to NEG_INF (float32 min), and the
// maximum of every run of G consecutive rows ("bin max").
//
// Replaces the TPU kernels codemix_dense_retrieval_tpu/ops/topk.py::
// _bin_scores_pallas_bm (bin-major outputs: S (B, N), binmax (B, N/G); kernel
// A, bin_scores_bm_kernel below) and ::_bin_scores_pallas (transposed outputs:
// S (N, B), binmax (N/G, B); kernel 2, bin_scores_t_kernel below).
//
// Kernel 7, "binub", replaces codemix_dense_retrieval_tpu/ops/sketch.py::
// _binub_pallas: kernel A over the PCA sketch (d = ds, bf16) with the score
// store compiled out and one more epilogue term, ub = s + d_tail[n] *
// q_tail[q], the Cauchy-Schwarz upper bound of the full-width score, before
// the mask and the bin max. The term is written __fadd_rn(s, __fmul_rn(d_tail,
// q_tail)) in the JAX order so no FMA contraction can fuse it: the kernel
// differs from its plain version only in the order of the ds-long f32 sum.
//
// Kernel 5, "bin max only", replaces ::_binmax_only_pallas: only the bin
// maxima leave the SM, emitted bin-major (B, N/G) (the TPU kernel writes
// (N/G, B) and its callers transpose at once). It alone still runs the
// pre-Hopper wmma loop (binmax_only_kernel below, with bin_epilogue.cuh),
// kept for it only until it moves onto bin_scores_bm_kernel.
//
// What bounds them on an H100: bytes. At the main path's shape (B = 256
// queries, N = 8,842,240 rows, d = 1024, bf16) kernel A must read D once
// (18.1 GB) and write S (9.05 GB f32) and binmax (1.13 GB): 28.3 GB, 8.45 ms
// at 3.35 TB/s, against 4.64 TFLOP = 4.7 ms at 989 TF/s of bf16 tensor-core
// work. Without the score store (kernel 5): 19.2 GB, 5.74 ms. Kernel 7 at the
// sketch tier's shape (ds = 128) reads 2.26 GB of sketch and 35 MB of tails
// and writes 1.13 GB of bin maxima: 1.02 ms, above its 0.59 ms of tensor-core
// work. Kernel 2 at its shape (B = 256, N = 131,072): 0.27 GB of D, 0.13 GB
// of S, 0.12 ms.
//
// Kernels A, 7 and 2 are warp-specialised Hopper kernels on sm90.cuh: a
// producer thread streams 64-dim chunks (128-byte rows, 128-byte swizzle) by
// TMA into an mbarrier ring, two consumer warpgroups multiply them with
// wgmma, and the blocks are persistent (one per SM), so the next tile's
// chunks load while the current tile's epilogue runs; rows past N and dims
// past d read as zeros. Epilogues work on the accumulators in registers.
// Kernel 2 (transposed, bin_scores_t_kernel): doc rows are wgmma's M (64 per
// warpgroup, 128-row tiles) and every query (B <= 256) its N (n256; n128 for
// B <= 128, n64 for B <= 64; 256-query tiles past that); a Q chunk rides
// beside each D chunk in a 4-stage ring; S (N, B) rows are stored from the
// fragments (a quad writes 32 contiguous bytes) and each bin max takes three
// __shfl_xor_sync.
// Kernels A and 7 (bin-major, bin_scores_bm_kernel) turn the roles round:
// queries are wgmma's M and the tile's 128 doc rows its N, so a bin lies
// along the fragment's columns, inside one quad:
// - tiles of NT queries x 128 rows (NT = 256, 128 or 64 as for kernel 2);
//   at NT = 256 each warpgroup takes 128 queries (two m64 blocks, n128), at
//   128 each takes 64, at 64 both take the 64 queries and split the rows;
// - Q resident where all of a query tile's chunks fit beside the ring
//   (kernel 7's 64 KB sketch at ds = 128, B = 256): loaded once per query
//   tile (tiles ordered query tile slowest), and the ring (up to 8 stages)
//   carries D chunks only. Otherwise (kernel A at d = 1024: Q is 512 KB) a Q
//   chunk rides beside each D chunk in a 3- or 4-stage ring, query tile
//   fastest so the tiles of one D tile run side by side and share it in L2;
// - a mask pass only on tiles that reach n_valid; kernel 7 first adds the
//   tail term (q_tail of the thread's queries in registers, d_tail staged in
//   shared memory per tile);
// - bin maxima: in-thread maxima of each quad lane's pairs, then two
//   shuffles that scatter as they reduce, so even lanes hold query qa's bin
//   maximum and odd lanes qa + 8's; lanes 0 and 1 of each quad write a
//   query's NW / G bins as one run of float4 stores;
// - kernel A stores S (B, N) from the fragments: a quad writes 32
//   contiguous bytes of a query's row (f32).
// Measured on an H100 (scripts/torch_kernel_ab.py): kernel A's main loop
// alone reads D at ~3.0 TB/s; its time above that is the 9.05 GB of S
// written beside the reads. Kernel 7's epilogue (tail term, mask, bin max,
// stores) costs more than its main loop.
// Every offset into S and binmax is 64-bit: B * N exceeds 2^31 at the main
// path's shape.
// Requirements (checked by the Python wrapper): Q, D bf16, contiguous and
// 16-byte aligned, d % 32 == 0, N % G == 0, G in {8, 16}; N < 2^31 (TMA
// coordinates are 32-bit).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "bin_epilogue.cuh"
#include "sm90.cuh"

using namespace nvcuda;
using namespace bin_tile;

namespace {

// ---------------------------------------------------------------------------
// kernel 5: the pre-Hopper wmma loop, bin maxima only
// ---------------------------------------------------------------------------

constexpr int TILE_K = 32;
constexpr int LDS = TILE_K + 8;      // bf16 row stride of the staged chunks
constexpr int SQ_BYTES = TILE_Q * LDS * 2;
constexpr int SD_BYTES = TILE_N * LDS * 2;
constexpr int SMEM_BYTES = (SQ_BYTES + SD_BYTES) > SC_BYTES ? (SQ_BYTES + SD_BYTES) : SC_BYTES;

// a block computes a 128-query x 128-row tile with wmma bf16 m16n16k16
// fragments (each warp 64 queries x 32 rows), looping over d in chunks of 32
// staged in shared memory (the next chunk's global loads are issued into
// registers before the current chunk's products); the epilogue stages the
// f32 tile in shared memory and reduces each G-row run there
template <int G>
__global__ void __launch_bounds__(THREADS)
binmax_only_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ d,
                   float* __restrict__ binmax,
                   const int* __restrict__ nv_ptr,
                   long long nv_int,
                   int B, long long N, int D, int num_q_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sD = reinterpret_cast<__nv_bfloat16*>(smem + SQ_BYTES);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_q = warp / 4;  // 2 warps along queries: 64 rows each
  const int warp_n = warp % 4;  // 4 warps along doc rows: 32 rows each
  const long long bid = blockIdx.x;
  const int q0 = static_cast<int>(bid % num_q_tiles) * TILE_Q;
  const long long n0 = (bid / num_q_tiles) * TILE_N;

  // global -> register staging: two 16-byte Q vectors and two D vectors per
  // thread per 32-wide chunk (zero outside the arrays)
  const __nv_bfloat16* q_src[2];
  const __nv_bfloat16* d_src[2];
  bool q_in[2], d_in[2];
  int row[2], vec[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    row[i] = idx / 4;
    vec[i] = idx % 4;
    q_in[i] = q0 + row[i] < B;
    q_src[i] = q + static_cast<long long>(q0 + row[i]) * D + vec[i] * 8;
    d_in[i] = n0 + row[i] < N;
    d_src[i] = d + (n0 + row[i]) * static_cast<long long>(D) + vec[i] * 8;
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 rq[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rq[i] = q_in[i] ? *reinterpret_cast<const uint4*>(q_src[i]) : zero;
    rd[i] = d_in[i] ? *reinterpret_cast<const uint4*>(d_src[i]) : zero;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < D; k0 += TILE_K) {
    __syncthreads();  // the previous chunk's fragments are loaded
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(sQ + row[i] * LDS + vec[i] * 8) = rq[i];
      *reinterpret_cast<uint4*>(sD + row[i] * LDS + vec[i] * 8) = rd[i];
    }
    __syncthreads();
    const int k1 = k0 + TILE_K;
    if (k1 < D) {  // next chunk's loads fly while this chunk multiplies
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rq[i] = q_in[i] ? *reinterpret_cast<const uint4*>(q_src[i] + k1) : zero;
        rd[i] = d_in[i] ? *reinterpret_cast<const uint4*>(d_src[i] + k1) : zero;
      }
    }
#pragma unroll
    for (int kk = 0; kk < TILE_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], sQ + (warp_q * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sD + (warp_n * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();  // sC aliases the staging buffers
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (warp_q * 64 + i * 16) * LDC + warp_n * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  const long long nv = nv_ptr != nullptr ? static_cast<long long>(*nv_ptr) : nv_int;
  mask_store_binmax<G, true, false>(sC, static_cast<float*>(nullptr), binmax, nv, q0, n0, B, N);
}

template <int G>
void launch_binmax_only(const void* q, const void* d, void* binmax, const void* nv_ptr,
                        long long nv_int, int B, long long N, int D, unsigned int blocks, int nqt,
                        cudaStream_t stream) {
  // the 67.6 KB staged tile is above the 48 KB a launch gets by default
  cudaFuncSetAttribute(binmax_only_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  binmax_only_kernel<G><<<blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(d),
      static_cast<float*>(binmax), static_cast<const int*>(nv_ptr), nv_int, B, N, D, nqt);
}

// ---------------------------------------------------------------------------
// kernel 2: the transposed layout on TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int T_ROWS = 128;    // doc rows per tile: two consumer warpgroups of 64
constexpr int T_KC = 64;       // dims per stage: one 128-byte swizzled row
constexpr int T_STAGES = 4;
constexpr int T_THREADS = 384;  // producer warpgroup + two consumer warpgroups

template <int NT>
struct TLayout {
  static constexpr int D_BYTES = T_ROWS * 128;
  static constexpr int STAGE = D_BYTES + NT * 128;             // D chunk, then Q chunk
  static constexpr int BAR_OFF = T_STAGES * STAGE;             // full[T_STAGES], empty[T_STAGES]
  static constexpr int BYTES = BAR_OFF + 16 * T_STAGES + 1024;  // + 1024-byte alignment slack
};

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

template <int NT, int G, typename OutT>
__global__ void __launch_bounds__(T_THREADS, 1)
bin_scores_t_kernel(const __grid_constant__ CUtensorMap dmap,
                    const __grid_constant__ CUtensorMap qmap, OutT* __restrict__ scores,
                    float* __restrict__ binmax, const int* __restrict__ nv_ptr,
                    long long nv_int, int B, long long N, int D, int q_tiles, long long tiles) {
  using L = TLayout<NT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + L::BAR_OFF;           // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * T_STAGES;    // + 8 * stage
  const int tid = threadIdx.x;
  const int chunks = (D + T_KC - 1) / T_KC;

  if (tid == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
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
          const int st = it % T_STAGES;
          sm90::mbar_wait(bar_empty + 8 * st, ((it / T_STAGES) & 1) ^ 1);
          sm90::mbar_expect_tx(bar_full + 8 * st, L::STAGE);
          const uint32_t dst = base + st * L::STAGE;
          sm90::tma_load_2d(dst, &dmap, bar_full + 8 * st, kc * T_KC, n0);
          sm90::tma_load_2d(dst + L::D_BYTES, &qmap, bar_full + 8 * st, kc * T_KC, qb);
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
    const bool pair = (B % 2) == 0;  // (row, q) and (row, q + 1) share an aligned pair
    float acc[NT / 2];
    int it = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int qb = static_cast<int>(tile % q_tiles) * NT;
      const long long n0 = (tile / q_tiles) * T_ROWS;
      for (int kc = 0; kc < chunks; ++kc, ++it) {
        const int st = it % T_STAGES;
        sm90::mbar_wait(bar_full + 8 * st, (it / T_STAGES) & 1);
        const uint32_t d_st = base + st * L::STAGE + wg * 64 * 128;
        const uint32_t q_st = base + st * L::STAGE + L::D_BYTES;
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T_KC / 16; ++kk) {
          const uint64_t da = sm90::desc_sw128(d_st + kk * 32, 16, 1024);
          const uint64_t db = sm90::desc_sw128(q_st + kk * 32, 16, 1024);
          sm90::Wgmma<NT>::template ss<0>(acc, da, db, kc > 0 || kk > 0);
        }
        sm90::wgmma_commit();
        if (kc > 0) {  // the previous chunk's products are done: free its stage
          sm90::wgmma_wait<1>();
          if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * ((it - 1) % T_STAGES));
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * ((it - 1) % T_STAGES));

      // epilogue from the fragments: rows ra (acc[4i], acc[4i+1]) and ra + 8
      const long long r16 = n0 + wg * 64 + warp * 16;  // this warp's 16 rows
      const long long ra = r16 + g;
      const long long rb = ra + 8;
#pragma unroll
      for (int i = 0; i < NT / 8; ++i) {
        const int q = qb + 8 * i + 2 * t;
        const float v0 = ra < nv ? acc[4 * i + 0] : NEG_INF;
        const float v1 = ra < nv ? acc[4 * i + 1] : NEG_INF;
        const float v2 = rb < nv ? acc[4 * i + 2] : NEG_INF;
        const float v3 = rb < nv ? acc[4 * i + 3] : NEG_INF;
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

template <int NT, int G, typename OutT>
int launch_t(const void* q, const void* d, void* scores, void* binmax, const void* nv_ptr,
             long long nv_int, int B, long long N, int D, cudaStream_t stream) {
  using L = TLayout<NT>;
  CUtensorMap dmap, qmap;
  const uint64_t ddims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N)};
  const uint64_t qdims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(B)};
  const uint64_t row_bytes[1] = {static_cast<uint64_t>(D) * 2};
  const uint32_t dbox[2] = {T_KC, T_ROWS};
  const uint32_t qbox[2] = {T_KC, NT};
  int rc = sm90::make_tma_bf16(&dmap, d, 2, ddims, row_bytes, dbox);
  if (rc == 0) rc = sm90::make_tma_bf16(&qmap, q, 2, qdims, row_bytes, qbox);
  if (rc != 0) return rc;
  const int q_tiles = (B + NT - 1) / NT;
  const long long tiles = (N + T_ROWS - 1) / T_ROWS * q_tiles;
  const int sms = sm90::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const unsigned int grid = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  const int smem = L::BYTES > sm90::ONE_BLOCK_SMEM ? L::BYTES : sm90::ONE_BLOCK_SMEM;
  cudaError_t err = cudaFuncSetAttribute(bin_scores_t_kernel<NT, G, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_scores_t_kernel<NT, G, OutT><<<grid, T_THREADS, smem, stream>>>(
      dmap, qmap, static_cast<OutT*>(scores), static_cast<float*>(binmax),
      static_cast<const int*>(nv_ptr), nv_int, B, N, D, q_tiles, tiles);
  return static_cast<int>(cudaGetLastError());
}

// the query tile (wgmma's N) for B queries: the smallest of 64, 128, 256
// that holds them, 256 past that
template <typename OutT>
int launch_transposed(int G, const void* q, const void* d, void* scores, void* binmax,
                      const void* nv_ptr, long long nv_int, int B, long long N, int D,
                      cudaStream_t s) {
  if (G == 8) {
    if (B <= 64) return launch_t<64, 8, OutT>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, s);
    if (B <= 128) return launch_t<128, 8, OutT>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, s);
    return launch_t<256, 8, OutT>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, s);
  }
  if (B <= 64) return launch_t<64, 16, OutT>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, s);
  if (B <= 128) return launch_t<128, 16, OutT>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, s);
  return launch_t<256, 16, OutT>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, s);
}

// ---------------------------------------------------------------------------
// kernels A and 7: the bin-major layout on TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int W_SMEM_MAX = 227 * 1024;  // a block's dynamic shared memory on an H100
constexpr int W_MAX_STAGES = 8;
constexpr int W_D_CHUNK = T_ROWS * 128;  // one 64-dim chunk of a 128-row D tile: 16 KB

// shared-memory plan, as byte offsets from the 1024-aligned base: resident Q
// chunks (q_resident) at 0, then the ring of `stages` stages (a D chunk, and
// a Q chunk after it unless Q is resident), two tiles' d_tail (kernel 7), the
// barriers full[stages], empty[stages], q_full, q_empty
struct WLayout {
  int stages, stage_bytes, ring_off, dt_off, bar_off, bytes, q_resident;
};

inline WLayout w_layout(int nt, int D, bool ub) {
  const int chunks = (D + T_KC - 1) / T_KC;
  const int q_bytes = chunks * nt * 128;
  const int tails = ub ? 2 * T_ROWS * 4 : 0;  // d_tail of this tile and the next
  const int fixed = tails + 16 * W_MAX_STAGES + 16 + 1024;  // + 1024-byte alignment slack
  WLayout L{};
  L.q_resident = q_bytes + 2 * W_D_CHUNK + fixed <= W_SMEM_MAX;
  if (L.q_resident) {
    L.stage_bytes = W_D_CHUNK;
    L.ring_off = q_bytes;
    L.stages = (W_SMEM_MAX - fixed - q_bytes) / W_D_CHUNK;
    if (L.stages > W_MAX_STAGES) L.stages = W_MAX_STAGES;
  } else {
    L.stage_bytes = W_D_CHUNK + nt * 128;
    L.ring_off = 0;
    L.stages = T_STAGES;
  }
  L.dt_off = L.ring_off + L.stages * L.stage_bytes;
  L.bar_off = L.dt_off + tails;
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

// STORE: write S (B, N) (kernel A); UB: add the tail term (kernel 7).
// QRES: Q resident, tiles ordered query tile slowest (Q is loaded once per
// query tile); else Q streams beside D, query tile fastest (the query tiles
// of one D tile run side by side and share it in L2).
template <int NT, int G, typename OutT, bool STORE, bool UB, bool QRES>
__global__ void __launch_bounds__(T_THREADS, 1)
bin_scores_bm_kernel(const __grid_constant__ CUtensorMap dmap,
                     const __grid_constant__ CUtensorMap qmap, const WLayout L,
                     OutT* __restrict__ scores, float* __restrict__ binmax,
                     const int* __restrict__ nv_ptr, long long nv_int,
                     const float* __restrict__ q_tail, const float* __restrict__ d_tail,
                     int B, long long N, int D, int q_tiles, long long n_tiles) {
  using S = WSplit<NT>;
  constexpr int MB = S::MB;
  constexpr int NW = S::NW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base + L.ring_off;
  const uint32_t bar_full = base + L.bar_off;           // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * L.stages;   // + 8 * stage
  const uint32_t bar_qfull = bar_empty + 8 * L.stages;
  const uint32_t bar_qempty = bar_qfull + 8;
  const int tid = threadIdx.x;
  const int chunks = (D + T_KC - 1) / T_KC;
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
          sm90::mbar_expect_tx(bar_qfull, chunks * NT * 128);
          for (int kc = 0; kc < chunks; ++kc)
            sm90::tma_load_2d(base + kc * NT * 128, &qmap, bar_qfull, kc * T_KC, qt * NT);
          cur_q = qt;
          ++q_loads;
        }
        for (int kc = 0; kc < chunks; ++kc) {
          sm90::mbar_wait(bar_empty + 8 * st, ph ^ 1);
          sm90::mbar_expect_tx(bar_full + 8 * st, L.stage_bytes);
          const uint32_t dst = ring + st * L.stage_bytes;
          sm90::tma_load_2d(dst, &dmap, bar_full + 8 * st, kc * T_KC, n0);
          if (!QRES) sm90::tma_load_2d(dst + W_D_CHUNK, &qmap, bar_full + 8 * st, kc * T_KC, qt * NT);
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
    float* s_dt = reinterpret_cast<float*>(smem_raw + (base - raw) + L.dt_off);
    float acc[MB][NW / 2];
    float qta[MB], qtb[MB];  // kernel 7: q_tail of this thread's two queries per m block
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
        if (UB) {
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            const int qa = qb + q_off + 64 * mb + 16 * warp + g;
            qta[mb] = qa < B ? q_tail[qa] : 0.0f;
            qtb[mb] = qa + 8 < B ? q_tail[qa + 8] : 0.0f;
          }
        }
        cur_q = qt;
      }
      // kernel 7: this tile's d_tail, staged in shared memory at the epilogue
      const float my_dt = UB && tc < T_ROWS && n0 + tc < N ? d_tail[n0 + tc] : 0.0f;
      for (int kc = 0; kc < chunks; ++kc) {
        sm90::mbar_wait(bar_full + 8 * st, ph);
        const uint32_t stage = ring + st * L.stage_bytes;
        const uint32_t d_st = stage + r_off * 128;
        const uint32_t q_st = (QRES ? base + kc * (NT * 128) : stage + W_D_CHUNK) + q_off * 128;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) sm90::fence_regs(acc[mb]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T_KC / 16; ++kk) {
          const uint64_t db = sm90::desc_sw128(d_st + kk * 32, 16, 1024);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            const uint64_t da = sm90::desc_sw128(q_st + mb * 64 * 128 + kk * 32, 16, 1024);
            sm90::Wgmma<NW>::template ss<0>(acc[mb], da, db, kc > 0 || kk > 0);
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
      if (UB) {  // ub = s + d_tail * q_tail, in the JAX order
        const float* dt_tile = s_dt + (local & 1) * T_ROWS;
        if (tc < T_ROWS) s_dt[(local & 1) * T_ROWS + tc] = my_dt;
        sm90::named_sync(1, 256);
#pragma unroll
        for (int i = 0; i < NW / 8; ++i) {
          const float2 dt = *reinterpret_cast<const float2*>(dt_tile + r_off + 8 * i + 2 * t);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            acc[mb][4 * i + 0] = __fadd_rn(acc[mb][4 * i + 0], __fmul_rn(dt.x, qta[mb]));
            acc[mb][4 * i + 1] = __fadd_rn(acc[mb][4 * i + 1], __fmul_rn(dt.y, qta[mb]));
            acc[mb][4 * i + 2] = __fadd_rn(acc[mb][4 * i + 2], __fmul_rn(dt.x, qtb[mb]));
            acc[mb][4 * i + 3] = __fadd_rn(acc[mb][4 * i + 3], __fmul_rn(dt.y, qtb[mb]));
          }
        }
      }
      if (n0 + T_ROWS > nv) {  // a tile that reaches n_valid: the mask pass
#pragma unroll
        for (int i = 0; i < NW / 8; ++i) {
          const long long c = cb + 8 * i;
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            acc[mb][4 * i + 0] = c < nv ? acc[mb][4 * i + 0] : NEG_INF;
            acc[mb][4 * i + 1] = c + 1 < nv ? acc[mb][4 * i + 1] : NEG_INF;
            acc[mb][4 * i + 2] = c < nv ? acc[mb][4 * i + 2] : NEG_INF;
            acc[mb][4 * i + 3] = c + 1 < nv ? acc[mb][4 * i + 3] : NEG_INF;
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
            const float v0 = acc[mb][4 * i + 0], v1 = acc[mb][4 * i + 1];
            const float v2 = acc[mb][4 * i + 2], v3 = acc[mb][4 * i + 3];
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

template <int NT, int G, typename OutT, bool STORE, bool UB, bool QRES>
int launch_bm_q(const WLayout& L, const void* q, const void* d, void* scores, void* binmax,
                const void* nv_ptr, long long nv_int, const void* q_tail, const void* d_tail,
                int B, long long N, int D, cudaStream_t stream) {
  CUtensorMap dmap, qmap;
  const uint64_t ddims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N)};
  const uint64_t qdims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(B)};
  const uint64_t row_bytes[1] = {static_cast<uint64_t>(D) * 2};
  const uint32_t dbox[2] = {T_KC, T_ROWS};
  const uint32_t qbox[2] = {T_KC, NT};
  int rc = sm90::make_tma_bf16(&dmap, d, 2, ddims, row_bytes, dbox);
  if (rc == 0) rc = sm90::make_tma_bf16(&qmap, q, 2, qdims, row_bytes, qbox);
  if (rc != 0) return rc;
  const int q_tiles = (B + NT - 1) / NT;
  const long long n_tiles = (N + T_ROWS - 1) / T_ROWS;
  const long long tiles = n_tiles * q_tiles;
  const int sms = sm90::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const unsigned int grid = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  const int smem = L.bytes > sm90::ONE_BLOCK_SMEM ? L.bytes : sm90::ONE_BLOCK_SMEM;
  auto kernel = bin_scores_bm_kernel<NT, G, OutT, STORE, UB, QRES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, T_THREADS, smem, stream>>>(
      dmap, qmap, L, static_cast<OutT*>(scores), static_cast<float*>(binmax),
      static_cast<const int*>(nv_ptr), nv_int, static_cast<const float*>(q_tail),
      static_cast<const float*>(d_tail), B, N, D, q_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int G, typename OutT, bool STORE, bool UB>
int launch_bm(const void* q, const void* d, void* scores, void* binmax, const void* nv_ptr,
              long long nv_int, const void* q_tail, const void* d_tail, int B, long long N,
              int D, cudaStream_t stream) {
  const WLayout L = w_layout(NT, D, UB);
  if (L.q_resident)
    return launch_bm_q<NT, G, OutT, STORE, UB, true>(L, q, d, scores, binmax, nv_ptr, nv_int,
                                                     q_tail, d_tail, B, N, D, stream);
  return launch_bm_q<NT, G, OutT, STORE, UB, false>(L, q, d, scores, binmax, nv_ptr, nv_int, q_tail,
                                                    d_tail, B, N, D, stream);
}

// the query tile for B queries, as for kernel 2
template <typename OutT, bool STORE, bool UB>
int launch_bin_major(int G, const void* q, const void* d, void* scores, void* binmax,
                     const void* nv_ptr, long long nv_int, const void* q_tail,
                     const void* d_tail, int B, long long N, int D, cudaStream_t s) {
  if (G == 8) {
    if (B <= 64)
      return launch_bm<64, 8, OutT, STORE, UB>(q, d, scores, binmax, nv_ptr, nv_int, q_tail, d_tail,
                                               B, N, D, s);
    if (B <= 128)
      return launch_bm<128, 8, OutT, STORE, UB>(q, d, scores, binmax, nv_ptr, nv_int, q_tail,
                                                d_tail, B, N, D, s);
    return launch_bm<256, 8, OutT, STORE, UB>(q, d, scores, binmax, nv_ptr, nv_int, q_tail, d_tail,
                                              B, N, D, s);
  }
  if (B <= 64)
    return launch_bm<64, 16, OutT, STORE, UB>(q, d, scores, binmax, nv_ptr, nv_int, q_tail, d_tail,
                                              B, N, D, s);
  if (B <= 128)
    return launch_bm<128, 16, OutT, STORE, UB>(q, d, scores, binmax, nv_ptr, nv_int, q_tail, d_tail,
                                               B, N, D, s);
  return launch_bm<256, 16, OutT, STORE, UB>(q, d, scores, binmax, nv_ptr, nv_int, q_tail, d_tail,
                                             B, N, D, s);
}

}  // namespace

// Launches kernel A (bin_major) or kernel 2 (transposed) on `stream` and
// returns cudaGetLastError() (0 = ok) or the tensor-map error. n_valid is
// read from the device int32 at nv_ptr when it is not null, else taken from
// nv_int.
extern "C" int bin_scores_launch(const void* q, const void* d, void* scores, void* binmax,
                                 const void* nv_ptr, long long nv_int, int B, long long N,
                                 int D, int G, int bin_major, int score_bf16, void* stream) {
  int nqt = 0;
  if (grid_blocks(B, N, D, G, TILE_K, &nqt) == 0) return cudaErrorInvalidValue;
  if (N > INT_MAX) return cudaErrorInvalidValue;  // TMA coordinates are 32-bit
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bin_major) {
    if (score_bf16)
      return launch_transposed<__nv_bfloat16>(G, q, d, scores, binmax, nv_ptr, nv_int, B, N, D, s);
    return launch_transposed<float>(G, q, d, scores, binmax, nv_ptr, nv_int, B, N, D, s);
  }
  if (score_bf16)
    return launch_bin_major<__nv_bfloat16, true, false>(G, q, d, scores, binmax, nv_ptr, nv_int,
                                                        nullptr, nullptr, B, N, D, s);
  return launch_bin_major<float, true, false>(G, q, d, scores, binmax, nv_ptr, nv_int, nullptr,
                                              nullptr, B, N, D, s);
}

// Kernel 5: the bin maxima alone, bin-major (B, N/G); same requirements and
// return value as bin_scores_launch.
extern "C" int binmax_only_launch(const void* q, const void* d, void* binmax, const void* nv_ptr,
                                  long long nv_int, int B, long long N, int D, int G,
                                  void* stream) {
  int nqt = 0;
  const unsigned int blocks = grid_blocks(B, N, D, G, TILE_K, &nqt);
  if (blocks == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 8)
    launch_binmax_only<8>(q, d, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
  else
    launch_binmax_only<16>(q, d, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 7: bin maxima (B, N/G), bin-major, of the sketch upper bound
// s_q . s_x + q_tail[q] * d_tail[x] with rows >= n_valid masked; q_sketch
// (B, ds) and d_sketch (N, ds) bf16, tails f32. Same requirements and return
// value as bin_scores_launch (ds % 32 == 0).
extern "C" int binub_launch(const void* q_sketch, const void* q_tail, const void* d_sketch,
                            const void* d_tail, void* binmax, const void* nv_ptr,
                            long long nv_int, int B, long long N, int DS, int G, void* stream) {
  int nqt = 0;
  if (grid_blocks(B, N, DS, G, TILE_K, &nqt) == 0) return cudaErrorInvalidValue;
  if (N > INT_MAX) return cudaErrorInvalidValue;
  return launch_bin_major<float, false, true>(G, q_sketch, d_sketch, nullptr, binmax, nv_ptr,
                                              nv_int, q_tail, d_tail, B, N, DS,
                                              static_cast<cudaStream_t>(stream));
}

// Fused phase 1 of the exact bin-max-cover top-k: scores S = Q . D^T with
// f32 accumulation, rows >= n_valid masked to NEG_INF (float32 min), and the
// maximum of every run of G consecutive rows ("bin max").
//
// Replaces the TPU kernels codemix_dense_retrieval_tpu/ops/topk.py::
// _bin_scores_pallas_bm (bin-major outputs: S (B, N), binmax (B, N/G); kernel
// A, bin_scores_kernel below) and ::_bin_scores_pallas (transposed outputs:
// S (N, B), binmax (N/G, B); kernel 2, bin_scores_t_kernel below).
//
// The bin-major kernel with the score store compiled out (STORE = false) is
// kernel 5, "bin max only", which replaces ::_binmax_only_pallas: only the
// bin maxima leave the SM, emitted bin-major (B, N/G) (the TPU kernel writes
// (N/G, B) and its callers transpose at once).
//
// Kernel 7, "binub", replaces codemix_dense_retrieval_tpu/ops/sketch.py::
// _binub_pallas: kernel 5 over the PCA sketch (d = ds = 128, bf16) with one
// more epilogue term, ub = s + d_tail[n] * q_tail[q], the Cauchy-Schwarz
// upper bound of the full-width score, before the mask and the bin max. The
// term is written __fadd_rn(s, __fmul_rn(d_tail, q_tail)) in the JAX order so
// no FMA contraction can fuse it: the kernel differs from its plain version
// only in the order of the ds-long f32 sum. At the sketch tier's main shape
// (B = 256, N = 8,842,240, ds = 128, G = 8) it must read 2.26 GB of sketch and
// 35 MB of tails and write 1.13 GB of bin maxima: 1.02 ms at 3.35 TB/s, above
// the 0.59 ms of bf16 tensor-core work, so bytes bound it as they bound
// kernel 5.
//
// What bounds them on an H100: bytes. At the main path's shape (B = 256
// queries, N = 8,842,240 rows, d = 1024, bf16) kernel A must read D once
// (18.1 GB) and write S (9.05 GB f32) and binmax (1.13 GB): 28.3 GB, 8.4 ms
// at 3.35 TB/s, against 4.64 TFLOP = 4.7 ms at 989 TF/s of bf16 tensor-core
// work. Without the score store: 19.2 GB, 5.74 ms. Kernel 2 at its shape
// (B = 256, N = 131,072): 0.27 GB of D, 0.13 GB of S, 0.12 ms.
//
// Design of kernels A, 5 and 7 (bin-major):
// - a block computes a 128-query x 128-row tile with nvcuda::wmma bf16
//   m16n16k16 fragments (f32 accumulators; each warp 64 queries x 32 rows),
//   looping over d in chunks of 32 staged in shared memory; the next chunk's
//   global loads are issued into registers before the current chunk's
//   products, so they overlap;
// - every query tile re-reads its D tile, so the bytes moved from L2 into
//   the SMs are D * ceil(B / 128) + Q * (N / 128). Blocks are numbered
//   query-tile fastest, so the query tiles that share a D tile run side by
//   side and read it from L2;
// - the epilogue (bin_epilogue.cuh) stages the f32 tile in shared memory,
//   masks it, writes the scores coalesced and reduces each G-row run to its
//   bin max there: the score matrix is written once and never read back.
//
// Design of kernel 2 (transposed), a warp-specialised Hopper kernel
// (sm90.cuh), which removes what held the bin-major loop back there
// (synchronous staging, each D tile read by both 128-query tiles, a 4-way
// bank-conflicted transposed epilogue, 5.2 waves of 3 blocks per SM):
// - S_t = D . Q^T with doc rows as wgmma's M: two consumer warpgroups of 64
//   rows make a 128-row tile, and every query (B <= 256) is wgmma's N
//   (m64n256k16; n128 for B <= 128, n64 for B <= 64), so each D row reaches
//   an SM once; more than 256 queries take 256-query tiles;
// - a producer thread streams 64-dim chunks of the D tile and of Q (128-byte
//   rows, 128-byte swizzle) by TMA into a 4-stage mbarrier ring; the blocks
//   are persistent (one per SM), so the next tile's chunks load while the
//   current tile's epilogue runs; rows past N read as zeros;
// - the epilogue works on the accumulators in registers: rows >= n_valid
//   set to NEG_INF, scores stored straight from the fragments (a quad writes
//   32 contiguous bytes of an (N, B) row), and the bin max without shared
//   memory: a warp's 16 rows are one bin (G = 16) or two (G = 8), so each
//   maximum is the thread's own rows and three __shfl_xor_sync over the
//   lane's row index;
// - what still bounds it: every block re-reads Q (512 KB per 128 rows at
//   d = 1024) from L2, three times the D bytes.
// Every offset into S and binmax is 64-bit: B * N exceeds 2^31 at the main
// path's shape.
// Requirements (checked by the Python wrapper): Q, D bf16 and contiguous,
// d % 32 == 0, N % G == 0, G in {8, 16}.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "bin_epilogue.cuh"
#include "sm90.cuh"

using namespace nvcuda;
using namespace bin_tile;

namespace {

constexpr int TILE_K = 32;
constexpr int LDS = TILE_K + 8;      // bf16 row stride of the staged chunks
constexpr int SQ_BYTES = TILE_Q * LDS * 2;
constexpr int SD_BYTES = TILE_N * LDS * 2;
constexpr int SMEM_BYTES = (SQ_BYTES + SD_BYTES) > SC_BYTES ? (SQ_BYTES + SD_BYTES) : SC_BYTES;

template <int G, bool STORE, bool UB, typename OutT>
__global__ void __launch_bounds__(THREADS)
bin_scores_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ d,
                  OutT* __restrict__ scores,
                  float* __restrict__ binmax,
                  const int* __restrict__ nv_ptr,
                  long long nv_int,
                  int B, long long N, int D, int num_q_tiles,
                  const float* __restrict__ q_tail,
                  const float* __restrict__ d_tail) {
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
  if (UB) {  // kernel 7: add the tail bound, in the JAX order, before the mask
    for (int idx = tid; idx < TILE_Q * TILE_N; idx += THREADS) {
      const int ql = idx / TILE_N;
      const int r = idx % TILE_N;
      const float qt = q0 + ql < B ? q_tail[q0 + ql] : 0.0f;
      const float dt = n0 + r < N ? d_tail[n0 + r] : 0.0f;
      sC[ql * LDC + r] = __fadd_rn(sC[ql * LDC + r], __fmul_rn(dt, qt));
    }
    __syncthreads();
  }

  const long long nv = nv_ptr != nullptr ? static_cast<long long>(*nv_ptr) : nv_int;
  mask_store_binmax<G, true, STORE>(sC, scores, binmax, nv, q0, n0, B, N);
}

template <int G, typename OutT, bool STORE = true, bool UB = false>
void launch(const void* q, const void* d, void* scores, void* binmax, const void* nv_ptr,
            long long nv_int, int B, long long N, int D, unsigned int blocks, int nqt,
            cudaStream_t stream, const void* q_tail = nullptr, const void* d_tail = nullptr) {
  // the 67.6 KB staged tile is above the 48 KB a launch gets by default
  cudaFuncSetAttribute(bin_scores_kernel<G, STORE, UB, OutT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  bin_scores_kernel<G, STORE, UB, OutT><<<blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(d),
      static_cast<OutT*>(scores), static_cast<float*>(binmax),
      static_cast<const int*>(nv_ptr), nv_int, B, N, D, nqt,
      static_cast<const float*>(q_tail), static_cast<const float*>(d_tail));
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

}  // namespace

// Launches kernel A (bin_major) or kernel 2 (transposed) on `stream` and
// returns cudaGetLastError() (0 = ok) or the tensor-map error. n_valid is
// read from the device int32 at nv_ptr when it is not null, else taken from
// nv_int.
extern "C" int bin_scores_launch(const void* q, const void* d, void* scores, void* binmax,
                                 const void* nv_ptr, long long nv_int, int B, long long N,
                                 int D, int G, int bin_major, int score_bf16, void* stream) {
  int nqt = 0;
  const unsigned int blocks = grid_blocks(B, N, D, G, TILE_K, &nqt);
  if (blocks == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bin_major) {
    if (N > INT_MAX) return cudaErrorInvalidValue;  // TMA coordinates are 32-bit
    if (score_bf16)
      return launch_transposed<__nv_bfloat16>(G, q, d, scores, binmax, nv_ptr, nv_int, B, N, D, s);
    return launch_transposed<float>(G, q, d, scores, binmax, nv_ptr, nv_int, B, N, D, s);
  }
  if (G == 8) {
    if (score_bf16)
      launch<8, __nv_bfloat16>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
    else
      launch<8, float>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
  } else {
    if (score_bf16)
      launch<16, __nv_bfloat16>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
    else
      launch<16, float>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
  }
  return static_cast<int>(cudaGetLastError());
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
    launch<8, float, false>(q, d, nullptr, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
  else
    launch<16, float, false>(q, d, nullptr, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
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
  const unsigned int blocks = grid_blocks(B, N, DS, G, TILE_K, &nqt);
  if (blocks == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 8)
    launch<8, float, false, true>(q_sketch, d_sketch, nullptr, binmax, nv_ptr, nv_int, B, N,
                                        DS, blocks, nqt, s, q_tail, d_tail);
  else
    launch<16, float, false, true>(q_sketch, d_sketch, nullptr, binmax, nv_ptr, nv_int, B,
                                         N, DS, blocks, nqt, s, q_tail, d_tail);
  return static_cast<int>(cudaGetLastError());
}

// Fused phase 1 of the exact bin-max-cover top-k over an int8 index (kernel
// 4): int8 x int8 products accumulated exactly in int32, rescaled to f32 per
// row as (f32(acc) * d_scale) * q_scale, rows >= n_valid masked to NEG_INF
// (float32 min), and the maximum of every run of G consecutive rows.
//
// Replaces the TPU kernel codemix_dense_retrieval_tpu/ops/topk.py::
// _bin_scores_pallas_int8 (with _bin_scores_pallas_int8_kernel), in both of
// its output layouts: bin-major S (B, N) + binmax (B, N/G), or transposed
// S (N, B) + binmax (N/G, B).
//
// Exactness: with d <= 1040, |acc| <= 127^2 * d < 2^24, so f32(acc) is exact
// and the two round-to-nearest multiplies in the fixed order reproduce the
// plain version (ops/topk.py::bin_scores_int8_plain) and the JAX package bit
// for bit. The build uses no --use_fast_math, and the multiplies are
// __fmul_rn so they are never contracted into an FMA.
//
// What bounds it on an H100: bytes. At the main path's shape (B = 256
// queries, N = 8,842,240 rows, d = 1024) it must read D once (9.05 GB of
// int8) and write S (9.05 GB f32) and binmax (1.13 GB): 19.2 GB, 5.75 ms at
// 3.35 TB/s, against 4.64 TOP = 2.3 ms at 1,979 TOP/s of int8 tensor-core
// work.
//
// Design (the tiling of kernel A, bin_scores.cu, with int8 operands):
// - a block computes a 128-query x 128-row tile on the tensor cores through
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (each warp 64 queries x
//   32 rows, 64 int32 accumulators per thread). Query rows and doc rows are
//   both K-contiguous, which is the row.col operand order, so ldmatrix
//   without .trans loads both fragments from the staged chunks;
// - d is walked in 64-byte chunks staged in shared memory (row stride 80
//   bytes, so the eight rows of an ldmatrix phase hit distinct banks); the
//   next chunk's global loads are issued into registers before the current
//   chunk's products, so they overlap;
// - the epilogue rescales the accumulators into an f32 tile in shared memory
//   and hands it to the epilogue shared with kernel A (bin_epilogue.cuh):
//   mask, coalesced score store in the requested layout, bin max; every
//   offset into S and binmax is 64-bit (B * N exceeds 2^31).
// Requirements (checked by the Python wrapper): Q, D int8 and contiguous,
// scales f32 and contiguous, d % 64 == 0, N % G == 0, G in {8, 16}.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bin_epilogue.cuh"

using namespace bin_tile;

namespace {

constexpr int TILE_K = 64;           // bytes (= int8 values) of d per chunk
constexpr int LDS = TILE_K + 16;     // byte row stride of the staged chunks
constexpr int SQ_BYTES = TILE_Q * LDS;
constexpr int SD_BYTES = TILE_N * LDS;
constexpr int SMEM_BYTES = (SQ_BYTES + SD_BYTES) > SC_BYTES ? (SQ_BYTES + SD_BYTES) : SC_BYTES;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int8_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int G, bool BIN_MAJOR, typename OutT>
__global__ void __launch_bounds__(THREADS)
bin_scores_int8_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ q_scale,
                       const int8_t* __restrict__ d,
                       const float* __restrict__ d_scale,
                       OutT* __restrict__ scores,
                       float* __restrict__ binmax,
                       const int* __restrict__ nv_ptr,
                       long long nv_int,
                       int B, long long N, int D, int num_q_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem);
  int8_t* sD = reinterpret_cast<int8_t*>(smem + SQ_BYTES);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_q = warp / 4;  // 2 warps along queries: 64 rows each
  const int warp_n = warp % 4;  // 4 warps along doc rows: 32 rows each
  const long long bid = blockIdx.x;
  const int q0 = static_cast<int>(bid % num_q_tiles) * TILE_Q;
  const long long n0 = (bid / num_q_tiles) * TILE_N;

  // global -> register staging: two 16-byte Q vectors and two D vectors per
  // thread per 64-byte chunk (zero outside the arrays)
  const int8_t* q_src[2];
  const int8_t* d_src[2];
  bool q_in[2], d_in[2];
  int row[2], vec[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    row[i] = idx / 4;
    vec[i] = idx % 4;
    q_in[i] = q0 + row[i] < B;
    q_src[i] = q + static_cast<long long>(q0 + row[i]) * D + vec[i] * 16;
    d_in[i] = n0 + row[i] < N;
    d_src[i] = d + (n0 + row[i]) * static_cast<long long>(D) + vec[i] * 16;
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 rq[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rq[i] = q_in[i] ? *reinterpret_cast<const uint4*>(q_src[i]) : zero;
    rd[i] = d_in[i] ? *reinterpret_cast<const uint4*>(d_src[i]) : zero;
  }

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix row addresses: A (16 rows x 32 bytes) takes rows lane % 16,
  // bytes (lane / 16) * 16; B (two 8-row n-tiles x 32 bytes) takes n-tile
  // lane / 16, row lane % 8, bytes ((lane / 8) % 2) * 16
  const int a_row = warp_q * 64 + (lane % 16);
  const int a_col = (lane / 16) * 16;
  const int b_row = warp_n * 32 + (lane / 16) * 8 + (lane % 8);
  const int b_col = ((lane / 8) % 2) * 16;

  for (int k0 = 0; k0 < D; k0 += TILE_K) {
    __syncthreads();  // the previous chunk's fragments are loaded
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(sQ + row[i] * LDS + vec[i] * 16) = rq[i];
      *reinterpret_cast<uint4*>(sD + row[i] * LDS + vec[i] * 16) = rd[i];
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
    for (int kk = 0; kk < TILE_K; kk += 32) {
      uint32_t a[4][4];
      uint32_t b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldsm_x4(a[i], sQ + (a_row + i * 16) * LDS + kk + a_col);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) ldsm_x4(b[jj], sD + (b_row + jj * 16) * LDS + kk + b_col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
  }
  __syncthreads();  // sC aliases the staging buffers

  // accumulator (i, j, e): query row warp_q*64 + i*16 + lane/4 + (e/2)*8,
  // doc row warp_n*32 + j*8 + (lane%4)*2 + e%2
  float ds[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long n = n0 + warp_n * 32 + j * 8 + (lane % 4) * 2 + e;
      ds[j][e] = n < N ? d_scale[n] : 0.0f;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ql = warp_q * 64 + i * 16 + lane / 4 + h * 8;
      const float qs = q0 + ql < B ? q_scale[q0 + ql] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nl = warp_n * 32 + j * 8 + (lane % 4) * 2;
        float2 v;
        v.x = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][h * 2]), ds[j][0]), qs);
        v.y = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][h * 2 + 1]), ds[j][1]), qs);
        *reinterpret_cast<float2*>(sC + ql * LDC + nl) = v;
      }
    }
  __syncthreads();

  const long long nv = nv_ptr != nullptr ? static_cast<long long>(*nv_ptr) : nv_int;
  mask_store_binmax<G, BIN_MAJOR, true>(sC, scores, binmax, nv, q0, n0, B, N);
}

template <int G, bool BIN_MAJOR, typename OutT>
void launch(const void* q, const void* qs, const void* d, const void* ds, void* scores,
            void* binmax, const void* nv_ptr, long long nv_int, int B, long long N, int D,
            unsigned int blocks, int nqt, cudaStream_t stream) {
  // the 67.6 KB staged tile is above the 48 KB a launch gets by default
  cudaFuncSetAttribute(bin_scores_int8_kernel<G, BIN_MAJOR, OutT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  bin_scores_int8_kernel<G, BIN_MAJOR, OutT><<<blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qs),
      static_cast<const int8_t*>(d), static_cast<const float*>(ds),
      static_cast<OutT*>(scores), static_cast<float*>(binmax),
      static_cast<const int*>(nv_ptr), nv_int, B, N, D, nqt);
}

template <int G>
void dispatch(int bin_major, int score_bf16, const void* q, const void* qs, const void* d,
              const void* ds, void* scores, void* binmax, const void* nv_ptr, long long nv_int,
              int B, long long N, int D, unsigned int blocks, int nqt, cudaStream_t stream) {
  if (bin_major) {
    if (score_bf16)
      launch<G, true, __nv_bfloat16>(q, qs, d, ds, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, stream);
    else
      launch<G, true, float>(q, qs, d, ds, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, stream);
  } else {
    if (score_bf16)
      launch<G, false, __nv_bfloat16>(q, qs, d, ds, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, stream);
    else
      launch<G, false, float>(q, qs, d, ds, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, stream);
  }
}

}  // namespace

// Launches kernel 4 on `stream` and returns cudaGetLastError() (0 = ok).
// n_valid is read from the device int32 at nv_ptr when it is not null, else
// taken from nv_int.
extern "C" int bin_scores_int8_launch(const void* q, const void* q_scale, const void* d,
                                      const void* d_scale, void* scores, void* binmax,
                                      const void* nv_ptr, long long nv_int, int B, long long N,
                                      int D, int G, int bin_major, int score_bf16, void* stream) {
  int nqt = 0;
  const unsigned int nb = grid_blocks(B, N, D, G, TILE_K, &nqt);
  if (nb == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 8)
    dispatch<8>(bin_major, score_bf16, q, q_scale, d, d_scale, scores, binmax, nv_ptr, nv_int,
                B, N, D, nb, nqt, s);
  else
    dispatch<16>(bin_major, score_bf16, q, q_scale, d, d_scale, scores, binmax, nv_ptr, nv_int,
                 B, N, D, nb, nqt, s);
  return static_cast<int>(cudaGetLastError());
}

// Fused phase 1 of the exact bin-max-cover top-k: scores S = Q . D^T with
// f32 accumulation, rows >= n_valid masked to NEG_INF (float32 min), and the
// maximum of every run of G consecutive rows ("bin max").
//
// Replaces the TPU kernels codemix_dense_retrieval_tpu/ops/topk.py::
// _bin_scores_pallas_bm (bin-major outputs: S (B, N), binmax (B, N/G)) and
// ::_bin_scores_pallas (transposed outputs: S (N, B), binmax (N/G, B)); one
// kernel serves both through its layout template argument.
//
// The same kernel with the score store compiled out (STORE = false) is
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
// What bounds it on an H100: bytes. At the main path's shape (B = 256
// queries, N = 8,842,240 rows, d = 1024, bf16) it must read D once (18.1 GB)
// and write S (9.05 GB f32) and binmax (1.13 GB): 28.3 GB, 8.4 ms at
// 3.35 TB/s, against 4.64 TFLOP = 4.7 ms at 989 TF/s of bf16 tensor-core work.
// Without the score store: 19.2 GB, 5.74 ms.
//
// Design:
// - a block computes a 128-query x 128-row tile with nvcuda::wmma bf16
//   m16n16k16 fragments (f32 accumulators; each warp 64 queries x 32 rows),
//   looping over d in chunks of 32 staged in shared memory; the next chunk's
//   global loads are issued into registers before the current chunk's
//   products, so they overlap;
// - every query tile re-reads its D tile, so the bytes moved from L2 into
//   the SMs are D * ceil(B / 128) + Q * (N / 128): 128-query tiles halve the
//   D re-reads of 64-query ones (72 GB instead of 108 GB per 256-query call
//   at the main path's shape). Blocks are numbered query-tile fastest, so the
//   query tiles that share a D tile run side by side and read it from L2;
// - the epilogue (bin_epilogue.cuh) stages the f32 tile in shared memory,
//   masks it, writes the scores coalesced in the requested layout and
//   reduces each G-row run to its bin max there: the score matrix is written
//   once and never read back;
// - every offset into S and binmax is 64-bit: B * N exceeds 2^31 at the main
//   path's shape.
// Requirements (checked by the Python wrapper): Q, D bf16 and contiguous,
// d % 32 == 0, N % G == 0, G in {8, 16}.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "bin_epilogue.cuh"

using namespace nvcuda;
using namespace bin_tile;

namespace {

constexpr int TILE_K = 32;
constexpr int LDS = TILE_K + 8;      // bf16 row stride of the staged chunks
constexpr int SQ_BYTES = TILE_Q * LDS * 2;
constexpr int SD_BYTES = TILE_N * LDS * 2;
constexpr int SMEM_BYTES = (SQ_BYTES + SD_BYTES) > SC_BYTES ? (SQ_BYTES + SD_BYTES) : SC_BYTES;

template <int G, bool BIN_MAJOR, bool STORE, bool UB, typename OutT>
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
  mask_store_binmax<G, BIN_MAJOR, STORE>(sC, scores, binmax, nv, q0, n0, B, N);
}

template <int G, bool BIN_MAJOR, typename OutT, bool STORE = true, bool UB = false>
void launch(const void* q, const void* d, void* scores, void* binmax, const void* nv_ptr,
            long long nv_int, int B, long long N, int D, unsigned int blocks, int nqt,
            cudaStream_t stream, const void* q_tail = nullptr, const void* d_tail = nullptr) {
  // the 67.6 KB staged tile is above the 48 KB a launch gets by default
  cudaFuncSetAttribute(bin_scores_kernel<G, BIN_MAJOR, STORE, UB, OutT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  bin_scores_kernel<G, BIN_MAJOR, STORE, UB, OutT><<<blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(d),
      static_cast<OutT*>(scores), static_cast<float*>(binmax),
      static_cast<const int*>(nv_ptr), nv_int, B, N, D, nqt,
      static_cast<const float*>(q_tail), static_cast<const float*>(d_tail));
}

template <int G>
void dispatch(int bin_major, int score_bf16, const void* q, const void* d, void* scores,
              void* binmax, const void* nv_ptr, long long nv_int, int B, long long N, int D,
              unsigned int blocks, int nqt, cudaStream_t stream) {
  if (bin_major) {
    if (score_bf16)
      launch<G, true, __nv_bfloat16>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, stream);
    else
      launch<G, true, float>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, stream);
  } else {
    if (score_bf16)
      launch<G, false, __nv_bfloat16>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, stream);
    else
      launch<G, false, float>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, stream);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// n_valid is read from the device int32 at nv_ptr when it is not null, else
// taken from nv_int.
extern "C" int bin_scores_launch(const void* q, const void* d, void* scores, void* binmax,
                                 const void* nv_ptr, long long nv_int, int B, long long N,
                                 int D, int G, int bin_major, int score_bf16, void* stream) {
  int nqt = 0;
  const unsigned int blocks = grid_blocks(B, N, D, G, TILE_K, &nqt);
  if (blocks == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 8)
    dispatch<8>(bin_major, score_bf16, q, d, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
  else
    dispatch<16>(bin_major, score_bf16, q, d, scores, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
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
    launch<8, true, float, false>(q, d, nullptr, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
  else
    launch<16, true, float, false>(q, d, nullptr, binmax, nv_ptr, nv_int, B, N, D, blocks, nqt, s);
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
    launch<8, true, float, false, true>(q_sketch, d_sketch, nullptr, binmax, nv_ptr, nv_int, B, N,
                                        DS, blocks, nqt, s, q_tail, d_tail);
  else
    launch<16, true, float, false, true>(q_sketch, d_sketch, nullptr, binmax, nv_ptr, nv_int, B,
                                         N, DS, blocks, nqt, s, q_tail, d_tail);
  return static_cast<int>(cudaGetLastError());
}

// Fused phase 1 of the exact bin-max-cover top-k: scores S = Q . D^T with
// f32 accumulation, rows >= n_valid masked to NEG_INF (float32 min), and the
// maximum of every run of G consecutive rows ("bin max").
//
// Replaces the TPU kernels codemix_dense_retrieval_tpu/ops/topk.py::
// _bin_scores_pallas_bm (bin-major outputs: S (B, N), binmax (B, N/G)) and
// ::_bin_scores_pallas (transposed outputs: S (N, B), binmax (N/G, B)); one
// kernel serves both through its layout template argument.
//
// What bounds it on an H100: bytes. At the main path's shape (B = 256
// queries, N = 8,842,240 rows, d = 1024, bf16) it must read D once (18.1 GB)
// and write S (9.05 GB f32) and binmax (1.13 GB): 28.3 GB, 8.4 ms at
// 3.35 TB/s, against 4.64 TFLOP = 4.7 ms at 989 TF/s of bf16 tensor-core work.
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
// - the epilogue stages the f32 tile in shared memory, masks it, writes the
//   scores coalesced in the requested layout and reduces each G-row run to its
//   bin max there: the score matrix is written once and never read back;
// - every offset into S and binmax is 64-bit: B * N exceeds 2^31 at the main
//   path's shape.
// Requirements (checked by the Python wrapper): Q, D bf16 and contiguous,
// d % 32 == 0, N % G == 0, G in {8, 16}.

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int TILE_Q = 128;
constexpr int TILE_N = 128;
constexpr int TILE_K = 32;
constexpr int THREADS = 256;
constexpr int LDS = TILE_K + 8;      // bf16 row stride of the staged chunks
constexpr int LDC = TILE_N + 4;      // f32 row stride of the staged tile
constexpr int SQ_BYTES = TILE_Q * LDS * 2;
constexpr int SD_BYTES = TILE_N * LDS * 2;
constexpr int SC_BYTES = TILE_Q * LDC * 4;
constexpr int SMEM_BYTES = (SQ_BYTES + SD_BYTES) > SC_BYTES ? (SQ_BYTES + SD_BYTES) : SC_BYTES;
constexpr float NEG_INF = -FLT_MAX;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void store_out4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_out4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

template <int G, bool BIN_MAJOR, typename OutT>
__global__ void __launch_bounds__(THREADS)
bin_scores_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ d,
                  OutT* __restrict__ scores,
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
  if (BIN_MAJOR) {
    // S row q is contiguous along n: 4 rows per thread, one vector store
    for (int idx = tid; idx < TILE_Q * (TILE_N / 4); idx += THREADS) {
      const int ql = idx / (TILE_N / 4);
      const int r = (idx % (TILE_N / 4)) * 4;
      const long long n = n0 + r;
      float4 v = *reinterpret_cast<float4*>(sC + ql * LDC + r);
      v.x = n + 0 < nv ? v.x : NEG_INF;
      v.y = n + 1 < nv ? v.y : NEG_INF;
      v.z = n + 2 < nv ? v.z : NEG_INF;
      v.w = n + 3 < nv ? v.w : NEG_INF;
      *reinterpret_cast<float4*>(sC + ql * LDC + r) = v;
      if (q0 + ql < B && n < N)  // N % 4 == 0: the 4 rows are all in or all out
        store_out4(scores + static_cast<long long>(q0 + ql) * N + n, v);
    }
  } else {
    // S row n is contiguous along q: consecutive threads take consecutive q
    for (int idx = tid; idx < TILE_Q * TILE_N; idx += THREADS) {
      const int r = idx / TILE_Q;
      const int ql = idx % TILE_Q;
      const long long n = n0 + r;
      float v = sC[ql * LDC + r];
      v = n < nv ? v : NEG_INF;
      sC[ql * LDC + r] = v;
      if (q0 + ql < B && n < N) store_out(scores + n * B + (q0 + ql), v);
    }
  }
  __syncthreads();

  constexpr int NB = TILE_N / G;
  const long long nb_total = N / G;
  const long long b0 = n0 / G;
  for (int idx = tid; idx < TILE_Q * NB; idx += THREADS) {
    int ql, j;
    if (BIN_MAJOR) {
      ql = idx / NB;
      j = idx % NB;
    } else {
      j = idx / TILE_Q;
      ql = idx % TILE_Q;
    }
    const float* row = sC + ql * LDC + j * G;
    float m = row[0];
#pragma unroll
    for (int t = 1; t < G; ++t) m = fmaxf(m, row[t]);
    const long long bin = b0 + j;
    if (q0 + ql < B && bin < nb_total) {
      if (BIN_MAJOR)
        binmax[static_cast<long long>(q0 + ql) * nb_total + bin] = m;
      else
        binmax[bin * B + (q0 + ql)] = m;
    }
  }
}

template <int G, bool BIN_MAJOR, typename OutT>
void launch(const void* q, const void* d, void* scores, void* binmax, const void* nv_ptr,
            long long nv_int, int B, long long N, int D, unsigned int blocks, int nqt,
            cudaStream_t stream) {
  // the 67.6 KB staged tile is above the 48 KB a launch gets by default
  cudaFuncSetAttribute(bin_scores_kernel<G, BIN_MAJOR, OutT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  bin_scores_kernel<G, BIN_MAJOR, OutT><<<blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(d),
      static_cast<OutT*>(scores), static_cast<float*>(binmax),
      static_cast<const int*>(nv_ptr), nv_int, B, N, D, nqt);
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
  if (B <= 0 || N <= 0 || D <= 0 || D % TILE_K != 0 || N % 4 != 0) return cudaErrorInvalidValue;
  if (G != 8 && G != 16) return cudaErrorInvalidValue;
  if (N % G != 0) return cudaErrorInvalidValue;
  const int nqt = (B + TILE_Q - 1) / TILE_Q;
  const long long nnt = (N + TILE_N - 1) / TILE_N;
  const long long blocks = nnt * nqt;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 8)
    dispatch<8>(bin_major, score_bf16, q, d, scores, binmax, nv_ptr, nv_int, B, N, D,
                static_cast<unsigned int>(blocks), nqt, s);
  else
    dispatch<16>(bin_major, score_bf16, q, d, scores, binmax, nv_ptr, nv_int, B, N, D,
                 static_cast<unsigned int>(blocks), nqt, s);
  return static_cast<int>(cudaGetLastError());
}

// Shared epilogue of the bin-score kernels (bin_scores.cu, bin_scores_int8.cu):
// a block's f32 score tile, staged query-major in shared memory, is masked
// (rows >= n_valid -> NEG_INF, float32 min), optionally written to S in the
// bin-major (B, N) or transposed (N, B) layout, and reduced to the maximum of
// every run of G consecutive rows, written to binmax (B, N/G) or (N/G, B).
// Every offset into S and binmax is 64-bit: B * N exceeds 2^31 at the main
// path's shape.
#pragma once

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bin_tile {

constexpr int TILE_Q = 128;          // queries per block
constexpr int TILE_N = 128;          // doc rows per block
constexpr int THREADS = 256;
constexpr int LDC = TILE_N + 4;      // f32 row stride of the staged tile
constexpr int SC_BYTES = TILE_Q * LDC * 4;
constexpr float NEG_INF = -FLT_MAX;

// Grid size for B queries x N rows (query tile fastest, *nqt query tiles),
// or 0 when the shape is refused: d must be a multiple of the kernel's K
// chunk `k_multiple`, N of 4 and of G, and G is 8 or 16.
inline unsigned int grid_blocks(int B, long long N, int D, int G, int k_multiple, int* nqt) {
  if (B <= 0 || N <= 0 || D <= 0 || D % k_multiple != 0 || N % 4 != 0) return 0;
  if (G != 8 && G != 16) return 0;
  if (N % G != 0) return 0;
  *nqt = (B + TILE_Q - 1) / TILE_Q;
  const long long nnt = (N + TILE_N - 1) / TILE_N;
  const long long blocks = nnt * *nqt;
  if (blocks > INT_MAX) return 0;
  return static_cast<unsigned int>(blocks);
}

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

// sC holds the tile's TILE_Q x TILE_N scores (row = query, col = doc row),
// row stride LDC. The caller has synchronised after filling it. With STORE
// false the score matrix is never written: only the bin maxima leave the SM.
template <int G, bool BIN_MAJOR, bool STORE, typename OutT>
__device__ __forceinline__ void mask_store_binmax(float* sC, OutT* __restrict__ scores,
                                                  float* __restrict__ binmax, long long nv,
                                                  int q0, long long n0, int B, long long N) {
  const int tid = threadIdx.x;
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
      if (STORE && q0 + ql < B && n < N)  // N % 4 == 0: the 4 rows are all in or all out
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
      if (STORE && q0 + ql < B && n < N) store_out(scores + n * B + (q0 + ql), v);
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

}  // namespace bin_tile

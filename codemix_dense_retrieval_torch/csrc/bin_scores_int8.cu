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
// Design: the templates of bin_kernels.cuh with int8 operands and the
// rescale epilogue (EPI_RESCALE): the bin-major layout runs
// bin_scores_bm_kernel (kernel A's skeleton: queries as wgmma's M, 128 doc
// rows as its N), the transposed layout bin_scores_t_kernel (kernel 2's: doc
// rows as M, queries as N), both on wgmma.m64nNk32.s32.s8.s8 with both
// operands K-major (integer wgmma takes no transpose). A stage's 128-byte
// swizzled row holds 128 int8 dims, so d = 1024 is 8 stages' worth of chunks
// (16 for bf16), and a k32 step is 32 bytes as a bf16 k16 step is.
//
// Exactness: with d <= 1040, |acc| <= 127^2 * d < 2^24, so f32(acc) is exact
// whatever order the tensor cores sum the integers in, and the two
// round-to-nearest multiplies in the fixed order reproduce the plain version
// (ops/topk.py::bin_scores_int8_plain) and the JAX package bit for bit. The
// build uses no --use_fast_math, and the multiplies are __fmul_rn so they are
// never contracted into an FMA. A bf16 score rounds from that f32 value.
//
// What bounds it on an H100: bytes. At the main path's shape (B = 256
// queries, N = 8,842,240 rows, d = 1024) it must read D once (9.05 GB of
// int8) and write S (9.05 GB f32) and binmax (1.13 GB): 19.2 GB, 5.75 ms at
// 3.35 TB/s, against 4.64 TOP = 2.3 ms at 1,979 TOP/s of int8 tensor-core
// work. Transposed at B = 256, N = 131,072: 0.28 GB, 0.083 ms.
// Requirements (checked by the Python wrapper): Q, D int8, contiguous and
// 16-byte aligned, scales f32 and contiguous, d % 64 == 0, N % G == 0, G in
// {8, 16}; N < 2^31 (TMA coordinates are 32-bit).

#include "bin_kernels.cuh"

// Launches kernel 4 on `stream` and returns cudaGetLastError() (0 = ok) or
// the tensor-map error. n_valid is read from the device int32 at nv_ptr when
// it is not null, else taken from nv_int.
extern "C" int bin_scores_int8_launch(const void* q, const void* q_scale, const void* d,
                                      const void* d_scale, void* scores, void* binmax,
                                      const void* nv_ptr, long long nv_int, int B, long long N,
                                      int D, int G, int bin_major, int score_bf16, void* stream) {
  using bf16 = __nv_bfloat16;
  if (!shape_ok(B, N, D, G, 64)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bin_major) {
    if (score_bf16)
      return launch_transposed<int8_t, bf16, EPI_RESCALE>(G, q, d, scores, binmax, nv_ptr, nv_int,
                                                          q_scale, d_scale, B, N, D, s);
    return launch_transposed<int8_t, float, EPI_RESCALE>(G, q, d, scores, binmax, nv_ptr, nv_int,
                                                         q_scale, d_scale, B, N, D, s);
  }
  if (score_bf16)
    return launch_bin_major<int8_t, bf16, EPI_RESCALE, true>(G, q, d, scores, binmax, nv_ptr, nv_int,
                                                             q_scale, d_scale, B, N, D, s);
  return launch_bin_major<int8_t, float, EPI_RESCALE, true>(G, q, d, scores, binmax, nv_ptr, nv_int,
                                                            q_scale, d_scale, B, N, D, s);
}

// Kernels A, 2 and 5 over an f16 index: the templates of bin_kernels.cuh
// with f16 operands (wgmma m64nNk16.f32.f16.f16). f16 x f16 products are
// exact in f32, as bf16's are, so the scores differ from the plain version
// (ops/topk.py::bin_scores_plain) only in the order of the f32 sums.
//
// Replaces, for f16 indexes (the JAX package casts the queries to the index
// dtype and runs the same Pallas kernels on f16 operands):
// codemix_dense_retrieval_tpu/ops/topk.py::_bin_scores_pallas_bm (kernel A),
// ::_bin_scores_pallas (kernel 2) and ::_binmax_only_pallas (kernel 5).
//
// What bounds them on an H100: bytes, as for bf16 (the same 2-byte rows):
// kernel A at B = 256, N = 8,842,240, d = 1024 moves 28.3 GB, 8.45 ms at
// 3.35 TB/s, above 4.7 ms of f16 tensor-core work; kernel 5 19.2 GB, 5.74 ms;
// kernel 2 at N = 131,072 0.41 GB, 0.123 ms.
// Requirements (checked by the Python wrapper): Q, D f16, contiguous and
// 16-byte aligned, d % 32 == 0, N % G == 0, G in {8, 16}; N < 2^31.

#include "bin_kernels.cuh"

// Kernel A (bin_major) or kernel 2 (transposed); arguments and return value
// as bin_scores.cu's bin_scores_launch.
extern "C" int bin_scores_launch(const void* q, const void* d, void* scores, void* binmax,
                                 const void* nv_ptr, long long nv_int, int B, long long N,
                                 int D, int G, int bin_major, int score_bf16, void* stream) {
  return bin_scores_any<__half>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, G, bin_major,
                                score_bf16, static_cast<cudaStream_t>(stream));
}

// Kernel 5: the bin maxima alone, bin-major (B, N/G).
extern "C" int binmax_only_launch(const void* q, const void* d, void* binmax, const void* nv_ptr,
                                  long long nv_int, int B, long long N, int D, int G,
                                  void* stream) {
  return binmax_only_any<__half>(q, d, binmax, nv_ptr, nv_int, B, N, D, G,
                                 static_cast<cudaStream_t>(stream));
}

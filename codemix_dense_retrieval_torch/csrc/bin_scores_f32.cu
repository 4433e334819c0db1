// Kernels A, 2, 5 and 7 over f32 operands: the templates of bin_kernels.cuh
// with f32-faithful products on the tf32 tensor cores (3xTF32: every stage's
// values split in shared memory into tf32 hi + lo, three wgmma
// m64nNk8.f32.tf32.tf32 per k step, hi.hi + hi.lo + lo.hi; each 32-dim chunk
// accumulated in a fresh fragment and added to a running sum with __fadd_rn;
// see Operand<float>). No operand is rounded to bf16 or to one tf32: the
// scores stay within 2e-6 of f32 products on unit rows at d = 1024
// (chip_smoke.py's TOL_F32), where one tf32 pass would miss by ~1e-3.
//
// Replaces, for f32 indexes and the f32 sketch tier (the JAX package runs the
// same Pallas kernels on f32 operands, the sketch kernel at
// Precision.HIGHEST): codemix_dense_retrieval_tpu/ops/topk.py::
// _bin_scores_pallas_bm (kernel A), ::_bin_scores_pallas (kernel 2),
// ::_binmax_only_pallas (kernel 5) and ops/sketch.py::_binub_pallas
// (kernel 7, f32 sketch; its tail term __fadd_rn(s, __fmul_rn(d_tail,
// q_tail)) as in the bf16 instance).
//
// What bounds them on an H100: operations, counted as f32-faithful work, the
// three tf32 passes at 494.7 TF/s. Kernel A at B = 256, N = 8,842,240,
// d = 1024: 3 x 4.64 TFLOP, 28.1 ms, above the 46.4 GB it moves (13.9 ms);
// kernel 5 28.1 ms (37.4 GB, 11.2 ms); kernel 2 at N = 131,072 0.42 ms;
// kernel 7 at ds = 128 3.5 ms (5.66 GB, 1.69 ms). The design spends more:
// the split is a pass over shared memory per stage, query tiles hold at most
// 128 queries (two accumulators), and each chunk's products finish before
// the next chunk's start.
// Requirements (checked by the Python wrapper): Q, D f32, contiguous and
// 16-byte aligned, d % 32 == 0, N % G == 0, G in {8, 16}; N < 2^31.

#include "bin_kernels.cuh"

// Kernel A (bin_major) or kernel 2 (transposed); arguments and return value
// as bin_scores.cu's bin_scores_launch.
extern "C" int bin_scores_launch(const void* q, const void* d, void* scores, void* binmax,
                                 const void* nv_ptr, long long nv_int, int B, long long N,
                                 int D, int G, int bin_major, int score_bf16, void* stream) {
  return bin_scores_any<float>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, G, bin_major,
                               score_bf16, static_cast<cudaStream_t>(stream));
}

// Kernel 5: the bin maxima alone, bin-major (B, N/G).
extern "C" int binmax_only_launch(const void* q, const void* d, void* binmax, const void* nv_ptr,
                                  long long nv_int, int B, long long N, int D, int G,
                                  void* stream) {
  return binmax_only_any<float>(q, d, binmax, nv_ptr, nv_int, B, N, D, G,
                                static_cast<cudaStream_t>(stream));
}

// Kernel 7 over an f32 sketch: q_sketch (B, ds), d_sketch (N, ds) f32, tails
// f32; arguments and return value as bin_scores.cu's binub_launch.
extern "C" int binub_launch(const void* q_sketch, const void* q_tail, const void* d_sketch,
                            const void* d_tail, void* binmax, const void* nv_ptr,
                            long long nv_int, int B, long long N, int DS, int G, void* stream) {
  return binub_any<float>(q_sketch, q_tail, d_sketch, d_tail, binmax, nv_ptr, nv_int, B, N, DS, G,
                          static_cast<cudaStream_t>(stream));
}

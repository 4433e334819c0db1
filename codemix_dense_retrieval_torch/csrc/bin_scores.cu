// Fused phase 1 of the exact bin-max-cover top-k over a bf16 index: scores
// S = Q . D^T with f32 accumulation, rows >= n_valid masked to NEG_INF
// (float32 min), and the maximum of every run of G consecutive rows ("bin
// max"). The kernels are the templates of bin_kernels.cuh with bf16 operands.
//
// Replaces the TPU kernels codemix_dense_retrieval_tpu/ops/topk.py::
// _bin_scores_pallas_bm (bin-major outputs: S (B, N), binmax (B, N/G); kernel
// A, bin_scores_bm_kernel) and ::_bin_scores_pallas (transposed outputs:
// S (N, B), binmax (N/G, B); kernel 2, bin_scores_t_kernel).
//
// Kernel 5, "bin max only", replaces ::_binmax_only_pallas: kernel A with the
// score store compiled out, so only the bin maxima leave the SM, emitted
// bin-major (B, N/G) (the TPU kernel writes (N/G, B) and its callers transpose
// at once).
//
// Kernel 7, "binub", replaces codemix_dense_retrieval_tpu/ops/sketch.py::
// _binub_pallas: kernel A over the PCA sketch (d = ds, bf16) with the score
// store compiled out and one more epilogue term, ub = s + d_tail[n] *
// q_tail[q], the Cauchy-Schwarz upper bound of the full-width score, before
// the mask and the bin max. The term is written __fadd_rn(s, __fmul_rn(d_tail,
// q_tail)) in the JAX order so no FMA contraction can fuse it: the kernel
// differs from its plain version only in the order of the ds-long f32 sum.
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
// Measured on an H100 (scripts/torch_kernel_ab.py): kernel A's main loop
// alone reads D at ~3.0 TB/s; its time above that is the 9.05 GB of S
// written beside the reads. Kernel 7's epilogue (tail term, mask, bin max,
// stores) costs more than its main loop.
// Requirements (checked by the Python wrapper): Q, D bf16, contiguous and
// 16-byte aligned, d % 32 == 0, N % G == 0, G in {8, 16}; N < 2^31 (TMA
// coordinates are 32-bit).

#include "bin_kernels.cuh"

using bf16 = __nv_bfloat16;

// Launches kernel A (bin_major) or kernel 2 (transposed) on `stream` and
// returns cudaGetLastError() (0 = ok) or the tensor-map error. n_valid is
// read from the device int32 at nv_ptr when it is not null, else taken from
// nv_int.
extern "C" int bin_scores_launch(const void* q, const void* d, void* scores, void* binmax,
                                 const void* nv_ptr, long long nv_int, int B, long long N,
                                 int D, int G, int bin_major, int score_bf16, void* stream) {
  return bin_scores_any<bf16>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, G, bin_major,
                              score_bf16, static_cast<cudaStream_t>(stream));
}

// Kernel 5: the bin maxima alone, bin-major (B, N/G); same requirements and
// return value as bin_scores_launch.
extern "C" int binmax_only_launch(const void* q, const void* d, void* binmax, const void* nv_ptr,
                                  long long nv_int, int B, long long N, int D, int G,
                                  void* stream) {
  return binmax_only_any<bf16>(q, d, binmax, nv_ptr, nv_int, B, N, D, G,
                               static_cast<cudaStream_t>(stream));
}

// Kernel 7: bin maxima (B, N/G), bin-major, of the sketch upper bound
// s_q . s_x + q_tail[q] * d_tail[x] with rows >= n_valid masked; q_sketch
// (B, ds) and d_sketch (N, ds) bf16, tails f32. Same requirements and return
// value as bin_scores_launch (ds % 32 == 0).
extern "C" int binub_launch(const void* q_sketch, const void* q_tail, const void* d_sketch,
                            const void* d_tail, void* binmax, const void* nv_ptr,
                            long long nv_int, int B, long long N, int DS, int G, void* stream) {
  return binub_any<bf16>(q_sketch, q_tail, d_sketch, d_tail, binmax, nv_ptr, nv_int, B, N, DS, G,
                         static_cast<cudaStream_t>(stream));
}

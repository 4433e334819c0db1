// Kernels A, 2, 5 and 7 over f32 operands: bin_kernels.cuh's bin_scores_f32_kernel
// with f32-faithful products on the tf32 tensor cores (3xTF32: every value
// split into tf32 hi + lo, three wgmma m64nNk8.f32.tf32.tf32 per k step,
// hi.hi + hi.lo + lo.hi; each 32-dim chunk accumulated in a fresh fragment
// and added to a running sum with __fadd_rn; see Operand<float>). No operand
// is rounded to bf16 or to one tf32: the scores stay within 2e-6 of f32
// products on unit rows at d = 1024 (chip_smoke.py's TOL_F32), where one
// tf32 pass would miss by ~1e-3.
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
// kernel 7 at ds = 128 3.5 ms (5.66 GB, 1.69 ms). Past the tensor cores,
// shared memory: with the queries as wgmma's M (the template's bin-major
// layout), each 32-dim chunk of a 128 x 128 tile cost 144 KB of SS wgmma
// reads, 48 KB of TMA writes and a 48 KB split pass in place, ~240 KB
// against the SM's 128 bytes per clock, ~1.3x the chunk's tensor time, and
// the split sat on the consumers' path (68.75 ms, 2.4x the bound).
// bin_scores_f32_kernel (both layouts: kernels A, 5, 7 bin-major, 2
// transposed) turns the roles round: doc rows are M, read into registers by
// ldmatrix and split there, fed as wgmma's register A operand; the queries
// are split once per call by tf32_split_kernel (2 MB at B = 256) and both
// planes stream by TMA beside D, so wgmma reads only them from shared memory
// (~160 KB a chunk, below the tensor time) and no thread rewrites a stage.
// Query tiles hold at most 128 queries (the fresh fragment plus the running
// sum).
// Requirements (checked by the Python wrapper): Q, D f32, contiguous and
// 16-byte aligned, d % 32 == 0, N % G == 0, G in {8, 16}; N < 2^31. Every
// entry takes the queries as their (2, B, d) split (tf32_split_launch).

#include "bin_kernels.cuh"

namespace {

// out[0 .. n) = hi = tf32(x) and out[n .. 2n) = lo = tf32(x - hi), as
// bin_scores_f32_kernel splits the rows in registers; n4 = n / 4
__global__ void tf32_split_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                  long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = x[i];
    const float4 h = make_float4(sm90::tf32_rna(v.x), sm90::tf32_rna(v.y), sm90::tf32_rna(v.z),
                                 sm90::tf32_rna(v.w));
    out[i] = h;
    out[n4 + i] = make_float4(sm90::tf32_rna(v.x - h.x), sm90::tf32_rna(v.y - h.y),
                              sm90::tf32_rna(v.z - h.z), sm90::tf32_rna(v.w - h.w));
  }
}

}  // namespace

// The queries' tf32 split for the entries below: x (n f32, n % 4
// == 0, 16-byte aligned) into out (2n f32: hi, then lo). Returns
// cudaGetLastError().
extern "C" int tf32_split_launch(const void* x, void* out, long long n, void* stream) {
  if (n <= 0 || n % 4) return cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const long long blocks = (n4 + 255) / 256;
  tf32_split_kernel<<<static_cast<unsigned int>(blocks < 1024 ? blocks : 1024), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(static_cast<const float4*>(x),
                                                           static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// Kernel A (bin_major) or kernel 2 (transposed); arguments and return value
// as bin_scores.cu's bin_scores_launch, but q is the (2, B, d) split of the
// queries (tf32_split_launch) in both layouts.
extern "C" int bin_scores_launch(const void* q, const void* d, void* scores, void* binmax,
                                 const void* nv_ptr, long long nv_int, int B, long long N,
                                 int D, int G, int bin_major, int score_bf16, void* stream) {
  return bin_scores_any<float>(q, d, scores, binmax, nv_ptr, nv_int, B, N, D, G, bin_major,
                               score_bf16, static_cast<cudaStream_t>(stream));
}

// Kernel 5: the bin maxima alone, bin-major (B, N/G); q the (2, B, d) split.
extern "C" int binmax_only_launch(const void* q, const void* d, void* binmax, const void* nv_ptr,
                                  long long nv_int, int B, long long N, int D, int G,
                                  void* stream) {
  return binmax_only_any<float>(q, d, binmax, nv_ptr, nv_int, B, N, D, G,
                                static_cast<cudaStream_t>(stream));
}

// Kernel 7 over an f32 sketch: q_sketch the (2, B, ds) split of the query
// sketch (tf32_split_launch), d_sketch (N, ds) f32, tails f32; arguments and
// return value as bin_scores.cu's binub_launch.
extern "C" int binub_launch(const void* q_sketch, const void* q_tail, const void* d_sketch,
                            const void* d_tail, void* binmax, const void* nv_ptr,
                            long long nv_int, int B, long long N, int DS, int G, void* stream) {
  return binub_any<float>(q_sketch, q_tail, d_sketch, d_tail, binmax, nv_ptr, nv_int, B, N, DS, G,
                          static_cast<cudaStream_t>(stream));
}

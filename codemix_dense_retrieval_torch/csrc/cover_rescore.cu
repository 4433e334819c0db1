// The scores of the rows a two-level bin-max cover selected, for the route
// whose phase 1 writes bin maxima only (kernel 5): for query b and covered
// bin j of b's (B, KB) bin ids (ascending, as ops/topk.py's
// _select_bins_two_level returns them), out[b, j * G + i] is the score of row
// bins[b, j] * G + i, NEG_INF (float32 min) where that row is >= n_valid.
//
// Replaces no TPU kernel: the JAX package's exact search keeps kernel A's
// score store and gathers these scores from it. Without the store (9.05 GB of
// f32 per 256-query launch at B = 256, N = 8,842,240, d = 1024) phase 1 is
// kernel 5, which writes only the bin maxima, and this kernel computes the
// k * G candidates' scores a query needs.
//
// Bit for bit the values kernel A would have stored. Each score is summed by
// the instruction kernel A sums it with at the same batch (bin_kernels.cuh,
// bin_scores_bm_kernel): wgmma m64n128k16 (m64n64k16 where B <= 64, kernel
// A's 64-query tile), bf16 or f16 -> f32, both operands from 128-byte
// swizzled shared memory, the query as operand A (wgmma's M) and 128 (64)
// doc rows as operand B (its N), over the same 64-dim chunks in ascending
// order, 4 k16 steps each, the accumulator started with scale_d = 0; dims
// past d read as zeros, as TMA zero-fills them for kernel A. So kernel 5's
// bin maxima are the maxima of these scores, and the cover's exactness
// argument (ops/topk.py) holds with no slack. Only row 0 of the 64 M rows is
// a query; the rest of A reads zeros or the next chunks' query rows, and the
// 63 rows of products it gives are dropped.
//
// Design: one block (one warpgroup) per (query, tile of 128 covered rows).
// The query sits in shared memory once, as row 0 of one 1024-byte swizzle
// atom per 64-dim chunk, the atoms laid 1024 bytes apart so that A's further
// 8-row groups (1024 bytes apart) read the next atoms: 23 KB at d = 1024
// where 64 full rows would take 128 KB. The tile's rows are gathered with
// cp.async (16 bytes a thread, 8 threads a 128-byte row chunk) straight into
// the swizzled layout kernel A's TMA ring writes, through a 4-stage ring of
// 64-dim chunks, 3 chunks in flight while one multiplies; 2 blocks share an
// SM.
//
// What bounds it on an H100: bytes. At the main path's shape (B = 256, k =
// 100, G = 8) it reads 256 x 800 rows x 2 KB = 419 MB of gathered rows: 0.125
// ms at 3.35 TB/s. Its tensor-core work, 63 of every 64 M rows wasted, is
// 256 x 7 tiles x 16 chunks x 4 wgmma of 64 x 128 x 16: 30 GFLOP, 0.03 ms.
// Requirements (checked by the Python wrapper): q (B, d) and D (N, d) bf16 or
// f16, contiguous and 16-byte aligned, bins int64 (B, KB) contiguous, d % 32
// == 0, G in {8, 16}, N % G == 0, 1 <= KB <= N / G. A bin id out of [0, N /
// G), or not above the one before it, traps (the launch fails at the next
// synchronisation).

#include "bin_kernels.cuh"

namespace {

constexpr int R_THREADS = 128;  // one warpgroup: it gathers the rows and multiplies
constexpr int R_STAGES = 4;
constexpr int ATOM = 8 * CHUNK_BYTES;  // a 128-byte swizzle atom: 8 rows

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared memory: the query atoms (chunks + 7 of them, the last 7 zero), then
// the ring of R_STAGES chunks of NW rows
inline int rescore_smem(int D, int kc_dims, int NW) {
  const int chunks = (D + kc_dims - 1) / kc_dims;
  return (chunks + 7) * ATOM + R_STAGES * NW * CHUNK_BYTES + 1024;  // + 1024-byte alignment slack
}

// NW: rows per tile, kernel A's wgmma N at this batch (128, or 64 for B <= 64)
template <typename T, int NW>
__global__ void __launch_bounds__(R_THREADS)
cover_rescore_kernel(const T* __restrict__ q, const T* __restrict__ d,
                     const long long* __restrict__ bins, float* __restrict__ out,
                     const int* __restrict__ nv_ptr, long long nv_int, long long N, int D, int KB,
                     int G, int tiles) {
  constexpr int KC = CHUNK_BYTES / sizeof(T);  // dims per chunk
  constexpr int PER = NW * 8 / R_THREADS;      // 16-byte pieces a thread gathers per chunk
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const int chunks = (D + KC - 1) / KC;
  const uint32_t ring = base + (chunks + 7) * ATOM;
  const int tid = threadIdx.x;
  const long long qi = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * NW;  // the tile's first candidate
  const int cands = KB * G;
  const long long nb = N / G;
  const long long* qbins = bins + qi * KB;

  // the thread's rows: r = tid / 8 + 16 j, each as 16-byte unit u of every
  // chunk; candidates past the query's last are zero-filled
  const int u = tid & 7;
  const int r0 = tid >> 3;
  const T* rows[PER];
  bool live[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = c0 + r0 + 16 * j;
    live[j] = c < cands;
    long long row = 0;
    if (live[j]) {
      const int jb = c / G;
      const long long bin = qbins[jb];
      if (bin < 0 || bin >= nb || (jb > 0 && c % G == 0 && bin <= qbins[jb - 1])) __trap();
      row = bin * G + c % G;
    }
    rows[j] = d + row * D;
  }
  auto load_chunk = [&](int kc) {
    const uint32_t st = ring + (kc % R_STAGES) * (NW * CHUNK_BYTES);
    const int dim = kc * KC + 8 * u;
    const bool in_d = dim < D;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int r = r0 + 16 * j;
      const uint32_t dst = st + r * CHUNK_BYTES + ((u ^ (r & 7)) << 4);
      cp_async16(dst, in_d ? rows[j] + dim : rows[j], live[j] && in_d ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < R_STAGES - 1; ++s) {
    if (s < chunks) load_chunk(s);
    cp_async_commit();
  }

  // the query: row 0 of atom kc holds dims kc * KC .. + KC - 1 (row 0 is not
  // swizzled); every other row of every atom is zero
  const uint4* qrow = reinterpret_cast<const uint4*>(q + qi * D);
  const int q_units = (chunks + 7) * (ATOM / 16);
  for (int p = tid; p < q_units; p += R_THREADS) {
    const int atom = p / (ATOM / 16), slot = p % (ATOM / 16);  // slot: row slot / 8, unit slot % 8
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (slot < 8 && atom < chunks && atom * KC + 8 * slot < D) v = qrow[(atom * KC + 8 * slot) / 8];
    reinterpret_cast<uint4*>(gbase)[p] = v;
  }

  float acc[NW / 2];
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<R_STAGES - 2>();  // this thread's pieces of chunk kc have landed
    sm90::fence_proxy_async();      // its shared-memory writes, before wgmma reads them
    __syncthreads();                // every thread's, and every warp past chunk kc - 1's products
    if (kc + R_STAGES - 1 < chunks) load_chunk(kc + R_STAGES - 1);  // into chunk kc - 1's stage
    cp_async_commit();
    const uint32_t d_st = ring + (kc % R_STAGES) * (NW * CHUNK_BYTES);
    const uint32_t q_st = base + kc * ATOM;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // four k steps of 32 bytes, as kernel A
      const uint64_t db = sm90::desc_sw128(d_st + kk * 32, 16, 1024);
      const uint64_t da = sm90::desc_sw128(q_st + kk * 32, 16, 1024);
      Operand<T>::template mma<NW>(acc, da, db, kc > 0 || kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }

  // row 0 of the fragment: lanes 0-3 of warp 0 hold columns 8 i + 2 t, + 1 in
  // acc[4 i], acc[4 i + 1]
  const int lane = tid % 32;
  if (tid < 4) {
    const long long nv = nv_ptr != nullptr ? static_cast<long long>(*nv_ptr) : nv_int;
    float* dst = out + qi * cands;
#pragma unroll
    for (int i = 0; i < NW / 8; ++i) {
      const int c = c0 + 8 * i + 2 * lane;  // even, and cands is even: c and c + 1 agree
      if (c < cands) {
        const long long row = qbins[c / G] * G + c % G;  // c + 1 lies in the same bin
        *reinterpret_cast<float2*>(dst + c) =
            make_float2(row < nv ? acc[4 * i] : NEG_INF, row + 1 < nv ? acc[4 * i + 1] : NEG_INF);
      }
    }
  }
}

template <typename T, int NW>
int launch_rescore(const void* q, const void* d, const void* bins, void* out, const void* nv_ptr,
                   long long nv_int, int B, long long N, int D, int KB, int G, cudaStream_t stream) {
  const int smem = rescore_smem(D, CHUNK_BYTES / sizeof(T), NW);
  const long long tiles = (static_cast<long long>(KB) * G + NW - 1) / NW;
  if (smem > W_SMEM_MAX || tiles * B > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = cover_rescore_kernel<T, NW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(tiles * B), R_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(d), static_cast<const long long*>(bins),
      static_cast<float*>(out), static_cast<const int*>(nv_ptr), nv_int, N, D, KB, G,
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rescore_any(const void* q, const void* d, const void* bins, void* out, const void* nv_ptr,
                long long nv_int, int B, long long N, int D, int KB, int G, cudaStream_t s) {
  if (B <= 64)  // kernel A's query tile of 64: wgmma m64n64k16
    return launch_rescore<T, 64>(q, d, bins, out, nv_ptr, nv_int, B, N, D, KB, G, s);
  return launch_rescore<T, 128>(q, d, bins, out, nv_ptr, nv_int, B, N, D, KB, G, s);
}

}  // namespace

// Scores (B, KB * G) f32 of the covered rows on `stream`; dtype 0: bf16, 1:
// f16. n_valid is read from the device int32 at nv_ptr when it is not null,
// else taken from nv_int. Returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for shapes outside the requirements above.
extern "C" int cover_rescore_launch(const void* q, const void* d, const void* bins, void* out,
                                    const void* nv_ptr, long long nv_int, int B, long long N, int D,
                                    int KB, int G, int dtype, void* stream) {
  if (!shape_ok(B, N, D, G, 32) || KB <= 0 || KB > N / G) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rescore_any<__nv_bfloat16>(q, d, bins, out, nv_ptr, nv_int, B, N, D, KB, G, s);
  if (dtype == 1) return rescore_any<__half>(q, d, bins, out, nv_ptr, nv_int, B, N, D, KB, G, s);
  return cudaErrorInvalidValue;
}

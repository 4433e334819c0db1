// MaxSim late-interaction scores (kernel 6): for query b and candidate c,
//   score[b, c] = sum over valid query tokens i of max over valid doc tokens j
//                 of q[b, i] . d[b, c, j]
// where a candidate with no valid doc token scores 0 and an invalid query
// token adds 0 (the zero-output contract of the JAX package's
// ops/maxsim.py:42-43).
//
// Replaces the TPU kernel codemix_dense_retrieval_tpu/ops/maxsim.py::
// maxsim_scores_pallas (with _maxsim_kernel).
//
// What bounds it on an H100: bytes. At the two-stage path's shape (B = 256
// queries, K = 400 candidates, Tq = Td = 32 tokens, d = 1024) it must read
// 6.71 GB of gathered bf16 doc tokens: 2.0 ms at 3.35 TB/s, against 0.43 ms
// of bf16 tensor-core work for the two products of the split query.
//
// Design:
// - one block (8 warps) per (query, chunk of candidates). The block stages
//   32 query tokens at a time in shared memory, each f32 value split into
//   bf16 hi = rn(q) and lo = rn(q - hi): q = hi + lo to about 2^-16 relative,
//   so the products keep ~16 mantissa bits of the query where one bf16
//   rounding would keep 8 (and move a 32-token score by up to ~1e-2);
// - each warp owns whole candidates (candidate c goes to warp c % 8). It
//   streams the candidate's tokens, 32 tokens x 64 dims per stage, through
//   its own two shared-memory stages with cp.async (the next stage's copy
//   flies while the current one multiplies), and computes the 32 x 32
//   similarity tile on mma.sync.m16n8k16 bf16 with f32 accumulation, two
//   products (hi, lo) per fragment. The tensor cores' f32 accumulation does
//   not round to nearest, and its error grows with the number of products
//   added into one fragment, so each 64-dim stage accumulates into a fresh
//   fragment that is then added to the running sum with a rounded f32 add
//   (__fadd_rn). On an H100 this cut the largest error against the plain
//   f32 version at the two-stage shape, with scores up to ~30, from 8.4e-5
//   to 1.1e-5;
// - after the last d chunk of a 32-token doc chunk, masked doc tokens are
//   dropped from a running per-row maximum held in registers; after the last
//   doc chunk the row maxima of valid query tokens are summed in a fixed
//   shuffle tree. Whether the candidate had any valid doc token is a flag,
//   so the maximum never needs a finite sentinel;
// - query tokens past 32 run as further groups, each adding its partial sum
//   to the same output element in a fixed order (the same warp owns it).
// f16 and f32 doc tokens (the card-resident token stores of those dtypes)
// take the same kernel: a stage holds 128 bytes of each token (64 f16 or 32
// f32 dims), and each doc pair read into registers is split there into bf16
// parts, exactly for f16 (11 significant bits = 8 + 3, and bf16's exponent
// range covers f16's) and to ~2^-24 relative for f32 (three parts d1 + d2 +
// d3). The products are qh.dp for every part p and ql.d1, ql.d2: every term
// down to ~2^-16 of q.d, the level of the query split's own error, so f16
// and f32 docs are held to the bf16 instance's tolerance. Bytes bound all
// three: 2.0 ms (bf16, f16) and 4.0 ms (f32) at the two-stage shape, above
// their 0.43, 0.86 and 1.07 ms of tensor-core work.
// Requirements (checked by the Python wrapper): q f32 (B, Tq, d), doc
// tokens bf16, f16 or f32 (B, K, Td, d), masks int32, all contiguous;
// d % 64 == 0 and d <= 1216 (the staged query group fits in shared memory).

#include <cstdint>
#include <math_constants.h>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QG = 32;                 // query tokens per staged group (2 m16 tiles)
constexpr int TDC = 32;                // doc tokens per chunk (4 n8 tiles)
constexpr int ROW_BYTES = 128 + 16;    // a staged token: 128 bytes + pad, conflict-free fragments
constexpr int STAGE_BYTES = TDC * ROW_BYTES;
constexpr int MAX_SMEM = 232448;

// what the doc token type fixes: dims per stage (KC), the bf16 parts a
// value splits into (PARTS) and the split of the pair at p into part
// registers (bf16 pairs)
template <typename TD>
struct Doc;

template <>
struct Doc<__nv_bfloat16> {
  static constexpr int KC = 64, PARTS = 1;
  static __device__ __forceinline__ void parts(const __nv_bfloat16* p, uint32_t (&r)[PARTS]) {
    r[0] = *reinterpret_cast<const uint32_t*>(p);
  }
};

__device__ __forceinline__ uint32_t bf16x2(float a, float b, float2& rounded) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  rounded = __bfloat1622float2(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <>
struct Doc<__half> {
  static constexpr int KC = 64, PARTS = 2;
  static __device__ __forceinline__ void parts(const __half* p, uint32_t (&r)[PARTS]) {
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(p));
    float2 h, l;
    r[0] = bf16x2(x.x, x.y, h);
    r[1] = bf16x2(x.x - h.x, x.y - h.y, l);
  }
};

template <>
struct Doc<float> {
  static constexpr int KC = 32, PARTS = 3;
  static __device__ __forceinline__ void parts(const float* p, uint32_t (&r)[PARTS]) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    float2 h1, h2, h3;
    r[0] = bf16x2(x.x, x.y, h1);
    const float2 e = make_float2(x.x - h1.x, x.y - h1.y);
    r[1] = bf16x2(e.x, e.y, h2);
    r[2] = bf16x2(e.x - h2.x, e.y - h2.y, h3);
  }
};

template <typename TD>
struct Params {
  const float* q;     // (B, Tq, D)
  const int* q_mask;  // (B, Tq)
  const TD* d;        // (B, K, Td, D)
  const int* d_mask;  // (B, K, Td)
  float* out;         // (B, K)
  int B, K, Tq, Td, D, cpb;
};

__host__ __device__ constexpr int smem_bytes(int D) {
  return 2 * QG * (D + 8) * 2 + WARPS * 2 * STAGE_BYTES;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ uint2 pack4(float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  return r;
}

template <typename TD>
__global__ void __launch_bounds__(THREADS) maxsim_kernel(Params<TD> p) {
  constexpr int KC = Doc<TD>::KC;              // dims per stage
  constexpr int PARTS = Doc<TD>::PARTS;
  constexpr int LDD = ROW_BYTES / sizeof(TD);  // element stride of a staged token
  constexpr int VEC = 16 / sizeof(TD);         // elements per 16-byte copy
  constexpr int STAGE = TDC * LDD;             // elements per stage
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = p.D + 8;
  __nv_bfloat16* sQh = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sQl = sQh + QG * ldq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  TD* sD = reinterpret_cast<TD*>(sQl + QG * ldq) + warp * 2 * STAGE;

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * p.cpb;
  const int c_end = min(c0 + p.cpb, p.K);
  const int first = c0 + warp;
  const int my_cands = first < c_end ? (c_end - first + WARPS - 1) / WARPS : 0;
  const int n_tdc = (p.Td + TDC - 1) / TDC;
  const int n_kc = p.D / KC;
  const int per_cand = n_tdc * n_kc;
  const int n_tiles = my_cands * per_cand;

  // stage (candidate, doc chunk, d chunk) number i of this warp into stage i % 2
  auto issue = [&](int i) {
    const int cand = first + (i / per_cand) * WARPS;
    const int rem = i % per_cand;
    const int tdc = rem / n_kc;
    const int kc = rem % n_kc;
    TD* dst = sD + (i & 1) * STAGE;
    const long long cand_base = (static_cast<long long>(b) * p.K + cand) * p.Td;
#pragma unroll
    for (int v = lane; v < TDC * KC / VEC; v += 32) {
      const int r = v / (KC / VEC);
      const int cv = v % (KC / VEC);
      const int tok = tdc * TDC + r;
      const int src_tok = tok < p.Td ? tok : p.Td - 1;
      const TD* src = p.d + (cand_base + src_tok) * p.D + kc * KC + cv * VEC;
      cp_async16(dst + r * LDD + cv * VEC, src, tok < p.Td ? 16 : 0);
    }
    cp_async_commit();
  };

  for (int q0 = 0; q0 < p.Tq; q0 += QG) {
    __syncthreads();  // the previous group's query tiles are no longer read
    const int vec_per_row = p.D / 4;
    for (int idx = threadIdx.x; idx < QG * vec_per_row; idx += THREADS) {
      const int row = idx / vec_per_row;
      const int col = (idx % vec_per_row) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + row < p.Tq)
        v = *reinterpret_cast<const float4*>(
            p.q + (static_cast<long long>(b) * p.Tq + q0 + row) * p.D + col);
      const uint2 hi = pack4(v.x, v.y, v.z, v.w);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hi);
      const float2 f01 = __bfloat1622float2(h2[0]);
      const float2 f23 = __bfloat1622float2(h2[1]);
      const uint2 lo = pack4(v.x - f01.x, v.y - f01.y, v.z - f23.x, v.w - f23.y);
      *reinterpret_cast<uint2*>(sQh + row * ldq + col) = hi;
      *reinterpret_cast<uint2*>(sQl + row * ldq + col) = lo;
    }
    // validity of this thread's four query rows: (m, h) -> m * 16 + g + 8 h
    bool qvalid[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + m * 16 + g + 8 * h;
        qvalid[m][h] = row < p.Tq && p.q_mask[static_cast<long long>(b) * p.Tq + row] > 0;
      }
    __syncthreads();

    if (n_tiles > 0) issue(0);
    float acc[2][4][4];
    float rmax[2][2];
    bool any_valid = false;
    for (int i = 0; i < n_tiles; ++i) {
      if (i + 1 < n_tiles) {
        issue(i + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const int cand = first + (i / per_cand) * WARPS;
      const int rem = i % per_cand;
      const int tdc = rem / n_kc;
      const int kc = rem % n_kc;
      if (rem == 0) {
        any_valid = false;
#pragma unroll
        for (int m = 0; m < 2; ++m) rmax[m][0] = rmax[m][1] = -CUDART_INF_F;
      }
      float part[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[m][n][e] = 0.0f;
      const TD* st = sD + (i & 1) * STAGE;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        const int kq = kc * KC + kk + 2 * t;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int r0 = (m * 16 + g) * ldq + kq;
          const int r1 = r0 + 8 * ldq;
          ah[m][0] = ld32(sQh + r0);
          ah[m][1] = ld32(sQh + r1);
          ah[m][2] = ld32(sQh + r0 + 8);
          ah[m][3] = ld32(sQh + r1 + 8);
          al[m][0] = ld32(sQl + r0);
          al[m][1] = ld32(sQl + r1);
          al[m][2] = ld32(sQl + r0 + 8);
          al[m][3] = ld32(sQl + r1 + 8);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const TD* br = st + (n * 8 + g) * LDD + kk + 2 * t;
          uint32_t b0[PARTS], b1[PARTS];
          Doc<TD>::parts(br, b0);
          Doc<TD>::parts(br + 8, b1);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // the smallest terms first: qh.d3, then ql.d2, qh.d2, ql.d1, qh.d1
#pragma unroll
            for (int j = PARTS - 1; j >= 0; --j) {
              if (j < 2) mma_bf16(part[m][n], al[m], b0[j], b1[j]);
              mma_bf16(part[m][n], ah[m], b0[j], b1[j]);
            }
          }
        }
      }
      __syncwarp();  // every lane is done with this stage before it is refilled
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][n][e] = kc == 0 ? part[m][n][e] : __fadd_rn(acc[m][n][e], part[m][n][e]);
      if (kc == n_kc - 1) {
        // fold the finished 32-token doc chunk into the running row maxima;
        // accumulator e holds row g + 8 (e / 2), column 2 t + (e % 2)
        const long long mbase = (static_cast<long long>(b) * p.K + cand) * p.Td;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int col = tdc * TDC + n * 8 + 2 * t + e2;
            const bool v = col < p.Td && p.d_mask[mbase + col] > 0;
            any_valid |= v;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              if (v) {
                rmax[m][0] = fmaxf(rmax[m][0], acc[m][n][e2]);
                rmax[m][1] = fmaxf(rmax[m][1], acc[m][n][2 + e2]);
              }
            }
          }
        }
        if (tdc == n_tdc - 1) {
          const bool cand_valid = __any_sync(0xffffffffu, any_valid);
          float part = 0.0f;
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float r = quad_max(rmax[m][h]);
              if (t == 0 && qvalid[m][h] && cand_valid) part += r;
            }
#pragma unroll
          for (int off = 16; off >= 1; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
          if (lane == 0) {
            float* o = p.out + static_cast<long long>(b) * p.K + cand;
            *o = q0 == 0 ? part : *o + part;
          }
        }
      }
    }
  }
}

template <typename TD>
int launch(const void* q, const void* q_mask, const void* d, const void* d_mask, void* out, int B,
           int K, int Tq, int Td, int D, cudaStream_t stream) {
  const int smem = smem_bytes(D);
  // candidates per block: about 80, a multiple of the warp count, so each
  // block's query staging is amortised over ~5 MB of doc tokens at d = 1024
  const int chunks = (K + 79) / 80;
  const int per_chunk = (K + chunks - 1) / chunks;
  const int cpb = (per_chunk + WARPS - 1) / WARPS * WARPS;
  Params<TD> p{static_cast<const float*>(q), static_cast<const int*>(q_mask),
               static_cast<const TD*>(d), static_cast<const int*>(d_mask),
               static_cast<float*>(out), B, K, Tq, Td, D, cpb};
  cudaError_t err =
      cudaFuncSetAttribute(maxsim_kernel<TD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((K + cpb - 1) / cpb, B);
  maxsim_kernel<TD><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// doc_dtype: 0 bf16, 1 f16, 2 f32 doc tokens.
extern "C" int maxsim_launch(const void* q, const void* q_mask, const void* d, const void* d_mask,
                             void* out, int B, int K, int Tq, int Td, int D, int doc_dtype,
                             void* stream) {
  if (B <= 0 || B > 65535 || K <= 0 || Tq <= 0 || Td <= 0 || D <= 0 || D % 64 != 0)
    return cudaErrorInvalidValue;
  if (smem_bytes(D) > MAX_SMEM) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (doc_dtype == 0) return launch<__nv_bfloat16>(q, q_mask, d, d_mask, out, B, K, Tq, Td, D, s);
  if (doc_dtype == 1) return launch<__half>(q, q_mask, d, d_mask, out, B, K, Tq, Td, D, s);
  if (doc_dtype == 2) return launch<float>(q, q_mask, d, d_mask, out, B, K, Tq, Td, D, s);
  return cudaErrorInvalidValue;
}

// Online-softmax (flash) attention forward for the encoder stack.
//
// Replaces the TPU kernel codemix_dense_retrieval_tpu/ops/flash_attention.py::
// attention_flash (Pallas kernels _flash_kernel and _flash_kernel_seg): per-
// sequence key lengths, optional causal mask, grouped-query attention (q head
// h reads kv head h / (H / KVH), never repeated in memory), optional
// block-diagonal segment masking (segment 0 = pad), and an exact zero for a
// row that sees no valid key. The mask sentinel is -1e30 and a row whose
// running max never rose above -1e30 / 2 is written as zeros.
//
// What bounds it on an H100: operations. The encoder calls it at S >= 1024,
// dh = 64: per (sequence, head) it reads and writes 4 * S * dh values but
// does 4 * S * len * dh flops, about 500 flops per byte at S = 1024, above
// the card's ~295 flops/byte bf16 ridge. The design keeps the S x S score
// matrix out of device memory and skips the key blocks past
// min(length, causal frontier), the work the TPU kernel also skips.
//
// Design, bf16 (the card's path): one block per (batch * head, 64-query
// block), 4 warps of 16 query rows. Each 64-key block of K (row-major) and V
// (transposed) is staged in shared memory; each warp keeps its Q fragments,
// its 16 x 64 score tile, the online-softmax row state and its 16 x dh output
// accumulator in registers: scores come from mma.sync m16n8k16 bf16 products
// (f32 accumulate), the softmax runs in f32 with quad shuffles, P is rounded
// to bf16 in registers and fed as the A operand of the P.V product. Rounding
// P to bf16 is the one numerical departure from the TPU kernel (which
// multiplies f32 P by f32 V): it costs up to ~2^-9 relative per weight, so
// outputs agree with an all-f32 reference to ~1e-2 absolute for unit-scale
// values.
// f32 inputs take a plain SIMT kernel (f32 FMAs throughout, no TF32).
// Tensors are read through their strides (last dim contiguous), so the
// (B, S, H, dh) projection layout is consumed without a transpose copy.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

struct Strides {
  long long qb, qh, qs;
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, os;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* lengths;
  const int* seg;  // (B, S) or null
  int B, H, KVH, S;
  int causal;
  float scale;
  Strides st;
};

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel on mma.sync.m16n8k16, state in registers
// ---------------------------------------------------------------------------
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with bf16 inputs, f32 accumulate),
// with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major) regs: {A[g][2t..2t+1]}, {A[g+8][2t..2t+1]},
//                              {A[g][2t+8..2t+9]}, {A[g+8][2t+8..2t+9]}
//   B (16x8, "col")      regs: {B[2t..2t+1][g]}, {B[2t+8..2t+9][g]}
//   C (16x8, f32):             C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]
// So a thread holds two query rows (g and g+8) of every score tile; the four
// threads of a quad share those rows and reduce row maxima and sums with two
// shuffles; the score accumulators of two adjacent key tiles are exactly the
// A fragment of P for the next product, and the output accumulators are
// rescaled per row in registers.

template <int DH>
struct Bf16Layout {
  static constexpr int LDQ = DH + 8;   // bf16 row stride of Q and K tiles
  static constexpr int LDVT = BK + 10; // bf16 row stride of the transposed V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + align128(BQ * LDQ * 2);
  static constexpr int VT_OFF = K_OFF + align128(BK * LDQ * 2);
  static constexpr int KSEG_OFF = VT_OFF + align128(DH * LDVT * 2);
  static constexpr int BYTES = KSEG_OFF + align128(BK * 4);
};

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16(Params p) {
  using L = Bf16Layout<DH>;
  constexpr int KQ = DH / 16;   // k-steps of Q.K^T
  constexpr int NK = BK / 8;    // key tiles of 8
  constexpr int ND = DH / 8;    // output tiles of 8
  constexpr int VPR = DH / 8;   // 16-byte vectors per row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
  __nv_bfloat16* sVt = reinterpret_cast<__nv_bfloat16*>(smem + L::VT_OFF);
  int* sKseg = reinterpret_cast<int*>(smem + L::KSEG_OFF);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.y * BQ;
  const int S = p.S;
  int length = p.lengths[b];
  length = length < S ? length : S;
  int limit = length;
  if (p.causal && q0 + BQ < limit) limit = q0 + BQ;
  const int n_kb = limit > 0 ? (limit + BK - 1) / BK : 0;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.st.qb + h * p.st.qh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.st.kb + kvh * p.st.kh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.st.vb + kvh * p.st.vh;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int idx = tid; idx < BQ * VPR; idx += THREADS) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    const int row = q0 + r;
    *reinterpret_cast<uint4*>(sQ + r * L::LDQ + c) =
        row < S ? *reinterpret_cast<const uint4*>(qg + row * p.st.qs + c) : zero;
  }
  __syncthreads();

  // this thread's two query rows and their Q fragments, held for the whole loop
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qf[KQ][4];
  {
    const __nv_bfloat16* q_lo = sQ + (warp * 16 + g) * L::LDQ + 2 * t;
    const __nv_bfloat16* q_hi = q_lo + 8 * L::LDQ;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      qf[kk][0] = ld32(q_lo + kk * 16);
      qf[kk][1] = ld32(q_hi + kk * 16);
      qf[kk][2] = ld32(q_lo + kk * 16 + 8);
      qf[kk][3] = ld32(q_hi + kk * 16 + 8);
    }
  }
  const long long seg_row = static_cast<long long>(b) * S;
  const int qs0 = (p.seg != nullptr && r0 < S) ? p.seg[seg_row + r0] : 0;
  const int qs1 = (p.seg != nullptr && r1 < S) ? p.seg[seg_row + r1] : 0;

  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // every warp is done with the previous K / V tiles
    for (int idx = tid; idx < BK * VPR; idx += THREADS) {
      const int r = idx / VPR, c = (idx % VPR) * 8;
      const int key = k0 + r;
      const bool in = key < S;
      *reinterpret_cast<uint4*>(sK + r * L::LDQ + c) =
          in ? *reinterpret_cast<const uint4*>(kg + key * p.st.ks + c) : zero;
      const uint4 vv = in ? *reinterpret_cast<const uint4*>(vg + key * p.st.vs + c) : zero;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * L::LDVT + r] = ve[j];
    }
    if (tid < BK)
      sKseg[tid] = (p.seg != nullptr && k0 + tid < S) ? p.seg[seg_row + k0 + tid] : 0;
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const __nv_bfloat16* kr = sK + (n * 8 + g) * L::LDQ + kk * 16 + 2 * t;
        mma_bf16(s[n], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kl = n * 8 + 2 * t + (c & 1);
        const int key = k0 + kl;
        const int row = c < 2 ? r0 : r1;
        bool valid = key < length;
        if (p.seg != nullptr) {
          const int ks = sKseg[kl];
          valid = valid && ks == (c < 2 ? qs0 : qs1) && ks > 0;
        }
        if (p.causal) valid = valid && key <= row;
        const float v = valid ? s[n][c] * p.scale : NEG;
        s[n][c] = v;
        if (c < 2)
          mx0 = fmaxf(mx0, v);
        else
          mx1 = fmaxf(mx1, v);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = __expf(m0 - mn0);
    const float alpha1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp(S - m) rounded to bf16, packed straight into A fragments
    uint32_t pf[BK / 16][4];
    float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * j + half;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(__expf(s[n][0] - mn0), __expf(s[n][1] - mn0));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(__expf(s[n][2] - mn1), __expf(s[n][3] - mn1));
        ls0 += __low2float(lo) + __high2float(lo);
        ls1 += __low2float(hi) + __high2float(hi);
        pf[j][2 * half] = *reinterpret_cast<const uint32_t*>(&lo);
        pf[j][2 * half + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
    }
    l0 = l0 * alpha0 + quad_sum(ls0);
    l1 = l1 * alpha1 + quad_sum(ls1);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = sVt + (n * 8 + g) * L::LDVT + j * 16 + 2 * t;
        mma_bf16(o[n], pf[j], ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float inv0 = m0 > NEG / 2 ? 1.0f / fmaxf(l0, 1e-30f) : 0.0f;
  const float inv1 = m1 > NEG / 2 ? 1.0f / fmaxf(l1, 1e-30f) : 0.0f;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + b * p.st.ob + h * p.st.oh + 2 * t;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (r0 < S) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(og + r0 * p.st.os + n * 8) = v;
    }
    if (r1 < S) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
      *reinterpret_cast<__nv_bfloat162*>(og + r1 * p.st.os + n * 8) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT kernel (f32 FMAs, no tensor cores)
// ---------------------------------------------------------------------------

template <int DH>
struct F32Layout {
  static constexpr int LDQ = DH + 1;
  static constexpr int LDS = BK + 1;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + align128(BQ * LDQ * 4);
  static constexpr int V_OFF = K_OFF + align128(BK * LDQ * 4);
  static constexpr int S_OFF = V_OFF + align128(BK * DH * 4);
  static constexpr int O_OFF = S_OFF + align128(BQ * LDS * 4);
  static constexpr int M_OFF = O_OFF + align128(BQ * DH * 4);
  static constexpr int L_OFF = M_OFF + align128(BQ * 4);
  static constexpr int A_OFF = L_OFF + align128(BQ * 4);
  static constexpr int QSEG_OFF = A_OFF + align128(BQ * 4);
  static constexpr int KSEG_OFF = QSEG_OFF + align128(BQ * 4);
  static constexpr int BYTES = KSEG_OFF + align128(BK * 4);
};

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(Params p) {
  using L = F32Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* sK = reinterpret_cast<float*>(smem + L::K_OFF);
  float* sV = reinterpret_cast<float*>(smem + L::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  float* sO = reinterpret_cast<float*>(smem + L::O_OFF);
  float* sM = reinterpret_cast<float*>(smem + L::M_OFF);
  float* sL = reinterpret_cast<float*>(smem + L::L_OFF);
  float* sA = reinterpret_cast<float*>(smem + L::A_OFF);
  int* sQseg = reinterpret_cast<int*>(smem + L::QSEG_OFF);
  int* sKseg = reinterpret_cast<int*>(smem + L::KSEG_OFF);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.y * BQ;
  const int S = p.S;
  int length = p.lengths[b];
  length = length < S ? length : S;
  int limit = length;
  if (p.causal && q0 + BQ < limit) limit = q0 + BQ;
  const int n_kb = limit > 0 ? (limit + BK - 1) / BK : 0;

  const float* qg = static_cast<const float*>(p.q) + b * p.st.qb + h * p.st.qh;
  const float* kg = static_cast<const float*>(p.k) + b * p.st.kb + kvh * p.st.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.st.vb + kvh * p.st.vh;

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH, c = idx % DH;
    sQ[r * L::LDQ + c] = q0 + r < S ? qg[(q0 + r) * p.st.qs + c] : 0.0f;
    sO[idx] = 0.0f;
  }
  if (tid < BQ) {
    sM[tid] = NEG;
    sL[tid] = 0.0f;
    sQseg[tid] = (p.seg != nullptr && q0 + tid < S) ? p.seg[static_cast<long long>(b) * S + q0 + tid] : 0;
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    for (int idx = tid; idx < BK * DH; idx += THREADS) {
      const int r = idx / DH, c = idx % DH;
      const bool in = k0 + r < S;
      sK[r * L::LDQ + c] = in ? kg[(k0 + r) * p.st.ks + c] : 0.0f;
      sV[idx] = in ? vg[(k0 + r) * p.st.vs + c] : 0.0f;
    }
    if (tid < BK)
      sKseg[tid] = (p.seg != nullptr && k0 + tid < S) ? p.seg[static_cast<long long>(b) * S + k0 + tid] : 0;
    __syncthreads();
    for (int idx = tid; idx < BQ * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) acc = fmaf(sQ[r * L::LDQ + d], sK[c * L::LDQ + d], acc);
      const int col = k0 + c;
      bool valid = col < length;
      if (p.seg != nullptr) valid = valid && sKseg[c] == sQseg[r] && sKseg[c] > 0;
      if (p.causal) valid = valid && col <= q0 + r;
      sS[r * L::LDS + c] = valid ? acc * p.scale : NEG;
    }
    __syncthreads();
    if (tid < BQ) {
      float* srow = sS + tid * L::LDS;
      float mloc = NEG;
      for (int c = 0; c < BK; ++c) mloc = fmaxf(mloc, srow[c]);
      const float m_old = sM[tid];
      const float m_new = fmaxf(m_old, mloc);
      const float alpha = expf(m_old - m_new);
      float lsum = 0.0f;
      for (int c = 0; c < BK; ++c) {
        const float e = expf(srow[c] - m_new);
        srow[c] = e;
        lsum += e;
      }
      sM[tid] = m_new;
      sL[tid] = sL[tid] * alpha + lsum;
      sA[tid] = alpha;
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * DH; idx += THREADS) {
      const int r = idx / DH, d = idx % DH;
      float acc = sO[idx] * sA[r];
#pragma unroll 8
      for (int c = 0; c < BK; ++c) acc = fmaf(sS[r * L::LDS + c], sV[c * DH + d], acc);
      sO[idx] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    if (q0 + r >= S) continue;
    const bool live = sM[r] > NEG / 2;
    const float val = live ? sO[idx] / fmaxf(sL[r], 1e-30f) : 0.0f;
    static_cast<float*>(p.out)[b * p.st.ob + h * p.st.oh + (q0 + r) * p.st.os + d] = val;
  }
}

template <typename Kernel>
int launch(Kernel kernel, int smem_bytes, const Params& prm, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(prm.B * prm.H, (prm.S + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem_bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64 element strides (batch, head, seq) of q, k, v and out;
// the head-dim stride of every tensor is 1. Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const int* lengths, const int* seg, int B, int H,
                                      int KVH, int S, int dh, const long long* strides,
                                      int causal, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || S <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  if (dh != 64 && dh != 128) return cudaErrorInvalidValue;
  if ((S + BQ - 1) / BQ > 65535) return cudaErrorInvalidValue;
  Params prm;
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.out = out;
  prm.lengths = lengths;
  prm.seg = seg;
  prm.B = B;
  prm.H = H;
  prm.KVH = KVH;
  prm.S = S;
  prm.causal = causal;
  prm.scale = 1.0f / sqrtf(static_cast<float>(dh));
  prm.st = Strides{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dh == 64) return launch(flash_fwd_bf16<64>, Bf16Layout<64>::BYTES, prm, s);
    return launch(flash_fwd_bf16<128>, Bf16Layout<128>::BYTES, prm, s);
  }
  if (dh == 64) return launch(flash_fwd_f32<64>, F32Layout<64>::BYTES, prm, s);
  return launch(flash_fwd_f32<128>, F32Layout<128>::BYTES, prm, s);
}

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
// Design, bf16 (the card's path), a warp-specialised Hopper kernel (sm90.cuh):
// - persistent blocks, one per SM, each walking over (128-query tile,
//   batch * head) tiles: a producer warpgroup and two consumer warpgroups of
//   64 query rows; setmaxnreg gives the producer's registers to the
//   consumers (40 / 232). The producer runs ahead into the next tile, so its
//   Q and first K/V tiles load while the current tile finishes;
// - one producer thread loads Q once and K and V tiles of 128 keys x dh by
//   TMA into a 3-stage ring guarded by mbarriers. The tensor maps describe
//   the strided (B, S, H, dh) view as 4-D (dh, S, H, B), so no transpose copy
//   is made, and rows past S read as zeros. A 64-value (128-byte) box with
//   the 128-byte swizzle is exactly wgmma's operand layout (dh = 128 takes
//   two);
// - S = Q.K^T by wgmma m64n128k16 (bf16, f32 accumulate) from shared memory,
//   K read K-major; lengths, causal and segment masks and the online softmax
//   (exp2 of one FMA, the scale folded into log2 e / sqrt(dh)) run on the
//   accumulator fragments in registers. The masks run as a separate pass
//   on the key blocks that need one (the last block of a sequence, or every
//   block when causal or segmented): kept inside the softmax's unrolled
//   loop as a per-element branch, they cost 0.2 of its 0.55 ms on an
//   H100 at the encoder's shape;
// - P is rounded to bf16 in registers and fed as the register A operand of
//   the P.V wgmma (m64n{dh}k16); V is read MN-major through the descriptor's
//   transpose flag, so it is never transposed by hand;
// - the products and the exponentials overlap: a warpgroup issues S(k) and
//   P(k-1).V(k-1) together, then runs block k's softmax while they run, and
//   the two warpgroups take turns issuing (two named barriers), so one's
//   softmax runs beside the other's products;
// - the key loop still stops at min(length, causal frontier of the tile).
// What bounds it now: at dh = 64 a 128 x 128 key block costs as many MUFU
// cycles (16 ex2 per SM clock) as tensor-core cycles, so the overlap above
// is what keeps the tensor cores fed.
// Rounding P to bf16 is the one numerical departure from the TPU kernel
// (which multiplies f32 P by f32 V): it costs up to ~2^-9 relative per
// weight, so outputs agree with an all-f32 reference to ~1e-2 absolute for
// unit-scale values.
// f32 inputs take a plain SIMT kernel (f32 FMAs throughout, no TF32).
// Tensors are read through their strides (last dim contiguous), so the
// (B, S, H, dh) projection layout is consumed without a transpose copy.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised TMA + wgmma kernel
// ---------------------------------------------------------------------------

constexpr int WQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int WK = 128;        // keys per stage
constexpr int WSTAGES = 3;
constexpr int WTHREADS = 384;  // producer warpgroup + two consumer warpgroups

template <int DH>
struct WgLayout {
  static constexpr int Q_HALF = WQ * 128;  // one 64-column (128-byte) half of the Q tile
  static constexpr int KV_HALF = WK * 128;
  static constexpr int KV_BYTES = KV_HALF * (DH / 64);
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_HALF * (DH / 64);
  static constexpr int V_OFF = K_OFF + WSTAGES * KV_BYTES;
  // q_full, q_empty, full[WSTAGES], empty[WSTAGES]
  static constexpr int BAR_OFF = V_OFF + WSTAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 + 2 * WSTAGES) + 1024;  // + 1024-byte alignment slack
};

struct WgParams {
  const int* lengths;
  const int* seg;  // (B, S) or null
  void* out;
  int B, H, KVH, S;
  int causal;
  float scale_log2;  // log2(e) / sqrt(dh)
  long long ob, oh, os;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bf16 pair (lo, hi) as a 32-bit A-operand register; adds the rounded values to sum
__device__ __forceinline__ uint32_t pack_p(float lo, float hi, float& sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  sum += __low2float(v) + __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, WgParams p) {
  using L = WgLayout<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::Q_OFF;
  const uint32_t sK = base + L::K_OFF;
  const uint32_t sV = base + L::V_OFF;
  const uint32_t bar_qfull = base + L::BAR_OFF;
  const uint32_t bar_qempty = bar_qfull + 8;
  const uint32_t bar_full = bar_qfull + 16;            // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * WSTAGES;   // + 8 * stage

  const int tid = threadIdx.x;
  const int S = p.S;
  const int n_qt = (S + WQ - 1) / WQ;
  const int tiles = n_qt * p.B * p.H;  // (query tile, batch * head), query tile fastest
  // a tile's key blocks: up to min(length, causal frontier)
  auto key_blocks = [&](int q0, int length) {
    const int limit = p.causal ? min(length, q0 + WQ) : length;
    return limit > 0 ? (limit + WK - 1) / WK : 0;
  };

  if (tid == 0) {
    sm90::mbar_init(bar_qfull, 1);
    sm90::mbar_init(bar_qempty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < WSTAGES; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, 8);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int role = sm90::warpgroup_index();  // 0: producer, 1 and 2: consumers
  if (role == 0) {
    // ---- producer: one thread issues every TMA load ----
    sm90::setmaxnreg_dec<40>();
    if (tid == 0) {
      sm90::tma_prefetch(&qmap);
      sm90::tma_prefetch(&kmap);
      sm90::tma_prefetch(&vmap);
      int it = 0;  // K/V stages issued so far
      int tq = 0;  // tiles so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tq) {
        const int q0 = (tile % n_qt) * WQ;
        const int b = tile / n_qt / p.H;
        const int h = tile / n_qt % p.H;
        const int kvh = h / (p.H / p.KVH);
        const int n_kb = key_blocks(q0, min(p.lengths[b], S));
        sm90::mbar_wait(bar_qempty, (tq & 1) ^ 1);  // the previous tile's Q is read
        sm90::mbar_expect_tx(bar_qfull, L::Q_HALF * (DH / 64));
#pragma unroll
        for (int c = 0; c < DH / 64; ++c)
          sm90::tma_load_4d(sQ + c * L::Q_HALF, &qmap, bar_qfull, c * 64, q0, h, b);
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int st = it % WSTAGES;
          sm90::mbar_wait(bar_empty + 8 * st, ((it / WSTAGES) & 1) ^ 1);
          sm90::mbar_expect_tx(bar_full + 8 * st, 2 * L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < DH / 64; ++c) {
            const uint32_t off = st * L::KV_BYTES + c * L::KV_HALF;
            sm90::tma_load_4d(sK + off, &kmap, bar_full + 8 * st, c * 64, kb * WK, kvh, b);
            sm90::tma_load_4d(sV + off, &vmap, bar_full + 8 * st, c * 64, kb * WK, kvh, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 of each tile ----
    sm90::setmaxnreg_inc<232>();
    const int wg = role - 1;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t q_wg = sQ + wg * 64 * 128;
    // the two warpgroups take turns issuing their products (named barriers
    // 1 and 2), so one's softmax runs while the other's products do
    const int bar_mine = 1 + wg, bar_other = 2 - wg;
    int it = 0;  // K/V stages consumed before this tile
    int tq = 0;  // tiles so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tq) {
      const int q0 = (tile % n_qt) * WQ;
      const int b = tile / n_qt / p.H;
      const int h = tile / n_qt % p.H;
      const int length = min(p.lengths[b], S);
      const int n_kb = key_blocks(q0, length);
      const int r0 = q0 + wg * 64 + warp * 16 + g;  // this thread's two query rows
      const int r1 = r0 + 8;
      const long long seg_row = static_cast<long long>(b) * S;
      const int qs0 = (p.seg != nullptr && r0 < S) ? p.seg[seg_row + r0] : 0;
      const int qs1 = (p.seg != nullptr && r1 < S) ? p.seg[seg_row + r1] : 0;

      float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;
      float alpha0 = 1.0f, alpha1 = 1.0f;  // rescale of O before the next P.V
      float o[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
      float s[WK / 2];
      uint32_t pf[WK / 16][4];

      // key block kb of this tile sits in ring slot it + kb
      auto wait_turn = [&](int kb) {
        sm90::mbar_wait(bar_full + 8 * ((it + kb) % WSTAGES), ((it + kb) / WSTAGES) & 1);
        sm90::named_sync(bar_mine, 256);
      };
      auto pass_turn = [&](int kb) {  // warpgroup 1's last turn of a tile has no taker
        if (wg == 0 || kb + 1 < n_kb) sm90::named_arrive(bar_other, 256);
      };
      // S = Q . K^T (64 x 128 per warpgroup), left in flight
      auto issue_s = [&](int kb) {
        sm90::fence_regs(s);
        sm90::wgmma_fence();
        const uint32_t k_st = sK + ((it + kb) % WSTAGES) * L::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t koff = (kk % 4) * 32;  // k16 step inside the 128-byte row
          const uint64_t da = sm90::desc_sw128(q_wg + (kk / 4) * L::Q_HALF + koff, 16, 1024);
          const uint64_t db = sm90::desc_sw128(k_st + (kk / 4) * L::KV_HALF + koff, 16, 1024);
          sm90::Wgmma<WK>::template ss<0>(s, da, db, kk > 0);
        }
        sm90::wgmma_commit();
      };
      // O = O * alpha + P . V over block kb's V tile (keys x dh, MN-major, 16
      // keys = 2048 bytes per k-step), left in flight
      auto issue_pv = [&](int kb) {
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          o[4 * n + 0] *= alpha0;
          o[4 * n + 1] *= alpha0;
          o[4 * n + 2] *= alpha1;
          o[4 * n + 3] *= alpha1;
        }
        sm90::fence_regs(o);
        sm90::wgmma_fence();
        const uint32_t v_st = sV + ((it + kb) % WSTAGES) * L::KV_BYTES;
#pragma unroll
        for (int j = 0; j < WK / 16; ++j) {
          const uint64_t db = sm90::desc_sw128(v_st + j * 16 * 128, L::KV_HALF, 1024);
          sm90::Wgmma<DH>::template rs<1>(o, pf[j], db, 1);
        }
        sm90::wgmma_commit();
      };
      auto release = [&](int kb) {
        if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * ((it + kb) % WSTAGES));
      };
      // block kb's masked keys to -inf, on the blocks that have any (kept out
      // of the softmax's straight-line code, which it would slow throughout)
      auto mask = [&](int k0) {
#pragma unroll
        for (int i = 0; i < WK / 8; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * i + 2 * t + c;
            bool ok0 = key < length, ok1 = ok0;
            if (p.seg != nullptr) {
              const int ks = ok0 ? p.seg[seg_row + key] : 0;
              ok0 = ok0 && ks > 0 && ks == qs0;
              ok1 = ok1 && ks > 0 && ks == qs1;
            }
            if (p.causal) {
              ok0 = ok0 && key <= r0;
              ok1 = ok1 && key <= r1;
            }
            s[4 * i + c] = ok0 ? s[4 * i + c] : -INFINITY;
            s[4 * i + 2 + c] = ok1 ? s[4 * i + 2 + c] : -INFINITY;
          }
        }
      };
      // block kb's running maxima (log2 domain, NEG until a valid key) and
      // exponentials exp2(s * scale - m), in place in s; a masked key gives 0
      auto softmax = [&](int kb) {
        const int k0 = kb * WK;
        if (k0 + WK > length || p.causal || p.seg != nullptr) mask(k0);
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < WK / 8; ++i) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * i + 0], s[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
        const float mn0 = fmaxf(m0, quad_max(mx0) * p.scale_log2);
        const float mn1 = fmaxf(m1, quad_max(mx1) * p.scale_log2);
        alpha0 = ex2(m0 - mn0);
        alpha1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int i = 0; i < WK / 8; ++i) {
          s[4 * i + 0] = ex2(fmaf(s[4 * i + 0], p.scale_log2, -mn0));
          s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], p.scale_log2, -mn0));
          s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], p.scale_log2, -mn1));
          s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], p.scale_log2, -mn1));
        }
      };
      // P rounded to bf16, packed straight into A fragments; l sums the rounded P
      auto pack = [&]() {
        float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
        for (int j = 0; j < WK / 16; ++j) {
          pf[j][0] = pack_p(s[8 * j + 0], s[8 * j + 1], ls0);
          pf[j][1] = pack_p(s[8 * j + 2], s[8 * j + 3], ls1);
          pf[j][2] = pack_p(s[8 * j + 4], s[8 * j + 5], ls0);
          pf[j][3] = pack_p(s[8 * j + 6], s[8 * j + 7], ls1);
        }
        l0 = l0 * alpha0 + quad_sum(ls0);
        l1 = l1 * alpha1 + quad_sum(ls1);
      };

      sm90::mbar_wait(bar_qfull, tq & 1);
      if (n_kb > 0) {
        if (wg == 1) sm90::named_arrive(bar_other, 256);  // warpgroup 0 goes first
        wait_turn(0);
        issue_s(0);
        pass_turn(0);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        softmax(0);
        pack();
        // block kb's S runs beside block kb-1's P.V; its softmax beside that P.V
        for (int kb = 1; kb < n_kb; ++kb) {
          wait_turn(kb);
          issue_s(kb);
          issue_pv(kb - 1);
          pass_turn(kb);
          sm90::wgmma_wait<1>();
          sm90::fence_regs(s);
          softmax(kb);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(o);
          release(kb - 1);
          pack();
        }
        if (lane == 0) sm90::mbar_arrive(bar_qempty);  // every S of the tile is done
        issue_pv(n_kb - 1);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        release(n_kb - 1);
      } else if (lane == 0) {
        sm90::mbar_arrive(bar_qempty);
      }
      it += n_kb;

      // the output rows as bf16 pairs, converted on every lane, then stored
      const float inv0 = m0 > NEG / 2 ? 1.0f / fmaxf(l0, 1e-30f) : 0.0f;
      const float inv1 = m1 > NEG / 2 ? 1.0f / fmaxf(l1, 1e-30f) : 0.0f;
      uint32_t out0[DH / 8], out1[DH / 8];
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        __nv_bfloat162 v0 = __floats2bfloat162_rn(o[4 * n + 0] * inv0, o[4 * n + 1] * inv0);
        __nv_bfloat162 v1 = __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
        out0[n] = *reinterpret_cast<uint32_t*>(&v0);
        out1[n] = *reinterpret_cast<uint32_t*>(&v1);
      }
      sm90::fence_regs(out0);
      sm90::fence_regs(out1);
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + b * p.ob + h * p.oh + 2 * t;
      if (r0 < S) {
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) *reinterpret_cast<uint32_t*>(og + r0 * p.os + n * 8) = out0[n];
      }
      if (r1 < S) {
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) *reinterpret_cast<uint32_t*>(og + r1 * p.os + n * 8) = out1[n];
      }
    }
  }
}

// strides: element strides (batch, head, seq) of q, k, v, out; head dim contiguous
template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, const int* lengths,
                 const int* seg, int B, int H, int KVH, int S, const long long* st, int causal,
                 cudaStream_t stream) {
  using L = WgLayout<DH>;
  const uint32_t box[4] = {64, 128, 1, 1};
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const uint64_t heads = i == 0 ? H : KVH;
    const uint64_t dims[4] = {DH, static_cast<uint64_t>(S), heads, static_cast<uint64_t>(B)};
    const uint64_t bytes[3] = {static_cast<uint64_t>(st[3 * i + 2]) * 2,
                               static_cast<uint64_t>(st[3 * i + 1]) * 2,
                               static_cast<uint64_t>(st[3 * i]) * 2};
    const int rc =
        sm90::make_tma(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptrs[i], 4, dims, bytes, box);
    if (rc != 0) return rc;
  }
  WgParams prm;
  prm.lengths = lengths;
  prm.seg = seg;
  prm.out = out;
  prm.B = B;
  prm.H = H;
  prm.KVH = KVH;
  prm.S = S;
  prm.causal = causal;
  prm.scale_log2 = LOG2E / sqrtf(static_cast<float>(DH));
  prm.ob = st[9];
  prm.oh = st[10];
  prm.os = st[11];
  const int smem = L::BYTES > sm90::ONE_BLOCK_SMEM ? L::BYTES : sm90::ONE_BLOCK_SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((S + WQ - 1) / WQ) * B * H;
  const int sms = sm90::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const unsigned int grid = static_cast<unsigned int>(tiles < sms ? tiles : sms);  // persistent blocks
  flash_fwd_wgmma<DH><<<grid, WTHREADS, smem, stream>>>(maps[0], maps[1], maps[2], prm);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: SIMT kernel (f32 FMAs, no tensor cores)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

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
// the head-dim stride of every tensor is 1 (bf16: the others multiples of 8,
// for the tensor maps). Returns cudaGetLastError() or the tensor-map error.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const int* lengths, const int* seg, int B, int H,
                                      int KVH, int S, int dh, const long long* strides,
                                      int causal, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || S <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  if (dh != 64 && dh != 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dh == 64) return launch_wgmma<64>(q, k, v, out, lengths, seg, B, H, KVH, S, strides, causal, s);
    return launch_wgmma<128>(q, k, v, out, lengths, seg, B, H, KVH, S, strides, causal, s);
  }
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
  if (dh == 64) return launch(flash_fwd_f32<64>, F32Layout<64>::BYTES, prm, s);
  return launch(flash_fwd_f32<128>, F32Layout<128>::BYTES, prm, s);
}

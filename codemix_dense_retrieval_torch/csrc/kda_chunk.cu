// Kimi Delta Attention's gated delta-rule scan in its chunked form
// (models/kimi_linear.py; ops/kda.py holds the wrapper and the plain
// version). Per head, with q, k (unit keys, q scaled) and v of width D = 128,
// a per-channel log decay g_t <= 0 in R^D and a step size beta_t:
//
//   S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T,
//   o_t = S_t^T q_t,   S_0 = 0 at the start of each sequence or segment.
//
// Replaces no TPU kernel: the JAX package runs no linear attention.
//
// The chunk form (C = 64 tokens; within a chunk, G_i = sum_{l<=i} g_l, the
// chunk's carried state S0):
//   u_i + sum_{j<i} A_ij u_j = beta_i (v_i - S0^T (e^{G_i} * k_i)),
//     A_ij = beta_i sum_c k_ic k_jc e^{G_ic - G_jc}   (strictly lower)
//   o_i = S0^T (e^{G_i} * q_i) + sum_{j<=i} P_ij u_j,
//     P_ij = sum_c q_ic k_jc e^{G_ic - G_jc}          (lower, diagonal in)
//   S' = e^{G_63} * S0 (by rows) + sum_j (e^{G_63 - G_j} * k_j) u_j^T.
//
// Stability: the decay is per channel, so A and P are no product of
// k e^{G} by k e^{-G}: at log decays of -20 a step e^{-G} overflows f32
// within 5 tokens. Every factor here is e^{x} with x <= 0:
// - pairs in one 16-token block: e^{G_i - G_j} by products of per-step decays
//   alpha = e^{g} down a 4 x 4 tile's rows, one exp of a difference a tile
//   row where the tile lies below the block's diagonal;
// - pairs in blocks J < I: (x_i e^{G_i - r_I}) . (k_j e^{r_I - G_j}) with
//   r_I = G at the last token before block I, so G_i <= r_I <= G_j, on the
//   tensor cores;
// - the state terms e^{G_i}, e^{G_63 - G_j}, e^{G_63}.
// An underflow flushes a factor whose true product is smaller still.
//
// Packed rows: a token takes the carried state only if it continues the
// segment of the last token of the chunk before (carry), A and P pair tokens
// of one segment only, and the next state is that of the chunk's last
// segment. Right-padded rows are one segment of `lengths[b]` tokens.
//
// Precision: q, k, v are bf16, g and beta f32; the state, A, P, the solve
// and every sum are f32. The products with the state and with U run on the
// tensor cores as TF32 (mma.sync m16n8k8, operands rounded to TF32, f32
// accumulation); A's and P's diagonal blocks and the 16 x 16 inverses are
// f32 FMAs.
//
// Design: one block of 256 threads (8 warps) per (row, head), walking the
// row's chunks in order with the 128 x 128 f32 state in shared memory; a
// chunk is 11 phases between barriers (see the kernel). 222 KB of shared
// memory: one block an SM. No TMA or wgmma: the products are 16- to
// 64-row tiles over f32 operands built in shared memory phase by phase,
// and the phases' latency, not the tensor cores, bounds the kernel (at
// 256 x 512 x 32 heads on an H100: ~40k cycles a (chunk, head), a quarter
// each in the blocks' pair terms by FMA (P2) and between blocks (P4)).
// Requirements (checked by the Python wrapper): q, k, v, o (B, S, H, 128)
// bf16, g (B, S, H, 128) f32, beta (B, S, H) f32, all contiguous; lengths
// int32 (B,), tokens processed per row (<= S); seg int32 (B, S) or null
// (segment ids, 0 a pad); g <= 0. o is written at every processed token
// (zeros at pads) and left alone past lengths[b].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;        // tokens a chunk
constexpr int D = 128;       // head width (keys and values)
constexpr int THREADS = 256;
constexpr int SS = 136;      // row strides (floats), chosen for the mma fragment reads
constexpr int XS = 132;
constexpr int US = 136;
constexpr int AS = 68;
constexpr int PDS = 20;

constexpr int OFF_S = 0;                    // state [dk][dv]
constexpr int OFF_X = OFF_S + D * SS;       // scaled operands [token][dk]
constexpr int OFF_U = OFF_X + C * XS;       // beta v, then U [token][dv]
constexpr int OFF_G = OFF_U + C * US;       // cumulative log decay [token][dk]
constexpr int OFF_A = OFF_G + C * D;        // A (lower), 16 x 16 inverses (diagonal blocks), P^T (upper)
constexpr int OFF_PD = OFF_A + C * AS;      // P's diagonal blocks [4][16][PDS]
constexpr int OFF_B = OFF_PD + 4 * 16 * PDS;
constexpr int OFF_DEC = OFF_B + C;
constexpr int OFF_SEG = OFF_DEC + D;
constexpr int OFF_Q = OFF_SEG + C;          // bf16 q, k [token][dk]
constexpr int SMEM_FLOATS = OFF_Q + C * D;  // q and k: C * D bf16 each
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 8 at m0, k0): A(m, k) = p[m * ld + k], or p[k * ld + m] when T
template <bool T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const float* p, int ld, int m0, int k0, float sign) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m[4] = {m0 + g, m0 + g + 8, m0 + g, m0 + g + 8};
  const int k[4] = {k0 + t, k0 + t, k0 + t + 4, k0 + t + 4};
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = tf32(sign * (T ? p[k[r] * ld + m[r]] : p[m[r] * ld + k[r]]));
}

// B fragment (8 x 8 at k0, n0): B(k, n) = p[k * ld + n], or p[n * ld + k] when T
template <bool T>
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const float* p, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  b[0] = tf32(T ? p[(n0 + g) * ld + k0 + t] : p[(k0 + t) * ld + n0 + g]);
  b[1] = tf32(T ? p[(n0 + g) * ld + k0 + t + 4] : p[(k0 + t + 4) * ld + n0 + g]);
}

// accumulator tile (16 x 8 at m0, n0) from / to p[m * ld + n]
__device__ __forceinline__ void load_c(float (&d)[4], const float* p, int ld, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  d[0] = p[(m0 + g) * ld + n0 + 2 * t];
  d[1] = p[(m0 + g) * ld + n0 + 2 * t + 1];
  d[2] = p[(m0 + g + 8) * ld + n0 + 2 * t];
  d[3] = p[(m0 + g + 8) * ld + n0 + 2 * t + 1];
}

__device__ __forceinline__ void store_c(const float (&d)[4], float* p, int ld, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  p[(m0 + g) * ld + n0 + 2 * t] = d[0];
  p[(m0 + g) * ld + n0 + 2 * t + 1] = d[1];
  p[(m0 + g + 8) * ld + n0 + 2 * t] = d[2];
  p[(m0 + g + 8) * ld + n0 + 2 * t + 1] = d[3];
}

__device__ __forceinline__ float bf(const __nv_bfloat16* p, int i) { return __bfloat162float(p[i]); }

constexpr int FILL = 16 * D / THREADS;  // elements of a 16-token block a thread

enum class FillKind { kCarryK, kCarryQ, kTailK };

// X[i][c] for the chunk's 64 tokens, 8 elements a thread at a time with
// every load of a batch issued before its first store (the arrays all lie
// in one shared buffer, so the compiler cannot reorder them itself):
// kCarryK: beta_i k_ic e^{G_ic} where token i continues segment `sid`;
// kCarryQ: q_ic e^{G_ic} there; kTailK: k_jc e^{G_63c - G_jc} where token j
// is in segment `sid` (the chunk's last); zero elsewhere.
__device__ __forceinline__ void fill_scaled(float* sX, const float* sG, const __nv_bfloat16* src,
                                            const int* sSeg, const float* sB, int sid, FillKind kind) {
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int b0 = 0; b0 < C * D; b0 += FILL * THREADS) {
    float ex[FILL], xv[FILL];
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int idx = b0 + tid + u * THREADS, i = idx >> 7, c = idx & (D - 1);
      const bool on = sSeg[i] == sid && sid > 0;
      ex[u] = kind == FillKind::kTailK ? sG[(C - 1) * D + c] - sG[i * D + c] : sG[i * D + c];
      xv[u] = on ? (kind == FillKind::kCarryK ? sB[i] : 1.f) * __bfloat162float(src[i * D + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int idx = b0 + tid + u * THREADS, i = idx >> 7, c = idx & (D - 1);
      sX[i * XS + c] = xv[u] * __expf(ex[u]);
    }
  }
}

// the 10 lower 4 x 4 tiles of a 16 x 16 block: (tile row, tile column)
__constant__ int8_t TILE_R[10] = {0, 1, 1, 2, 2, 2, 3, 3, 3, 3};
__constant__ int8_t TILE_C[10] = {0, 0, 1, 0, 1, 2, 0, 1, 2, 3};

__global__ void __launch_bounds__(THREADS, 1)
kda_chunk_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ g, const float* __restrict__ beta,
                 const int* __restrict__ lengths, const int* __restrict__ seg, __nv_bfloat16* __restrict__ o,
                 int S, int H) {
  extern __shared__ float smem[];
  float* sS = smem + OFF_S;
  float* sX = smem + OFF_X;
  float* sU = smem + OFF_U;
  float* sG = smem + OFF_G;
  float* sA = smem + OFF_A;
  float* sPd = smem + OFF_PD;
  float* sB = smem + OFF_B;
  float* sDec = smem + OFF_DEC;
  int* sSeg = reinterpret_cast<int*>(smem + OFF_SEG);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + OFF_Q);
  __nv_bfloat16* sK = sQ + C * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int len = lengths[b];
  const int chunks = (len + C - 1) / C;
  const long long row_stride = static_cast<long long>(H) * D;  // elements between tokens
  const long long base = (static_cast<long long>(b) * S * H + h) * D;

  for (int i = tid; i < D * SS; i += THREADS) sS[i] = 0.f;
  int carry = 0;  // segment id the carried state belongs to (0: none)

  for (int ch = 0; ch < chunks; ++ch) {
    const int t0 = ch * C;
    const bool last = ch == chunks - 1;
    // ---- P0: load q, k (bf16), g (f32), beta, segment ids; clear P's diagonal blocks.
    // Every load of a thread is issued before its first store, so their
    // latencies overlap (one block an SM leaves few warps to hide them).
    {
      constexpr int QW = C * (D / 2) / THREADS;  // bf16 pairs a thread, per tensor
      constexpr int GW = C * (D / 4) / THREADS;  // float4 a thread
      __nv_bfloat162 rq[QW], rk[QW];
      float4 rg[GW];
#pragma unroll
      for (int u = 0; u < QW; ++u) {
        const int idx = tid + u * THREADS, i = idx / (D / 2), c2 = idx % (D / 2), tok = t0 + i;
        rq[u] = rk[u] = __float2bfloat162_rn(0.f);
        if (tok < len) {
          const long long at = base + tok * row_stride + 2 * c2;
          rq[u] = *reinterpret_cast<const __nv_bfloat162*>(q + at);
          rk[u] = *reinterpret_cast<const __nv_bfloat162*>(k + at);
        }
      }
#pragma unroll
      for (int u = 0; u < GW; ++u) {
        const int idx = tid + u * THREADS, i = idx / (D / 4), c4 = idx % (D / 4), tok = t0 + i;
        rg[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (tok < len) rg[u] = *reinterpret_cast<const float4*>(g + base + tok * row_stride + 4 * c4);
      }
#pragma unroll
      for (int u = 0; u < QW; ++u) {
        reinterpret_cast<__nv_bfloat162*>(sQ)[tid + u * THREADS] = rq[u];
        reinterpret_cast<__nv_bfloat162*>(sK)[tid + u * THREADS] = rk[u];
      }
#pragma unroll
      for (int u = 0; u < GW; ++u) reinterpret_cast<float4*>(sG)[tid + u * THREADS] = rg[u];
    }
    if (tid < C) {
      const int tok = t0 + tid;
      int sg = 0;
      float bt = 0.f;
      if (tok < len) {
        sg = seg ? seg[static_cast<long long>(b) * S + tok] : 1;
        bt = beta[(static_cast<long long>(b) * S + tok) * H + h];
      }
      sSeg[tid] = sg;
      sB[tid] = sg > 0 ? bt : 0.f;
    }
    for (int i = tid; i < 4 * 16 * PDS; i += THREADS) sPd[i] = 0.f;
    __syncthreads();

    // ---- P1: per-step decays alpha = e^g into X, G = cumulative sum (a thread a
    // channel and half of the tokens, its loads all issued first)
    {
      const int c = tid & (D - 1), half = tid >> 7;
      float gv[C / 2];
#pragma unroll
      for (int u = 0; u < C / 2; ++u) gv[u] = sG[(half * (C / 2) + u) * D + c];
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < C / 2; ++u) {
        sX[(half * (C / 2) + u) * XS + c] = __expf(gv[u]);
        run += gv[u];
        gv[u] = run;
      }
      if (half == 0) sDec[c] = run;
      __syncthreads();
      const float off = half ? sDec[c] : 0.f;
#pragma unroll
      for (int u = 0; u < C / 2; ++u) sG[(half * (C / 2) + u) * D + c] = gv[u] + off;
    }
    __syncthreads();
    const int seg_last = sSeg[C - 1];

    // ---- P2: A and P in the diagonal 16 x 16 blocks, 4 x 4 tiles, a lane a channel
    for (int tile = warp; tile < 40; tile += THREADS / 32) {
      const int blk = tile / 10, tr = TILE_R[tile % 10], tc = TILE_C[tile % 10];
      const int i0 = 16 * blk + 4 * tr, j0 = 16 * blk + 4 * tc;
      float acc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[r] = 0.f;
#pragma unroll
      for (int s = 0; s < D / 32; ++s) {
        const int c = lane + 32 * s;
        float E[4][4];
        const float a1 = sX[(i0 + 1) * XS + c], a2 = sX[(i0 + 2) * XS + c], a3 = sX[(i0 + 3) * XS + c];
        if (tr == tc) {
          // E[r][cj] = prod_{l = j + 1}^{i} alpha_l (zero above the diagonal: masked below)
#pragma unroll
          for (int cj = 0; cj < 4; ++cj) E[0][cj] = cj == 0 ? 1.f : 0.f;
          E[1][0] = a1;          E[1][1] = 1.f;       E[1][2] = 0.f;  E[1][3] = 0.f;
          E[2][0] = a1 * a2;     E[2][1] = a2;        E[2][2] = 1.f;  E[2][3] = 0.f;
          E[3][0] = E[2][0] * a3; E[3][1] = a2 * a3;  E[3][2] = a3;   E[3][3] = 1.f;
        } else {
          const float gi = sG[i0 * D + c];
#pragma unroll
          for (int cj = 0; cj < 4; ++cj) E[0][cj] = __expf(fminf(gi - sG[(j0 + cj) * D + c], 0.f));
#pragma unroll
          for (int cj = 0; cj < 4; ++cj) {
            E[1][cj] = E[0][cj] * a1;
            E[2][cj] = E[1][cj] * a2;
            E[3][cj] = E[2][cj] * a3;
          }
        }
        float kj[4];
#pragma unroll
        for (int cj = 0; cj < 4; ++cj) kj[cj] = bf(sK, (j0 + cj) * D + c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float ki = bf(sK, (i0 + r) * D + c), qi = bf(sQ, (i0 + r) * D + c);
#pragma unroll
          for (int cj = 0; cj < 4; ++cj) {
            const float w = kj[cj] * E[r][cj];
            acc[r * 4 + cj] = fmaf(ki, w, acc[r * 4 + cj]);
            acc[16 + r * 4 + cj] = fmaf(qi, w, acc[16 + r * 4 + cj]);
          }
        }
      }
      // sum over the 32 lanes: lane l ends with value l (every index a
      // constant once unrolled, so acc stays in registers)
#pragma unroll
      for (int step = 0; step < 5; ++step) {
        const int sh = 16 >> step;
        const bool upper = lane & sh;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if (r < sh) {
            const float send = upper ? acc[r] : acc[r + sh];
            const float keep = upper ? acc[r + sh] : acc[r];
            acc[r] = keep + __shfl_xor_sync(0xffffffffu, send, sh);
          }
        }
      }
      const int idx = lane & 15, r = idx >> 2, cj = idx & 3;
      const int i = i0 + r, j = j0 + cj;
      const bool same = sSeg[i] > 0 && sSeg[i] == sSeg[j];
      if (lane < 16) {
        sA[i * AS + j] = (j < i && same) ? sB[i] * acc[0] : 0.f;
      } else {
        sPd[blk * 16 * PDS + (i - 16 * blk) * PDS + (j - 16 * blk)] = (j <= i && same) ? acc[0] : 0.f;
      }
    }
    __syncthreads();

    // ---- P3: the inverses of the unit lower diagonal blocks (I + A_II), a thread a column
    {
      float x[16];
      const int blk = tid >> 4, j = tid & 15;
      const float* ab = sA + (16 * blk) * AS + 16 * blk;
      if (tid < 64) {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          float s = 0.f;
#pragma unroll
          for (int l = 0; l < r; ++l) s = fmaf(ab[r * AS + l], x[l], s);
          x[r] = r < j ? 0.f : (r == j ? 1.f : -s);
        }
      }
      __syncthreads();
      if (tid < 64) {
        float* out = sA + (16 * blk) * AS + 16 * blk;
#pragma unroll
        for (int r = 0; r < 16; ++r) out[r * AS + j] = x[r];
      }
    }
    __syncthreads();

    // ---- P4: A and P between blocks J < I, on the tensor cores
    for (int blk = 1; blk < 4; ++blk) {
      const int i0 = 16 * blk;
      const float* gref = sG + (i0 - 1) * D;
      {
        float ex[FILL], qv[FILL], kv[FILL];
#pragma unroll
        for (int u = 0; u < FILL; ++u) {
          const int idx = tid + u * THREADS, i = i0 + (idx >> 7), c = idx & (D - 1);
          ex[u] = sG[i * D + c] - gref[c];
          qv[u] = bf(sQ, i * D + c);
          kv[u] = bf(sK, i * D + c);
        }
#pragma unroll
        for (int u = 0; u < FILL; ++u) {
          const int idx = tid + u * THREADS, r = idx >> 7, c = idx & (D - 1);
          const float e = __expf(ex[u]);
          sX[r * XS + c] = qv[u] * e;
          sX[(16 + r) * XS + c] = kv[u] * e;
        }
      }
      for (int jb = 0; jb < blk; ++jb) {
        float ex[FILL], kv[FILL];
#pragma unroll
        for (int u = 0; u < FILL; ++u) {
          const int idx = tid + u * THREADS, j = 16 * jb + (idx >> 7), c = idx & (D - 1);
          ex[u] = gref[c] - sG[j * D + c];
          kv[u] = bf(sK, j * D + c);
        }
#pragma unroll
        for (int u = 0; u < FILL; ++u) {
          const int idx = tid + u * THREADS, j = 16 * jb + (idx >> 7), c = idx & (D - 1);
          sU[j * US + c] = kv[u] * __expf(ex[u]);
        }
      }
      __syncthreads();
      const int ntiles = 2 * blk;  // n8 tiles over the i0 earlier tokens
      for (int tile = warp; tile < 2 * ntiles; tile += THREADS / 32) {
        const int mt = tile / ntiles, nt = tile % ntiles;
        float d[4] = {0.f, 0.f, 0.f, 0.f}, d2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < D / 8; kk += 2) {   // two chains of mma in flight
          uint32_t a[4], bb[2], a2[4], bb2[2];
          load_a<false>(a, sX, XS, 16 * mt, 8 * kk, 1.f);
          load_b<true>(bb, sU, US, 8 * kk, 8 * nt);
          load_a<false>(a2, sX, XS, 16 * mt, 8 * kk + 8, 1.f);
          load_b<true>(bb2, sU, US, 8 * kk + 8, 8 * nt);
          mma(d, a, bb);
          mma(d2, a2, bb2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] += d2[e];
        const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gq + (e >= 2 ? 8 : 0), j = 8 * nt + 2 * tq + (e & 1);
          const bool same = sSeg[i] > 0 && sSeg[i] == sSeg[j];
          if (mt == 0) sA[j * AS + i] = same ? d[e] : 0.f;           // P^T, upper blocks
          else sA[i * AS + j] = same ? sB[i] * d[e] : 0.f;           // A, lower blocks
        }
      }
      __syncthreads();
    }

    // ---- P5: X = beta e^G k (carried tokens), U = beta v; then U -= X S0
    const bool has_state = carry > 0;
    if (has_state) fill_scaled(sX, sG, sK, sSeg, sB, carry, FillKind::kCarryK);
    {
      constexpr int VW = C * (D / 2) / THREADS;
      float2 rv[VW];
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        const int idx = tid + u * THREADS, i = idx / (D / 2), c2 = idx % (D / 2);
        rv[u] = make_float2(0.f, 0.f);
        if (sSeg[i] > 0)
          rv[u] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + base + (t0 + i) * row_stride + 2 * c2));
      }
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        const int idx = tid + u * THREADS, i = idx / (D / 2), c2 = idx % (D / 2);
        sU[i * US + 2 * c2] = sB[i] * rv[u].x;
        sU[i * US + 2 * c2 + 1] = sB[i] * rv[u].y;
      }
    }
    __syncthreads();
    const int mb = (warp >> 2) * 32, nb = (warp & 3) * 32;  // a warp's 32 x 32 tile of a 64 x 128 product
    if (has_state) {
      float d[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) load_c(d[mi][ni], sU, US, mb + 16 * mi, nb + 8 * ni);
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t a[2][4], bb[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) load_a<false>(a[mi], sX, XS, mb + 16 * mi, 8 * kk, -1.f);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) load_b<false>(bb[ni], sS, SS, 8 * kk, nb + 8 * ni);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma(d[mi][ni], a[mi], bb[ni]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) store_c(d[mi][ni], sU, US, mb + 16 * mi, nb + 8 * ni);
    }
    __syncthreads();

    // ---- P6: U = (I + A)^{-1} U by blocks; a warp owns 16 value columns, no barrier
    {
      const int n0 = 16 * warp;
      for (int blk = 0; blk < 4; ++blk) {
        float d[2][4];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) load_c(d[ni], sU, US, 16 * blk, n0 + 8 * ni);
        for (int kk = 0; kk < 2 * blk; ++kk) {
          uint32_t a[4], bb[2];
          load_a<false>(a, sA, AS, 16 * blk, 8 * kk, -1.f);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            load_b<false>(bb, sU, US, 8 * kk, n0 + 8 * ni);
            mma(d[ni], a, bb);
          }
        }
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) store_c(d[ni], sU, US, 16 * blk, n0 + 8 * ni);
        __syncwarp();
        float e[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[4], bb[2];
          load_a<false>(a, sA + (16 * blk) * AS + 16 * blk, AS, 0, 8 * kk, 1.f);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            load_b<false>(bb, sU + (16 * blk) * US, US, 8 * kk, n0 + 8 * ni);
            mma(e[ni], a, bb);
          }
        }
        __syncwarp();
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) store_c(e[ni], sU, US, 16 * blk, n0 + 8 * ni);
        __syncwarp();
      }
    }
    __syncthreads();

    // ---- P7: X = e^G q (carried tokens)
    if (has_state) fill_scaled(sX, sG, sQ, sSeg, sB, carry, FillKind::kCarryQ);
    __syncthreads();

    // ---- P8: O = X S0 + P U, written as bf16
    {
      float d[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[mi][ni][e] = 0.f;
      if (has_state) {
#pragma unroll 2
        for (int kk = 0; kk < D / 8; ++kk) {
          uint32_t a[2][4], bb[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) load_a<false>(a[mi], sX, XS, mb + 16 * mi, 8 * kk, 1.f);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) load_b<false>(bb[ni], sS, SS, 8 * kk, nb + 8 * ni);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma(d[mi][ni], a[mi], bb[ni]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int blk = (mb >> 4) + mi;
        for (int kk = 0; kk < 2 * (blk + 1); ++kk) {
          const int jb = kk >> 1;
          uint32_t a[4], bb[4][2];
          if (jb < blk) load_a<true>(a, sA, AS, 16 * blk, 8 * kk, 1.f);
          else load_a<false>(a, sPd + blk * 16 * PDS, PDS, 0, 8 * (kk & 1), 1.f);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) load_b<false>(bb[ni], sU, US, 8 * kk, nb + 8 * ni);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma(d[mi][ni], a, bb[ni]);
        }
      }
      const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = mb + 16 * mi + gq + 8 * half, tok = t0 + i;
          if (tok < len) {
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const int n = nb + 8 * ni + 2 * tq;
              *reinterpret_cast<__nv_bfloat162*>(o + base + tok * row_stride + n) =
                  __floats2bfloat162_rn(d[mi][ni][2 * half], d[mi][ni][2 * half + 1]);
            }
          }
        }
    }
    if (last) break;
    __syncthreads();

    // ---- P9: X = e^{G_63 - G_j} k_j (the last segment's tokens), row decays of S0
    const bool keep = has_state && seg_last == carry;
    fill_scaled(sX, sG, sK, sSeg, sB, seg_last, FillKind::kTailK);
    if (tid < D) sDec[tid] = keep ? __expf(sG[(C - 1) * D + tid]) : 0.f;
    __syncthreads();

    // ---- P10: S = Diag(dec) S0 + X^T U; a warp owns 16 key rows
    {
      const int m0 = 16 * warp, gq = lane >> 2;
      float d[16][4];
      const float d0 = sDec[m0 + gq], d1 = sDec[m0 + gq + 8];
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        load_c(d[ni], sS, SS, m0, 8 * ni);
        d[ni][0] *= d0;
        d[ni][1] *= d0;
        d[ni][2] *= d1;
        d[ni][3] *= d1;
      }
#pragma unroll 2
      for (int kk = 0; kk < C / 8; ++kk) {
        uint32_t a[4];
        load_a<true>(a, sX, XS, m0, 8 * kk, 1.f);
#pragma unroll
        for (int ni = 0; ni < 16; ++ni) {
          uint32_t bb[2];
          load_b<false>(bb, sU, US, 8 * kk, 8 * ni);
          mma(d[ni], a, bb);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) store_c(d[ni], sS, SS, m0, 8 * ni);
    }
    carry = seg_last;
    __syncthreads();
  }
}

}  // namespace

extern "C" int kda_chunk_launch(const void* q, const void* k, const void* v, const void* g, const void* beta,
                                const void* lengths, const void* seg, void* o, int B, int S, int H, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kda_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kda_chunk_kernel<<<B * H, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(g), static_cast<const float*>(beta),
      static_cast<const int*>(lengths), static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(o), S, H);
  return cudaGetLastError();
}

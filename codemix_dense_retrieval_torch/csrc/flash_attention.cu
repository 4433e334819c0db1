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
// What bounds it on an H100: operations. Per (sequence, head) it reads and
// writes 4 * S * dh values but does 4 * S * len * dh flops (half that
// causal), hundreds of flops per byte at S >= 256, above the card's ~295
// flops/byte bf16 ridge. Two callers: BGE-M3 (XLM-R) at S >= 512, dh = 64,
// non-causal, whole rows or packed rows with segment ids; Qwen3-Embedding
// causal with GQA (16 q heads over 8 KV heads), dh = 128, at every length
// bucket from 16 to 1024, ragged or packed. The design keeps the S x S score
// matrix out of device memory and skips the key blocks past min(length,
// causal frontier), the work the TPU kernel also skips.
//
// Design, bf16 (the card's path), a warp-specialised Hopper kernel (sm90.cuh):
// - persistent blocks, one per SM, each walking over tiles of 128 query rows
//   of one (batch, head): a producer warpgroup and two consumer warpgroups of
//   64 query rows; setmaxnreg gives the producer's registers to the
//   consumers (40 / 232). The producer runs ahead into the next tile, so its
//   Q and first K/V tiles load while the current tile finishes;
// - the tile order (tile_plan): non-causal, query tile fastest, so the tiles
//   of one (batch, head) run side by side and share its K/V in L2. Causal,
//   a tile's work grows with its query tile (qt + 1 key blocks), and with
//   the query tile fastest over 132 blocks each block alternates two query
//   tiles (at S = 1024: 132 mod 8 = 4), the busiest carrying ~1.37x the mean;
//   so causal tiles run heaviest first, in chunks of whole sequences sized to
//   ~8 waves of tiles (their K/V stays in L2), (batch, head) fastest inside a
//   chunk: within ~1.03x of the mean. At S <= 64 with an even GQA group one
//   tile holds two q heads of one KV head (64 rows each, one warpgroup per
//   head, one Q box of two heads), where a 128-row tile would leave at least
//   half its rows past S;
// - one producer thread loads Q once per tile and K and V tiles of 128 keys
//   x dh by TMA into a 3-stage ring guarded by mbarriers (dh = 128: 224 KB);
//   each consumer warp hands Q back as soon as its tile's last S is done, so
//   the next tile's Q loads under the last softmax and P.V.
//   The tensor maps describe the strided (B, S, H, dh) view as 4-D (dh, S,
//   H, B), so no transpose copy is made, and rows past S read as zeros. A
//   64-value (128-byte) box with the 128-byte swizzle is exactly wgmma's
//   operand layout (dh = 128 takes two);
// - S = Q.K^T by wgmma m64n128k16 (bf16, f32 accumulate) from shared memory,
//   K read K-major; lengths, causal and segment masks and the online softmax
//   (exp2 of one FMA, the scale folded into log2 e / sqrt(dh)) run on the
//   accumulator fragments in registers. The masks run as a separate pass on
//   the key blocks that need one: the block that crosses the length, every
//   block of a segmented call, and causal only the diagonal block (the key
//   loop already stops at the causal frontier). Kept inside the softmax's
//   unrolled loop as a per-element branch, they cost 0.2 of its 0.55 ms on
//   an H100 at BGE-M3's shape;
// - P is rounded to bf16 in registers and fed as the register A operand of
//   the P.V wgmma (m64n{dh}k16); V is read MN-major through the descriptor's
//   transpose flag, so it is never transposed by hand;
// - the products and the exponentials overlap: a warpgroup issues S(k) and
//   P(k-1).V(k-1) together, then runs block k's softmax while they run, and
//   the two warpgroups take turns issuing (two named barriers), so one's
//   softmax runs beside the other's products;
// - the output: once both consumer warpgroups' products of a tile are done,
//   they write its rows as bf16 into the K half of the tile's last K/V stage
//   in K's swizzle, and a storer thread of the producer warpgroup sends them
//   out with a TMA store per 64 rows x 64 columns (rows past S are skipped)
//   and then releases the stage to the producer. Stored from the fragments
//   instead (a 4-byte store per thread over 8 rows per instruction), the rows
//   held the warpgroups for ~1/6 of the kernel at Qwen3's shapes on an
//   H100; issued by a consumer thread, the TMA store cost the consumers'
//   loop the registers that keep its wgmmas asynchronous (ptxas C7512);
// What bounds it now: at dh = 64 a 128 x 128 key block costs as many MUFU
// cycles (16 ex2 per SM clock) as tensor-core cycles, so the overlap above
// is what keeps the tensor cores fed; at dh = 128 the products take twice
// the exponentials' cycles.
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

constexpr int WQ = 128;        // query rows per tile: two consumer warpgroups of 64
constexpr int WK = 128;        // keys per stage
constexpr int WTHREADS = 384;  // producer warpgroup + two consumer warpgroups
// causal tiles run in chunks of whole sequences, heaviest query tile first
// inside a chunk; a chunk holds about this many waves of tiles (one tile per
// block), so its K/V (~35 MB at 132 SMs for dh = 128 over half as many KV
// heads, or dh = 64 over as many) stays in the 50 MB L2 across its query
// tiles, and the blocks' shares even out
constexpr int CAUSAL_CHUNK_WAVES = 8;

// the order of a launch's tiles (WgParams::mode)
enum TileMode {
  TILES_QUERY_FASTEST = 0,  // (batch, head, query tile), query tile fastest
  TILES_CAUSAL = 1,         // chunks of sequences, heaviest query tile first
  TILES_HEAD_PAIRS = 2,     // S <= 64: one tile = two q heads of one KV head
};

// K/V ring depth: dh = 128 takes 3 x 64 KB beside its 32 KB Q tile, 224 KB
// of the 227 (two stages and a second Q buffer measured slower on an H100)
constexpr int WSTAGES = 3;

template <int DH>
struct WgLayout {
  static constexpr int Q_HALF = WQ * 128;  // one 64-column (128-byte) half of the Q tile
  static constexpr int KV_HALF = WK * 128;
  static constexpr int KV_BYTES = KV_HALF * (DH / 64);
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_HALF * (DH / 64);
  static constexpr int V_OFF = K_OFF + WSTAGES * KV_BYTES;
  // q_full, q_empty, o_staged, full[WSTAGES], empty[WSTAGES]
  static constexpr int BAR_OFF = V_OFF + WSTAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (3 + 2 * WSTAGES) + 1024;  // + 1024-byte alignment slack
  static_assert(BYTES <= 227 * 1024, "kernel B's shared memory");
};

struct WgParams {
  const int* lengths;
  const int* seg;  // (B, S) or null
  void* out;       // (written directly only for rows of length-0 sequences)
  long long ob, oh, os;
  int B, H, KVH, S;
  int causal;
  int mode;      // TileMode
  int chunk_b;   // TILES_CAUSAL: sequences per chunk
  float scale_log2;  // log2(e) / sqrt(dh)
};

// a tile: query rows from q0, batch b, first q head hq (TILES_HEAD_PAIRS:
// heads hq and hq + 1, rows 0 .. S - 1 each)
struct WgTile {
  int q0, b, hq;
};

__device__ __forceinline__ WgTile tile_at(const WgParams& p, int n_qt, int tile) {
  WgTile t;
  if (p.mode == TILES_HEAD_PAIRS) {
    const int pairs = p.H / 2;
    t.q0 = 0;
    t.b = tile / pairs;
    t.hq = 2 * (tile % pairs);
  } else if (p.mode == TILES_CAUSAL) {
    // chunks of chunk_b sequences (the last may hold fewer); inside one, the
    // last query tile of every (batch, head) first, (batch, head) fastest
    const int per_b = p.H * n_qt;
    const int full = p.B / p.chunk_b;
    int c = tile / (p.chunk_b * per_b);
    int nb = p.chunk_b;
    if (c >= full) {
      c = full;
      nb = p.B - full * p.chunk_b;
    }
    const int u = tile - c * p.chunk_b * per_b;
    const int bh = u % (nb * p.H);
    t.q0 = (n_qt - 1 - u / (nb * p.H)) * WQ;
    t.b = c * p.chunk_b + bh / p.H;
    t.hq = bh % p.H;
  } else {
    t.q0 = (tile % n_qt) * WQ;
    t.b = tile / n_qt / p.H;
    t.hq = tile / n_qt % p.H;
  }
  return t;
}

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
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                WgParams p) {
  using L = WgLayout<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::Q_OFF;
  const uint32_t sK = base + L::K_OFF;
  const uint32_t sV = base + L::V_OFF;
  const uint32_t bar_qfull = base + L::BAR_OFF;
  const uint32_t bar_qempty = bar_qfull + 8;
  const uint32_t bar_ostaged = bar_qfull + 16;        // a tile's output rows are staged
  const uint32_t bar_full = bar_qfull + 24;           // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * WSTAGES;   // + 8 * stage

  const int tid = threadIdx.x;
  const int S = p.S;
  const int n_qt = (S + WQ - 1) / WQ;
  const bool pairs = p.mode == TILES_HEAD_PAIRS;
  const int tiles = pairs ? p.B * (p.H / 2) : n_qt * p.B * p.H;
  // a tile's key blocks: up to min(length, causal frontier)
  auto key_blocks = [&](int q0, int length) {
    const int limit = p.causal ? min(length, q0 + WQ) : length;
    return limit > 0 ? (limit + WK - 1) / WK : 0;
  };

  if (tid == 0) {
    sm90::mbar_init(bar_qfull, 1);
    sm90::mbar_init(bar_qempty, 8);     // lane 0 of each consumer warp
    sm90::mbar_init(bar_ostaged, 256);  // every consumer thread, its output rows staged
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
        const WgTile tl = tile_at(p, n_qt, tile);
        const int kvh = tl.hq / (p.H / p.KVH);
        const int n_kb = key_blocks(tl.q0, min(p.lengths[tl.b], S));
        sm90::mbar_wait(bar_qempty, (tq & 1) ^ 1);  // every S of the previous tile is done
        sm90::mbar_expect_tx(bar_qfull, L::Q_HALF * (DH / 64));
        // one box of 128 rows of head hq, or (head pairs) 64 rows of heads hq, hq + 1
#pragma unroll
        for (int c = 0; c < DH / 64; ++c)
          sm90::tma_load_4d(sQ + c * L::Q_HALF, &qmap, bar_qfull, c * 64, tl.q0, tl.hq, tl.b);
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int st = it % WSTAGES;
          sm90::mbar_wait(bar_empty + 8 * st, ((it / WSTAGES) & 1) ^ 1);
          sm90::mbar_expect_tx(bar_full + 8 * st, 2 * L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < DH / 64; ++c) {
            const uint32_t off = st * L::KV_BYTES + c * L::KV_HALF;
            sm90::tma_load_4d(sK + off, &kmap, bar_full + 8 * st, c * 64, kb * WK, kvh, tl.b);
            sm90::tma_load_4d(sV + off, &vmap, bar_full + 8 * st, c * 64, kb * WK, kvh, tl.b);
          }
        }
      }
    }
    if (tid == 32) {
      // ---- storer: each tile's output rows, staged by the consumers in the
      // K half of the tile's last K/V stage, to the output by TMA; then that
      // stage goes back to the producer ----
      sm90::tma_prefetch(&omap);
      int it = 0;      // K/V stages of the tiles so far
      int staged = 0;  // tiles staged so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const WgTile tl = tile_at(p, n_qt, tile);
        const int n_kb = key_blocks(tl.q0, min(p.lengths[tl.b], S));
        if (n_kb == 0) continue;  // its zeros are stored by the consumers
        it += n_kb;
        const int st = (it - 1) % WSTAGES;
        sm90::mbar_wait(bar_ostaged, staged++ & 1);
#pragma unroll
        for (int w = 0; w < 2; ++w)
#pragma unroll
          for (int c = 0; c < DH / 64; ++c)
            sm90::tma_store_4d(&omap, sK + st * L::KV_BYTES + w * 64 * 128 + c * L::KV_HALF, c * 64,
                               pairs ? 0 : tl.q0 + 64 * w, tl.hq + (pairs ? w : 0), tl.b);
        sm90::bulk_commit();
        sm90::bulk_wait_read<0>();
        sm90::mbar_arrive_cnt(bar_empty + 8 * st, 8);  // as the 8 consumer warps release a stage
      }
      sm90::bulk_wait<0>();  // the last tile's rows are written
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 of each
    // tile (head pairs: rows 0 .. 63 of head hq + wg) ----
    sm90::setmaxnreg_inc<232>();
    const int wg = role - 1;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    // the two warpgroups take turns issuing their products (named barriers
    // 1 and 2), so one's softmax runs while the other's products do
    const int bar_mine = 1 + wg, bar_other = 2 - wg;
    int it = 0;  // K/V stages consumed before this tile
    int tq = 0;  // tiles so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tq) {
      const WgTile tl = tile_at(p, n_qt, tile);
      const int b = tl.b;
      const int h = tl.hq + (pairs ? wg : 0);
      const uint32_t q_wg = sQ + wg * 64 * 128;
      const int length = min(p.lengths[b], S);
      const int n_kb = key_blocks(tl.q0, length);
      const int row0 = pairs ? 0 : tl.q0 + wg * 64;  // this warpgroup's first query row
      const int r0 = row0 + warp * 16 + g;  // this thread's two query rows
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
      // exponentials exp2(s * scale - m), in place in s; a masked key gives 0.
      // The mask pass runs on the blocks that need it: the one that crosses
      // the length, every block of a segmented (packed) call, and, causal,
      // the one that reaches past this warpgroup's first row (the diagonal)
      auto softmax = [&](int kb) {
        const int k0 = kb * WK;
        if (k0 + WK > length || p.seg != nullptr || (p.causal && k0 + WK - 1 > row0)) mask(k0);
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
        if (n_kb == 1 && lane == 0) sm90::mbar_arrive(bar_qempty);  // every S of the tile is done
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
          if (kb + 1 == n_kb && lane == 0) sm90::mbar_arrive(bar_qempty);  // every S of the tile is done
          softmax(kb);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(o);
          release(kb - 1);
          pack();
        }
        issue_pv(n_kb - 1);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        // the output rows as bf16 pairs into the K half of the tile's last
        // K/V stage (once q_empty says both warpgroups' S are done: the
        // other's last S may still read it), in the 128-byte swizzle K was
        // loaded with; the storer sends them out by TMA, which skips rows past
        // S, and then releases the stage, so no consumer thread waits on
        // global stores
        const float inv0 = m0 > NEG / 2 ? 1.0f / fmaxf(l0, 1e-30f) : 0.0f;
        const float inv1 = m1 > NEG / 2 ? 1.0f / fmaxf(l1, 1e-30f) : 0.0f;
        sm90::mbar_wait(bar_qempty, tq & 1);
        // row w of the 64 at w * 128, its 16-byte chunk c at (c ^ (w % 8)) * 16;
        // the thread's rows warp * 16 + g (+ 8) both have w % 8 = g, so column
        // pair 8 n + 2 t sits at the row's base ^ ((n % 8) * 16), + KV_HALF
        // per 64 columns
        const uint32_t o0 = sK + ((it + n_kb - 1) % WSTAGES) * L::KV_BYTES + wg * 64 * 128 +
                            (warp * 16 + g) * 128 + (g << 4) + 4 * t;
        const uint32_t o1 = o0 + 8 * 128;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          const __nv_bfloat162 v0 = __floats2bfloat162_rn(o[4 * n + 0] * inv0, o[4 * n + 1] * inv0);
          const __nv_bfloat162 v1 = __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
          const uint32_t sw = (n % 8) << 4, hk = (n / 8) * L::KV_HALF;
          sm90::st_shared_b32((o0 ^ sw) + hk, *reinterpret_cast<const uint32_t*>(&v0));
          sm90::st_shared_b32((o1 ^ sw) + hk, *reinterpret_cast<const uint32_t*>(&v1));
        }
        sm90::fence_proxy_async();
        sm90::mbar_arrive(bar_ostaged);
      } else {
        // no valid key (length 0): the rows are zeros, stored directly
        if (lane == 0) sm90::mbar_arrive(bar_qempty);
        __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + b * p.ob + h * p.oh;
        for (int i = tid % 128; i < 64 * (DH / 8); i += 128) {
          const int row = row0 + i / (DH / 8);
          if (row < S) *reinterpret_cast<uint4*>(og + row * p.os + (i % (DH / 8)) * 8) = make_uint4(0, 0, 0, 0);
        }
      }
      it += n_kb;
    }
  }
}

// the tile order of a launch (TileMode) and, causal, its chunk of sequences:
// about CAUSAL_CHUNK_WAVES waves of `grid` tiles, spread evenly over the batch
inline void tile_plan(int B, int H, int KVH, int S, int causal, int grid, int* mode, int* chunk_b) {
  const int n_qt = (S + WQ - 1) / WQ;
  *chunk_b = B;
  if (S <= 64 && (H / KVH) % 2 == 0) {
    *mode = TILES_HEAD_PAIRS;
  } else if (causal) {
    *mode = TILES_CAUSAL;
    const long long per_b = static_cast<long long>(H) * n_qt;
    long long want = (static_cast<long long>(CAUSAL_CHUNK_WAVES) * grid + per_b - 1) / per_b;
    if (want < 1) want = 1;
    const long long chunks = (B + want - 1) / want;
    *chunk_b = static_cast<int>((B + chunks - 1) / chunks);
  } else {
    *mode = TILES_QUERY_FASTEST;
  }
}

// strides: element strides (batch, head, seq) of q, k, v, out; head dim contiguous
template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, const int* lengths,
                 const int* seg, int B, int H, int KVH, int S, const long long* st, int causal,
                 cudaStream_t stream) {
  using L = WgLayout<DH>;
  const int sms = sm90::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long n_qt = (S + WQ - 1) / WQ;
  WgParams prm;
  tile_plan(B, H, KVH, S, causal, sms, &prm.mode, &prm.chunk_b);
  const bool pairs = prm.mode == TILES_HEAD_PAIRS;
  const long long tiles = pairs ? static_cast<long long>(B) * (H / 2) : n_qt * B * H;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) {
    const uint64_t heads = i == 0 || i == 3 ? H : KVH;
    const uint64_t dims[4] = {DH, static_cast<uint64_t>(S), heads, static_cast<uint64_t>(B)};
    const uint64_t bytes[3] = {static_cast<uint64_t>(st[3 * i + 2]) * 2,
                               static_cast<uint64_t>(st[3 * i + 1]) * 2,
                               static_cast<uint64_t>(st[3 * i]) * 2};
    // Q of a head pair: 64 rows of two heads in one box, the same 16 KB (per
    // 64 columns) as 128 rows of one head; O: a warpgroup's 64 rows
    const uint32_t box[4] = {64, i == 3 || (i == 0 && pairs) ? 64u : 128u, i == 0 && pairs ? 2u : 1u, 1};
    const int rc =
        sm90::make_tma(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptrs[i], 4, dims, bytes, box);
    if (rc != 0) return rc;
  }
  prm.lengths = lengths;
  prm.seg = seg;
  prm.B = B;
  prm.H = H;
  prm.KVH = KVH;
  prm.S = S;
  prm.causal = causal;
  prm.scale_log2 = LOG2E / sqrtf(static_cast<float>(DH));
  prm.out = out;
  prm.ob = st[9];
  prm.oh = st[10];
  prm.os = st[11];
  const int smem = L::BYTES > sm90::ONE_BLOCK_SMEM ? L::BYTES : sm90::ONE_BLOCK_SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid = static_cast<unsigned int>(tiles < sms ? tiles : sms);  // persistent blocks
  flash_fwd_wgmma<DH><<<grid, WTHREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], prm);
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

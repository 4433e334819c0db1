// The elementwise steps of a Kimi Delta Attention block around its scan
// (models/kimi_linear.py, KdaAttention; ops/kda.py holds the wrappers and
// the plain versions), each one pass over its rows in place of torch's
// chains of casts, copies, a depthwise convolution and norms:
// - kda_conv_kernel: y = SiLU(causal depthwise conv of x over K = 4 taps,
//   the taps inside the token's own segment), then, for q and k, each
//   head's 128 channels L2-normalized (norm clamped at 1e-12) and scaled;
//   x (B, S, H * 128) bf16 -> y (B, S, H, 128) bf16, f32 inside;
// - kda_gate_kernel: g = -exp(A_log[h]) softplus(f + dt_bias) (f32, torch's
//   softplus: the input itself above 20) and beta = sigmoid(b) (f32);
// - kda_out_kernel: out = RMSNorm(o) w * sigmoid(gate) per head (f32
//   inside, eps given), rounded to bf16.
// A warp takes one head (a lane 4 channels) of one token, or for the
// convolution of a run of 16 tokens.
// Replace no TPU kernel: the JAX package runs no linear attention.
// Requirements (checked by the Python wrapper): bf16 rows of H * 128,
// contiguous; conv weights (H * 128, 1, 4) bf16; A_log (H,) and dt_bias
// (H * 128,) bf16; seg (B, S) int32 or null (then lengths (B,) int32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int TAPS = 4;
constexpr int WARPS = 8;

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  v[0] = fa.x;
  v[1] = fa.y;
  v[2] = fb.x;
  v[3] = fb.y;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int segment_of(const int* seg, const int* lengths, int b, int S, int t) {
  return seg ? seg[static_cast<long long>(b) * S + t] : (t < lengths[b] ? 1 : 0);
}

// a warp takes one head over RUN consecutive tokens of a row, each x row
// read once and the last TAPS - 1 kept in registers
constexpr int RUN = 16;

__global__ void __launch_bounds__(WARPS * 32)
kda_conv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ seg, const int* __restrict__ lengths, __nv_bfloat16* __restrict__ y,
                int B, int S, int H, int normalize, float scale) {
  const int runs = (S + RUN - 1) / RUN;
  const long long item = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(B) * runs * H) return;
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(item % H);
  const long long br = item / H;
  const int t0 = static_cast<int>(br % runs) * RUN, b = static_cast<int>(br / runs);
  const long long C = static_cast<long long>(H) * D;
  const int c0 = h * D + 4 * lane;
  float wt[4][TAPS];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint2 raw = *reinterpret_cast<const uint2*>(w + static_cast<long long>(c0 + j) * TAPS);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    wt[j][0] = a.x;
    wt[j][1] = a.y;
    wt[j][2] = bb.x;
    wt[j][3] = bb.y;
  }
  // win[m]: token t - (TAPS - 1) + m for m < TAPS - 1, its segment in wseg (-1: before the row)
  float win[TAPS][4];
  int wseg[TAPS];
#pragma unroll
  for (int m = 0; m < TAPS - 1; ++m) {
    const int src = t0 - (TAPS - 1) + m;
    wseg[m] = -1;
    if (src >= 0) {
      wseg[m] = segment_of(seg, lengths, b, S, src);
      load4(x + (static_cast<long long>(b) * S + src) * C + c0, win[m]);
    }
  }
  const int t1 = min(S, t0 + RUN);
  for (int t = t0; t < t1; ++t) {
    wseg[TAPS - 1] = segment_of(seg, lengths, b, S, t);
    load4(x + (static_cast<long long>(b) * S + t) * C + c0, win[TAPS - 1]);
    const int own = wseg[TAPS - 1];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < TAPS; ++m) {
      if (wseg[m] != own) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(wt[j][m], win[m][j], acc[j]);
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j] = acc[j] / (1.f + __expf(-acc[j]));
      ss = fmaf(acc[j], acc[j], ss);
    }
    if (normalize) {
      const float inv = scale / fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] *= inv;
    }
    store4(y + (static_cast<long long>(b) * S + t) * C + c0, acc);
#pragma unroll
    for (int m = 0; m < TAPS - 1; ++m) {
      wseg[m] = wseg[m + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) win[m][j] = win[m + 1][j];
    }
  }
}

__global__ void kda_gate_kernel(const __nv_bfloat16* __restrict__ f, const __nv_bfloat16* __restrict__ bproj,
                                const __nv_bfloat16* __restrict__ a_log, const __nv_bfloat16* __restrict__ dt_bias,
                                float* __restrict__ g, float* __restrict__ beta, long long tokens, int H) {
  const long long C = static_cast<long long>(H) * D;
  const long long n4 = tokens * C / 4;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long e = 4 * i;
    const int c = static_cast<int>(e % C);
    const float rate = __expf(__bfloat162float(a_log[c / D]));
    float fv[4], dv[4];
    load4(f + e, fv);
    load4(dt_bias + c, dv);
    float4 out;
    float* o = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float z = fv[j] + dv[j];
      o[j] = -rate * (z > 20.f ? z : log1pf(__expf(z)));
    }
    *reinterpret_cast<float4*>(g + e) = out;
  }
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < tokens * H;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    beta[i] = 1.f / (1.f + __expf(-__bfloat162float(bproj[i])));
}

__global__ void __launch_bounds__(WARPS * 32)
kda_out_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ gate,
               const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out, long long items, float eps) {
  const long long item = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (item >= items) return;
  const int lane = threadIdx.x & 31;
  const long long at = item * D + 4 * lane;
  float ov[4], gv[4], wv[4];
  load4(o + at, ov);
  load4(gate + at, gv);
  load4(w + 4 * lane, wv);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) ss = fmaf(ov[j], ov[j], ss);
  const float r = rsqrtf(warp_sum(ss) / D + eps);
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) res[j] = ov[j] * r * wv[j] / (1.f + __expf(-gv[j]));
  store4(out + at, res);
}

int blocks_for(long long items) { return static_cast<int>((items + WARPS - 1) / WARPS); }

}  // namespace

extern "C" int kda_conv_launch(const void* x, const void* w, const void* seg, const void* lengths, void* y, int B,
                               int S, int H, int normalize, float scale, void* stream) {
  const long long items = static_cast<long long>(B) * ((S + RUN - 1) / RUN) * H;
  if (items <= 0 || (seg == nullptr && lengths == nullptr) || items / WARPS >= (1LL << 31))
    return cudaErrorInvalidValue;
  kda_conv_kernel<<<blocks_for(items), WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<const int*>(seg),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(y), B, S, H, normalize, scale);
  return cudaGetLastError();
}

extern "C" int kda_gate_launch(const void* f, const void* b, const void* a_log, const void* dt_bias, void* g,
                               void* beta, long long tokens, int H, void* stream) {
  if (tokens <= 0 || H <= 0) return cudaErrorInvalidValue;
  kda_gate_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(a_log), static_cast<const __nv_bfloat16*>(dt_bias),
      static_cast<float*>(g), static_cast<float*>(beta), tokens, H);
  return cudaGetLastError();
}

extern "C" int kda_out_launch(const void* o, const void* gate, const void* w, void* out, long long items, float eps,
                              void* stream) {
  if (items <= 0 || items / WARPS >= (1LL << 31)) return cudaErrorInvalidValue;
  kda_out_kernel<<<blocks_for(items), WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(gate),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), items, eps);
  return cudaGetLastError();
}

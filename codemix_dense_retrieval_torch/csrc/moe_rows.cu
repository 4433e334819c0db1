// The row moves of a mixture-of-experts layer that holds a share of its
// experts (models/moe.py, MoeLayer with `held` narrower than all experts):
// the (token, slot) rows routed to a held expert come first in the layer's
// expert-sorted order, and how many there are, `count`, is known only on the
// card (the last running end of the grouped products' offsets). Each kernel
// reads `count` from device memory and touches only those rows, so the layer
// neither reads the count back nor moves the rows routed to experts held
// elsewhere (7 of 8 at 32 of 256 experts held):
// - moe_gather_kernel: out[r] = x[src[r]] for r < count (bf16 rows of H);
// - moe_act_kernel: out[r] = SiLU(gu[r, :F]) * gu[r, F:] for r < count,
//   in f32, rounded to bf16 as torch rounds silu(a) * b of bf16 tensors
//   (each op rounds: silu to bf16, then the product);
// - moe_combine_kernel: out[t] = bf16(sum_s w[t, s] * ys[inv[t k + s]]) over
//   token t's k slots whose row inv[.] < count, in f32 in slot order.
// Replace no TPU kernel: the JAX package's encoders are dense.
// Requirements (checked by the Python wrapper): bf16 rows, contiguous, H and
// F multiples of 8 and 16-byte aligned rows; src int64, inv int32, w f32;
// count one int32 on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void moe_gather_kernel(const __nv_bfloat16* __restrict__ x, const long long* __restrict__ src,
                                  const int* __restrict__ count, __nv_bfloat16* __restrict__ out, int H) {
  const int n = *count;
  const int vecs = H / 8;
  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    const uint4* s = reinterpret_cast<const uint4*>(x + src[r] * H);
    uint4* d = reinterpret_cast<uint4*>(out + static_cast<long long>(r) * H);
    for (int i = threadIdx.x; i < vecs; i += blockDim.x) d[i] = s[i];
  }
}

__global__ void moe_act_kernel(const __nv_bfloat16* __restrict__ gu, const int* __restrict__ count,
                               __nv_bfloat16* __restrict__ out, int F) {
  const int n = *count;
  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    const __nv_bfloat16* row = gu + static_cast<long long>(r) * 2 * F;
    for (int c = threadIdx.x; c < F; c += blockDim.x) {
      const float a = __bfloat162float(row[c]);
      const float s = __bfloat162float(__float2bfloat16_rn(a / (1.f + expf(-a))));
      out[static_cast<long long>(r) * F + c] = __float2bfloat16_rn(s * __bfloat162float(row[F + c]));
    }
  }
}

__global__ void moe_combine_kernel(const __nv_bfloat16* __restrict__ ys, const int* __restrict__ inv,
                                   const float* __restrict__ w, const int* __restrict__ count,
                                   __nv_bfloat16* __restrict__ out, int n, int k, int H) {
  const int cnt = *count;
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    for (int c = 2 * threadIdx.x; c < H; c += 2 * blockDim.x) {
      float a0 = 0.f, a1 = 0.f;
      for (int s = 0; s < k; ++s) {
        const int r = inv[t * k + s];
        if (r < cnt) {
          const float ws = w[t * k + s];
          const float2 y = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ys + static_cast<long long>(r) * H + c));
          a0 = fmaf(y.x, ws, a0);
          a1 = fmaf(y.y, ws, a1);
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(t) * H + c) = __floats2bfloat162_rn(a0, a1);
    }
  }
}

int grid_for(long long rows) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long most = 8LL * sms;
  return static_cast<int>(rows < most ? (rows > 0 ? rows : 1) : most);
}

}  // namespace

extern "C" int moe_gather_launch(const void* x, const void* src, const void* count, void* out, long long rows,
                                 int H, void* stream) {
  if (H % 8 != 0 || rows < 0) return cudaErrorInvalidValue;
  moe_gather_kernel<<<grid_for(rows), THREADS / 2, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const long long*>(src), static_cast<const int*>(count),
      static_cast<__nv_bfloat16*>(out), H);
  return cudaGetLastError();
}

extern "C" int moe_act_launch(const void* gu, const void* count, void* out, long long rows, int F, void* stream) {
  if (F <= 0 || rows < 0) return cudaErrorInvalidValue;
  moe_act_kernel<<<grid_for(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(gu), static_cast<const int*>(count), static_cast<__nv_bfloat16*>(out), F);
  return cudaGetLastError();
}

extern "C" int moe_combine_launch(const void* ys, const void* inv, const void* w, const void* count, void* out,
                                  int n, int k, int H, void* stream) {
  if (H % 2 != 0 || n < 0 || k <= 0) return cudaErrorInvalidValue;
  moe_combine_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(ys), static_cast<const int*>(inv), static_cast<const float*>(w),
      static_cast<const int*>(count), static_cast<__nv_bfloat16*>(out), n, k, H);
  return cudaGetLastError();
}

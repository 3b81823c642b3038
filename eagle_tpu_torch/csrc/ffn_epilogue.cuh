// The fused FFN kernels' epilogues and their arguments, shared by the
// matmul passes of ffn.cu (SIMT) and ffn_tensor_core.cu (the 1-row and
// small-row tensor-core bodies); ffn.cu describes the design.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kActGelu = 1;  // act: 0 SiLU, 1 tanh-GELU (ACTS in ops/ffn.py)
constexpr int kNormThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool BF16>
__device__ __forceinline__ void store_ct(void* p, size_t i, float v) {
  if constexpr (BF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// grid: R blocks of kNormThreads; partial [splits][R][N], N % 4 == 0, all
// rows 16-byte aligned. Each thread sums 4 adjacent columns over the splits
// in split order (8 splits' loads in flight), so one block covers a
// 4096-wide row in one pass.
template <bool BF16>
__global__ void __launch_bounds__(kNormThreads) out_norm_kernel(
    const float* __restrict__ partial, int splits, const float* __restrict__ resid,
    const float* __restrict__ norm_w, float* __restrict__ x_out, void* __restrict__ h_out,
    int R, int N, float eps) {
  __shared__ float red[kNormThreads / 32];
  const int r = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t plane = (size_t)R * N, row = (size_t)r * N;
  float ss = 0.f;
  for (int n = 4 * threadIdx.x; n < N; n += 4 * kNormThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(partial + s * plane + row + n);
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    const float4 rs = *reinterpret_cast<const float4*>(resid + row + n);
    const float4 xv = make_float4(v.x + rs.x, v.y + rs.y, v.z + rs.z, v.w + rs.w);
    *reinterpret_cast<float4*>(x_out + row + n) = xv;
    ss += xv.x * xv.x + xv.y * xv.y + xv.z * xv.z + xv.w * xv.w;
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kNormThreads / 32 ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float rs = rsqrtf(red[0] / (float)N + eps);
  for (int n = 4 * threadIdx.x; n < N; n += 4 * kNormThreads) {  // this thread's own x
    const float4 xv = *reinterpret_cast<const float4*>(x_out + row + n);
    const float4 nw = *reinterpret_cast<const float4*>(norm_w + n);
    store_ct<BF16>(h_out, row + n, xv.x * rs * nw.x);
    store_ct<BF16>(h_out, row + n + 1, xv.y * rs * nw.y);
    store_ct<BF16>(h_out, row + n + 2, xv.z * rs * nw.z);
    store_ct<BF16>(h_out, row + n + 3, xv.w * rs * nw.w);
  }
}

__device__ __forceinline__ float act_fn(int act, float g) {
  if (act == kActGelu) {
    // tanh approximation: 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
    const float kBeta = 0.7978845608028654f, kKappa = 0.044715f;
    const float inner = kBeta * (g + kKappa * (g * g * g));
    return 0.5f * g * (1.f + tanhf(inner));
  }
  return g / (1.f + expf(-g));  // SiLU
}

// out[i] = round_ct(act(g) * u), g and u the split sums in split order.
template <bool BF16>
__global__ void gate_up_epilogue_kernel(const float* __restrict__ partial, int splits,
                                        void* __restrict__ out, size_t count, int act) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float g = 0.f, u = 0.f;
  for (int s = 0; s < splits; ++s) {
    g += partial[(size_t)(2 * s) * count + i];
    u += partial[(size_t)(2 * s + 1) * count + i];
  }
  store_ct<BF16>(out, i, act_fn(act, g) * u);
}

struct OutNormArgs {
  const float* x; const int8_t* q; const void* scale; const void* bias;
  const float* resid; const float* norm_w; float* x_out; void* h_out; float* partial;
  int R, K, N, scale_kind, bias_kind, splits, gps; float eps; cudaStream_t st;
};

template <bool BF16>
void out_norm_epilogue(const OutNormArgs& a) {
  out_norm_kernel<BF16><<<a.R, kNormThreads, 0, a.st>>>(a.partial, a.splits, a.resid, a.norm_w,
                                                        a.x_out, a.h_out, a.R, a.N, a.eps);
}

struct GateUpArgs {
  const void* h; const int8_t* q; const void* scale; const void* bias; void* out;
  float* partial; int R, K, F, scale_kind, bias_kind, act, splits, gps; cudaStream_t st;
};

template <bool BF16>
void gate_up_epilogue(const GateUpArgs& a) {
  const size_t count = (size_t)a.R * a.F;
  gate_up_epilogue_kernel<BF16><<<(unsigned)((count + 255) / 256), 256, 0, a.st>>>(
      a.partial, a.splits, a.out, count, a.act);
}

}  // namespace

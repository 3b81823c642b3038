// Fused dequant + matmul for group-quantized "kn" weights:
//   out[B, N] (f32) = x[B, K] @ (scale ⊙ q + bias)
// Port of eagle_tpu/ops/pallas_qmm.py:_qmm_kernel (reached through
// qmatmul_pallas_2d and qmatmul_pallas_stacked). A layer of a stacked weight
// is chosen by the caller offsetting the pointers; nothing is copied.
//
// Rounding points follow the Pallas kernel (qmm_body.cuh, whose inner loop
// the fused FFN kernels of ffn.cu share).
//
// Two bodies behind one entry point:
// - qmm_kernel (SIMT; decode, verify, any f32 compute). Bound on the H100 at
//   decode: the weight bytes (4.75 bits per weight for Q4_K packed with
//   codes). Every weight byte is read once per row tile, 4 adjacent columns
//   per lane (one 128-byte line per warp and weight row); a warp loads all
//   rows of a quant group before it uses any, so many loads are in flight;
//   K is split across warps and blocks so that even the small-N projections
//   put several blocks on each of the 132 SMs. Partial sums from K splits
//   are reduced in a fixed order by a second small kernel (deterministic, no
//   atomics). The integer-to-float step uses the 2^23 magic number and bf16
//   rounding goes two values per instruction: conversion instructions run
//   at a quarter of the FMA rate on this card.
// - qmm_tc_kernel (bf16 compute, more than 8 rows: prefill). Bound by
//   operations; 64 x 128 output tiles on the tensor cores (wmma bf16, f32
//   accumulate). Each K step dequantizes a 64-deep weight tile into shared
//   memory and appends the group sums of x and the group biases as extra
//   contraction columns/rows, so the bias side product rides in the same
//   MMAs. No pipelining yet: load, sync, multiply.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "qmm_body.cuh"

namespace {

// Sixteen adjacent values: four load4 calls at off, off+4, ...
__device__ __forceinline__ void load16(const void* p, int kind, size_t off, const float* sup,
                                       size_t soff, float o[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    load4(p, kind, off + 4 * i, o + 4 * i);
    if (kind == kKindCode) mul_sup(sup, soff + 4 * i, o + 4 * i);
  }
}

// out[i] = sum over splits of partial[s][i], in split order.
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, size_t count, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[(size_t)s * count + i];
  out[i] = v;
}

// ---- tensor-core body (bf16 compute, prefill) ----
constexpr int kTcRows = 64;   // output rows per block
constexpr int kTcCols = 128;  // output columns per block
constexpr int kTcK = 64;      // K per step: 2 groups of 32, 4 of 16 or 8 of 8
constexpr int kTcKx = 80;     // + one group-sum column per group, padded to 16
constexpr int kAStride = 88;  // bf16; row strides off a multiple of 128 bytes
constexpr int kBStride = 136;
constexpr int kCStride = 132;  // f32
constexpr int kTcSmemAB = (kTcRows * kAStride + kTcKx * kBStride) * 2;
constexpr int kTcSmemC = kTcRows * kCStride * 4;
constexpr int kTcSmem = kTcSmemAB > kTcSmemC ? kTcSmemAB : kTcSmemC;

// grid: (ceil(N/128), ceil(B/64)); 256 threads = 8 warps as 2 (rows) x 4
// (columns), each warp owning a 32 x 32 block of 2 x 2 wmma tiles. Needs
// K % 64 == 0 and N % 16 == 0 (checked by the wrapper). G = 8 (IQ1_M) puts
// 8 groups, and 8 group-sum columns, in a step.
template <int G, bool PACKED>
__global__ void __launch_bounds__(256) qmm_tc_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ q,
    const void* __restrict__ scale, const void* __restrict__ bias,
    const float* __restrict__ sup, const float* __restrict__ sup_min,
    float* __restrict__ dst, int B, int K, int N, int scale_kind, int bias_kind) {
  using namespace nvcuda;
  constexpr int kGroups = kTcK / G;  // quant groups per K step
  __shared__ __align__(128) unsigned char smem[kTcSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][kAStride]
  __nv_bfloat16* Bs = As + kTcRows * kAStride;                  // [80][kBStride]
  float* Cs = reinterpret_cast<float*>(smem);                   // [64][kCStride], after the loop
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = blockIdx.y * kTcRows, n0 = blockIdx.x * kTcCols;
  const bool has_bias = bias_kind != kKindNone;
  const int kx = has_bias ? kTcKx : kTcK;  // contraction width of a step
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // the pad columns of A and rows of B past the group sums stay zero
  for (int e = tid; e < kTcRows * (kTcKx - kTcK); e += 256)
    As[(e / (kTcKx - kTcK)) * kAStride + kTcK + e % (kTcKx - kTcK)] = zero;
  for (int e = tid; e < (kTcKx - kTcK) * kTcCols; e += 256)
    Bs[(kTcK + e / kTcCols) * kBStride + e % kTcCols] = zero;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;

  for (int k0 = 0; k0 < K; k0 += kTcK) {
    __syncthreads();  // the previous step's tiles are consumed
    {  // x: row tid/4, 16 values from column (tid%4)*16; group sums in f32
      const int r = tid >> 2, c0 = (tid & 3) * 16;
      float v[16];
      if (r0 + r < B) {
        const float4* src = reinterpret_cast<const float4*>(x + (size_t)(r0 + r) * K + k0 + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 f = src[i];
          v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = 0.f;
      }
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) sum += v[i];
      if constexpr (G == 32) sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __nv_bfloat162* dstA = reinterpret_cast<__nv_bfloat162*>(As + r * kAStride + c0);
#pragma unroll
      for (int i = 0; i < 8; ++i) dstA[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      if constexpr (G == 8) {  // the 16 values span two groups
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s0 += v[i];
          s1 += v[8 + i];
        }
        if (has_bias) {
          As[r * kAStride + kTcK + c0 / G] = __float2bfloat16(s0);
          As[r * kAStride + kTcK + c0 / G + 1] = __float2bfloat16(s1);
        }
      } else if (has_bias && (G == 16 || (tid & 1) == 0)) {
        As[r * kAStride + kTcK + c0 / G] = __float2bfloat16(sum);
      }
    }
    {  // weights: 16 columns from (tid%8)*16, dequantized to the compute dtype
      const int nc = (tid & 7) * 16, n = n0 + nc;
      const size_t soff = (size_t)(k0 / 256) * N + n;
      if constexpr (PACKED) {
        const int pr = tid >> 3;  // packed row of the step, 0..31
        const int gi = pr / (G / 2), klo = gi * G + pr % (G / 2), khi = klo + G / 2;
        __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(Bs + klo * kBStride + nc);
        __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(Bs + khi * kBStride + nc);
        if (n < N) {
          float s[16];
          load16(scale, scale_kind, (size_t)(k0 / G + gi) * N + n, sup, soff, s);
          const uint4 qb = *reinterpret_cast<const uint4*>(q + (size_t)(k0 / 2 + pr) * N + n);
          const uint32_t words[4] = {qb.x, qb.y, qb.z, qb.w};
#pragma unroll
          for (int i = 0; i < 16; i += 2) {
            const uint32_t w = words[i / 4] >> (8 * (i % 4));  // bytes i, i+1
            const float c0 = -kTwo23 * s[i], c1 = -kTwo23 * s[i + 1];
            lo[i / 2] = __floats2bfloat162_rn(deq4(w & 0xFu, s[i], c0),
                                              deq4((w >> 8) & 0xFu, s[i + 1], c1));
            hi[i / 2] = __floats2bfloat162_rn(deq4((w >> 4) & 0xFu, s[i], c0),
                                              deq4((w >> 12) & 0xFu, s[i + 1], c1));
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) lo[i] = hi[i] = __floats2bfloat162_rn(0.f, 0.f);
        }
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // rows tid/8 and tid/8 + 32
          const int kr = (tid >> 3) + 32 * half;
          __nv_bfloat162* row = reinterpret_cast<__nv_bfloat162*>(Bs + kr * kBStride + nc);
          if (n < N) {
            float s[16];
            load16(scale, scale_kind, (size_t)(k0 / G + kr / G) * N + n, sup, soff, s);
            const uint4 qb = *reinterpret_cast<const uint4*>(q + (size_t)(k0 + kr) * N + n);
            const uint32_t words[4] = {qb.x, qb.y, qb.z, qb.w};
#pragma unroll
            for (int i = 0; i < 16; i += 2) {
              const uint32_t w = words[i / 4] >> (8 * (i % 4));
              row[i / 2] = __floats2bfloat162_rn(s8_to_f(w) * s[i], s8_to_f(w >> 8) * s[i + 1]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) row[i] = __floats2bfloat162_rn(0.f, 0.f);
          }
        }
      }
    }
    if (has_bias) {  // one bias row per group, after the 64 weight rows
      for (int e = tid; e < kGroups * kTcCols; e += 256) {
        const int gi = e / kTcCols, col = e % kTcCols, n = n0 + col;
        float b = 0.f;
        if (n < N) {
          const size_t off = (size_t)(k0 / G + gi) * N + n;
          if (bias_kind == kKindF32) {
            b = static_cast<const float*>(bias)[off];
          } else if (bias_kind == kKindBF16) {
            b = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[off]);
          } else {
            b = s8_to_f(static_cast<uint32_t>(static_cast<const int8_t*>(bias)[off])) *
                sup_min[(size_t)(k0 / 256) * N + n];
          }
        }
        Bs[(kTcK + gi) * kBStride + col] = __float2bfloat16(b);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kx; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * kAStride + kk, kAStride);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kBStride + wn + 16 * j, kBStride);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();  // A and B are dead: C reuses their memory
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kCStride + wn + 16 * j, acc[i][j], kCStride,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kTcRows * kTcCols; e += 256) {
    const int r = e / kTcCols, col = e % kTcCols;
    if (r0 + r < B && n0 + col < N) dst[(size_t)(r0 + r) * N + n0 + col] = Cs[r * kCStride + col];
  }
}

struct Launch {
  const float* x; const int8_t* q; const void* scale; const void* bias;
  const float* sup; const float* sup_min; float* dst;
  int B, K, N, scale_kind, bias_kind, splits, groups_per_split;
  cudaStream_t stream;
};

template <int RB, bool BF16, int G, bool PACKED>
void launch(const Launch& a) {
  const dim3 grid((a.N + kColsPerBlock - 1) / kColsPerBlock, a.splits, (a.B + RB - 1) / RB);
  qmm_kernel<RB, BF16, G, PACKED, false, float><<<grid, kWarps * 32, 0, a.stream>>>(
      a.x, a.q, a.scale, a.bias, a.sup, a.sup_min, a.dst, a.B, a.K, a.N, a.scale_kind,
      a.bias_kind, a.groups_per_split);
}

template <int G, bool PACKED>
void launch_tc(const Launch& a) {
  const dim3 grid((a.N + kTcCols - 1) / kTcCols, (a.B + kTcRows - 1) / kTcRows);
  qmm_tc_kernel<G, PACKED><<<grid, 256, 0, a.stream>>>(
      a.x, a.q, a.scale, a.bias, a.sup, a.sup_min, a.dst, a.B, a.K, a.N, a.scale_kind,
      a.bias_kind);
}

template <int RB, bool BF16>
void dispatch_form(int G, int packed, const Launch& a) {
  if (G == 8) {
    packed ? launch<RB, BF16, 8, true>(a) : launch<RB, BF16, 8, false>(a);
  } else if (G == 16) {
    packed ? launch<RB, BF16, 16, true>(a) : launch<RB, BF16, 16, false>(a);
  } else {
    packed ? launch<RB, BF16, 32, true>(a) : launch<RB, BF16, 32, false>(a);
  }
}

template <bool BF16>
void dispatch_rb(int rb, int G, int packed, const Launch& a) {
  switch (rb) {
    case 1: dispatch_form<1, BF16>(G, packed, a); break;
    case 2: dispatch_form<2, BF16>(G, packed, a); break;
    case 4: dispatch_form<4, BF16>(G, packed, a); break;
    default: dispatch_form<8, BF16>(G, packed, a); break;
  }
}

}  // namespace

// x f32 [B, K]; q int8 [K, N] or packed [K/2, N]; scale/bias [K/G, N] of
// kind f32 (0), bf16 (1) or int8 codes (2, with sup/sup_min f32 [K/256, N]);
// bias_kind -1 = no bias; G in {8, 16, 32}. out f32 [B, N]; partial f32 [splits, B, N] when
// splits > 1 (else unused). rb in {1, 2, 4, 8}: rows per block of the SIMT
// body; rb = 64 takes the tensor-core body (bf16 compute, splits = 1).
extern "C" int qmm_launch(const void* x, const void* q, const void* scale,
                          const void* bias, const void* sup, const void* sup_min,
                          void* out, void* partial, int B, int K, int N, int G,
                          int packed, int scale_kind, int bias_kind, int compute_bf16,
                          int rb, int splits, int groups_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch a{static_cast<const float*>(x), static_cast<const int8_t*>(q), scale, bias,
                 static_cast<const float*>(sup), static_cast<const float*>(sup_min),
                 static_cast<float*>(splits > 1 ? partial : out), B, K, N, scale_kind,
                 bias_kind, splits, groups_per_split, st};
  if (rb == kTcRows) {
    if (G == 8) {
      packed ? launch_tc<8, true>(a) : launch_tc<8, false>(a);
    } else if (G == 16) {
      packed ? launch_tc<16, true>(a) : launch_tc<16, false>(a);
    } else {
      packed ? launch_tc<32, true>(a) : launch_tc<32, false>(a);
    }
  } else if (compute_bf16) {
    dispatch_rb<true>(rb, G, packed, a);
  } else {
    dispatch_rb<false>(rb, G, packed, a);
  }
  if (splits > 1) {
    const size_t count = (size_t)B * N;
    qmm_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), count, splits);
  }
  return (int)cudaGetLastError();
}

// The SIMT qmm body (qmm_kernel) with its dequantize-and-FMA inner loop,
// shared by qmm.cu (qmm) and ffn.cu (the matmul passes of ffn_out_norm and
// gate_up_act), as the Pallas FFN kernels reuse pallas_qmm.py:_qmm_kernel.
// One definition of the arithmetic, so the fused kernels' matmul sums are
// the qmm kernel's.
//
// Rounding points follow the Pallas kernel: the effective scale is an f32
// product (sup * code when coded), w = q * scale is computed in f32 and
// rounded to the compute dtype, x is rounded to the compute dtype, products
// accumulate in f32. The per-group bias is folded as a side product
// round(xsum_g) * round(bias_g), xsum_g being the f32 sum of x over group g.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKindNone = -1, kKindF32 = 0, kKindBF16 = 1, kKindCode = 2;
constexpr int kWarps = 8;
constexpr int kColsPerBlock = 128;  // 32 lanes x 4 adjacent columns
constexpr uint32_t kMagic = 0x4B000000u;  // 2^23 as f32: (kMagic | n) == 2^23 + n
constexpr float kTwo23 = 8388608.f;

// a, b <- round_ct(a), round_ct(b): one bf16x2 conversion for the pair
template <bool BF16>
__device__ __forceinline__ void round2(float& a, float& b) {
  if constexpr (BF16) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
    a = __low2float(r);
    b = __high2float(r);
  }
}

// exact f32 q * s for a 4-bit code n in [0, 15]; c = -2^23 * s:
// fma(2^23 + n, s, -2^23 s) rounds n * s once, as the f32 product does
__device__ __forceinline__ float deq4(uint32_t n, float s, float c) {
  return fmaf(__uint_as_float(kMagic | n), s, c);
}

// the signed byte b (as its low 8 bits) as an exact f32, without I2F; the
// whole int8 range [-128, 127] (Q8_0 codes included) maps exactly
__device__ __forceinline__ float s8_to_f(uint32_t b) {
  return __uint_as_float(kMagic | ((b & 0xFFu) ^ 0x80u)) - (kTwo23 + 128.f);
}

// one activation value as f32 (the input may be f32 or bf16)
__device__ __forceinline__ float ldx(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldx(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// four adjacent activation values at p (16- or 8-byte aligned) as f32
__device__ __forceinline__ void ldx4(const float* p, float v[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void ldx4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
}

// Four adjacent per-group values at element offset `off` (a multiple of 4).
__device__ __forceinline__ void load4(const void* p, int kind, size_t off, float o[4]) {
  if (kind == kKindF32) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + off));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if (kind == kKindBF16) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + off));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    o[0] = __low2float(a); o[1] = __high2float(a);
    o[2] = __low2float(b); o[3] = __high2float(b);
  } else {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(static_cast<const int8_t*>(p) + off));
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = s8_to_f(v >> (8 * c));
  }
}

__device__ __forceinline__ void mul_sup(const float* sup, size_t off, float o[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(sup + off));
  o[0] = v.x * o[0]; o[1] = v.y * o[1]; o[2] = v.z * o[2]; o[3] = v.w * o[3];
}

// The same at a column edge that is not a multiple of 4 (VEC false: N % 4
// != 0, so rows are not 4-byte aligned): the first `nv` values element by
// element, zeros after. VEC true is the vector path above.
template <bool VEC>
__device__ __forceinline__ void load4v(const void* p, int kind, size_t off, int nv, float o[4]) {
  if constexpr (VEC) {
    load4(p, kind, off, o);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      o[c] = 0.f;
      if (c < nv) {
        if (kind == kKindF32) {
          o[c] = __ldg(static_cast<const float*>(p) + off + c);
        } else if (kind == kKindBF16) {
          o[c] = __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p) + off + c));
        } else {
          o[c] = s8_to_f((uint32_t)__ldg(static_cast<const int8_t*>(p) + off + c));
        }
      }
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void mul_supv(const float* sup, size_t off, int nv, float o[4]) {
  if constexpr (VEC) {
    mul_sup(sup, off, o);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < nv) o[c] = __ldg(sup + off + c) * o[c];
  }
}

// the bytes of 4 adjacent columns of one q row (the first `nv` when !VEC)
template <bool VEC>
__device__ __forceinline__ uint32_t load_q4(const int8_t* p, int nv) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    uint32_t v = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < nv) v |= (uint32_t)(uint8_t)__ldg(p + c) << (8 * c);
    return v;
  }
}

// grid: (column tiles, K splits, ceil(B/RB) row tiles); 256 threads. One
// quantized "kn" weight: q int8 [K, N] or packed [K/2, N]; scale/bias
// [K/G, N] of kind f32, bf16 or int8 codes (with sup/sup_min f32 [K/256, N]);
// x [B, K] of type XT (f32, or bf16 for the gate/up pass).
// - PAIRED = false (qmm, and the wo pass of ffn_out_norm): column tile c is
//   columns [128c, 128c + 128) of N; dst [splits][B][N].
// - PAIRED = true (gate_up_act): N = 2F; tile c walks the gate columns
//   [128c, 128c + 128), then the matching up columns F + [128c, 128c + 128);
//   dst [splits][2][B][F]. Each pass has its f32 accumulators and the same
//   warp order as qmm's tile over those columns, so the sums are qmm's.
// Warp w of a block walks groups g_begin+w, g_begin+w+8, ... of its split. A
// group's G (or G/2 packed) weight rows are all loaded before any is used, so
// each lane keeps that many 4-byte loads in flight. The block's warps are
// summed in a fixed order. VEC (N % 4 == 0, every shape the fused kernels
// take) loads 4 columns as one vector; without it (qmm at N % 4 != 0) the
// loads go element by element, masked at the last column.
template <int RB, bool BF16, int G, bool PACKED, bool PAIRED, typename XT, bool VEC = true>
__global__ void __launch_bounds__(256) qmm_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ q,
    const void* __restrict__ scale, const void* __restrict__ bias,
    const float* __restrict__ sup, const float* __restrict__ sup_min,
    float* __restrict__ dst, int B, int K, int N,
    int scale_kind, int bias_kind, int groups_per_split) {
  constexpr int kQRows = PACKED ? G / 2 : G;  // weight rows per group
  constexpr int kPasses = PAIRED ? 2 : 1;
  __shared__ float red[kWarps][RB][kColsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ncols = N / kPasses;  // columns of one output plane
  const int r0 = blockIdx.z * RB;
  const int rows = min(RB, B - r0);
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(K / G, g_begin + groups_per_split);
  const bool has_bias = bias_kind != kKindNone;
  const XT* xr = x + (size_t)r0 * K;

#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    const int c0 = blockIdx.x * kColsPerBlock + lane * 4;  // column in the plane
    const int n0 = pass * ncols + c0;                      // column of the weight
    const int nv = min(4, ncols - c0);                     // columns of this lane
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    if (c0 < ncols) {
      for (int g = g_begin + warp; g < g_end; g += kWarps) {
        const int k0 = g * G;
        const int8_t* qg = q + (size_t)(PACKED ? k0 / 2 : k0) * N + n0;
        uint32_t qv[kQRows];  // 4 columns' bytes per weight row
#pragma unroll
        for (int j = 0; j < kQRows; ++j)
          qv[j] = load_q4<VEC>(qg + (size_t)j * N, nv);
        const size_t goff = (size_t)g * N + n0;
        const size_t soff = (size_t)(k0 / 256) * N + n0;
        float s[4], b[4] = {0.f, 0.f, 0.f, 0.f};
        load4v<VEC>(scale, scale_kind, goff, nv, s);
        if (scale_kind == kKindCode) mul_supv<VEC>(sup, soff, nv, s);
        if (has_bias) {
          load4v<VEC>(bias, bias_kind, goff, nv, b);
          if (bias_kind == kKindCode) mul_supv<VEC>(sup_min, soff, nv, b);
        }
        float xs[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) xs[r] = 0.f;

        if constexpr (PACKED) {
          float c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = -kTwo23 * s[i];
          // packed row j of the group holds k0+j (lo nibble) and k0+j+G/2 (hi)
#pragma unroll
          for (int j = 0; j < kQRows; ++j) {
            float wl[4], wh[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint32_t by = qv[j] >> (8 * i);
              wl[i] = deq4(by & 0xFu, s[i], c[i]);
              wh[i] = deq4((by >> 4) & 0xFu, s[i], c[i]);
              round2<BF16>(wl[i], wh[i]);
            }
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              if (r < rows) {
                const float xl = ldx(xr + (size_t)r * K + k0 + j);
                const float xh = ldx(xr + (size_t)r * K + k0 + j + kQRows);
                xs[r] += xl + xh;
                float xlc = xl, xhc = xh;
                round2<BF16>(xlc, xhc);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  acc[r][i] = fmaf(xhc, wh[i], fmaf(xlc, wl[i], acc[r][i]));
              }
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kQRows; j += 2) {  // two weight rows at a time
            float w0[4], w1[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              w0[i] = s8_to_f(qv[j] >> (8 * i)) * s[i];
              w1[i] = s8_to_f(qv[j + 1] >> (8 * i)) * s[i];
              round2<BF16>(w0[i], w1[i]);
            }
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              if (r < rows) {
                const float x0 = ldx(xr + (size_t)r * K + k0 + j);
                const float x1 = ldx(xr + (size_t)r * K + k0 + j + 1);
                xs[r] += x0 + x1;
                float x0c = x0, x1c = x1;
                round2<BF16>(x0c, x1c);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  acc[r][i] = fmaf(x1c, w1[i], fmaf(x0c, w0[i], acc[r][i]));
              }
            }
          }
        }
        if (has_bias) {
#pragma unroll
          for (int i = 0; i < 4; i += 2) round2<BF16>(b[i], b[i + 1]);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            float xsc = xs[r], unused = 0.f;
            round2<BF16>(xsc, unused);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(xsc, b[i], acc[r][i]);
          }
        }
      }
    }

    // reduce the 8 warps' partial sums in a fixed order
    if (pass > 0) __syncthreads();  // the previous pass has read red
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = acc[r][c];
    __syncthreads();
    // this split's (and pass's) output plane
    float* out = dst + ((size_t)blockIdx.y * kPasses + pass) * B * ncols;
    for (int e = threadIdx.x; e < RB * kColsPerBlock; e += blockDim.x) {
      const int r = e / kColsPerBlock, col = e % kColsPerBlock;
      const int n = blockIdx.x * kColsPerBlock + col;
      if (r < rows && n < ncols) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += red[w][r][col];
        out[(size_t)(r0 + r) * ncols + n] = v;
      }
    }
  }
}

// out[i] = sum over splits of partial[s][i], in split order (the K splits
// of every qmm body).
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, size_t count, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[(size_t)s * count + i];
  out[i] = v;
}

}  // namespace

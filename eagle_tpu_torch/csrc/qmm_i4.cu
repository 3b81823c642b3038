// Dequant + matmul for int4 "kn" weights:
//   out[B, N] (f32) = x[B, K] @ w,  w[k, n] = q[k, n] * scale[k/G, n] + bias[k/G, n]
// with q signed in [-8, 7] and no zero-point. Port of
// eagle_tpu/ops/pallas_qmm.py:_qmm_kernel_i4, reached there through
// qmatmul_pallas_2d_i4 (pallas_call at :600) and qmatmul_pallas_stacked_i4
// (:839). Both entries here serve both: a layer of a stacked weight is
// chosen by the caller offsetting the pointers; nothing is copied.
//
// q is stored as int8 [K/2, N] of two's-complement nibbles: within each
// group of G K-rows, packed row j holds values (j, j + G/2) in its (lo, hi)
// nibbles (QTensor.int4). scale and bias are f32 or bf16 [K/G, N].
//
// Rounding points are the Pallas kernel's, which are not qmm's: the bias is
// added to every weight, not folded in as a group-sum side product.
//   q, scale and bias round to the compute dtype (q exactly);
//   w = round_ct(q * scale), then w = round_ct(w + bias);
//   x rounds to the compute dtype; products accumulate in f32.
// The product and the sum are single f32 operations (__fmul_rn, __fadd_rn:
// never contracted into an FMA). bf16 rounding uses __floats2bfloat162_rn,
// which rounds each of its two values to nearest even exactly as
// __float2bfloat16_rn does, in one instruction.
//
// Three bodies, chosen by ops/qmm.py (`_route`), as for qmm:
// - qmm_i4_kernel (SIMT; 1 row, any row count in f32, and the shapes the
//   tensor-core bodies cannot address: K % 64 != 0, N % 16 != 0; at N % 4
//   != 0 it loads element by element, masked at the last column). Bound on
//   the H100 by the bytes: at wqkv (K 4096, N 12288, G 32, bf16 scale and
//   bias, 1 row) 9.4 us at 3.35 TB/s. qmm's SIMT structure (qmm_body.cuh):
//   each lane reads 4 adjacent columns, a warp loads all G/2 packed rows of
//   a group before it uses any, K is split over warps and blocks to fill
//   the 132 SMs, and the partial sums of K splits are added in a fixed
//   order by a second kernel. It pays one f32 multiply, one add and two
//   bf16 roundings per weight, then an FMA per weight and row.
// - qmm_mma_kernel<.., kFormInt4> (qmm_mma.cuh; bf16 compute, 2-8 rows).
//   Bound by the bytes as at one row. The SIMT body took 2.4x its 1-row
//   time at 8 rows; this one dequantizes each weight once, in bf16 pairs at
//   the rounding points above, into a bf16 tile that `mma.sync` reads for
//   all rows at once, from a 3-stage `cp.async` ring; K splits added by
//   qmm_i4_reduce_kernel in split order.
// - qmm_tc_kernel<.., kFormInt4> (qmm_tc.cuh; bf16 compute, more than 8
//   rows). Bound by operations at 512 rows, by bytes at 37. The SIMT body
//   re-read every weight once per 8-row tile there; this one runs qmm's
//   tensor-core main loop (x prologue, `wgmma.mma_async` on 64/128 x 256
//   tiles, a 3-4 stage ring filled by TMA under mbarriers, the weight tile
//   dequantized in shared memory at the rounding points above, in bf16
//   pairs, while the previous step's wgmma runs, K splits to fill the card)
//   with the bias applied per weight.
// No dequantized weight is written to device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_body.cuh"
#include "qmm_mma.cuh"
#include "qmm_tc.cuh"

namespace {

// the signed nibble in the low 4 bits of v as an exact f32: (v & 0xF) ^ 8
// is the value + 8, in [0, 15], so the 2^23 magic number needs no I2F
__device__ __forceinline__ float s4_to_f(uint32_t v) {
  return __uint_as_float(kMagic | ((v & 0xFu) ^ 0x8u)) - (kTwo23 + 8.f);
}

// out[i] = sum over splits of partial[s][i], in split order.
__global__ void qmm_i4_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, size_t count, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[(size_t)s * count + i];
  out[i] = v;
}

// grid: (ceil(N/128), K splits, ceil(B/RB)); 256 threads. Warp w of a block
// walks groups g_begin+w, g_begin+w+8, ... of its split; the block's 8
// warps are summed in a fixed order into dst [splits][B][N]. VEC: N % 4 ==
// 0 (4-column vector loads), else element loads masked at N.
template <int RB, bool BF16, int G, bool BIAS, bool VEC>
__global__ void __launch_bounds__(256) qmm_i4_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ q,
    const void* __restrict__ scale, const void* __restrict__ bias,
    float* __restrict__ dst, int B, int K, int N, int scale_kind, int bias_kind,
    int groups_per_split) {
  constexpr int kHalf = G / 2;  // packed rows per group
  __shared__ float red[kWarps][RB][kColsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kColsPerBlock + lane * 4;
  const int nv = min(4, N - n0);  // columns of this lane (VEC: N % 4 == 0, all 4)
  const int r0 = blockIdx.z * RB;
  const int rows = min(RB, B - r0);
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(K / G, g_begin + groups_per_split);
  const float* xr = x + (size_t)r0 * K;

  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (n0 < N) {
    for (int g = g_begin + warp; g < g_end; g += kWarps) {
      const int k0 = g * G;
      const int8_t* qg = q + (size_t)(k0 / 2) * N + n0;
      uint32_t qv[kHalf];  // 4 columns' bytes per packed row
#pragma unroll
      for (int j = 0; j < kHalf; ++j)
        qv[j] = load_q4<VEC>(qg + (size_t)j * N, nv);
      const size_t goff = (size_t)g * N + n0;
      float s[4], b[4] = {0.f, 0.f, 0.f, 0.f};
      load4v<VEC>(scale, scale_kind, goff, nv, s);
      if (BIAS) load4v<VEC>(bias, bias_kind, goff, nv, b);
      round2<BF16>(s[0], s[1]);
      round2<BF16>(s[2], s[3]);
      round2<BF16>(b[0], b[1]);
      round2<BF16>(b[2], b[3]);
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        float wl[4], wh[4];  // K rows k0 + j and k0 + j + G/2
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t by = qv[j] >> (8 * i);
          wl[i] = __fmul_rn(s4_to_f(by), s[i]);
          wh[i] = __fmul_rn(s4_to_f(by >> 4), s[i]);
          round2<BF16>(wl[i], wh[i]);
          if (BIAS) {
            wl[i] = __fadd_rn(wl[i], b[i]);
            wh[i] = __fadd_rn(wh[i], b[i]);
            round2<BF16>(wl[i], wh[i]);
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < rows) {
            float xl = __ldg(xr + (size_t)r * K + k0 + j);
            float xh = __ldg(xr + (size_t)r * K + k0 + j + kHalf);
            round2<BF16>(xl, xh);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(xh, wh[i], fmaf(xl, wl[i], acc[r][i]));
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = acc[r][c];
  __syncthreads();
  float* out = dst + (size_t)blockIdx.y * B * N;  // this split's plane
  for (int e = threadIdx.x; e < RB * kColsPerBlock; e += blockDim.x) {
    const int r = e / kColsPerBlock, col = e % kColsPerBlock;
    const int n = blockIdx.x * kColsPerBlock + col;
    if (r < rows && n < N) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][r][col];
      out[(size_t)(r0 + r) * N + n] = v;
    }
  }
}

struct Launch {
  const float* x; const int8_t* q; const void* scale; const void* bias; float* dst;
  int B, K, N, scale_kind, bias_kind, splits, groups_per_split;
  cudaStream_t stream;
};

template <int RB, bool BF16, int G, bool BIAS, bool VEC>
void launch(const Launch& a) {
  const dim3 grid((a.N + kColsPerBlock - 1) / kColsPerBlock, a.splits, (a.B + RB - 1) / RB);
  qmm_i4_kernel<RB, BF16, G, BIAS, VEC><<<grid, kWarps * 32, 0, a.stream>>>(
      a.x, a.q, a.scale, a.bias, a.dst, a.B, a.K, a.N, a.scale_kind, a.bias_kind,
      a.groups_per_split);
}

template <int RB, bool BF16, bool VEC>
void dispatch_form(int G, bool has_bias, const Launch& a) {
  if (G == 16) {
    has_bias ? launch<RB, BF16, 16, true, VEC>(a) : launch<RB, BF16, 16, false, VEC>(a);
  } else {
    has_bias ? launch<RB, BF16, 32, true, VEC>(a) : launch<RB, BF16, 32, false, VEC>(a);
  }
}

template <bool BF16, bool VEC>
void dispatch_rb(int rb, int G, bool has_bias, const Launch& a) {
  switch (rb) {
    case 1: dispatch_form<1, BF16, VEC>(G, has_bias, a); break;
    case 2: dispatch_form<2, BF16, VEC>(G, has_bias, a); break;
    case 4: dispatch_form<4, BF16, VEC>(G, has_bias, a); break;
    default: dispatch_form<8, BF16, VEC>(G, has_bias, a); break;
  }
}

}  // namespace

// x f32 [B, K]; q int8 [K/2, N] of signed nibble pairs; scale/bias [K/G, N]
// of kind f32 (0) or bf16 (1), bias_kind -1 = no bias; G in {16, 32}. out
// f32 [B, N]; partial f32 [splits, B, N] when splits > 1 (else unused). rb in
// {1, 2, 4, 8}: rows per block.
extern "C" int qmm_i4_launch(const void* x, const void* q, const void* scale, const void* bias,
                             void* out, void* partial, int B, int K, int N, int G,
                             int scale_kind, int bias_kind, int compute_bf16, int rb, int splits,
                             int groups_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch a{static_cast<const float*>(x), static_cast<const int8_t*>(q), scale, bias,
                 static_cast<float*>(splits > 1 ? partial : out), B, K, N, scale_kind,
                 bias_kind, splits, groups_per_split, st};
  const bool has_bias = bias_kind != kKindNone;
  const bool vec = N % 4 == 0;  // else the masked column edge
  if (compute_bf16) {
    vec ? dispatch_rb<true, true>(rb, G, has_bias, a) : dispatch_rb<true, false>(rb, G, has_bias, a);
  } else {
    vec ? dispatch_rb<false, true>(rb, G, has_bias, a) : dispatch_rb<false, false>(rb, G, has_bias, a);
  }
  if (splits > 1) {
    const size_t count = (size_t)B * N;
    qmm_i4_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), count, splits);
  }
  return (int)cudaGetLastError();
}

namespace {

template <int BM>
cudaError_t tc_i4_group(int G, const TcArgs& a, int splits, int smem, cudaStream_t st) {
  return G == 16 ? tc_launch<BM, 16, kFormInt4>(a, splits, smem, st)
                 : tc_launch<BM, 32, kFormInt4>(a, splits, smem, st);
}

}  // namespace

// The tensor-core body (bf16 compute; the wrapper sends it more than 8
// rows). x f32 [B, K]; xb bf16 [B, K] is scratch that the x prologue fills;
// weight operands as qmm_i4_launch's. bm in {64, 128}: rows per block;
// stages in {3, 4}; split z of `splits` runs K steps of 64 [z *
// steps_per_split, ...) into partial [splits, B, N] (out directly when
// splits == 1); smem: dynamic shared memory bytes, at least the layout's
// (ops/qmm.py:_tc_plan).
extern "C" int qmm_i4_tc_launch(const void* x, void* xb, const void* q, const void* scale,
                                const void* bias, void* out, void* partial, int B, int K, int N,
                                int G, int scale_kind, int bias_kind, int bm, int stages,
                                int splits, int steps_per_split, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((bm != 64 && bm != 128) || (G != 16 && G != 32) || K % kTcK || N % 16)
    return (int)cudaErrorInvalidValue;
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  tc_x_prologue<32><<<dim3((K / 4 + 255) / 256, B), 256, 0, st>>>(
      static_cast<const float*>(x), xbp, nullptr, K, 0);
  const int bias_bytes = bias_kind == kKindNone ? 0 : tc_kind_bytes(bias_kind);
  TcArgs a{xbp, nullptr, static_cast<const int8_t*>(q), scale, bias, nullptr, nullptr,
           static_cast<float*>(splits > 1 ? partial : out), B, K, N, 0, scale_kind, bias_kind,
           steps_per_split, stages,
           tc_layout(bm, kFormInt4, G, tc_kind_bytes(scale_kind), 0, bias_bytes, stages)};
  const cudaError_t e = bm == 128 ? tc_i4_group<128>(G, a, splits, smem, st)
                                  : tc_i4_group<64>(G, a, splits, smem, st);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const size_t count = (size_t)B * N;
    qmm_i4_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), count, splits);
  }
  return (int)cudaGetLastError();
}

// The small-row tensor-core body (bf16 compute; the wrapper sends it 2-8
// rows). x f32 [B, K]; weight operands as qmm_i4_launch's; split y of
// `splits` runs K steps of 64 [y * steps_per_split, ...) into partial
// [splits, B, N] (out directly when splits == 1); smem: dynamic shared
// memory bytes, at least the layout's (ops/qmm.py:_mma_plan).
extern "C" int qmm_i4_mma_launch(const void* x, const void* q, const void* scale,
                                 const void* bias, void* out, void* partial, int B, int K, int N,
                                 int G, int scale_kind, int bias_kind, int splits,
                                 int steps_per_split, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MmaArgs a{x, static_cast<const int8_t*>(q), scale, bias, nullptr, nullptr,
                  static_cast<float*>(splits > 1 ? partial : out), B, K, N, scale_kind,
                  bias_kind, steps_per_split, {}};
  const cudaError_t e = mma_run<kFormInt4, false, float, 8>(a, G, splits, smem, st);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const size_t count = (size_t)B * N;
    qmm_i4_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), count, splits);
  }
  return (int)cudaGetLastError();
}

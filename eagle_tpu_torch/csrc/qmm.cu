// Fused dequant + matmul for group-quantized "kn" weights:
//   out[B, N] (f32) = x[B, K] @ (scale ⊙ q + bias)
// Port of eagle_tpu/ops/pallas_qmm.py:_qmm_kernel (reached through
// qmatmul_pallas_2d, pallas_call at :513, and qmatmul_pallas_stacked, at
// :758). A layer of a stacked weight is chosen by the caller offsetting the
// pointers; nothing is copied.
//
// Rounding points follow the Pallas kernel: w = round_ct(q * scale_f32),
// the scale code * sup for coded weights; x rounds to the compute dtype;
// products accumulate in f32; the per-group bias is the side product
// round_ct(xsum_g) * round_ct(bias_g).
//
// Four bodies, chosen by ops/qmm.py (`_route`) from the shape alone:
// - qmm_kernel (SIMT, qmm_body.cuh; f32 compute at any row count, and the
//   shapes the tensor-core bodies cannot address: K % 64 != 0, N % 16 !=
//   0; at N % 4 != 0 it loads element by element, masked at the last
//   column). Bound on the H100 by the weight bytes (4.75 bits per
//   weight for Q4_K packed with codes). Every weight byte is read once
//   per row tile, 4 adjacent columns per lane (one 128-byte line per warp
//   and weight row); a warp loads all rows of a quant group before it uses
//   any, so many loads are in flight; K is split across warps and blocks so
//   that even the small-N projections put several blocks on each of the 132
//   SMs. Partial sums from K splits are reduced in a fixed order by a second
//   small kernel (deterministic, no atomics). The integer-to-float step uses
//   the 2^23 magic number and bf16 rounding goes two values per
//   instruction: conversion instructions run at a quarter of the FMA rate.
// - qmm_gemv_kernel (qmm_gemv.cuh; bf16 compute, 1 row: decode). Bound by
//   the weight bytes; the SIMT body reached 23-36 % of that bound there,
//   held by its per-group load-then-compute order and ~4.5 issue slots per
//   weight. A 3-stage cp.async ring of raw weight tiles runs ahead of the
//   math; x is staged once per block; each weight becomes a bf16 A operand
//   of mma.sync.m16n8k16 in three instructions. K splits reduced as below.
// - qmm_mma_kernel (qmm_mma.cuh; bf16 compute, 2-8 rows: the EAGLE verify
//   forward). Bound by the weight bytes as at one row; the SIMT body paid an
//   FMA per weight and row there. Each weight is dequantized once into a
//   bf16 tile that `mma.sync.m16n8k16` reads for all rows at once, from a
//   3-stage `cp.async` ring; K splits reduced as above. Held by the latency
//   of its barrier-separated phases per 64-deep step (see qmm_mma.cuh).
// - qmm_tc_kernel (qmm_tc.cuh; bf16 compute, more than 8 rows: prefill).
//   Bound by operations at 512 rows. An x prologue rounds x to bf16 and
//   takes the group sums once per call; the main loop runs `wgmma.mma_async`
//   (bf16, f32 accumulators) on 64- or 128-row x 256-column tiles, fed by a
//   3-4 stage ring that one producer thread fills by TMA under mbarriers,
//   with each bf16 weight tile dequantized in shared memory while the
//   previous step's wgmma runs; the bias side product is a few trailing
//   wgmma steps over the group dimension; K splits fill the card when the
//   tiles are few.
// Every form (packed / int8, coded / f32 / bf16 scales, bias or none, G = 8,
// 16, 32, 2-D or stacked) takes every body.
// This file holds the SIMT and 1-row bodies' entry points (qmm_launch,
// qmm_gemv_launch); the wgmma and small-row bodies' are in
// qmm_tensor_core.cu, a translation unit of its own so that the two compile
// in parallel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_body.cuh"
#include "qmm_gemv.cuh"

namespace {

struct Launch {
  const float* x; const int8_t* q; const void* scale; const void* bias;
  const float* sup; const float* sup_min; float* dst;
  int B, K, N, scale_kind, bias_kind, splits, groups_per_split;
  cudaStream_t stream;
};

template <int RB, bool BF16, int G, bool PACKED, bool VEC>
void launch(const Launch& a) {
  const dim3 grid((a.N + kColsPerBlock - 1) / kColsPerBlock, a.splits, (a.B + RB - 1) / RB);
  qmm_kernel<RB, BF16, G, PACKED, false, float, VEC><<<grid, kWarps * 32, 0, a.stream>>>(
      a.x, a.q, a.scale, a.bias, a.sup, a.sup_min, a.dst, a.B, a.K, a.N, a.scale_kind,
      a.bias_kind, a.groups_per_split);
}

template <int RB, bool BF16, bool VEC>
void dispatch_form(int G, int packed, const Launch& a) {
  if (G == 8) {
    packed ? launch<RB, BF16, 8, true, VEC>(a) : launch<RB, BF16, 8, false, VEC>(a);
  } else if (G == 16) {
    packed ? launch<RB, BF16, 16, true, VEC>(a) : launch<RB, BF16, 16, false, VEC>(a);
  } else {
    packed ? launch<RB, BF16, 32, true, VEC>(a) : launch<RB, BF16, 32, false, VEC>(a);
  }
}

template <bool BF16, bool VEC>
void dispatch_rb(int rb, int G, int packed, const Launch& a) {
  switch (rb) {
    case 1: dispatch_form<1, BF16, VEC>(G, packed, a); break;
    case 2: dispatch_form<2, BF16, VEC>(G, packed, a); break;
    case 4: dispatch_form<4, BF16, VEC>(G, packed, a); break;
    default: dispatch_form<8, BF16, VEC>(G, packed, a); break;
  }
}

}  // namespace

// x f32 [B, K]; q int8 [K, N] or packed [K/2, N]; scale/bias [K/G, N] of
// kind f32 (0), bf16 (1) or int8 codes (2, with sup/sup_min f32 [K/256, N]);
// bias_kind -1 = no bias; G in {8, 16, 32}. out f32 [B, N]; partial f32 [splits, B, N] when
// splits > 1 (else unused). rb in {1, 2, 4, 8}: rows per block of the SIMT
// body (qmm_mma_launch and qmm_tc_launch below are the tensor-core bodies).
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
  const bool vec = N % 4 == 0;  // else the masked column edge
  if (compute_bf16) {
    vec ? dispatch_rb<true, true>(rb, G, packed, a) : dispatch_rb<true, false>(rb, G, packed, a);
  } else {
    vec ? dispatch_rb<false, true>(rb, G, packed, a) : dispatch_rb<false, false>(rb, G, packed, a);
  }
  if (splits > 1) {
    const size_t count = (size_t)B * N;
    qmm_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), count, splits);
  }
  return (int)cudaGetLastError();
}


// The 1-row tensor-core body (bf16 compute; the wrapper sends it one row at
// K % 64 == 0, N % 16 == 0 and any form but int4). x f32 [1, K]; weight
// operands as qmm_launch's; split y of `splits` runs K steps of 64
// [y * steps_per_split, ...) into partial [splits, 1, N] (out directly when
// splits == 1); stages: ring stages (2-6); smem: dynamic shared memory
// bytes, at least the layout's (ops/qmm.py:_gemv_plan).
extern "C" int qmm_gemv_launch(const void* x, const void* q, const void* scale, const void* bias,
                               const void* sup, const void* sup_min, void* out, void* partial,
                               int K, int N, int G, int packed, int scale_kind, int bias_kind,
                               int stages, int splits, int steps_per_split, int smem,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GemvArgs a{static_cast<const float*>(x), static_cast<const int8_t*>(q), scale, bias,
                   static_cast<const float*>(sup), static_cast<const float*>(sup_min),
                   static_cast<float*>(splits > 1 ? partial : out), K, N, scale_kind, bias_kind,
                   stages, steps_per_split, 0, 0, 0, 0, {}};
  const cudaError_t e = gemv_run<false, float>(a, G, packed, splits, smem, st);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    qmm_reduce_kernel<<<(unsigned)((N + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), (size_t)N, splits);
  }
  return (int)cudaGetLastError();
}

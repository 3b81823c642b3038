// Fused FFN block kernels for decode and verify rows (R <= 64):
//
// ffn_out_norm — replaces eagle_tpu/ops/pallas_ffn.py:_fused_qmm_call with
//   the epi_out_norm epilogue (pallas_calls at :257 and :265, epilogue :457):
//     x = resid + attn @ Wo          (f32)
//     h = round_ct(x * rsqrt(mean(x^2) + eps) * w)
// gate_up_act — replaces pallas_ffn.py:_gate_up_act_2d (:413 and :419):
//     a = round_ct(act(h @ Wg) * (h @ Wu)), gate columns [0, F) and up
//     columns [F, 2F) of one fused weight; act is SiLU or tanh-GELU.
//
// Bound on the H100: the weight bytes (Q4_0 packed with f32 scale and bias:
// 6 bits per weight; wo 12.6 MB and w_gate_up 67.6 MB per Vicuna-7B layer),
// exactly as the qmm kernel is; the epilogues move a few R x D rows.
//
// Design. The TPU kernels keep the whole [R, N] output row resident in VMEM
// over a K-only grid and fire the epilogue on the last K step. On the card
// blocks run in parallel over column tiles and K splits, so no block holds
// a full row or a full K sum. Each op is therefore two kernels:
// 1. the matmul pass, writing per-split partial sums, on one of qmm's
//    bodies with qmm's plan for the same product (ops/ffn.py:_body):
//    - bf16 at 1 row: qmm_gemv_kernel (qmm_gemv.cuh), with qmm's
//      _gemv_plan; paired for gate/up, a block takes 128 gate columns and
//      the matching 128 up columns, one half per four warps. x, g and u are
//      qmm's sums (+ resid) to the bit. The SIMT pass it replaced at 1 row
//      kept one quant group's loads in flight per warp and re-rounded x in
//      every lane: 43 % of the byte bound on Q4_0 w_gate_up (H100 80GB
//      HBM3, 700 W).
//    - f32 compute, K % 64 != 0: qmm_kernel (qmm_body.cuh). For wo it runs
//      as qmm does; for gate/up it runs paired: a block walks its tile of
//      gate columns, then the matching tile of up columns (offset F in the
//      same weight), each with its own f32 accumulators, one set live at a
//      time (both sets live took all 255 registers at 8 rows and ran 2.7x
//      slower than qmm over the same bytes on an H100 80GB HBM3);
//    - bf16 at 2-64 rows: qmm_mma_kernel (qmm_mma.cuh), each weight
//      dequantized once into a bf16 tile and `mma.sync` products over up to
//      four m16 row tiles; paired, a block takes 128 gate columns and the
//      matching 128 up columns together (the accumulators of 64 rows fit).
//      The SIMT body's FMA per weight and row made 6 rows cost 2.0-3.2x one
//      row; this body costs 1.0-1.2x (chip_smoke.py, H100 80GB HBM3, 700 W).
// 2. the epilogue pass, where the full sums first exist: it adds the splits
//    in a fixed order (deterministic, no atomics). For ffn_out_norm it runs
//    one block per row: residual add, x^2 reduced over the row, x and h
//    written. For gate_up_act it is elementwise: act(g) * u, rounded once.
// With the plan the unfused path's qmm would choose (the wrapper passes
// it), x, g and u are bit-equal to the unfused path's sums where qmm takes
// the same body too (every f32 product; bf16 at 1-8 rows). Any row count
// from 1 to 64 runs as it is: the TPU's pad to 8 rows does not carry over.
// This file holds the SIMT matmul passes' entry points; the tensor-core
// passes' are in ffn_tensor_core.cu, a translation unit of its own so that
// the two compile in parallel; both share ffn_epilogue.cuh.
#include <type_traits>

#include "ffn_epilogue.cuh"
#include "qmm_body.cuh"

namespace {

template <int RB, bool BF16, int G, bool PACKED>
struct OutNorm {
  static void run(const OutNormArgs& a) {
    const dim3 grid((a.N + kColsPerBlock - 1) / kColsPerBlock, a.splits, (a.R + RB - 1) / RB);
    qmm_kernel<RB, BF16, G, PACKED, false, float><<<grid, kWarps * 32, 0, a.st>>>(
        a.x, a.q, a.scale, a.bias, nullptr, nullptr, a.partial, a.R, a.K, a.N, a.scale_kind,
        a.bias_kind, a.gps);
    out_norm_epilogue<BF16>(a);
  }
};

template <int RB, bool BF16, int G, bool PACKED>
struct GateUp {
  static void run(const GateUpArgs& a) {
    using XT = typename std::conditional<BF16, __nv_bfloat16, float>::type;
    const dim3 grid((a.F + kColsPerBlock - 1) / kColsPerBlock, a.splits, (a.R + RB - 1) / RB);
    qmm_kernel<RB, BF16, G, PACKED, true, XT><<<grid, kWarps * 32, 0, a.st>>>(
        static_cast<const XT*>(a.h), a.q, a.scale, a.bias, nullptr, nullptr, a.partial, a.R,
        a.K, 2 * a.F, a.scale_kind, a.bias_kind, a.gps);
    gate_up_epilogue<BF16>(a);
  }
};

// Op<RB, BF16, G, PACKED>::run(a) for the runtime form
template <template <int, bool, int, bool> class Op, int RB, bool BF16, typename A>
void dispatch_form(int G, int packed, const A& a) {
  if (G == 8) {
    packed ? Op<RB, BF16, 8, true>::run(a) : Op<RB, BF16, 8, false>::run(a);
  } else if (G == 16) {
    packed ? Op<RB, BF16, 16, true>::run(a) : Op<RB, BF16, 16, false>::run(a);
  } else {
    packed ? Op<RB, BF16, 32, true>::run(a) : Op<RB, BF16, 32, false>::run(a);
  }
}

template <template <int, bool, int, bool> class Op, bool BF16, typename A>
void dispatch_rb(int rb, int G, int packed, const A& a) {
  switch (rb) {
    case 1: dispatch_form<Op, 1, BF16>(G, packed, a); break;
    case 2: dispatch_form<Op, 2, BF16>(G, packed, a); break;
    case 4: dispatch_form<Op, 4, BF16>(G, packed, a); break;
    default: dispatch_form<Op, 8, BF16>(G, packed, a); break;
  }
}

template <template <int, bool, int, bool> class Op, typename A>
void dispatch(int compute_bf16, int rb, int G, int packed, const A& a) {
  if (compute_bf16) {
    dispatch_rb<Op, true>(rb, G, packed, a);
  } else {
    dispatch_rb<Op, false>(rb, G, packed, a);
  }
}

}  // namespace

// x f32 [R, K] (attention rows); Wo layer: q int8 [K, N] or packed [K/2, N],
// scale/bias [K/G, N] of kind f32 (0) or bf16 (1), bias_kind -1 = none;
// resid f32 [R, N]; norm_w f32 [N]. Outputs x_out f32 [R, N], h_out [R, N]
// (bf16 if compute_bf16, else f32); scratch partial f32 [splits, R, N].
extern "C" int ffn_out_norm_launch(const void* x, const void* q, const void* scale,
                                   const void* bias, const void* resid, const void* norm_w,
                                   void* x_out, void* h_out, void* partial, int R, int K, int N,
                                   int G, int packed, int scale_kind, int bias_kind,
                                   int compute_bf16, int rb, int splits, int gps, float eps,
                                   void* stream) {
  const OutNormArgs a{static_cast<const float*>(x), static_cast<const int8_t*>(q), scale, bias,
                      static_cast<const float*>(resid), static_cast<const float*>(norm_w),
                      static_cast<float*>(x_out), h_out, static_cast<float*>(partial), R, K, N,
                      scale_kind, bias_kind, splits, gps, eps, static_cast<cudaStream_t>(stream)};
  dispatch<OutNorm>(compute_bf16, rb, G, packed, a);
  return (int)cudaGetLastError();
}

// h [R, K] in the compute dtype (bf16 if compute_bf16, else f32); fused
// weight layer: q [K(/2), 2F], scale/bias [K/G, 2F], gate columns [0, F),
// up columns [F, 2F); act 0 = SiLU, 1 = tanh-GELU. out [R, F] in the
// compute dtype; scratch partial f32 [splits, 2, R, F].
extern "C" int gate_up_act_launch(const void* h, const void* q, const void* scale,
                                  const void* bias, void* out, void* partial, int R, int K, int F,
                                  int G, int packed, int scale_kind, int bias_kind,
                                  int compute_bf16, int act, int rb, int splits, int gps,
                                  void* stream) {
  const GateUpArgs a{h, static_cast<const int8_t*>(q), scale, bias, out,
                     static_cast<float*>(partial), R, K, F, scale_kind, bias_kind, act, splits,
                     gps, static_cast<cudaStream_t>(stream)};
  dispatch<GateUp>(compute_bf16, rb, G, packed, a);
  return (int)cudaGetLastError();
}

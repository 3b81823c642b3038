// Entry points of the fused FFN kernels' matmul passes on the small-row
// (qmm_mma.cuh) and 1-row (qmm_gemv.cuh) tensor-core bodies, with the
// epilogues of ffn_epilogue.cuh; ffn.cu describes the design and holds the
// SIMT passes.
#include "ffn_epilogue.cuh"
#include "qmm_gemv.cuh"
#include "qmm_mma.cuh"

// The matmul passes on the small-row tensor-core body (qmm_mma.cuh; bf16
// compute, 2-64 rows), with the SIMT passes' epilogues: arguments as
// ffn.cu's ffn_out_norm_launch / gate_up_act_launch, minus compute_bf16
// and rb, plus the plan's steps_per_split and dynamic shared memory bytes
// (ops/qmm.py:_mma_plan).
extern "C" int ffn_out_norm_mma_launch(const void* x, const void* q, const void* scale,
                                       const void* bias, const void* resid, const void* norm_w,
                                       void* x_out, void* h_out, void* partial, int R, int K,
                                       int N, int G, int packed, int scale_kind, int bias_kind,
                                       int splits, int steps_per_split, int smem, float eps,
                                       void* stream) {
  const OutNormArgs a{static_cast<const float*>(x), static_cast<const int8_t*>(q), scale, bias,
                      static_cast<const float*>(resid), static_cast<const float*>(norm_w),
                      static_cast<float*>(x_out), h_out, static_cast<float*>(partial), R, K, N,
                      scale_kind, bias_kind, splits, 0, eps, static_cast<cudaStream_t>(stream)};
  const MmaArgs m{x, a.q, scale, bias, nullptr, nullptr, a.partial, R, K, N, scale_kind, bias_kind,
                  steps_per_split, {}};
  const cudaError_t e =
      packed ? mma_run<kFormPacked, false, float, kMmaMaxRows>(m, G, splits, smem, a.st)
             : mma_run<kFormInt8, false, float, kMmaMaxRows>(m, G, splits, smem, a.st);
  if (e != cudaSuccess) return (int)e;
  out_norm_epilogue<true>(a);
  return (int)cudaGetLastError();
}

extern "C" int gate_up_act_mma_launch(const void* h, const void* q, const void* scale,
                                      const void* bias, void* out, void* partial, int R, int K,
                                      int F, int G, int packed, int scale_kind, int bias_kind,
                                      int act, int splits, int steps_per_split, int smem,
                                      void* stream) {
  const GateUpArgs a{h, static_cast<const int8_t*>(q), scale, bias, out,
                     static_cast<float*>(partial), R, K, F, scale_kind, bias_kind, act, splits, 0,
                     static_cast<cudaStream_t>(stream)};
  const MmaArgs m{h, a.q, scale, bias, nullptr, nullptr, a.partial, R, K, 2 * F, scale_kind,
                  bias_kind, steps_per_split, {}};
  const cudaError_t e =
      packed ? mma_run<kFormPacked, true, __nv_bfloat16, kMmaMaxRows>(m, G, splits, smem, a.st)
             : mma_run<kFormInt8, true, __nv_bfloat16, kMmaMaxRows>(m, G, splits, smem, a.st);
  if (e != cudaSuccess) return (int)e;
  gate_up_epilogue<true>(a);
  return (int)cudaGetLastError();
}


// ffn_out_norm's matmul pass on the 1-row tensor-core body (qmm_gemv.cuh;
// bf16 compute, one row), with the same epilogue: arguments as
// ffn_out_norm_launch's for R = 1, minus compute_bf16, rb and gps, plus the
// plan's ring stages, steps_per_split and dynamic shared memory bytes
// (ops/qmm.py:_gemv_plan, qmm's plan for the same product).
extern "C" int ffn_out_norm_gemv_launch(const void* x, const void* q, const void* scale,
                                        const void* bias, const void* resid, const void* norm_w,
                                        void* x_out, void* h_out, void* partial, int K, int N,
                                        int G, int packed, int scale_kind, int bias_kind,
                                        int stages, int splits, int steps_per_split, int smem,
                                        float eps, void* stream) {
  const OutNormArgs a{static_cast<const float*>(x), static_cast<const int8_t*>(q), scale, bias,
                      static_cast<const float*>(resid), static_cast<const float*>(norm_w),
                      static_cast<float*>(x_out), h_out, static_cast<float*>(partial), 1, K, N,
                      scale_kind, bias_kind, splits, 0, eps, static_cast<cudaStream_t>(stream)};
  const GemvArgs m{a.x, a.q, scale, bias, nullptr, nullptr, a.partial, K, N, scale_kind,
                   bias_kind, stages, steps_per_split, 0, 0, 0, 0, {}};
  const cudaError_t e = gemv_run<false, float>(m, G, packed, splits, smem, a.st);
  if (e != cudaSuccess) return (int)e;
  out_norm_epilogue<true>(a);
  return (int)cudaGetLastError();
}

// gate_up_act's matmul pass on the 1-row tensor-core body, paired
// (qmm_gemv.cuh; bf16 compute, one row), with the same epilogue: arguments
// as gate_up_act_mma_launch's for R = 1, h bf16 [1, K], plus the plan's
// ring stages (ops/qmm.py:_gemv_plan for the [1, K] @ [K, 2F] product, as
// qmm takes it).
extern "C" int gate_up_act_gemv_launch(const void* h, const void* q, const void* scale,
                                       const void* bias, void* out, void* partial, int K, int F,
                                       int G, int packed, int scale_kind, int bias_kind, int act,
                                       int stages, int splits, int steps_per_split, int smem,
                                       void* stream) {
  const GateUpArgs a{h, static_cast<const int8_t*>(q), scale, bias, out,
                     static_cast<float*>(partial), 1, K, F, scale_kind, bias_kind, act, splits, 0,
                     static_cast<cudaStream_t>(stream)};
  const GemvArgs m{h, a.q, scale, bias, nullptr, nullptr, a.partial, K, 2 * F, scale_kind,
                   bias_kind, stages, steps_per_split, 0, 0, 0, 0, {}};
  const cudaError_t e = gemv_run<true, __nv_bfloat16>(m, G, packed, splits, smem, a.st);
  if (e != cudaSuccess) return (int)e;
  gate_up_epilogue<true>(a);
  return (int)cudaGetLastError();
}

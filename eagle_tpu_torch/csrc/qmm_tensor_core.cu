// Entry points of qmm's wgmma and small-row tensor-core bodies
// (qmm_tc_launch, qmm_mma_launch): what they compute, their bounds and
// designs are described in qmm.cu, whose SIMT and 1-row entry points
// compile in a translation unit of their own.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_mma.cuh"
#include "qmm_tc.cuh"

namespace {

template <int BM, int G>
cudaError_t tc_form(int packed, const TcArgs& a, int splits, int smem, cudaStream_t st) {
  return packed ? tc_launch<BM, G, kFormPacked>(a, splits, smem, st)
                : tc_launch<BM, G, kFormInt8>(a, splits, smem, st);
}

template <int BM>
cudaError_t tc_group(int G, int packed, const TcArgs& a, int splits, int smem, cudaStream_t st) {
  if (G == 8) return tc_form<BM, 8>(packed, a, splits, smem, st);
  if (G == 16) return tc_form<BM, 16>(packed, a, splits, smem, st);
  return tc_form<BM, 32>(packed, a, splits, smem, st);
}

}  // namespace

// The tensor-core body (bf16 compute; the wrapper sends it more than 8
// rows). x f32 [B, K]; xb bf16 [B, K] and, with a bias, xsum bf16 [B, gp]
// are scratch that the x prologue fills; weight operands as qmm_launch's.
// bm in {64, 128}: rows per block; stages in {3, 4}; split z of `splits`
// runs K steps of 64 [z * steps_per_split, ...) into partial [splits, B, N]
// (out directly when splits == 1); smem: dynamic shared memory bytes, at
// least the layout's (ops/qmm.py:_tc_plan).
extern "C" int qmm_tc_launch(const void* x, void* xb, void* xsum, const void* q,
                             const void* scale, const void* bias, const void* sup,
                             const void* sup_min, void* out, void* partial, int gp, int B, int K,
                             int N, int G, int packed, int scale_kind, int bias_kind, int bm,
                             int stages, int splits, int steps_per_split, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((bm != 64 && bm != 128) || (G != 8 && G != 16 && G != 32) || K % kTcK || N % 16)
    return (int)cudaErrorInvalidValue;
  const bool side = bias_kind != kKindNone;
  const dim3 pgrid((K / 4 + 255) / 256, B);
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  auto* xsp = side ? static_cast<__nv_bfloat16*>(xsum) : nullptr;
  if (G == 8) {
    tc_x_prologue<8><<<pgrid, 256, 0, st>>>(static_cast<const float*>(x), xbp, xsp, K, gp);
  } else if (G == 16) {
    tc_x_prologue<16><<<pgrid, 256, 0, st>>>(static_cast<const float*>(x), xbp, xsp, K, gp);
  } else {
    tc_x_prologue<32><<<pgrid, 256, 0, st>>>(static_cast<const float*>(x), xbp, xsp, K, gp);
  }
  const int form = packed ? kFormPacked : kFormInt8;
  TcArgs a{xbp, xsp, static_cast<const int8_t*>(q), scale, bias,
           static_cast<const float*>(sup), static_cast<const float*>(sup_min),
           static_cast<float*>(splits > 1 ? partial : out), B, K, N, gp, scale_kind, bias_kind,
           steps_per_split, stages,
           tc_layout(bm, form, G, tc_kind_bytes(scale_kind), scale_kind == kKindCode, 0, stages)};
  const cudaError_t e = bm == 128 ? tc_group<128>(G, packed, a, splits, smem, st)
                                  : tc_group<64>(G, packed, a, splits, smem, st);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const size_t count = (size_t)B * N;
    qmm_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), count, splits);
  }
  return (int)cudaGetLastError();
}

// The small-row tensor-core body (bf16 compute; the wrapper sends it 2-8
// rows). x f32 [B, K]; weight operands as qmm_launch's; split y of `splits`
// runs K steps of 64 [y * steps_per_split, ...) into partial [splits, B, N]
// (out directly when splits == 1); smem: dynamic shared memory bytes, at
// least the layout's (ops/qmm.py:_mma_plan).
extern "C" int qmm_mma_launch(const void* x, const void* q, const void* scale, const void* bias,
                              const void* sup, const void* sup_min, void* out, void* partial,
                              int B, int K, int N, int G, int packed, int scale_kind,
                              int bias_kind, int splits, int steps_per_split, int smem,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MmaArgs a{x, static_cast<const int8_t*>(q), scale, bias, static_cast<const float*>(sup),
            static_cast<const float*>(sup_min), static_cast<float*>(splits > 1 ? partial : out),
            B, K, N, scale_kind, bias_kind, steps_per_split, {}};
  const cudaError_t e = packed ? mma_run<kFormPacked, false, float, 8>(a, G, splits, smem, st)
                               : mma_run<kFormInt8, false, float, 8>(a, G, splits, smem, st);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const size_t count = (size_t)B * N;
    qmm_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), count, splits);
  }
  return (int)cudaGetLastError();
}

// The Hopper pieces that the wgmma bodies share (qmm_tc.cuh, used by qmm,
// qmm_i4 and the fused FFN kernels' headers, and flash_wgmma.cu):
// warpgroup MMA ordering (wgmma.fence / commit_group / wait_group and the
// async-proxy fence for operands written with st.shared), mbarriers (init,
// arrive, expect_tx, parity wait), TMA tensor loads completing on an
// mbarrier, the 128-byte-swizzle shared-memory descriptor, and the tensor
// maps' encoder, reached through the CUDA runtime (no libcuda link).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <stdint.h>

namespace {

// this thread's shared-memory writes (st.shared) become visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity; the
// thread is suspended (up to the hint, in ns) rather than spinning, so a
// waiting warp takes no issue slots from the warps that work
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity), "r"(1000000)
        : "memory");
  }
}
// arrive on the barrier and expect `bytes` of TMA copies on its phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// TMA: the box at (c0 innermost, c1) of the tensor map into shared memory,
// completing `bytes` on the barrier (coordinates past the array's end fill
// zeros)
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the same for a 3-D tensor map: the box at (c0 innermost, c1, c2)
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// the same for a 4-D tensor map: the box at (c0 innermost, c1, c2, c3)
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused; MN-major: between 64-element MN atoms) and
// stride byte offset (between groups of 8 rows), all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (the library links no libcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 tc_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

}  // namespace

// The tensor-core main loop of qmm (csrc/qmm_tensor_core.cu) and qmm_i4 (csrc/qmm_i4.cu)
// for bf16 compute at more than 8 rows (prefill), as qmm_body.cuh is the
// SIMT body of qmm and the fused FFN kernels. The two instantiations differ
// only in their dequant step and rounding points:
// - qmm (FORM packed or int8): w = round_bf16(q * scale_f32), the scale
//   code * sup for coded weights; the per-group bias is the side product
//   round_bf16(xsum_g) * round_bf16(bias_g), run as trailing steps over the
//   group dimension into the same accumulators (the bias code * sup_min for
//   coded weights).
// - qmm_i4 (FORM int4): w = round_bf16(q * round_bf16(scale)), then
//   w = round_bf16(w + round_bf16(bias)), per weight; no side product.
// In both, x is rounded to bf16 and products accumulate in f32.
//
// Bound on the H100 at 512 rows: operations (2 x 512 x K x N at 989 TFLOP/s
// bf16 against ~0.5 bytes per weight at 3.35 TB/s). So the loop feeds
// Hopper's warpgroup MMA (`wgmma.mma_async` m64nNk16, bf16 in, f32
// accumulators in registers) and hides everything else behind it:
// - An x prologue (tc_x_prologue) runs once per call: x rounded to bf16
//   [B, K] and, for qmm with a bias, the f32 group sums rounded to bf16
//   [B, gp] (zero past K/G), instead of every column block redoing both.
// - A block is two math warpgroups and one producer warp (288 threads) over
//   BM x 256 outputs: BM = 128 (each warpgroup 64 rows x 256 columns)
//   above 64 rows, BM = 64 (each 64 rows x 128 columns) at 9-64 rows. K
//   runs in steps of 64.
// - A ring of 3-4 stages in shared memory holds, per step, the bf16 x tile
//   (K-major, 128-byte swizzle: wgmma's A operand as it lands) and the raw
//   weight tile: q bytes (packed nibbles or int8), the scale rows, sup for
//   coded weights, the bias rows for int4. One thread of the producer warp
//   fills it by TMA (`cp.async.bulk.tensor` from tensor maps built per call,
//   zeros past the row and column edges), completing on an mbarrier per
//   stage (full); the math warps hand a stage back on another (empty). One
//   thread issues the 4-5 copies of a step, so they cost the math warps no
//   instructions (16-byte `cp.async` from every thread costs many).
// - The math warps dequantize each step's raw tile into one of two bf16 B
//   slots, in wgmma's MN-major layout with the 128-byte swizzle: the "kn"
//   weight is already N-contiguous, so no transpose. Step t + 1 is
//   dequantized while the wgmma of step t is in flight (wgmma.commit_group
//   / wait_group 1). The dequant, not the tensor cores, sets the pace: the
//   math warps' dequant of a 64 x 256 tile takes longer than the products of
//   a 128 x 256 x 64 step.
// - K splits (blockIdx.z) on 256-row boundaries fill the card where the
//   output tiles are fewer than its 132 SMs; a second kernel adds the
//   splits in a fixed order (no atomics). ops/qmm.py:_tc_plan picks the
//   row tile, the stages and the splits.
// - Epilogue: float2 stores straight from the accumulator fragments,
//   masked at the ragged row and column edges.
// Needs K % 64 == 0, N % 16 == 0 and 16-byte aligned operands, as TMA does
// (checked by the wrapper).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_sync.cuh"
#include "qmm_body.cuh"

namespace {

constexpr int kTcCols = 256;     // weight columns per block
constexpr int kTcK = 64;         // K per step: one 128-byte swizzle row of bf16
constexpr int kTcMath = 256;     // two warpgroups: dequant and products
constexpr int kTcThreads = 288;  // + one producer warp that fills the ring
constexpr int kTcBSlot = kTcK * kTcCols * 2;  // one dequantized bf16 weight tile
constexpr int kTcMaxSmem = 232448;            // 227 KB: a block's dynamic shared memory
constexpr int kFormPacked = 0, kFormInt8 = 1, kFormInt4 = 2;

// Byte offsets within one ring stage (the x tile at 0, BM rows of 128
// bytes), the stage size, the B slots' offset and the dynamic shared memory
// a launch needs. ops/qmm.py:_tc_layout computes the same.
struct TcLayout {
  int q, scale, sup, bias, stage, bslots, bars, total;
};

__host__ __device__ inline int tc_round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ inline TcLayout tc_layout(int bm, int form, int G, int scale_bytes, int coded,
                                               int bias_bytes, int stages) {
  TcLayout l{};
  l.q = bm * 128;
  l.scale = l.q + (form == kFormInt8 ? kTcK : kTcK / 2) * kTcCols;
  l.sup = l.scale + (kTcK / G) * kTcCols * scale_bytes;
  l.bias = l.sup + (coded ? kTcCols * 4 : 0);
  const int end = l.bias + (form == kFormInt4 ? (kTcK / G) * kTcCols * bias_bytes : 0);
  l.stage = tc_round_up(end, 1024);
  l.bslots = stages * l.stage;
  l.bars = l.bslots + 2 * kTcBSlot;        // 8 mbarriers: full[4], empty[4]
  l.total = l.bars + 64 + 1024;            // + slack to align the base to 1024 bytes
  return l;
}

__host__ __device__ inline int tc_kind_bytes(int kind) {
  return kind == kKindF32 ? 4 : kind == kKindBF16 ? 2 : 1;
}

struct TcArgs {
  const __nv_bfloat16* xb;    // round_bf16(x) [B, K]
  const __nv_bfloat16* xsum;  // round_bf16(group sums of x) [B, gp]; null: no side product
  const int8_t* q;
  const void* scale;
  const void* bias;
  const float* sup;
  const float* sup_min;
  float* dst;  // [splits][B][N]
  int B, K, N, gp, scale_kind, bias_kind, steps_per_split, stages;
  TcLayout lay;
};

// TMA descriptors of one call, built on the host (tc_make_maps): x (or
// the group sums for the side steps) as [B, K] bf16 boxes of BM x 64 with
// the 128-byte swizzle, the weight arrays as dense [rows, 256] boxes.
struct TcMaps {
  CUtensorMap x, xsum, q, scale, aux;  // aux: sup (coded qmm) or bias (qmm_i4)
};

// ---- PTX (the wgmma, mbarrier and TMA helpers: hopper.cuh) ----

// the two math warpgroups' own barrier (id 1); the producer warp runs free
__device__ __forceinline__ void math_bar_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kTcMath) : "memory");
}

template <int WN>
struct Wgmma;

template <>
struct Wgmma<128> {
  // d[64] = A (64 x 16, K-major) * B (16 x 128, MN-major) + (scale_d ? d : 0); A and B
  // from shared memory
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  // d[128] = A (64 x 16, K-major) * B (16 x 256, MN-major) + (scale_d ? d : 0); A and B
  // from shared memory
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// ---- x prologue ----

// grid (ceil(K / 1024), B); 256 threads, 4 adjacent values each (K % 64 ==
// 0, so a group never straddles a warp). xb = round_bf16(x); with xsum, the
// f32 sum of each group of G rounded to bf16 at [row, g], zero on [K/G, gp).
template <int G>
__global__ void __launch_bounds__(256) tc_x_prologue(const float* __restrict__ x,
                                                     __nv_bfloat16* __restrict__ xb,
                                                     __nv_bfloat16* __restrict__ xsum, int K,
                                                     int gp) {
  const int row = blockIdx.y;
  const int k = (blockIdx.x * 256 + threadIdx.x) * 4;
  const bool in = k < K;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (in) {
    v = __ldg(reinterpret_cast<const float4*>(x + (size_t)row * K + k));
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(xb + (size_t)row * K + k);
    o[0] = __floats2bfloat162_rn(v.x, v.y);
    o[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  if (xsum != nullptr) {
    float s = (v.x + v.y) + (v.z + v.w);
#pragma unroll
    for (int off = 1; off < G / 4; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (in && (threadIdx.x & (G / 4 - 1)) == 0) xsum[(size_t)row * gp + k / G] = __float2bfloat16(s);
    if (blockIdx.x == 0)
      for (int g = K / G + threadIdx.x; g < gp; g += 256)
        xsum[(size_t)row * gp + g] = __float2bfloat16(0.f);
  }
}

// ---- the main loop's pieces ----

// the B slot byte of (K row k, 8-column unit uc): MN-major, 128-byte
// swizzle; columns in atoms of 64 (8 KB each: 64 K rows of 128 bytes), the
// 16-byte unit of a row XOR-ed with k % 8
__device__ __forceinline__ uint4* tc_b_at(uint8_t* bs, int k, int uc) {
  return reinterpret_cast<uint4*>(bs + (uc >> 3) * 8192 + k * 128 + (((uc & 7) ^ (k & 7)) << 4));
}

// eight adjacent per-group values (element index idx, a multiple of 8) of
// kind f32, bf16 or int8 codes, from a shared-memory tile
__device__ __forceinline__ void tc_smem8(const uint8_t* p, int kind, int idx, float o[8]) {
  if (kind == kKindF32) {
    const float4 a = *reinterpret_cast<const float4*>(p + idx * 4);
    const float4 b = *reinterpret_cast<const float4*>(p + idx * 4 + 16);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else if (kind == kKindBF16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + idx * 2);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      o[2 * i] = __low2float(h);
      o[2 * i + 1] = __high2float(h);
    }
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p + idx);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = s8_to_f((i < 4 ? v.x : v.y) >> (8 * (i & 3)));
  }
}

// the same from device memory (element offset off, a multiple of 8)
__device__ __forceinline__ void tc_global8(const void* p, int kind, size_t off, float o[8]) {
  load4(p, kind, off, o);
  load4(p, kind, off + 4, o + 4);
}

// 2^23 + byte p of w, as an f32 (p in 0..3): one byte permute
__device__ __forceinline__ float tc_magic_byte(uint32_t w, int p) {
  return __uint_as_float(__byte_perm(w, kMagic, 0x7540 + p));
}

// bytes p0, p1 of w (values 0..15, offset by 8: a signed nibble + 8) as a
// bf16 pair (128 + byte): one byte permute
__device__ __forceinline__ __nv_bfloat162 tc_bf16_pair(uint32_t w, int p0, int p1) {
  const uint32_t v = __byte_perm(w, 0x43434343u, p0 | 0x4000 | (p1 << 8) | 0x40);
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

__device__ __forceinline__ uint32_t bf16x2_as_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Dequantize one step's raw weight tile (stage sb) into the B slot bs.
// Warp rw dequantizes 8 K rows (int8) or 4 packed rows (8 K rows), all in
// one quant group, so each thread derives its 8 columns' scales once per
// step; lane uc writes columns 8uc .. 8uc+7 of each row: a warp stores full
// 128-byte rows of the swizzled slot (no bank conflict) from 256
// contiguous q bytes. Nibbles and bytes become floats by one byte permute
// into the 2^23 magic number each.
template <int G, int FORM>
__device__ __forceinline__ void tc_dequant(const uint8_t* sb, const TcLayout& L, uint8_t* bs,
                                           int scale_kind, int bias_kind, int rw, int uc) {
  constexpr int kRows = FORM == kFormInt8 ? 8 : 4;  // weight rows of this warp
  const int row0 = kRows * rw;
  const int gi = FORM == kFormInt8 ? row0 / G : row0 / (G / 2);
  float s[8];
  tc_smem8(sb + L.scale + gi * kTcCols * tc_kind_bytes(scale_kind), scale_kind, 8 * uc, s);
  if (FORM != kFormInt4 && scale_kind == kKindCode) {
    float sp[8];
    tc_smem8(sb + L.sup, kKindF32, 8 * uc, sp);
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] = sp[c] * s[c];
  }
  if constexpr (FORM == kFormInt8) {
    // w = round_bf16(q * s): (2^23 + 128 + q) - (2^23 + 128) is exact
    uint2 qv[kRows];  // every row's bytes first: the compiler cannot move a
                      // load of the raw tile above a store to the B slot
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      qv[i] = *reinterpret_cast<const uint2*>(sb + L.q + (row0 + i) * kTcCols + 8 * uc);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kr = row0 + i;
      const uint2 qb = qv[i];
      const uint32_t wd[2] = {qb.x ^ 0x80808080u, qb.y ^ 0x80808080u};
      uint32_t o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t w = wd[c >> 1];
        const int p = 2 * (c & 1);
        o[c] = pack_bf16((tc_magic_byte(w, p) - (kTwo23 + 128.f)) * s[2 * c],
                           (tc_magic_byte(w, p + 1) - (kTwo23 + 128.f)) * s[2 * c + 1]);
      }
      *tc_b_at(bs, kr, uc) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else if constexpr (FORM == kFormPacked) {
    // w = round_bf16(n * s) by fma(2^23 + n, s, -2^23 s), as deq4
    float cs[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) cs[c] = -kTwo23 * s[c];
    uint2 qv[kRows];  // loads first (see above)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      qv[i] = *reinterpret_cast<const uint2*>(sb + L.q + (row0 + i) * kTcCols + 8 * uc);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int pr = row0 + i, j = pr % (G / 2);
      const int klo = gi * G + j, khi = klo + G / 2;
      const uint2 qb = qv[i];
      const uint32_t lo[2] = {qb.x & 0x0F0F0F0Fu, qb.y & 0x0F0F0F0Fu};
      const uint32_t hi[2] = {(qb.x >> 4) & 0x0F0F0F0Fu, (qb.y >> 4) & 0x0F0F0F0Fu};
      uint32_t ol[4], oh[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = 2 * (c & 1);
        ol[c] = pack_bf16(fmaf(tc_magic_byte(lo[c >> 1], p), s[2 * c], cs[2 * c]),
                            fmaf(tc_magic_byte(lo[c >> 1], p + 1), s[2 * c + 1], cs[2 * c + 1]));
        oh[c] = pack_bf16(fmaf(tc_magic_byte(hi[c >> 1], p), s[2 * c], cs[2 * c]),
                            fmaf(tc_magic_byte(hi[c >> 1], p + 1), s[2 * c + 1], cs[2 * c + 1]));
      }
      *tc_b_at(bs, klo, uc) = make_uint4(ol[0], ol[1], ol[2], ol[3]);
      *tc_b_at(bs, khi, uc) = make_uint4(oh[0], oh[1], oh[2], oh[3]);
    }
  } else {
    // int4 in bf16 pairs: q = (128 + 8 + q) - 136 exactly; round_bf16(q *
    // round_bf16(s)) and round_bf16(w + round_bf16(b)) are single bf16
    // operations, equal to the f32 operation rounded (q * s has at most 12
    // significant bits; a bf16 sum that f32 cannot hold rounds to the
    // larger term either way)
    __nv_bfloat162 sp[4], bp[4];
    const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
    for (int c = 0; c < 4; ++c) sp[c] = __floats2bfloat162_rn(s[2 * c], s[2 * c + 1]);
    const bool bias = bias_kind != kKindNone;
    if (bias) {
      float b[8];
      tc_smem8(sb + L.bias + gi * kTcCols * tc_kind_bytes(bias_kind), bias_kind, 8 * uc, b);
#pragma unroll
      for (int c = 0; c < 4; ++c) bp[c] = __floats2bfloat162_rn(b[2 * c], b[2 * c + 1]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int pr = row0 + i, j = pr % (G / 2);
      const int klo = gi * G + j, khi = klo + G / 2;
      // loaded row by row: the scale and bias pairs take the registers that
      // hoisting the loads (as above) would need
      const uint2 qb = *reinterpret_cast<const uint2*>(sb + L.q + pr * kTcCols + 8 * uc);
      const uint32_t lo[2] = {(qb.x & 0x0F0F0F0Fu) ^ 0x08080808u, (qb.y & 0x0F0F0F0Fu) ^ 0x08080808u};
      const uint32_t hi[2] = {((qb.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                              ((qb.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u};
      uint32_t ol[4], oh[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = 2 * (c & 1);
        __nv_bfloat162 wl = __hmul2(__hsub2(tc_bf16_pair(lo[c >> 1], p, p + 1), off), sp[c]);
        __nv_bfloat162 wh = __hmul2(__hsub2(tc_bf16_pair(hi[c >> 1], p, p + 1), off), sp[c]);
        if (bias) {
          wl = __hadd2(wl, bp[c]);
          wh = __hadd2(wh, bp[c]);
        }
        ol[c] = bf16x2_as_bits(wl);
        oh[c] = bf16x2_as_bits(wh);
      }
      *tc_b_at(bs, klo, uc) = make_uint4(ol[0], ol[1], ol[2], ol[3]);
      *tc_b_at(bs, khi, uc) = make_uint4(oh[0], oh[1], oh[2], oh[3]);
    }
  }
}

// One trailing step of qmm's side product: the B slot's K row gr holds
// round_bf16(bias) of group gb0 + gr (code * sup_min when coded), zero for
// groups at or past g_end (another split's) and columns past N.
template <int G>
__device__ __forceinline__ void tc_dequant_bias(const TcArgs& a, uint8_t* bs, int gb0, int g_end,
                                                int n0, int rw, int uc) {
  const int n = n0 + 8 * uc;
#pragma unroll 2
  for (int i = 0; i < 8; ++i) {
    const int gr = rw + 8 * i, g = gb0 + gr;
    float b[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (g < g_end && n < a.N) {
      tc_global8(a.bias, a.bias_kind, (size_t)g * a.N + n, b);
      if (a.bias_kind == kKindCode) {
        float sm[8];
        tc_global8(a.sup_min, kKindF32, (size_t)(g * G / 256) * a.N + n, sm);
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = sm[c] * b[c];
      }
    }
    *tc_b_at(bs, gr, uc) = make_uint4(pack_bf16(b[0], b[1]), pack_bf16(b[2], b[3]),
                                      pack_bf16(b[4], b[5]), pack_bf16(b[6], b[7]));
  }
}

// grid (ceil(N / 256), ceil(B / BM), splits); 288 threads; dynamic shared
// memory a.lay.total. Split z runs K steps [z * steps_per_split, ...) and,
// with a side product, the trailing steps over its groups.
// Warp 8 is the producer: one thread fills ring stage t % S with step t's
// tiles by TMA as soon as step t - S has left it (empty[stage]); the
// copies complete on full[stage]. Warps 0-7 (two warpgroups)
// wait on full, dequantize step t + 1 into one of two B slots while the
// wgmma of step t runs (wait_group 1), and free the stage of step t - 1.
template <int BM, int G, int FORM>
__global__ void __launch_bounds__(kTcThreads, 1) qmm_tc_kernel(const __grid_constant__ TcArgs a,
                                                                const __grid_constant__ TcMaps m) {
  constexpr int WN = BM == 128 ? 256 : 128;  // columns of one warpgroup's product
  constexpr int kQRows = FORM == kFormInt8 ? kTcK : kTcK / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base_u32 = (raw_u32 + 1023u) & ~1023u;  // 128-byte swizzle atoms: 1 KB
  uint8_t* base = smem_raw + (base_u32 - raw_u32);
  const TcLayout& L = a.lay;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTcCols, r0 = blockIdx.y * BM;
  const int s_begin = blockIdx.z * a.steps_per_split;
  const int n_main = min(a.steps_per_split, a.K / kTcK - s_begin);
  const int g_begin = s_begin * (kTcK / G), g_end = (s_begin + n_main) * (kTcK / G);
  const int n_side = a.xsum != nullptr ? (g_end - g_begin + kTcK - 1) / kTcK : 0;
  const int total = n_main + n_side;
  const int S = a.stages;  // 3 or 4
  const uint32_t full0 = base_u32 + L.bars, empty0 = full0 + 32;  // [4] each, 8 bytes apart

  if (tid == 0) {
    for (int st = 0; st < 4; ++st) {
      mbar_init(full0 + 8 * st, 1);   // the producer's expect_tx, then the TMA bytes
      mbar_init(empty0 + 8 * st, 1);  // one math thread, after all are done with the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcMath) {
    // ---- producer: one thread issues every step's TMA copies ----
    if (tid == kTcMath) {
      const int eb = tc_kind_bytes(a.scale_kind);
      const bool sup = FORM != kFormInt4 && a.scale_kind == kKindCode;
      const bool ibias = FORM == kFormInt4 && a.bias_kind != kKindNone;
      const uint32_t w_bytes = kQRows * kTcCols + (kTcK / G) * kTcCols * eb + (sup ? kTcCols * 4 : 0) +
                               (ibias ? (kTcK / G) * kTcCols * tc_kind_bytes(a.bias_kind) : 0);
      for (int t = 0; t < total; ++t) {
        const int st = t % S;
        if (t >= S) mbar_wait(empty0 + 8 * st, ((t - S) / S) & 1);
        const uint32_t sa = base_u32 + st * L.stage, bar = full0 + 8 * st;
        if (t < n_main) {
          const int k0 = (s_begin + t) * kTcK;
          mbar_expect_tx(bar, BM * 128 + w_bytes);
          tma_2d(sa, &m.x, k0, r0, bar);
          tma_2d(sa + L.q, &m.q, n0, FORM == kFormInt8 ? k0 : k0 / 2, bar);
          tma_2d(sa + L.scale, &m.scale, n0, k0 / G, bar);
          if (sup) tma_2d(sa + L.sup, &m.aux, n0, k0 / 256, bar);
          if (ibias) tma_2d(sa + L.bias, &m.aux, n0, k0 / G, bar);
        } else {
          mbar_expect_tx(bar, BM * 128);
          tma_2d(sa, &m.xsum, g_begin + (t - n_main) * kTcK, r0, bar);
        }
      }
      // stay until the last copies have landed
      mbar_wait(full0 + 8 * ((total - 1) % S), ((total - 1) / S) & 1);
    }
    return;
  }

  // ---- math warpgroups: dequant and products ----
  const int wg = tid >> 7, rw = tid >> 5, uc = tid & 31;
  auto dequant = [&](int t) {
    const int st = t % S;
    mbar_wait(full0 + 8 * st, (t / S) & 1);  // the TMA bytes of step t have landed
    uint8_t* bs = base + L.bslots + (t & 1) * kTcBSlot;
    if (t < n_main)
      tc_dequant<G, FORM>(base + st * L.stage, L, bs, a.scale_kind, a.bias_kind, rw, uc);
    else
      tc_dequant_bias<G>(a, bs, g_begin + (t - n_main) * kTcK, g_end, n0, rw, uc);
    fence_proxy_async();  // the B slot, for wgmma
    math_bar_sync();
  };

  float acc[WN / 2];  // no initial value: the first product has scale_d = 0
  dequant(0);
  const uint32_t a_off = BM == 128 ? wg * 64 * 128 : 0;   // this warpgroup's rows
  const uint32_t b_off = BM == 128 ? 0 : wg * 2 * 8192;  // this warpgroup's columns
  for (int t = 0; t < total; ++t) {
    const uint32_t a_addr = base_u32 + (t % S) * L.stage + a_off;
    const uint32_t b_addr = base_u32 + L.bslots + (t & 1) * kTcBSlot + b_off;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk)
      Wgmma<WN>::mma(acc, desc_sw128(a_addr + kk * 32, 16, 1024),
                     desc_sw128(b_addr + kk * 16 * 128, 8192, 1024), t > 0 || kk > 0);
    wgmma_commit();
    if (t + 1 < total) {
      // step t - 1's products are done (this warpgroup, then both): its stage
      // goes back to the producer and its B slot takes step t + 1
      wgmma_wait<1>();
      math_bar_sync();
      if (t >= 1 && tid == 0) mbar_arrive(empty0 + 8 * ((t - 1) % S));
      dequant(t + 1);  // while step t's wgmma runs
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator fragment: warp w of the warpgroup holds rows 16w + lane/4
  // (+ 8); register 4j + {0, 1} (+ {2, 3}) holds columns 8j + 2 (lane % 4) + {0, 1}
  float* out = a.dst + (size_t)blockIdx.z * a.B * a.N;
  const int lane = tid & 31, w = (tid & 127) >> 5;
  const int row = r0 + (BM == 128 ? wg * 64 : 0) + 16 * w + (lane >> 2);
  const int col0 = n0 + (BM == 128 ? 0 : wg * 128) + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = col0 + 8 * j;
    if (col < a.N) {
      if (row < a.B)
        *reinterpret_cast<float2*>(out + (size_t)row * a.N + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < a.B)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * a.N + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

inline CUtensorMapDataType tc_map_type(int kind) {
  return kind == kKindF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : kind == kKindBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// a row-major [rows, cols] array of `kind` elements, boxes of box_rows x
// box_cols; swizzled: the 128-byte swizzle that wgmma's K-major operand reads
inline bool tc_map(CUtensorMap* map, const void* p, int kind, int rows, int cols, int box_rows,
                   int box_cols, bool swizzled) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * tc_kind_bytes(kind)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  return tc_encoder()(map, tc_map_type(kind), 2, const_cast<void*>(p), dims, strides, box, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch the main loop for row tile BM (after the prologue has filled
// a.xb, a.xsum). Refuses a plan whose shared memory does not hold the
// layout or whose stage count the loop does not take.
template <int BM, int G, int FORM>
cudaError_t tc_launch(const TcArgs& a, int splits, int smem, cudaStream_t st) {
  if (smem < a.lay.total || smem > kTcMaxSmem || (a.stages != 3 && a.stages != 4) ||
      tc_encoder() == nullptr)
    return cudaErrorInvalidValue;
  TcMaps m;
  const int q_rows = FORM == kFormInt8 ? a.K : a.K / 2;
  bool ok = tc_map(&m.x, a.xb, kKindBF16, a.B, a.K, BM, kTcK, true) &&
            tc_map(&m.q, a.q, kKindCode, q_rows, a.N, FORM == kFormInt8 ? kTcK : kTcK / 2,
                   kTcCols, false) &&
            tc_map(&m.scale, a.scale, a.scale_kind, a.K / G, a.N, kTcK / G, kTcCols, false);
  m.xsum = m.x;
  m.aux = m.scale;
  if (ok && a.xsum != nullptr) ok = tc_map(&m.xsum, a.xsum, kKindBF16, a.B, a.gp, BM, kTcK, true);
  if (ok && FORM != kFormInt4 && a.scale_kind == kKindCode)
    ok = tc_map(&m.aux, a.sup, kKindF32, a.K / 256, a.N, 1, kTcCols, false);
  if (ok && FORM == kFormInt4 && a.bias_kind != kKindNone)
    ok = tc_map(&m.aux, a.bias, a.bias_kind, a.K / G, a.N, kTcK / G, kTcCols, false);
  if (!ok) return cudaErrorInvalidValue;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(qmm_tc_kernel<BM, G, FORM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kTcMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.N + kTcCols - 1) / kTcCols, (a.B + BM - 1) / BM, splits);
  qmm_tc_kernel<BM, G, FORM><<<grid, kTcThreads, smem, st>>>(a, m);
  return cudaGetLastError();
}

}  // namespace

// The small-row tensor-core body (qmm_mma_kernel): the route of qmm and of
// qmm_i4 for 2-8 rows in bf16 (csrc/qmm_tensor_core.cu, csrc/qmm_i4.cu) and the matmul
// pass of the fused FFN kernels for 2-64 rows in bf16 (csrc/ffn_tensor_core.cu), as
// qmm_body.cuh is the SIMT body of qmm and the fused kernels and qmm_tc.cuh
// the wgmma prefill body of qmm and qmm_i4. One definition, so the fused
// kernels' matmul sums are qmm's to the bit where both take this body with
// the same plan. FORM is qmm_tc.cuh's: packed or int8 (qmm's rounding
// points, the bias as a side product) or int4 (qmm_i4's: the bias added to
// every weight inside tc_dequant, so no side product).
//
// Bound on the H100 at verify rows: the weight bytes (Q4_K packed with codes
// 4.75 bits per weight, Q4_0 6, Q8_0 9), as at one row. The SIMT body pays
// one f32 FMA per dequantized weight and row, so its 6-row time was 2.3-2.9x
// its 1-row time over the same bytes. Here every weight is dequantized once
// per call into a bf16 tile and `mma.sync.m16n8k16` (bf16 in, f32 sums)
// covers 16 rows per product, so the row count costs almost nothing: 2-8
// rows take 1.2-1.4x the SIMT body's 1-row time, 18-25 % of the byte bound
// (chip_smoke.py, H100 80GB HBM3 at 700 W). What holds it: a block-step
// (64 x 256 weights) takes ~1.9 us of SM time (wqkv at 6 rows: 768 blocks
// of 4 steps on 132 SMs in 43 us). Its phases (copies, dequant, products)
// are separated by the block's two barriers, so their latencies add up,
// and two blocks per SM (the 128-register cap of 256 threads) hide little
// of it. In development, three blocks per SM (80 registers, spills), a
// double-buffered B tile with one barrier per step (128 registers
// everywhere) and split accumulator chains were each slower; the bias side
// product on the tensor cores (below) was faster than FFMA per group.
// - A block takes 256 weight columns over one K split and all R <= 64 rows
//   (1-4 m16 tiles; rows past R read row R - 1 and are never stored). 256
//   threads (8 warps); warp w owns columns [32w, 32w + 32).
// - The raw weight tile of each 64-deep K step (q bytes, packed or int8
//   or int4 nibbles; the scale rows; sup for coded weights; the bias rows
//   and sup_min) goes
//   through a 3-stage ring in shared memory filled by 16-byte `cp.async`
//   from every thread (zero-filled past N), two steps in flight while the
//   third is used.
// - The 8 warps dequantize a step into one bf16 [64 x 256] B tile with
//   qmm_tc.cuh's tc_dequant (the same rounding points and layout: 64-column
//   atoms of 64 rows x 128 bytes, 16-byte units XOR-swizzled by the row), which
//   `ldmatrix.trans` reads as the B (.col) operand, as flash_attention.cu
//   reads V. The "kn" weight needs no re-layout.
// - x is staged once per block: the block's K range of every row, rounded to
//   bf16, swizzled for conflict-free `ldmatrix` (the A operand), and with a
//   bias (not int4) the f32 sum of each group of the unrounded x, rounded to
//   bf16.
// - int4 (qmm_i4): the bias rows go through the ring with the scale rows and
//   tc_dequant applies w = round(round(q * s) + b) per weight in bf16 pairs;
//   x needs no group sums and the step no fifth block. The SIMT body paid
//   an FMA per weight and row and two f32 roundings per weight, so 8 rows
//   cost it 2.4x one row over the same bytes.
// - qmm's bias side product round(xsum_g) * round(bias_g) runs on the
//   tensor cores as a fifth k16 block of each step: A holds the rows' group
//   sums of the step's groups (bf16, zero past them), B the groups' biases
//   (bf16, code * sup_min when coded, zero rows past them), so it costs 4
//   more products per m16 tile instead of an FFMA per group, row and column.
// - PAIRED (gate_up_act): the block's columns are 128 gate columns and the
//   128 matching up columns (offset F), written to [splits][2][R][F].
// - K splits (grid y) on step boundaries, on 256-row boundaries for coded
//   weights, fill the card; the reduce kernel (qmm) or the epilogue (ffn)
//   adds them in a fixed order (no atomics). ops/qmm.py:_mma_plan picks them
//   and computes the same shared-memory layout as mma_layout below.
// Needs K % 64 == 0, N % 16 == 0 (N % 256 paired), 1 <= R <= 64, G 16 or
// 32 for int4 and 16-byte aligned operands (checked by the wrappers).
#pragma once

#include "mma_sync.cuh"
#include "qmm_tc.cuh"

namespace {

constexpr int kMmaCols = kTcCols;  // weight columns per block: tc_dequant's tile
constexpr int kMmaK = kTcK;        // K per ring stage
constexpr int kMmaStages = 3;
constexpr int kMmaThreads = 256;
constexpr int kMmaMaxRows = 64;  // 4 m16 tiles

// Byte offsets within one ring stage, then after the ring the B tile, the
// side product's B tile (with a bias, not int4), the x tile and the group
// sums (the same); ops/qmm.py:_mma_layout computes the same.
struct MmaLayout {
  int q, scale, sup, bias, sup_min, stage, bslot, bside, x, xside, total;
};

constexpr int kMmaSideB = 16 * kMmaCols * 2;  // the side product's B tile: 16 x 256 bf16

// bytes of one row of the group sums in shared memory: 16 bf16 per step,
// rounded to whole 128-byte swizzle groups
__host__ __device__ inline int mma_side_row(int steps_per_split) {
  return tc_round_up(steps_per_split * 2, 8) * 16;
}

__host__ __device__ inline MmaLayout mma_layout(int R, int form, int G, int scale_bytes, int coded,
                                                 int bias_bytes, int steps_per_split) {
  MmaLayout l{};
  l.q = 0;
  l.scale = (form == kFormInt8 ? kMmaK : kMmaK / 2) * kMmaCols;
  l.sup = l.scale + (kMmaK / G) * kMmaCols * scale_bytes;
  l.bias = l.sup + (coded ? kMmaCols * 4 : 0);
  l.sup_min = l.bias + (kMmaK / G) * kMmaCols * bias_bytes;
  l.stage = tc_round_up(l.sup_min + (coded && bias_bytes ? kMmaCols * 4 : 0), 128);
  const bool side = bias_bytes && form != kFormInt4;  // the bias side product
  l.bslot = kMmaStages * l.stage;
  l.bside = l.bslot + kTcBSlot;
  l.x = l.bside + (side ? kMmaSideB : 0);
  l.xside = l.x + R * steps_per_split * kMmaK * 2;
  l.total = l.xside + (side ? R * mma_side_row(steps_per_split) : 0);
  return l;
}

struct MmaArgs {
  const void* x;  // [R, K] f32 or bf16
  const int8_t* q;
  const void* scale;
  const void* bias;
  const float* sup;
  const float* sup_min;
  float* dst;  // [splits][planes][R][N / planes]
  int R, K, N, scale_kind, bias_kind, steps_per_split;
  MmaLayout lay;
};

// rows [row0, row0 + rows) of a [*, N] array of EB-byte elements, at the
// block's two 128-column halves (weight columns wc0.., wc1..), into dense
// shared rows of 256 elements; chunks past N are zero-filled
template <int EB>
__device__ __forceinline__ void mma_copy_rows(uint32_t dst, const void* src, int rows, int row0,
                                              int N, int wc0, int wc1) {
  constexpr int kChunks = 8 * EB;  // 16-byte chunks per 128-column half row
  for (int i = threadIdx.x; i < rows * 2 * kChunks; i += kMmaThreads) {
    const int r = i / (2 * kChunks), h = (i / kChunks) & 1, ch = i % kChunks;
    const int col = (h ? wc1 : wc0) + ch * (16 / EB);
    const bool in = col < N;
    const char* s = static_cast<const char*>(src) + ((size_t)(row0 + r) * N + (in ? col : 0)) * EB;
    cp_async16(dst + (r * kMmaCols + h * 128) * EB + ch * 16, s, in);
  }
}

__device__ __forceinline__ void mma_copy_kind(uint32_t dst, const void* src, int rows, int row0,
                                              int N, int wc0, int wc1, int kind) {
  if (kind == kKindF32) {
    mma_copy_rows<4>(dst, src, rows, row0, N, wc0, wc1);
  } else if (kind == kKindBF16) {
    mma_copy_rows<2>(dst, src, rows, row0, N, wc0, wc1);
  } else {
    mma_copy_rows<1>(dst, src, rows, row0, N, wc0, wc1);
  }
}

// byte offset of 16-byte chunk c of x row r in shared memory: the low three
// bits of c XOR-ed with r, so ldmatrix's eight rows hit distinct banks
__device__ __forceinline__ int mma_x_at(int r, int c, int row_bytes) {
  return r * row_bytes + (((c & ~7) | ((c ^ r) & 7)) << 4);
}

// byte offset of (row k < 16, column col) in the side product's B tile:
// tc_b_at's layout (64-column atoms, 128-byte rows, 16-byte units XOR-ed
// with the row) with 16 rows per atom
__device__ __forceinline__ int mma_side_at(int k, int col) {
  return (col >> 6) * 2048 + k * 128 + (((((col >> 3) & 7) ^ (k & 7))) << 4) + (col & 7) * 2;
}

// grid (ceil(N / 256), splits); 256 threads; dynamic shared memory
// a.lay.total. Split y runs K steps [y * steps_per_split, ...). MT: m16
// tiles of accumulators (1: up to 16 rows, every verify; 4: up to 64, the
// tiles past R skipped).
template <int G, int FORM, bool PAIRED, typename XT, int MT>
__global__ void __launch_bounds__(kMmaThreads, 2) qmm_mma_kernel(const __grid_constant__ MmaArgs a) {
  constexpr int kQRows = FORM == kFormInt8 ? kMmaK : kMmaK / 2;  // q rows per step
  constexpr int kGroups = kMmaK / G;  // quant groups per step
  extern __shared__ __align__(16) uint8_t smem[];
  const MmaLayout& L = a.lay;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qr = lane >> 2, qc = lane & 3;  // fragment row (and +8), column pair
  const int s_begin = blockIdx.y * a.steps_per_split;
  const int n_steps = min(a.steps_per_split, a.K / kMmaK - s_begin);
  const int k_begin = s_begin * kMmaK;
  const int xs_row = a.steps_per_split * kMmaK * 2;  // bytes of one x row in shared memory
  const int xside_row = mma_side_row(a.steps_per_split);  // bytes of one row of group sums
  const int F = a.N / 2;
  const int wc0 = PAIRED ? blockIdx.x * 128 : blockIdx.x * kMmaCols;  // weight column of each half
  const int wc1 = PAIRED ? F + blockIdx.x * 128 : wc0 + 128;
  const bool coded = a.scale_kind == kKindCode;
  const bool has_bias = a.bias_kind != kKindNone;
  const bool side = has_bias && FORM != kFormInt4;  // the bias side product
  const uint32_t smem32 = smem_u32(smem);
  TcLayout tl{};  // where tc_dequant finds q, the scales, sup and (int4) the bias in a stage
  tl.q = L.q;
  tl.scale = L.scale;
  tl.sup = L.sup;
  tl.bias = L.bias;

  auto load_stage = [&](int t) {
    const uint32_t st = smem32 + (t % kMmaStages) * L.stage;
    const int k0 = (s_begin + t) * kMmaK;
    mma_copy_rows<1>(st + L.q, a.q, kQRows, k0 / (kMmaK / kQRows), a.N, wc0, wc1);
    mma_copy_kind(st + L.scale, a.scale, kGroups, k0 / G, a.N, wc0, wc1, a.scale_kind);
    if (coded) mma_copy_rows<4>(st + L.sup, a.sup, 1, k0 / 256, a.N, wc0, wc1);
    if (has_bias) {
      mma_copy_kind(st + L.bias, a.bias, kGroups, k0 / G, a.N, wc0, wc1, a.bias_kind);
      if (coded) mma_copy_rows<4>(st + L.sup_min, a.sup_min, 1, k0 / 256, a.N, wc0, wc1);
    }
  };

#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) {
    if (t < n_steps) load_stage(t);
    cp_async_commit();
  }

  // x of this split, while the first steps' weights are in flight; with the
  // side product, the group sums of step t at [16 t, 16 t + kGroups) of the
  // sums' row, zeros after, and the side product's B tile zeroed (rows past
  // kGroups stay zero)
  uint8_t* xs = smem + L.x;
  uint8_t* xside = smem + L.xside;
  uint8_t* bside = smem + L.bside;
  const XT* xg = static_cast<const XT*>(a.x);
  if (side) {
    for (int i = tid; i < kMmaSideB / 16; i += kMmaThreads)
      reinterpret_cast<uint4*>(bside)[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < a.R * n_steps * (16 - kGroups); i += kMmaThreads) {
      const int r = i / (n_steps * (16 - kGroups)), rest = i % (n_steps * (16 - kGroups));
      const int j = 16 * (rest / (16 - kGroups)) + kGroups + rest % (16 - kGroups);
      *reinterpret_cast<__nv_bfloat16*>(xside + mma_x_at(r, j >> 3, xside_row) + (j & 7) * 2) =
          __float2bfloat16_rn(0.f);
    }
  }
  const int q4 = n_steps * kMmaK / 4;  // 4-value pieces per row
  for (int base = 0; base < a.R * q4; base += kMmaThreads) {  // whole warps: shuffles below
    const int e = base + tid;
    const bool in = e < a.R * q4;
    const int r = in ? e / q4 : 0, p = in ? e - r * q4 : 0;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (in) {
      ldx4(xg + (size_t)r * a.K + k_begin + 4 * p, v);
      *reinterpret_cast<uint2*>(xs + mma_x_at(r, p >> 1, xs_row) + (p & 1) * 8) =
          make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    }
    if (side) {  // G / 4 adjacent lanes hold one group (q4 % 16 == 0)
      float s = (v[0] + v[1]) + (v[2] + v[3]);
#pragma unroll
      for (int off = 1; off < G / 4; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (in && p % (G / 4) == 0) {
        const int g = p / (G / 4);  // group within the split
        const int j = 16 * (g / kGroups) + g % kGroups;
        *reinterpret_cast<__nv_bfloat16*>(xside + mma_x_at(r, j >> 3, xside_row) + (j & 7) * 2) =
            __float2bfloat16_rn(s);
      }
    }
  }

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) acc[mt][nb][0] = acc[mt][nb][1] = acc[mt][nb][2] = acc[mt][nb][3] = 0.f;
  const int mts = (a.R + 15) / 16;
  uint8_t* bs = smem + L.bslot;
  const uint32_t xs32 = smem32 + L.x, xside32 = smem32 + L.xside, bside32 = smem32 + L.bside;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // step t landed; every warp is done with the B tile and step t - 1's slot
    if (t + kMmaStages - 1 < n_steps) load_stage(t + kMmaStages - 1);
    cp_async_commit();
    const uint8_t* st = smem + (t % kMmaStages) * L.stage;
    tc_dequant<G, FORM>(st, tl, bs, a.scale_kind, a.bias_kind, warp, lane);
    if (side) {  // this step's biases, rounded to bf16, as rows of the side tile
      for (int i = tid; i < kGroups * (kMmaCols / 2); i += kMmaThreads) {
        const int gl = i / (kMmaCols / 2), c = 2 * (i % (kMmaCols / 2));
        const int idx = gl * kMmaCols + c;
        float b0, b1;
        if (a.bias_kind == kKindF32) {
          const float2 f = *reinterpret_cast<const float2*>(st + L.bias + idx * 4);
          b0 = f.x;
          b1 = f.y;
        } else if (a.bias_kind == kKindBF16) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(st + L.bias + idx * 2);
          b0 = __low2float(h);
          b1 = __high2float(h);
        } else {
          const uint32_t cw = *reinterpret_cast<const uint16_t*>(st + L.bias + idx);
          const float2 sm = *reinterpret_cast<const float2*>(st + L.sup_min + c * 4);
          b0 = sm.x * s8_to_f(cw);
          b1 = sm.y * s8_to_f(cw >> 8);
        }
        *reinterpret_cast<uint32_t*>(bside + mma_side_at(gl, c)) = pack_bf16(b0, b1);
      }
    }
    __syncthreads();  // the B tiles are whole

#pragma unroll
    for (int kk = 0; kk < kMmaK / 16; ++kk) {
      uint32_t b[4][2];  // B fragments of this warp's four n8 blocks
      const int krow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        uint32_t r[4];
        ldmatrix_x4_trans(smem_u32(tc_b_at(bs, krow, 4 * warp + 2 * pair + (lane >> 4))), r);
        b[2 * pair][0] = r[0];
        b[2 * pair][1] = r[1];
        b[2 * pair + 1][0] = r[2];
        b[2 * pair + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mts) {
          const int row = min(mt * 16 + (lane & 15), a.R - 1);
          uint32_t af[4];
          ldmatrix_x4(xs32 + mma_x_at(row, t * 8 + kk * 2 + (lane >> 4), xs_row), af);
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) mma_bf16(acc[mt][nb], af, b[nb][0], b[nb][1]);
        }
      }
    }

    if (side) {  // the side product: group sums x biases, a fifth k16 block
      uint32_t b[4][2];
      const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        uint32_t r[4];
        ldmatrix_x4_trans(bside32 + mma_side_at(krow, 8 * (4 * warp + 2 * pair + (lane >> 4))), r);
        b[2 * pair][0] = r[0];
        b[2 * pair][1] = r[1];
        b[2 * pair + 1][0] = r[2];
        b[2 * pair + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mts) {
          const int row = min(mt * 16 + (lane & 15), a.R - 1);
          uint32_t af[4];
          ldmatrix_x4(xside32 + mma_x_at(row, 2 * t + (lane >> 4), xside_row), af);
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) mma_bf16(acc[mt][nb], af, b[nb][0], b[nb][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: rows 16 mt + lane / 4 (+ 8), columns 8 nb + 2 (lane % 4) + {0, 1}
  const int ncols = PAIRED ? F : a.N;  // columns of one output plane
  float* out = a.dst + (size_t)blockIdx.y * (PAIRED ? 2 : 1) * a.R * ncols;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int lc = 32 * warp + 8 * nb + 2 * qc;
    const int oc = PAIRED ? blockIdx.x * 128 + (lc & 127) : blockIdx.x * kMmaCols + lc;
    float* plane = out + (PAIRED ? (size_t)(lc >> 7) * a.R * ncols : 0);
    if (oc < ncols) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + qr;
        if (r < a.R)
          *reinterpret_cast<float2*>(plane + (size_t)r * ncols + oc) =
              make_float2(acc[mt][nb][0], acc[mt][nb][1]);
        if (r + 8 < a.R)
          *reinterpret_cast<float2*>(plane + (size_t)(r + 8) * ncols + oc) =
              make_float2(acc[mt][nb][2], acc[mt][nb][3]);
      }
    }
  }
}

template <int G, int FORM, bool PAIRED, typename XT, int MT>
cudaError_t mma_launch(const MmaArgs& a, int splits, int smem, cudaStream_t st) {
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(qmm_mma_kernel<G, FORM, PAIRED, XT, MT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kTcMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.N + kMmaCols - 1) / kMmaCols, splits);
  qmm_mma_kernel<G, FORM, PAIRED, XT, MT><<<grid, kMmaThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// G = 8 only for qmm's forms: int4 groups are 16 or 32 (mma_run refuses 8)
template <int FORM, bool PAIRED, typename XT, int MT>
cudaError_t mma_group(const MmaArgs& a, int G, int splits, int smem, cudaStream_t st) {
  if constexpr (FORM != kFormInt4) {
    if (G == 8) return mma_launch<8, FORM, PAIRED, XT, MT>(a, splits, smem, st);
  }
  if (G == 16) return mma_launch<16, FORM, PAIRED, XT, MT>(a, splits, smem, st);
  return mma_launch<32, FORM, PAIRED, XT, MT>(a, splits, smem, st);
}

// Fill in a.lay for the form and launch, with one m16 tile up to 16 rows
// and four above (MAX_ROWS: the most rows the caller sends, 8 for qmm and
// qmm_i4, 64 for the fused passes, so that qmm builds no 4-tile kernel).
// Refuses a shape the body does not take or a plan whose shared memory does
// not hold the layout.
template <int FORM, bool PAIRED, typename XT, int MAX_ROWS>
cudaError_t mma_run(MmaArgs a, int G, int splits, int smem, cudaStream_t st) {
  const int bias_bytes = a.bias_kind == kKindNone ? 0 : tc_kind_bytes(a.bias_kind);
  a.lay = mma_layout(a.R, FORM, G, tc_kind_bytes(a.scale_kind), a.scale_kind == kKindCode,
                     bias_bytes, a.steps_per_split);
  if (a.R < 1 || a.R > MAX_ROWS || a.K % kMmaK || a.N % (PAIRED ? 2 * 128 : 16) ||
      (G != 16 && G != 32 && (G != 8 || FORM == kFormInt4)) || smem < a.lay.total ||
      smem > kTcMaxSmem)
    return cudaErrorInvalidValue;
  if constexpr (MAX_ROWS > 16) {
    if (a.R > 16) return mma_group<FORM, PAIRED, XT, MAX_ROWS / 16>(a, G, splits, smem, st);
  }
  return mma_group<FORM, PAIRED, XT, 1>(a, G, splits, smem, st);
}

}  // namespace

// The 1-row tensor-core body (qmm_gemv_kernel): qmm's route for one row in
// bf16 (decode; csrc/qmm.cu) and the matmul pass of both fused FFN kernels
// at one bf16 row (csrc/ffn_tensor_core.cu), as qmm_mma.cuh is the 2-64-row body of
// all three. One definition, so the fused kernels' sums (x of ffn_out_norm,
// g and u of gate_up_act) are qmm's to the bit where both take this body
// with the same plan (ops/qmm.py:_gemv_plan).
//
// Bound on the H100 by the weight bytes (Q4_K packed with codes: 4.75 bits
// per weight, 1.17 ms per Vicuna-7B token at 3.35 TB/s). The SIMT body
// (qmm_body.cuh) reached 23-36 % of that bound at one row: a warp issued one
// quant group's 4-byte loads, waited, computed, and only then loaded the
// next group; every lane re-read and re-rounded x; and each weight cost
// ~4.5 issue slots. Here the copies run ahead of the math, and the math is
// what sets the pace (cut-down builds on an H100 80GB HBM3: the copies
// alone take about half the time of the whole body at wqkv; PERF.md, PR 9):
// - A block takes 256 weight columns over one K split; 256 threads (8
//   warps), warp w owns columns [32w, 32w + 32) over the whole split, so no
//   reduction across warps. Three blocks share an SM (80 registers).
// - The raw weight tile of each 64-deep K step (q bytes, packed or int8;
//   the scale rows; sup for coded weights; the bias rows and sup_min) goes
//   through a 3-stage ring in shared memory (2 where 3 do not fit), filled
//   by 16-byte `cp.async` from every thread (zero-filled past N) with
//   addresses worked out once, two steps in flight while one is read (more
//   stages ran slower). One barrier per step releases the stage (no B
//   tile). The q rows' 16-byte units are XOR-ed by the row block a lane
//   quad reads, so a warp's 4-byte reads hit 32 distinct banks.
// - x is staged once per block: the split's K range as bf16 pairs in the
//   order the products take them, and with a bias the f32 sum of each group
//   of the unrounded x, rounded to bf16 (tc_x_prologue's rounding points).
// - The products run on the tensor cores with the weights as the A operand
//   of `mma.sync.m16n8k16` (16 columns x 16 K values) and x as B (all 8 B
//   columns carry x, one is read). A weight costs one AND-OR into a
//   magic-number float (field_f), one FFMA (w = round_bf16(q * s), the
//   reference's rounding point) and half a bf16 pair conversion; no unpack,
//   no FMA into a sum. A lane's 4-byte read holds 4 adjacent columns; A row
//   m of the first product is the lane's column 0 (m < 8) or 1, of the
//   second 2 or 3. A k pair of A is one "unit": a packed row (its lo and
//   hi nibbles, K j and j + G/2) or two int8 rows 4 apart; lane qd of a
//   quad takes the 8 units of one or two quant groups, so it derives one
//   or two groups' scales per step.
// - The bias side product round(xsum_g) * round(bias_g) is an FFMA per
//   group and column on the lane that holds the group first, summed over
//   the quad by two shuffles at the end (in a fixed order).
// - PAIRED (gate_up_act): tile columns [0, 128) are 128 gate columns of
//   the fused [K, 2F] weight and [128, 256) the matching up columns (offset
//   F), so warps 0-3 sum the gate half and warps 4-7 the up half; only the
//   copies' source columns change. A column keeps its lane and A row (both
//   halves are whole warps), its K order and its splits, so g and u are
//   qmm's sums over the same weight to the bit, and the block writes them
//   to [splits][2][F], which is [splits][2F] at the weight's own columns.
// - K splits (grid y) on step boundaries, on 256-row boundaries for coded
//   weights (ops/qmm.py:_gemv_plan); the reduce kernel (qmm) or the
//   epilogue (ffn) adds them in split order.
// Needs one row, K % 64 == 0, N % 16 == 0 (N % 256 paired) and 16-byte
// aligned operands (checked by the wrappers).
#pragma once

#include "mma_sync.cuh"
#include "qmm_tc.cuh"

namespace {

constexpr int kGemvCols = 256;  // weight columns per block
constexpr int kGemvThreads = 256;
constexpr int kGemvMaxStages = 3;
constexpr int kGemvUnits = kTcK / 2;  // k pairs per step

// Byte offsets within one ring stage (the q rows, then the scale rows,
// sup, the bias rows and sup_min, each 256 columns wide), the
// stage size, and after the ring the split's x pairs (one u32 per unit)
// and, with a bias, its group sums (f32). ops/qmm.py:_gemv_layout
// computes the same.
struct GemvLayout {
  int scale, sup, bias, sup_min, stage, x, xsum, total;
};

__host__ __device__ inline GemvLayout gemv_layout(int form, int G, int scale_bytes, int coded,
                                                   int bias_bytes, int stages,
                                                   int steps_per_split) {
  GemvLayout l{};
  l.scale = (form == kFormInt8 ? kTcK : kTcK / 2) * kGemvCols;
  l.sup = l.scale + (kTcK / G) * kGemvCols * scale_bytes;
  l.bias = l.sup + (coded ? kGemvCols * 4 : 0);
  l.sup_min = l.bias + (kTcK / G) * kGemvCols * bias_bytes;
  l.stage = tc_round_up(l.sup_min + (coded && bias_bytes ? kGemvCols * 4 : 0), 128);
  l.x = stages * l.stage;
  l.xsum = l.x + steps_per_split * kGemvUnits * 4;
  l.total = l.xsum + (bias_bytes ? steps_per_split * (kTcK / G) * 4 : 0);
  return l;
}

struct GemvArgs {
  const void* x;  // [K] f32 or bf16 (XT): the one row
  const int8_t* q;
  const void* scale;
  const void* bias;
  const float* sup;
  const float* sup_min;
  float* dst;  // [splits][N] ([splits][2][N / 2] paired)
  int K, N, scale_kind, bias_kind, stages, steps_per_split;
  // 2^23, 2^19, 2^15, 2^11 as f32 bits, from the host, so that they sit in
  // registers and each field takes one AND-OR (field_f)
  uint32_t m23, m19, m15, m11;
  GemvLayout lay;
};

// The field of w under `mask`, whose lowest bit is bit b (b + width <= 23),
// OR-ed into magic = 2^(23 - b) as f32 bits: the exact f32 2^(23 - b) +
// field, in one AND-OR (LOP3) with the magic in a register. A byte permute
// per weight, as the other bodies use, made the dequant slower on an H100.
__device__ __forceinline__ float field_f(uint32_t w, uint32_t mask, uint32_t magic) {
  return __uint_as_float((w & mask) | magic);
}

// byte offset of column byte `col` (a multiple of 4) of q row r in a stage:
// 256-byte rows, the 16-byte units XOR-ed with 2 ((r >> SH) & 3), SH = 3
// (packed) or 4 (int8): the row block a lane quad reads
template <int SH>
__device__ __forceinline__ int gemv_q_at(int r, int col) {
  return r * kGemvCols + ((((col >> 4) ^ (((r >> SH) & 3) << 1))) << 4) + (col & 15);
}

// four adjacent per-group values (element index idx, a multiple of 4) of
// kind f32, bf16 or int8 codes, from a shared-memory row
__device__ __forceinline__ void gemv_smem4(const uint8_t* p, int kind, int idx, float (&o)[4]) {
  if (kind == kKindF32) {
    const float4 v = *reinterpret_cast<const float4*>(p + idx * 4);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if (kind == kKindBF16) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + idx * 2);
    o[0] = __uint_as_float(v.x << 16); o[1] = __uint_as_float(v.x & 0xFFFF0000u);
    o[2] = __uint_as_float(v.y << 16); o[3] = __uint_as_float(v.y & 0xFFFF0000u);
  } else {  // (2^23 + 128 + code) - (2^23 + 128), (2^15 + 128 + code) - (2^15 + 128): exact
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p + idx) ^ 0x80808080u, h = w >> 16;
    o[0] = __uint_as_float((w & 0xFFu) | 0x4B000000u) - 8388736.f;
    o[1] = __uint_as_float((w & 0xFF00u) | 0x47000000u) - 32896.f;
    o[2] = __uint_as_float((h & 0xFFu) | 0x4B000000u) - 8388736.f;
    o[3] = __uint_as_float((h & 0xFF00u) | 0x47000000u) - 32896.f;
  }
}

// the first of the two int8 rows of unit v of a step (the other is 4 on):
// units 8j .. 8j + 7 cover rows 16j .. 16j + 15, units 8j + 0..3 the first 8
__device__ __forceinline__ int gemv_int8_row(int v) {
  return 16 * (v >> 3) + (v & 4) * 2 + (v & 3);
}

// Lane qd of a quad takes units 8 qd .. 8 qd + 7 of a step (rows of one or
// two quant groups); product pair i takes its units 8 qd + i (k slots 2qd,
// 2qd + 1) and 8 qd + 4 + i (2qd + 8, 2qd + 9). Unit v's x pair sits at
// 8i + 2qd + {0, 1} of the step's 32, so a lane reads a product pair's two
// in one 8-byte load.
__device__ __forceinline__ int gemv_x_slot(int v) {
  return 8 * (v & 3) + 2 * (v >> 3) + ((v >> 2) & 1);
}

// The scales (code * sup when coded) of one group at a lane's 4 columns and,
// for packed weights, the FFMA addends -2^(23 - b) s of the nibble fields
// the dequant reads: lo nibbles of columns 0 and 2 at b = 0, their hi
// nibbles at b = 4, columns 1 and 3 at b = 8 and 12 (of each 16-bit half).
struct GemvScales {
  float s[4], lo[4], hi[4];
};

// grid (ceil(N / 256), splits); 256 threads; dynamic shared memory
// a.lay.total. Split y runs K steps [y * steps_per_split, ...). XT: x's
// type (bf16 for the gate/up pass, whose h is in the compute dtype).
template <int G, bool PACKED, bool PAIRED, typename XT>
__global__ void __launch_bounds__(kGemvThreads, 3) qmm_gemv_kernel(const __grid_constant__ GemvArgs a) {
  constexpr int kGroups = kTcK / G;  // quant groups per step
  constexpr int kQRows = PACKED ? kTcK / 2 : kTcK;
  constexpr int kQChunks = kQRows * 16 / kGemvThreads;  // 16-byte q copies per thread and step
  extern __shared__ __align__(16) uint8_t smem[];
  const GemvLayout& L = a.lay;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qd = lane & 3;                     // k slot pair of the fragments
  const int cl = warp * 32 + 4 * (lane >> 2);  // this lane's 4 columns in the tile
  const int S = a.stages;
  const int s_begin = blockIdx.y * a.steps_per_split;
  const int n_steps = min(a.steps_per_split, a.K / kTcK - s_begin);
  const int k_begin = s_begin * kTcK;
  // the weight columns of the tile's two 128-column halves (gate and up
  // when paired); tile column c is weight column wcol(c)
  const int wc0 = PAIRED ? blockIdx.x * 128 : blockIdx.x * kGemvCols;
  const int wc1 = PAIRED ? a.N / 2 + blockIdx.x * 128 : wc0 + 128;
  auto wcol = [&](int c) { return c < 128 ? wc0 + c : wc1 + (c - 128); };
  const bool coded = a.scale_kind == kKindCode;
  const bool has_bias = a.bias_kind != kKindNone;
  const uint32_t smem32 = smem_u32(smem);
  const uint32_t m23 = a.m23, m19 = a.m19, m15 = a.m15, m11 = a.m11;

  // The ring: every thread copies 16-byte pieces of each step, zero-filled
  // past N, with addresses worked out once: its q pieces are rows
  // tid / 16 + 16 j of the step at bytes 16 (tid % 16) of the tile, so a
  // running pointer advances by the step's rows; the other rows (scale,
  // sup, bias, sup_min: `n_aux` pieces) are shared out over the threads,
  // piece tid with a running pointer too (scale and bias rows advance every
  // step, a sup row every 4 steps: coded splits start on 256-row
  // boundaries), further pieces (G = 8, f32 rows) worked out per step.
  constexpr int kSh = PACKED ? 3 : 4;  // row block of a lane: 8 packed or 16 int8 rows
  const int qc = (tid & 15) * 16;
  const bool q_in = wcol(qc) < a.N;
  const int8_t* q_next =
      a.q + (size_t)((PACKED ? k_begin / 2 : k_begin) + (tid >> 4)) * a.N + (q_in ? wcol(qc) : 0);
  uint32_t q_dst[kQChunks];
#pragma unroll
  for (int j = 0; j < kQChunks; ++j) q_dst[j] = gemv_q_at<kSh>((tid >> 4) + 16 * j, qc);
  const int lg_s = a.scale_kind == kKindF32 ? 2 : a.scale_kind == kKindBF16 ? 1 : 0;
  const int lg_b = a.bias_kind == kKindF32 ? 2 : a.bias_kind == kKindBF16 ? 1 : 0;
  const int n_scale = kGroups * (16 << lg_s);  // 16-byte pieces of the scale rows
  const int n_sup = n_scale + (coded ? 64 : 0);
  const int n_bias = n_sup + (has_bias ? kGroups * (16 << lg_b) : 0);
  const int n_aux = n_bias + (coded && has_bias ? 64 : 0);
  // piece c of step t: its source, stage offset and whether it is inside N
  auto aux_piece = [&](int c, int t, const char*& src, uint32_t& dst, bool& in, int& every) {
    const int k0 = k_begin + t * kTcK;
    int row, rel, lg;
    if (c < n_scale) {
      src = static_cast<const char*>(a.scale); row = k0 / G; rel = c; lg = lg_s; dst = L.scale;
      every = 1;
    } else if (c < n_sup) {
      src = reinterpret_cast<const char*>(a.sup); row = k0 >> 8; rel = c - n_scale; lg = 2;
      dst = L.sup; every = 4;
    } else if (c < n_bias) {
      src = static_cast<const char*>(a.bias); row = k0 / G; rel = c - n_sup; lg = lg_b;
      dst = L.bias; every = 1;
    } else {
      src = reinterpret_cast<const char*>(a.sup_min); row = k0 >> 8; rel = c - n_bias; lg = 2;
      dst = L.sup_min; every = 4;
    }
    // piece rel: row rel / (16 << lg) of the array's step rows, columns
    // 16 / 2^lg at a time
    const int col = (rel & ((16 << lg) - 1)) << (4 - lg);  // a piece never straddles a half
    in = wcol(col) < a.N;
    src += ((size_t)(row + (rel >> (4 + lg))) * a.N + (in ? wcol(col) : 0)) << lg;
    dst += rel * 16;
  };
  const char* aux_next = nullptr;
  uint32_t aux_dst = 0;
  bool aux_in = false;
  int aux_every = 1;
  size_t aux_adv = 0;  // bytes the piece's source advances per step (or per 4 steps)
  if (tid < n_aux) {
    aux_piece(tid, 0, aux_next, aux_dst, aux_in, aux_every);
    const int lg = tid < n_scale ? lg_s : tid < n_sup ? 2 : tid < n_bias ? lg_b : 2;
    aux_adv = (size_t)(aux_every == 1 ? kGroups : 1) * a.N << lg;
  }
  auto issue = [&](int t, uint32_t base) {  // step t into the stage at `base`; t = 0, 1, ...
#pragma unroll
    for (int j = 0; j < kQChunks; ++j)
      cp_async16(base + q_dst[j], q_next + (size_t)j * 16 * a.N, q_in);
    q_next += (size_t)kQRows * a.N;
    if (tid < n_aux) {
      cp_async16(base + aux_dst, aux_next, aux_in);
      if (aux_every == 1 || (t & 3) == 3) aux_next += aux_adv;
    }
    for (int c = tid + kGemvThreads; c < n_aux; c += kGemvThreads) {
      const char* src;
      uint32_t dst;
      bool in;
      int every;
      aux_piece(c, t, src, dst, in, every);
      cp_async16(base + dst, src, in);
    }
  };

  for (int t = 0; t < S - 1; ++t) {
    if (t < n_steps) issue(t, smem32 + t * L.stage);
    cp_async_commit();
  }

  // x of this split as bf16 pairs, unit by unit, while the first steps'
  // weights are in flight; with a bias, the group sums
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + L.x);
  float* xsum = reinterpret_cast<float*>(smem + L.xsum);
  const XT* xg = static_cast<const XT*>(a.x) + k_begin;
  for (int u = tid; u < n_steps * kGemvUnits; u += kGemvThreads) {
    const int v = u % kGemvUnits;
    int ka, kb;
    if constexpr (PACKED) {  // packed row v: K (v / (G/2)) G + v % (G/2) and G/2 on
      ka = (v / (G / 2)) * G + v % (G / 2);
      kb = ka + G / 2;
    } else {
      ka = gemv_int8_row(v);
      kb = ka + 4;
    }
    const XT* xt = xg + (u / kGemvUnits) * kTcK;
    xs[u - v + gemv_x_slot(v)] = pack_bf16(ldx(xt + ka), ldx(xt + kb));
  }
  if (has_bias) {
    for (int gi = tid; gi < n_steps * kGroups; gi += kGemvThreads) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < G / 4; ++i) {
        float v[4];
        ldx4(xg + gi * G + 4 * i, v);
        s += (v[0] + v[1]) + (v[2] + v[3]);
      }
      xsum[gi] = __bfloat162float(__float2bfloat16_rn(s));
    }
  }

  float acc[2][4];  // product 0: columns cl, cl + 1; product 1: cl + 2, cl + 3
#pragma unroll
  for (int p = 0; p < 2; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;
  float bacc[4] = {0.f, 0.f, 0.f, 0.f};  // this lane's share of the side product

  int slot = 0, fill = S - 1;  // the stages of steps t and t + S - 1
  for (int t = 0; t < n_steps; ++t) {
    if (S == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step t landed; every warp is done with step t - 1's stage
    if (t + S - 1 < n_steps) issue(t + S - 1, smem32 + fill * L.stage);
    cp_async_commit();
    const uint8_t* st = smem + slot * L.stage;
    const uint32_t* xt = xs + t * kGemvUnits;
    slot = slot + 1 == S ? 0 : slot + 1;
    fill = fill + 1 == S ? 0 : fill + 1;

    // this step's q words: units 8 qd + i and 8 qd + 4 + i (packed: one row
    // each; int8: two rows each, 4 apart), the lane's 4 columns
    uint32_t qw[PACKED ? 8 : 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (PACKED) {
        qw[2 * i] = *reinterpret_cast<const uint32_t*>(st + gemv_q_at<kSh>(8 * qd + i, cl));
        qw[2 * i + 1] = *reinterpret_cast<const uint32_t*>(st + gemv_q_at<kSh>(8 * qd + 4 + i, cl));
      } else {
        const int r0 = 16 * qd + i, r1 = r0 + 8;
        qw[4 * i] = *reinterpret_cast<const uint32_t*>(st + gemv_q_at<kSh>(r0, cl));
        qw[4 * i + 1] = *reinterpret_cast<const uint32_t*>(st + gemv_q_at<kSh>(r0 + 4, cl));
        qw[4 * i + 2] = *reinterpret_cast<const uint32_t*>(st + gemv_q_at<kSh>(r1, cl));
        qw[4 * i + 3] = *reinterpret_cast<const uint32_t*>(st + gemv_q_at<kSh>(r1 + 4, cl));
      }
    }

    auto scales = [&](int gl, GemvScales& g) {
      gemv_smem4(st + L.scale, a.scale_kind, gl * kGemvCols + cl, g.s);
      if (coded) {
        const float4 sp = *reinterpret_cast<const float4*>(st + L.sup + cl * 4);
        g.s[0] = sp.x * g.s[0]; g.s[1] = sp.y * g.s[1]; g.s[2] = sp.z * g.s[2]; g.s[3] = sp.w * g.s[3];
      }
      if constexpr (PACKED) {
        g.lo[0] = -8388608.f * g.s[0]; g.hi[0] = -524288.f * g.s[0];  // 2^23, 2^19
        g.lo[1] = -32768.f * g.s[1]; g.hi[1] = -2048.f * g.s[1];      // 2^15, 2^11
        g.lo[2] = -8388608.f * g.s[2]; g.hi[2] = -524288.f * g.s[2];
        g.lo[3] = -32768.f * g.s[3]; g.hi[3] = -2048.f * g.s[3];
      }
    };
    // the groups of the lane's units: one (G 16, 32) or two (G 8: the first
    // four units and the last four)
    GemvScales ga_s, gb_s;
    scales(qd * 16 / G, ga_s);
    if constexpr (G == 8) scales(2 * qd + 1, gb_s);
    const GemvScales& s1 = G == 8 ? gb_s : ga_s;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t p0[4], p1[4];  // bf16 k pairs of units 8 qd + i, 8 qd + 4 + i at the 4 columns
      if constexpr (PACKED) {
        // w = round_bf16(n * s) by fma(2^(23-b) + n, s, -2^(23-b) s): exact n * s, rounded once
        auto deq = [&](uint32_t w, const GemvScales& g, uint32_t (&o)[4]) {
          const uint32_t h = w >> 16;
          o[0] = pack_bf16(fmaf(field_f(w, 0xFu, m23), g.s[0], g.lo[0]),
                           fmaf(field_f(w, 0xF0u, m19), g.s[0], g.hi[0]));
          o[1] = pack_bf16(fmaf(field_f(w, 0xF00u, m15), g.s[1], g.lo[1]),
                           fmaf(field_f(w, 0xF000u, m11), g.s[1], g.hi[1]));
          o[2] = pack_bf16(fmaf(field_f(h, 0xFu, m23), g.s[2], g.lo[2]),
                           fmaf(field_f(h, 0xF0u, m19), g.s[2], g.hi[2]));
          o[3] = pack_bf16(fmaf(field_f(h, 0xF00u, m15), g.s[3], g.lo[3]),
                           fmaf(field_f(h, 0xF000u, m11), g.s[3], g.hi[3]));
        };
        deq(qw[2 * i], ga_s, p0);
        deq(qw[2 * i + 1], s1, p1);
      } else {
        // w = round_bf16(q * s): (2^(23-b) + 128 + q) - (2^(23-b) + 128) is exact
        auto deq = [&](uint32_t wa, uint32_t wb, const float (&s)[4], uint32_t (&o)[4]) {
          wa ^= 0x80808080u;
          wb ^= 0x80808080u;
          const uint32_t ha = wa >> 16, hb = wb >> 16;
          o[0] = pack_bf16((field_f(wa, 0xFFu, m23) - 8388736.f) * s[0],
                           (field_f(wb, 0xFFu, m23) - 8388736.f) * s[0]);
          o[1] = pack_bf16((field_f(wa, 0xFF00u, m15) - 32896.f) * s[1],
                           (field_f(wb, 0xFF00u, m15) - 32896.f) * s[1]);
          o[2] = pack_bf16((field_f(ha, 0xFFu, m23) - 8388736.f) * s[2],
                           (field_f(hb, 0xFFu, m23) - 8388736.f) * s[2]);
          o[3] = pack_bf16((field_f(ha, 0xFF00u, m15) - 32896.f) * s[3],
                           (field_f(hb, 0xFF00u, m15) - 32896.f) * s[3]);
        };
        deq(qw[4 * i], qw[4 * i + 1], ga_s.s, p0);
        deq(qw[4 * i + 2], qw[4 * i + 3], s1.s, p1);
      }
      // A rows g (m < 8) and g + 8 are the lane's columns 0 and 1 (product 0)
      // or 2 and 3 (product 1); B is x at the same k slots
      const uint2 xv = *reinterpret_cast<const uint2*>(xt + 8 * i + 2 * qd);
      const uint32_t f0[4] = {p0[0], p0[1], p1[0], p1[1]};
      const uint32_t f1[4] = {p0[2], p0[3], p1[2], p1[3]};
      mma_bf16(acc[0], f0, xv.x, xv.y);
      mma_bf16(acc[1], f1, xv.x, xv.y);
    }

    if (has_bias) {  // the lane's groups, each added by the first lane that holds it
      const float* xst = xsum + t * kGroups;
#pragma unroll
      for (int h = 0; h < (G == 8 ? 2 : 1); ++h) {
        const int gl = G == 8 ? 2 * qd + h : qd * 16 / G;
        if (G == 32 && (qd & 1)) continue;
        float b[4];
        gemv_smem4(st + L.bias, a.bias_kind, gl * kGemvCols + cl, b);
        if (a.bias_kind == kKindCode) {
          const float4 sm = *reinterpret_cast<const float4*>(st + L.sup_min + cl * 4);
          b[0] = sm.x * b[0]; b[1] = sm.y * b[1]; b[2] = sm.z * b[2]; b[3] = sm.w * b[3];
        }
        const uint32_t r01 = pack_bf16(b[0], b[1]), r23 = pack_bf16(b[2], b[3]);
        const float xv = xst[gl];
        bacc[0] = fmaf(xv, __uint_as_float(r01 << 16), bacc[0]);
        bacc[1] = fmaf(xv, __uint_as_float(r01 & 0xFFFF0000u), bacc[1]);
        bacc[2] = fmaf(xv, __uint_as_float(r23 << 16), bacc[2]);
        bacc[3] = fmaf(xv, __uint_as_float(r23 & 0xFFFF0000u), bacc[3]);
      }
    }
  }
  cp_async_wait<0>();

  // every B column is x, so each lane of a quad holds the quad's products
  // (C row g, any column); the side product is summed over the quad
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    bacc[c] += __shfl_xor_sync(0xffffffffu, bacc[c], 1);
    bacc[c] += __shfl_xor_sync(0xffffffffu, bacc[c], 2);
  }
  const int col = wcol(cl);  // 4 columns, never straddling a half
  if (qd == 0 && col < a.N)
    *reinterpret_cast<float4*>(a.dst + (size_t)blockIdx.y * a.N + col) =
        make_float4(acc[0][0] + bacc[0], acc[0][2] + bacc[1], acc[1][0] + bacc[2],
                    acc[1][2] + bacc[3]);
}

template <int G, bool PACKED, bool PAIRED, typename XT>
cudaError_t gemv_launch(const GemvArgs& a, int splits, int smem, cudaStream_t st) {
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(qmm_gemv_kernel<G, PACKED, PAIRED, XT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTcMaxSmem);
    if (e == cudaSuccess)  // three blocks of up to 75 KB on one SM
      e = cudaFuncSetAttribute(qmm_gemv_kernel<G, PACKED, PAIRED, XT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.N + kGemvCols - 1) / kGemvCols, splits);
  qmm_gemv_kernel<G, PACKED, PAIRED, XT><<<grid, kGemvThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// Fill in a.lay for the form and launch (PAIRED: the gate/up pass over a
// fused [K, 2F] weight, N = 2F). Refuses a shape the body does not take or
// a plan whose shared memory does not hold the layout.
template <bool PAIRED, typename XT>
cudaError_t gemv_run(GemvArgs a, int G, int packed, int splits, int smem, cudaStream_t st) {
  const int bias_bytes = a.bias_kind == kKindNone ? 0 : tc_kind_bytes(a.bias_kind);
  a.lay = gemv_layout(packed ? kFormPacked : kFormInt8, G, tc_kind_bytes(a.scale_kind),
                      a.scale_kind == kKindCode, bias_bytes, a.stages, a.steps_per_split);
  a.m23 = 0x4B000000u;
  a.m19 = 0x49000000u;
  a.m15 = 0x47000000u;
  a.m11 = 0x45000000u;
  if (a.K % kTcK || a.N % (PAIRED ? 256 : 16) || (G != 8 && G != 16 && G != 32) ||
      a.stages < 2 || a.stages > kGemvMaxStages || splits < 1 || smem < a.lay.total ||
      smem > kTcMaxSmem)
    return cudaErrorInvalidValue;
  if (G == 8)
    return packed ? gemv_launch<8, true, PAIRED, XT>(a, splits, smem, st)
                  : gemv_launch<8, false, PAIRED, XT>(a, splits, smem, st);
  if (G == 16)
    return packed ? gemv_launch<16, true, PAIRED, XT>(a, splits, smem, st)
                  : gemv_launch<16, false, PAIRED, XT>(a, splits, smem, st);
  return packed ? gemv_launch<32, true, PAIRED, XT>(a, splits, smem, st)
                : gemv_launch<32, false, PAIRED, XT>(a, splits, smem, st);
}

}  // namespace

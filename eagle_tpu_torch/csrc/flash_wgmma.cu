// The wgmma body of both flash kernels for a bf16 cache at head width 256
// (Gemma's), on Hopper's warpgroup MMA, templated on where the mask comes
// from:
//   MASK = false: flash_prefill, replacing eagle_tpu/ops/pallas_attention.py:
//     _flash_prefill_kernel (via flash_attention_prefill) at that width: the
//     mask is tag >= 0 && tag <= q_pos, rebuilt from the slot tags;
//   MASK = true: flash_decode at 64 query rows per kv head and more (T*g >=
//     64: the EAGLE engine's prompt, Gemma-2B's tree verifies), replacing
//     pallas_attention.py:_flash_kernel (via flash_attention_cached): a bool
//     mask [B, T, s_limit] computed outside, row r = t*g + i reading row t.
// The semantics are flash_attention.cu's header: q rounded to bf16; f32
// scores times the scale, in the log2 domain; a masked score and the initial
// m are -1e30 * log2(e), so a row that sees no key comes out as the uniform
// average of V over [0, s_limit); l sums the unrounded p, p is rounded to
// bf16 for PV, the denominator is clamped at 1e-20; only [0, s_limit) is
// read; the output is f32 [B, T, H, D]. ops/flash_attention.py:_plan sends
// it every bf16 flash_prefill call at D = 256 and every bf16 flash_decode
// call at D = 256 with T*g >= 64 (flash_attention.cu takes fewer rows).
//
// Bound on the H100, at Gemma-7B's 512-row prompt (16 / 16 heads, 300 slots
// seen): bytes, 6.5 us at 3.35 TB/s (flash_decode: 7.6 us, its mask read
// once), 16.8 MB of it the f32 q read and the f32 output written; the two
// products over the seen (query, key) pairs take 2.3 GFLOP, 2.3 us at 989
// TFLOP/s. What it does about that:
// - One wave, no key-split round trip. A block is 64 query rows of one kv
//   head (one consumer warpgroup) and one producer warp: 16 heads x 8 row
//   blocks = 128 blocks at Gemma-7B's prompt, 8 x 16 at 16 / 8 heads, 64
//   at 8 / 1, each alone on an SM. The plan splits the keys only where the
//   row blocks leave most of the 132 SMs idle and a block's key tiles
//   outnumber the blocks (long contexts, short feeds; the combine kernel
//   then merges the splits); the blocks of the latest query positions,
//   which see the most keys, start first (blockIdx.y reversed).
// - Key tiles that no row of the block sees are not read. In a prologue the
//   producer warp decides, for each 64-key tile of its split, whether some
//   real row of the block (r < T*g) sees a key in it, and whether every real
//   row sees some key of [0, s_limit); one skip bit a tile, in shared
//   memory. A tile is skipped iff no real row sees a key in it and every
//   real row sees some key. Rule B (flash_prefill) reads this from the tags
//   in one pass over [0, s_limit): the least and the greatest q_pos of the
//   real rows, each tile's least non-negative tag (seen by some row iff it
//   is <= the greatest q_pos) and the least of the whole range (every row
//   sees some key iff the least q_pos is >= 0 and >= it). Rule M
//   (flash_decode) reads the mask rows of the block's real t rows over
//   [0, s_limit) (64 x 512 bytes at the EAGLE prompt, against 64 KB a K/V
//   tile), 16 bytes a load where the rows allow it. Both read values,
//   never slot order, so shifted, rolled-back and chat-fed caches, tree
//   masks and any mask given are skipped exactly. Exact, because: a row
//   that sees some key gets p = 0 from every key of a tile it does not see
//   once its m is a real score, and before that (m still -1e30 * log2(e))
//   whatever l and acc gathered is wiped by alpha = exp2(-1e30 * log2(e) -
//   m) = 0 at its first seen key; a split it sees nothing of ends with m at
//   that floor and weighs 0 in the combine. So the output values equal
//   those of reading every tile. A block with a row that sees no key reads
//   every tile: that row is the average of all of them.
//   ops/flash_attention.py:tile_reads and tile_reads_mask mirror the rules.
// - The products run on wgmma fed by TMA. The block's 64 q rows are
//   rounded to bf16 once by the consumer threads (every load in flight
//   before the first store) and stored, 128-byte swizzled, as four
//   [64 x 64] boxes: S = Q K^T is 16 wgmma.m64n64k16 over D with A and B
//   from shared memory (both K-major), so no q fragment is reloaded per
//   step, and S stays in registers (32 f32 a thread). The online softmax
//   runs on them with quad shuffles; P is packed into register A fragments
//   (the accumulator's layout is the A operand's), and O += P V is 4
//   wgmma.m64n256k16 per tile with V read MN-major from shared memory (the
//   transpose bit); O lives in registers (128 f32 a thread). Tile n's
//   QK^T and softmax run while tile n - 1's PV is in flight (wgmma groups
//   retire in order), so the softmax's exp2 and the tensor cores overlap.
// - The ring: K and V (64 keys each) a stage, filled by the producer warp
//   as the consumers free them (full / empty mbarriers). For a tile it
//   reads, eight lanes issue one TMA box each (4 of K, 4 of V, 64 features
//   wide: the 128-byte swizzle's width) from 4-D tensor maps (D, slots, kv
//   heads, batch) over the cache's own strides, so row views (batch_stride)
//   are read in place; the slot extent is s_limit, so TMA fills zeros past
//   it. Beside K comes what the softmax masks with: flash_prefill's 64 tags
//   (every lane copies two with cp.async, whose completion arrives on the
//   same barrier); flash_decode's mask tile, 64 keys x the block's t rows
//   (63 / g + 1 of them, at most 64) as bytes, by a ninth TMA box from a
//   3-D map (s_limit, T, B) where the rows are 16-byte aligned (s_limit %
//   16 == 0), by the producer lanes' own loads otherwise (zeros past the
//   split's end and past T). Keys at or past the split's end are masked by
//   index (p = 0). The maps are built per call on the host and passed as
//   __grid_constant__ parameters, so a captured launch holds them.
// - Shared memory: q 32 KB; flash_prefill 3 stages of 64 KB + their tags,
//   flash_decode 2 stages of 64 KB + their 4 KB mask tiles (a third stage
//   and its mask tile would pass one block's 227 KB); flags, skip bits,
//   barriers and 1 KB of alignment slack: 232,256 and 174,128 bytes
//   (ops/flash_attention.py:_plan computes the same; a disagreeing plan is
//   refused). One block an SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kD = 256;            // head width
constexpr int kRows = 64;          // query rows per block: one consumer warpgroup
constexpr int kKeys = 64;          // keys per tile
constexpr int kConsumers = 128;    // the consumer warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kBox = 64 * 128;     // one TMA box: 64 rows of 64 bf16 features (128 bytes)
constexpr int kTileKV = 4 * kBox;  // K (or V) of one tile, [64 keys][256]
constexpr int kMaskWords = 256;    // the skip bits: up to 8,192 tiles a split
constexpr int kMaskRows = 64;      // flash_decode's mask tile: at most 64 t rows a block
constexpr float kNegInf2 = -1e30f * 1.4426950408889634f;  // a masked score, log2 domain
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Offsets from the block's 1024-aligned base: q [64][256] bf16, the ring
// (stage s: K then V), the stages' mask sources (64 int32 tags, or the mask
// tile [64 t rows][64 keys] bytes), their flags (the tile's first key, -1:
// the end), the skip bits of the split's tiles, the full and empty
// mbarriers. ops/flash_attention.py:_WG_SMEM mirrors kSmem.
template <bool MASK>
struct WgShape {
  static constexpr int kStages = MASK ? 2 : 3;  // a third stage with its mask tile passes 227 KB
  static constexpr int kExtra = MASK ? kMaskRows * kKeys : kKeys * 4;
  static constexpr int kOffRing = 4 * kBox;
  static constexpr int kOffExtra = kOffRing + kStages * 2 * kTileKV;
  static constexpr int kOffFlags = kOffExtra + kStages * kExtra;
  static constexpr int kOffMask = kOffFlags + 16;
  static constexpr int kOffBars = kOffMask + kMaskWords * 4;
  static constexpr int kSmem = kOffBars + kStages * 16 + 1024;  // + slack to align the base
  static_assert(kSmem <= 232448, "one block's shared memory");
};

struct Maps {
  CUtensorMap k, v;  // [B][H_kv][s_lim][D] bf16, boxes of 64 x 64, 128-byte swizzle
  CUtensorMap m;     // flash_decode, 16-byte mask rows: [B][T][s_lim] bytes, boxes of 64 x t rows
};

// the t rows of flash_decode's mask tile: the most distinct t that a block's
// 64 rows r = t*g + i span, at most T. A block starts at a multiple of 64:
// where g divides 64 at t = 0 of a group, 64 / g rows; else up to g - 1
// rows into one, (62 + g) / g + 1 = 62 / g + 2 rows (g = 6: 12, not 11).
__host__ __device__ __forceinline__ int mask_box_rows(int g, int T) {
  const int n = kRows % g == 0 ? kRows / g : (kRows - 2) / g + 2;
  return n < T ? n : T;
}

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) = 0, exp2(0) = 1
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s[32] = A (64 x 16, K-major) * B (16 x 64, K-major) + (scale_d ? s : 0); A and B from
// shared memory
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(s[0]), "+f"(s[1]), "+f"(s[2]), "+f"(s[3]), "+f"(s[4]), "+f"(s[5]), "+f"(s[6]), "+f"(s[7]),
          "+f"(s[8]), "+f"(s[9]), "+f"(s[10]), "+f"(s[11]), "+f"(s[12]), "+f"(s[13]), "+f"(s[14]), "+f"(s[15]),
          "+f"(s[16]), "+f"(s[17]), "+f"(s[18]), "+f"(s[19]), "+f"(s[20]), "+f"(s[21]), "+f"(s[22]), "+f"(s[23]),
          "+f"(s[24]), "+f"(s[25]), "+f"(s[26]), "+f"(s[27]), "+f"(s[28]), "+f"(s[29]), "+f"(s[30]), "+f"(s[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// o[128] += A (64 x 16, registers: the m16n8k16 A fragment of each warp's 16 rows) *
// B (16 x 256, MN-major) from shared memory
__device__ __forceinline__ void wgmma_pv(float (&o)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]), "+f"(o[6]), "+f"(o[7]),
          "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]), "+f"(o[12]), "+f"(o[13]), "+f"(o[14]), "+f"(o[15]),
          "+f"(o[16]), "+f"(o[17]), "+f"(o[18]), "+f"(o[19]), "+f"(o[20]), "+f"(o[21]), "+f"(o[22]), "+f"(o[23]),
          "+f"(o[24]), "+f"(o[25]), "+f"(o[26]), "+f"(o[27]), "+f"(o[28]), "+f"(o[29]), "+f"(o[30]), "+f"(o[31]),
          "+f"(o[32]), "+f"(o[33]), "+f"(o[34]), "+f"(o[35]), "+f"(o[36]), "+f"(o[37]), "+f"(o[38]), "+f"(o[39]),
          "+f"(o[40]), "+f"(o[41]), "+f"(o[42]), "+f"(o[43]), "+f"(o[44]), "+f"(o[45]), "+f"(o[46]), "+f"(o[47]),
          "+f"(o[48]), "+f"(o[49]), "+f"(o[50]), "+f"(o[51]), "+f"(o[52]), "+f"(o[53]), "+f"(o[54]), "+f"(o[55]),
          "+f"(o[56]), "+f"(o[57]), "+f"(o[58]), "+f"(o[59]), "+f"(o[60]), "+f"(o[61]), "+f"(o[62]), "+f"(o[63]),
          "+f"(o[64]), "+f"(o[65]), "+f"(o[66]), "+f"(o[67]), "+f"(o[68]), "+f"(o[69]), "+f"(o[70]), "+f"(o[71]),
          "+f"(o[72]), "+f"(o[73]), "+f"(o[74]), "+f"(o[75]), "+f"(o[76]), "+f"(o[77]), "+f"(o[78]), "+f"(o[79]),
          "+f"(o[80]), "+f"(o[81]), "+f"(o[82]), "+f"(o[83]), "+f"(o[84]), "+f"(o[85]), "+f"(o[86]), "+f"(o[87]),
          "+f"(o[88]), "+f"(o[89]), "+f"(o[90]), "+f"(o[91]), "+f"(o[92]), "+f"(o[93]), "+f"(o[94]), "+f"(o[95]),
          "+f"(o[96]), "+f"(o[97]), "+f"(o[98]), "+f"(o[99]), "+f"(o[100]), "+f"(o[101]), "+f"(o[102]), "+f"(o[103]),
          "+f"(o[104]), "+f"(o[105]), "+f"(o[106]), "+f"(o[107]), "+f"(o[108]), "+f"(o[109]), "+f"(o[110]), "+f"(o[111]),
          "+f"(o[112]), "+f"(o[113]), "+f"(o[114]), "+f"(o[115]), "+f"(o[116]), "+f"(o[117]), "+f"(o[118]), "+f"(o[119]),
          "+f"(o[120]), "+f"(o[121]), "+f"(o[122]), "+f"(o[123]), "+f"(o[124]), "+f"(o[125]), "+f"(o[126]), "+f"(o[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// this thread's cp.async copies so far arrive on the barrier once they land
// (the barrier's count includes the arrival)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// keeps the compiler from reusing registers that an asynchronous wgmma
// still reads (its A fragments) before the wait that retires it
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The producer warp's prologue: the skip bit of each tile of the split
// (mask_s, bit j: skip tile j), by rule B from the tags (MASK = false) or
// rule M from the mask rows (MASK = true).
template <bool MASK>
__device__ __forceinline__ void skip_bits(const FlashArgs& a, uint32_t* mask_s, int b, int row0,
                                          int s_begin, int s_end, int lane) {
  const int gq = a.H / a.H_kv, TG = a.T * gq;
  const int n_tiles = (s_end - s_begin + kKeys - 1) / kKeys;
  for (int w = lane; w < (n_tiles + 31) / 32; w += 32) mask_s[w] = 0u;
  __syncwarp();
  bool may_skip;  // every real row of the block sees some key of [0, s_limit)
  if constexpr (MASK) {
    // bit j of mask_s: some real row sees a key of tile j (set below, then flipped)
    const int t_lo = row0 / gq;
    const int n_t = (min(row0 + kRows, TG) - 1) / gq - t_lo + 1;  // real t rows, <= 64
    const uint8_t* mrow = a.mask + ((size_t)b * a.T + t_lo) * a.s_lim;
    unsigned long long rows_seen = 0ull;  // bit tr: this lane saw a visible key of row t_lo + tr
    if (a.mask_vec16) {  // 16 bytes a load
      for (int c = lane; c < a.s_lim / 16; c += 32) {
        uint32_t any = 0u;
#pragma unroll 16
        for (int tr = 0; tr < n_t; ++tr) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(mrow + (size_t)tr * a.s_lim) + c);
          const uint32_t nz = (v.x | v.y | v.z | v.w) != 0u;
          any |= nz;
          rows_seen |= (unsigned long long)nz << tr;
        }
        const int s = 16 * c;
        if (any && s >= s_begin && s < s_end)
          atomicOr(mask_s + ((s - s_begin) >> 11), 1u << (((s - s_begin) >> 6) & 31));
      }
    } else {  // unaligned rows: a byte a load
      for (int s = lane; s < a.s_lim; s += 32) {
        uint32_t any = 0u;
#pragma unroll 16
        for (int tr = 0; tr < n_t; ++tr) {
          const uint32_t nz = __ldg(mrow + (size_t)tr * a.s_lim + s) != 0;
          any |= nz;
          rows_seen |= (unsigned long long)nz << tr;
        }
        if (any && s >= s_begin && s < s_end)
          atomicOr(mask_s + ((s - s_begin) >> 11), 1u << (((s - s_begin) >> 6) & 31));
      }
    }
    const unsigned long long seen =
        (unsigned long long)__reduce_or_sync(0xffffffffu, (uint32_t)(rows_seen >> 32)) << 32 |
        __reduce_or_sync(0xffffffffu, (uint32_t)rows_seen);
    may_skip = seen == (n_t >= 64 ? ~0ull : (1ull << n_t) - 1ull);
    __syncwarp();
    for (int w = lane; w < (n_tiles + 31) / 32; w += 32)
      mask_s[w] = may_skip ? ~mask_s[w] : 0u;
  } else {
    const int32_t* tg = a.slot_pos + (size_t)b * a.tag_stride;
    int qmin = INT_MAX, qmax = INT_MIN;  // over the block's real rows
    for (int i = lane; i < kRows && row0 + i < TG; i += 32) {
      const int p = a.q_pos[(size_t)b * a.T + (row0 + i) / gq];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
    qmin = __reduce_min_sync(0xffffffffu, qmin);
    qmax = __reduce_max_sync(0xffffffffu, qmax);
    // one pass over the split's tiles: each tile's least non-negative tag
    // (bit j of mask_s: above every row's q_pos) and the least of them
    int gmin = INT_MAX;  // least non-negative tag of [0, s_limit)
#pragma unroll 4
    for (int j = 0; j < n_tiles; ++j) {
      const int s0 = s_begin + j * kKeys;
      const int t0 = s0 + lane < s_end ? tg[s0 + lane] : -1;
      const int t1 = s0 + 32 + lane < s_end ? tg[s0 + 32 + lane] : -1;
      const int tmin = __reduce_min_sync(0xffffffffu, min(t0 >= 0 ? t0 : INT_MAX,
                                                          t1 >= 0 ? t1 : INT_MAX));
      gmin = min(gmin, tmin);
      if (lane == 0 && tmin > qmax) mask_s[j >> 5] |= 1u << (j & 31);
    }
    // the other splits' keys, for the least tag
#pragma unroll 4
    for (int s = lane; s < s_begin; s += 32) {
      const int v = tg[s];
      if (v >= 0) gmin = min(gmin, v);
    }
#pragma unroll 4
    for (int s = s_end + lane; s < a.s_lim; s += 32) {
      const int v = tg[s];
      if (v >= 0) gmin = min(gmin, v);
    }
    gmin = __reduce_min_sync(0xffffffffu, gmin);
    may_skip = qmin >= 0 && qmin >= gmin;
    __syncwarp();
    if (!may_skip)  // a real row sees no key: every tile is read
      for (int w = lane; w < (n_tiles + 31) / 32; w += 32) mask_s[w] = 0u;
  }
  __syncwarp();
}

// grid (B * H_kv, ceil(T * g / 64), splits), 160 threads.
template <bool MASK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wg_kernel(const __grid_constant__ FlashArgs a, const __grid_constant__ Maps maps) {
  using W = WgShape<MASK>;
  constexpr int kStages = W::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;  // 128-byte swizzle atoms: 1 KB
  uint8_t* sm = smem_raw + (base - raw_u32);
  uint8_t* extra_s = sm + W::kOffExtra;  // [stage][kExtra]: tags or the mask tile
  int32_t* flags_s = reinterpret_cast<int32_t*>(sm + W::kOffFlags);  // [stage]
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(sm + W::kOffMask);  // bit j: skip tile j
  const uint32_t full0 = base + W::kOffBars, empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int gq = a.H / a.H_kv, TG = a.T * gq;
  const int b = blockIdx.x / a.H_kv, kvh = blockIdx.x % a.H_kv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // the latest positions first
  const int t_lo = row0 / gq;  // the mask tile's row 0
  const int s_begin = blockIdx.z * a.keys_per_split;
  const int s_end = min(a.s_lim, s_begin + a.keys_per_split);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 33);           // the producer's lanes + lane 0's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers);  // every consumer thread, done with the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: the skip bits, then the ring ----
    const int lane = tid & 31;
    skip_bits<MASK>(a, mask_s, b, row0, s_begin, s_end, lane);
    const int n_tiles = (s_end - s_begin + kKeys - 1) / kKeys;
    const int32_t* tg = MASK ? nullptr : a.slot_pos + (size_t)b * a.tag_stride;
    const int n_box = MASK ? mask_box_rows(gq, a.T) : 0;  // flash_decode's mask tile rows
    const uint8_t* mrow = MASK ? a.mask + ((size_t)b * a.T + t_lo) * a.s_lim : nullptr;
    int n = 0;  // stages filled
    for (int j = 0;; ++j) {
      const bool end = j >= n_tiles;
      if (!end && (mask_s[j >> 5] >> (j & 31) & 1u)) continue;
      const int st = n % kStages, s0 = s_begin + j * kKeys;
      if (n >= kStages) mbar_wait(empty0 + 8 * st, ((n - kStages) / kStages) & 1);
      const uint32_t bar = full0 + 8 * st;
      uint8_t* ex = extra_s + st * W::kExtra;
      if (!end) {
        if constexpr (MASK) {
          if (!a.mask_vec16) {  // the mask tile by the lanes' own loads, zeros past the split or T
            for (int e = lane; e < n_box * kKeys; e += 32) {
              const int tr = e / kKeys, s = s0 + e % kKeys;
              ex[e] = (t_lo + tr < a.T && s < s_end) ? mrow[(size_t)tr * a.s_lim + s] : 0;
            }
          }
        } else {
          // the tile's tags beside it (zeros past the split's end: the
          // consumers mask those keys by index), arriving on `bar` when landed
          const uint32_t td = smem_u32(ex);
          const bool in0 = s0 + lane < s_end, in1 = s0 + 32 + lane < s_end;
          cp_async4(td + 4 * lane, tg + (in0 ? s0 + lane : 0), in0);
          cp_async4(td + 4 * (32 + lane), tg + (in1 ? s0 + 32 + lane : 0), in1);
        }
        const bool mask_tma = MASK && a.mask_vec16;
        if (lane == 0) {
          flags_s[st] = s0;
          mbar_expect_tx(bar, 2 * kTileKV + (mask_tma ? n_box * kKeys : 0));
        }
        __syncwarp();  // the TMA bytes are expected before any lands
        if (lane < 8) {  // K's four boxes, then V's
          const uint32_t dst = base + W::kOffRing + st * 2 * kTileKV + (lane >> 2) * kTileKV;
          tma_4d(dst + (lane & 3) * kBox, (lane >> 2) ? &maps.v : &maps.k, 64 * (lane & 3), s0,
                 kvh, b, bar);
        } else if (mask_tma && lane == 8) {  // the mask tile: keys s0.., t rows t_lo..
          tma_3d(smem_u32(ex), &maps.m, s0, t_lo, b, bar);
        }
      } else if (lane == 0) {
        flags_s[st] = -1;
        mbar_arrive(bar);
      }
      if constexpr (MASK) {
        mbar_arrive(bar);  // releases this lane's mask bytes
      } else {
        cp_async_arrive(bar);
      }
      ++n;
      if (end) break;
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----
  const int w = tid >> 5, lane = tid & 31;
  const int qr = lane >> 2, qc = lane & 3;  // fragment row (and +8), column pair
  // q rows rounded to bf16 into four swizzled [64][64] boxes: A of S = Q K^T.
  // Every load is issued before the first store (one round trip to memory,
  // not one per 32-byte chunk); 16-byte aligned: the wrapper aligns q and
  // D * 4 is a multiple of 16.
  constexpr int kQChunks = kRows * (kD / 8) / kConsumers;  // 8-feature chunks a thread
  float4 x[kQChunks][2];
#pragma unroll
  for (int i = 0; i < kQChunks; ++i) {
    const int c = tid + i * kConsumers, rr = c / (kD / 8), part = c % (kD / 8), r = row0 + rr;
    x[i][0] = x[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < TG) {
      const int t = r / gq;
      const float4* src = reinterpret_cast<const float4*>(
          a.q + (((size_t)b * a.T + t) * a.H + kvh * gq + (r - t * gq)) * kD + part * 8);
      x[i][0] = src[0];
      x[i][1] = src[1];
    }
  }
#pragma unroll
  for (int i = 0; i < kQChunks; ++i) {
    const int c = tid + i * kConsumers, rr = c / (kD / 8), part = c % (kD / 8);
    const uint4 val = make_uint4(pack_bf16(x[i][0].x, x[i][0].y), pack_bf16(x[i][0].z, x[i][0].w),
                                 pack_bf16(x[i][1].x, x[i][1].y), pack_bf16(x[i][1].z, x[i][1].w));
    *reinterpret_cast<uint4*>(sm + (part >> 3) * kBox + rr * 128 + (((part & 7) ^ (rr & 7)) << 4)) =
        val;
  }
  fence_proxy_async();  // the q boxes, for wgmma
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  const int rA = row0 + 16 * w + qr;
  const int rows[2] = {rA, rA + 8};
  int qpos[2];  // flash_prefill: the row's query position (-1: not a real row)
  int moff[2];  // flash_decode: the row's byte offset in the mask tile (-1: not a real row)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const bool real = rows[hr] < TG;
    qpos[hr] = !MASK && real ? a.q_pos[(size_t)b * a.T + rows[hr] / gq] : -1;
    moff[hr] = real ? (rows[hr] / gq - t_lo) * kKeys + 2 * qc : -1;
  }

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m2[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};
  const float scale2 = a.scale * kLog2e;

  // S = Q K^T of the tile in stage st: 16 k16 steps over D (not waited for)
  auto qk = [&](float (&s)[32], int st) {
    const uint32_t kb = base + W::kOffRing + st * 2 * kTileKV;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
      wgmma_qk(s, desc_sw128(base + off, 16, 1024), desc_sw128(kb + off, 16, 1024), kk > 0);
    }
  };
  // O += P V of the tile in stage st (not waited for)
  auto pv = [&](const uint32_t (&pa)[kKeys / 16][4], int st) {
    const uint32_t vb = base + W::kOffRing + st * 2 * kTileKV + kTileKV;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_pv(o, pa[kk], desc_sw128(vb + kk * 16 * 128, 8192, 1024));
  };
  // The online softmax of one tile's scores s[4j + 2hr + c] (row hr, key
  // 8j + 2qc + c), keys from s0: s becomes p, m2 and l move on, alpha is
  // the factor for O.
  auto softmax = [&](float (&s)[32], int st, int s0, float (&alpha)[2]) {
    const uint8_t* ex = extra_s + st * W::kExtra;
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const int key = s0 + 8 * j + 2 * qc;
      bool vis[2][2];  // [row hr][key / key + 1]
      if constexpr (MASK) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint32_t mb =
              moff[hr] >= 0 ? *reinterpret_cast<const uint16_t*>(ex + moff[hr] + 8 * j) : 0u;
          vis[hr][0] = (mb & 0xffu) != 0u;
          vis[hr][1] = (mb >> 8) != 0u;
        }
      } else {
        const int2 tg = *reinterpret_cast<const int2*>(ex + 4 * (8 * j + 2 * qc));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          vis[hr][0] = tg.x >= 0 && tg.x <= qpos[hr];
          vis[hr][1] = tg.y >= 0 && tg.y <= qpos[hr];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, c = e & 1;
        // past the split: -inf, so p = 0 and m is unchanged
        const float v = key + c >= s_end ? -INFINITY
                        : vis[hr][c]     ? s[4 * j + e] * scale2
                                         : kNegInf2;
        s[4 * j + e] = v;
        mx[hr] = fmaxf(mx[hr], v);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      alpha[hr] = fast_exp2(m2[hr] - mx[hr]);
      m2[hr] = mx[hr];
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = fast_exp2(s[e] - m2[(e >> 1) & 1]);
      ls[(e >> 1) & 1] += s[e];  // l sums the unrounded p
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + ls[hr];
  };

  // p rounded to bf16 as register A fragments, one per k16 step of keys
  // (the accumulator's layout is the A operand's)
  auto pack = [&](const float (&s)[32], uint32_t (&pa)[kKeys / 16][4]) {
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      pa[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };

  // Tile n's QK^T and softmax run while tile n - 1's PV is in flight: its
  // P stays in pa (read by the wgmma) until the wait that retires it, and
  // O takes tile n's factor after it.
  float s[32];  // no initial value: each product starts with scale_d = 0
  uint32_t pa[kKeys / 16][4];
  mbar_wait(full0, 0);
  int s0 = flags_s[0];
  if (s0 >= 0) {
    float alpha[2];
    wgmma_fence();
    qk(s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    softmax(s, 0, s0, alpha);  // O is still zero: no factor
    pack(s, pa);
    int n = 1;
    for (;; ++n) {
      const int st = n % kStages, prev = (n - 1) % kStages;
      mbar_wait(full0 + 8 * st, (n / kStages) & 1);
      s0 = flags_s[st];
      if (s0 < 0) break;
      wgmma_fence();
      qk(s, st);
      wgmma_commit();
      pv(pa, prev);
      wgmma_commit();
      wgmma_wait<1>();  // QK^T of tile n (groups retire in order)
      fence_acc(s);
      softmax(s, st, s0, alpha);
      wgmma_wait<0>();  // PV of tile n - 1
      fence_acc(o);
      fence_regs(pa);
      mbar_arrive(empty0 + 8 * prev);  // this thread is done with tile n - 1's stage
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      pack(s, pa);
    }
    wgmma_fence();
    pv(pa, (n - 1) % kStages);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pa);
  }

  // o[4j + 2hr + c]: row hr, feature 8j + 2qc + c
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = rows[hr];
    if (r >= TG) continue;
    const int t = r / gq, h = kvh * gq + (r - t * gq);
    if (a.splits == 1) {
      const float inv = 1.f / fmaxf(lr, 1e-20f);
      float* orow = a.out + (((size_t)b * a.T + t) * a.H + h) * kD + 2 * qc;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
    } else {
      const size_t pr = (((size_t)blockIdx.z * a.B + b) * a.H_kv + kvh) * TG + r;
      if (qc == 0) {
        a.part_m[pr] = m2[hr] * kLn2;  // the combine kernel works in the natural domain
        a.part_l[pr] = lr;
      }
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<float2*>(a.part_acc + pr * kD + 8 * j + 2 * qc) =
            make_float2(o[4 * j + 2 * hr], o[4 * j + 2 * hr + 1]);
    }
  }
}

}  // namespace

bool flash_kv_map(CUtensorMap* map, const void* p, const FlashArgs& a) {
  if (tc_encoder() == nullptr) return false;
  const long long row = (long long)a.H_kv * a.S_full * kD;  // a batch row's elements
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)a.s_lim, (cuuint64_t)a.H_kv,
                              (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)kD * 2, (cuuint64_t)a.S_full * kD * 2,
                                 (cuuint64_t)(a.B > 1 ? a.batch_stride : row) * 2};
  const cuuint32_t box[4] = {64, kKeys, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return tc_encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

namespace {

// flash_decode's mask [B][T][s_lim] bytes as a 3-D tensor map (rows 16-byte
// aligned: s_lim % 16 == 0), boxes of 64 keys x the block's t rows; keys
// past s_limit and rows past T fill zeros.
bool mask_map(CUtensorMap* map, const FlashArgs& a) {
  const cuuint64_t dims[3] = {(cuuint64_t)a.s_lim, (cuuint64_t)a.T, (cuuint64_t)a.B};
  const cuuint64_t strides[2] = {(cuuint64_t)a.s_lim, (cuuint64_t)a.T * a.s_lim};
  const cuuint32_t box[3] = {kKeys, (cuuint32_t)mask_box_rows(a.H / a.H_kv, a.T), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return tc_encoder()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<uint8_t*>(a.mask), dims,
                      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool MASK>
int wg_launch(const FlashArgs& a, int smem_bytes, cudaStream_t st) {
  constexpr int kSmem = WgShape<MASK>::kSmem;
  if (smem_bytes != kSmem || a.keys_per_split > 32 * kMaskWords * kKeys || tc_encoder() == nullptr)
    return (int)cudaErrorInvalidValue;  // a plan other than ops/flash_attention.py:_wg_plan's
  Maps m = {};
  if (!flash_kv_map(&m.k, a.k, a) || !flash_kv_map(&m.v, a.v, a)) return (int)cudaErrorInvalidValue;
  if (MASK && a.mask_vec16 && !mask_map(&m.m, a)) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // above 48 KB a block must ask for its shared memory
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wg_kernel<MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(a.B * a.H_kv, (a.T * (a.H / a.H_kv) + kRows - 1) / kRows, a.splits);
  flash_wg_kernel<MASK><<<grid, kThreads, kSmem, st>>>(a, m);
  return 0;
}

}  // namespace

int flash_wg_launch(bool mask, const FlashArgs& a, int smem_bytes, cudaStream_t st) {
  return mask ? wg_launch<true>(a, smem_bytes, st) : wg_launch<false>(a, smem_bytes, st);
}

// Flash attention over the layer-stacked, head-major, position-tagged KV
// cache [L, B, H_kv, S, D]. Two kernels, each with a tensor-core and a SIMT
// body (and a wgmma body at D = 256, flash_wgmma.cu):
//   flash_decode  <- eagle_tpu/ops/pallas_attention.py:_flash_kernel
//                    (flash_attention_cached): a bool mask [B, T, S_read]
//                    computed outside, read per key tile — decode (T=1),
//                    chain verify (T=K+1) and the EAGLE engine's prompt;
//   flash_prefill <- pallas_attention.py:_flash_prefill_kernel
//                    (flash_attention_prefill): the mask computed in the
//                    kernel as tag >= 0 && tag <= q_pos from the slot tags.
//
// Semantics follow the Pallas kernels: the GQA group folds into the query
// rows (row r = t*g + i reads query head kvh*g + i); q is rounded to the
// cache dtype; scores accumulate in f32 and are scaled; masked scores are
// -1e30; the online softmax keeps f32 m / l / acc with m starting at -1e30
// (so a fully masked row comes out as the uniform average of V over the
// s_limit keys, as in the reference); l sums the unrounded p, and p is
// rounded to the cache dtype for the PV product; the denominator is clamped
// at 1e-20; only keys [0, s_limit) are read; the output is f32 [B, T, H, D].
//
// Which body serves which cache (ops/flash_attention.py:_plan picks it):
// - bf16 cache: the tensor-core body (flash_tc_kernel), except at D = 256
//   for flash_prefill and for flash_decode at 64 rows and more (below).
//   Decode and verify
//   (T*g <= 16) are bound by the bytes of K and V (2 x S x D x 2 per kv
//   head per layer: 5.0 us at S = 1024, 32 heads of 128, on 3.35 TB/s); so
//   is T = S = 512 (7.5 us against 4.3 GFLOP, 4.4 us at 989 TFLOP/s), if
//   the products run on the tensor cores. So: QK^T and PV are
//   mma.sync.m16n8k16 bf16 products with f32 sums (FlashAttention-2 layout:
//   a warp owns 16 query rows, the scores stay in the accumulator registers,
//   the online softmax runs on them with quad shuffles, and P is re-packed
//   from the accumulators into A fragments for PV); K comes from shared
//   memory with ldmatrix, V with ldmatrix.trans. K/V tiles of 64 keys go
//   through a 3-stage ring in shared memory (2 where a third would keep a
//   second block off the SM) filled by cp.async, 16 bytes a thread,
//   zero-filled past the split's end; the 16-byte chunks of a row are
//   XOR-swizzled, so ldmatrix's eight rows hit distinct banks without
//   padding. The decode mask tile [t rows, 64 keys] (or the prefill's 64
//   slot tags) comes in with the K tile. A block has RB = 16, 32, 64 or 128
//   query rows on 4 warps (8 at 128 rows, which halves the K/V tiles that
//   prompt blocks re-read from L2); below 64 rows the warps of one 16-row
//   tile split each key tile between them, so no warp computes on rows that
//   do not exist while keys wait; their (m, l, acc) merge in shared memory
//   at the end (a warp that saw all keys of its rows stores them from its
//   registers). At T = S = 512 the loop is held by the mma.sync pipe and
//   its latencies with two warps per scheduler (4.3 GFLOP). The softmax
//   runs in the log2 domain (exp2 with a log2(e) factor on the scaled
//   score); a masked score is the constant -1e30 * log2(e) and m starts
//   there, so a fully masked row still gets p = 1 for every key.
//   flash_decode at D = 256 below 64 rows per kv head (decode, verify,
//   trees, Gemma-2B's g = 8 verify): a lane's q fragments (64 registers)
//   and output (128) would leave too few registers for the scores, so the
//   block's q rows stay in shared memory instead (bf16, swizzled as K, after
//   the ring), and each k16 step of QK^T reloads its A fragments with
//   ldmatrix, as FlashAttention-2 does at that width. Blocks have 16 or 32
//   rows; a stage is 64 KB of K and V, and a block has the SM to itself, so
//   the ring takes three stages (a block's first two tiles are in flight
//   together). K and V come by TMA (eight [64 keys][64 features] boxes a
//   tile, 128-byte swizzle, issued by one thread onto the stage's
//   mbarrier): 16-byte cp.async from 128 threads spent 1.5 us of each
//   block issuing its first two tiles on the H100. q's loads are in flight
//   before the tiles are asked for. The few row blocks split the keys, and
//   the splits of a row block are one thread-block cluster: each block
//   merges its warps' rows into its own shared memory, and after a cluster
//   barrier each block merges a share of the rows' (row, feature) pieces
//   over all the blocks' shared memory (distributed shared memory), splits
//   in rank order, and writes the output. One launch: no (m, l, acc) round
//   trip through device memory and no combine kernel; the merge order is
//   fixed, so graphed and eager calls agree bit for bit, and nothing is
//   reset between calls. At most 8 splits, and as many as keep every
//   cluster in one wave (ops/flash_attention.py:_cluster_plan: 15 clusters
//   of 8 fit the H100 at one block an SM, 17 of 6). Bound at decode
//   (Gemma-7B, T = 1, S = 1,024): the K and V bytes, 16 MB, 5.0 us on
//   3.35 TB/s; its 16 kv heads take 16 x 6 blocks of up to three tiles.
// - bf16 cache at D = 256, flash_prefill and flash_decode at 64 rows and
//   more (the EAGLE engine's prompt): the wgmma body (flash_wgmma.cu):
//   64-row blocks of one consumer warpgroup, K/V tiles (and flash_decode's
//   mask tile) by TMA under mbarriers, S and O in wgmma accumulators, one
//   wave without key splits at Gemma's prompts, and key tiles that no row
//   of a block sees skipped (rules B and M there).
// - f32 cache: the SIMT body (flash_body): one warp owns RPW query rows and
//   one lane one key of a 32-key tile; exact f32 FMAs, as the tests and the
//   tiny model's f32 path expect (the tensor cores' TF32 would change the
//   numbers). Its tiles live in dynamic shared memory; at D = 256 a warp
//   owns one row (four rows' outputs would not fit in registers).
// Few query rows give few blocks, so every body also splits the key range
// across blocks (flash-decoding): each split writes its (m, l, acc) and a
// combine kernel merges them (the D = 256 tensor-core body merges its
// splits in the launch, above). Only the wgmma body skips key tiles: in the
// others a row that sees no key averages every key of [0, s_limit), and a
// tile is read whether or not a row of the block sees it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;  // SIMT body: keys per tile, one per lane
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ float round_t(float v);
template <> __device__ __forceinline__ float round_t<float>(float v) { return v; }

using Args = FlashArgs;  // flash_common.cuh

// Dynamic shared memory of the SIMT body: q [rows][D] f32, then the K tile
// [32][D + one 32-bit word] and the V tile [32][D].
template <typename T, int D, int RPW>
struct SimtShape {
  static constexpr int kRows = kWarps * RPW;
  static constexpr int kStride = D + 4 / sizeof(T);  // one 32-bit word per key row
  static constexpr int kQs = kRows * D * 4;
  static constexpr int kKs = kTile * kStride * sizeof(T);
  static constexpr int kSmem = kQs + kKs + kTile * D * sizeof(T);
};

template <typename T, int D, int RPW, bool TAGS>
__device__ __forceinline__ void flash_body(const Args& a) {
  using Sh = SimtShape<T, D, RPW>;
  constexpr int kStride = Sh::kStride;
  constexpr int kRows = Sh::kRows;
  constexpr int kDL = D / 32;  // output features per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float(*qs)[D] = reinterpret_cast<float(*)[D]>(smem);
  T* ks = reinterpret_cast<T*>(smem + Sh::kQs);
  T* vs = reinterpret_cast<T*>(smem + Sh::kQs + Sh::kKs);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = a.H / a.H_kv;
  const int TG = a.T * g;
  const int b = blockIdx.x / a.H_kv, kvh = blockIdx.x % a.H_kv;
  const int row0 = blockIdx.y * kRows;
  const int split = blockIdx.z;
  const int s_begin = split * a.keys_per_split;
  const int s_end = min(a.s_lim, s_begin + a.keys_per_split);

  for (int e = threadIdx.x; e < kRows * D; e += blockDim.x) {
    const int rr = e / D, d = e % D, r = row0 + rr;
    float val = 0.f;
    if (r < TG) {
      const int t = r / g, h = kvh * g + r % g;
      val = round_t<T>(a.q[(((size_t)b * a.T + t) * a.H + h) * D + d]);
    }
    qs[rr][d] = val;
  }

  int qpos[RPW];
  int trow[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp * RPW + i;
    trow[i] = r < TG ? r / g : 0;
    qpos[i] = (TAGS && r < TG) ? a.q_pos[(size_t)b * a.T + trow[i]] : 0;
  }
  float m[RPW], l[RPW], acc[RPW][kDL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDL; ++c) acc[i][c] = 0.f;
  }

  const size_t head = (size_t)b * a.batch_stride + (size_t)kvh * a.S_full * D;
  const T* kg = static_cast<const T*>(a.k) + head;
  const T* vg = static_cast<const T*>(a.v) + head;

  for (int s0 = s_begin; s0 < s_end; s0 += kTile) {
    __syncthreads();  // previous tile consumed (and qs written, first time)
    for (int e = threadIdx.x; e < kTile * D; e += blockDim.x) {
      const int j = e / D, d = e % D, s = s0 + j;
      T kv = from_f<T>(0.f), vv = from_f<T>(0.f);  // zero past the split's end
      if (s < s_end) {
        kv = kg[(size_t)s * D + d];
        vv = vg[(size_t)s * D + d];
      }
      ks[j * kStride + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    const int s = s0 + lane;
    const bool in_range = s < s_end;
    float sc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = 0.f;
    const int qrow = warp * RPW;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv = to_f<T>(ks[lane * kStride + d]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) sc[i] = fmaf(qs[qrow + i][d], kv, sc[i]);
    }
    int tag = -1;
    if (TAGS && in_range) tag = a.slot_pos[(size_t)b * a.tag_stride + s];

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      bool vis;
      if (TAGS) {
        vis = tag >= 0 && tag <= qpos[i];
      } else {
        vis = in_range && a.mask[((size_t)b * a.T + trow[i]) * a.s_lim + s] != 0;
      }
      const float score = vis ? sc[i] * a.scale : kNegInf;
      // keys past the range leave m alone (m starts at kNegInf)
      float mc = in_range ? score : kNegInf;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_new = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - m_new);
      const float p = in_range ? expf(score - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
      const float pr = round_t<T>(p);
#pragma unroll
      for (int c = 0; c < kDL; ++c) acc[i][c] *= alpha;
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int c = 0; c < kDL; ++c)
          acc[i][c] = fmaf(pj, to_f<T>(vs[j * D + lane + 32 * c]), acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp * RPW + i;
    if (r >= TG) continue;
    const int h = kvh * g + r % g;
    if (a.splits == 1) {
      const float inv = 1.f / fmaxf(l[i], 1e-20f);
      float* o = a.out + (((size_t)b * a.T + trow[i]) * a.H + h) * D;
#pragma unroll
      for (int c = 0; c < kDL; ++c) o[lane + 32 * c] = acc[i][c] * inv;
    } else {
      const size_t pr = (((size_t)split * a.B + b) * a.H_kv + kvh) * TG + r;
      if (lane == 0) {
        a.part_m[pr] = m[i];
        a.part_l[pr] = l[i];
      }
#pragma unroll
      for (int c = 0; c < kDL; ++c) a.part_acc[pr * D + lane + 32 * c] = acc[i][c];
    }
  }
}

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kWarps * 32) flash_decode_kernel(Args a) {
  flash_body<T, D, RPW, false>(a);
}

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kWarps * 32) flash_prefill_kernel(Args a) {
  flash_body<T, D, RPW, true>(a);
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 cache).

constexpr int kKeys = 64;  // keys per ring tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // a masked score, log2 domain
constexpr int kTwoBlockSmem = 115712;  // a ring that lets two blocks share an SM
constexpr int kMaxSmem = 232448;  // what one block may opt into
constexpr int kMaxCluster = 8;  // D = 256 flash_decode: key splits a cluster (portable size)

// Shared memory of one block (ops/flash_attention.py:_plan computes the same
// sizes). A stage holds K [64][D] and V [64][D] bf16, then the mask tile
// [RB][64] bytes (decode) or 64 int32 tags (prefill). The 16-byte chunk c of
// key row r lies at chunk c ^ (r & 7) of its row, so the eight rows that one
// ldmatrix reads hit 32 distinct banks without padding (at D = 256 K and V
// come by TMA as four [64 keys][64 features] boxes each, the same swizzle
// within a box's 128-byte rows: kv_chunk). At D = 256 the block's q rows
// [RB][D] bf16 follow the ring, swizzled as at D = 128, then an mbarrier a
// stage, all from a 1024-aligned base (1 KB of slack). A
// third stage is taken where it fits: beside a second block on the SM below
// 128 rows, in one block's limit at 128 and at D = 256 (the block has the SM
// to itself there). After the key loop the ring is reused to merge the
// warps' (acc, m, l), and at D = 256 to hold the block's merged rows
// [RB][D] f32 and their m and l for the cluster's merge (kPart, after the
// warps' merge).
template <int D, int RB, bool TAGS>
struct TcShape {
  static constexpr int kWarps = RB > 64 ? RB / 16 : 4;  // 128 rows: 8 warps
  static constexpr int kKV = kKeys * D * 2;
  static constexpr int kExtra = TAGS ? kKeys * 4 : RB * kKeys;
  static constexpr int kStage = 2 * kKV + kExtra;
  // D = 256 (flash_decode below 64 rows, "mma_cluster"): q fragments
  // reloaded from shared memory, K/V by TMA, the key splits one cluster
  // merged in the launch
  static constexpr bool kWide = D > 128;
  static constexpr int kQ = kWide ? RB * D * 2 : 0;
  static constexpr int kStages =
      3 * kStage + kQ <= (RB > 64 || kWide ? kMaxSmem : kTwoBlockSmem) ? 3 : 2;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kMergeStride = D + 4;  // floats per merged row: no bank conflicts
  static constexpr int kMerge = kWarps * 16 * (kMergeStride + 2) * 4;
  static constexpr int kPart = kWide ? RB * (D + 2) * 4 : 0;
  static constexpr int kBars = kWide ? kStages * 8 + 1024 : 0;  // + the base's alignment slack
  static constexpr int kSmem =
      (kRing + kQ > kMerge + kPart ? kRing + kQ : kMerge + kPart) + kBars;
  static constexpr int kMinBlocks = RB > 64 || kWide ? 1 : 2;  // blocks per SM
};

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) = 0, exp2(0) = 1
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c (features 8c..8c+7) of key row kr in a
// D = 256 K or V tile: four TMA boxes of [64 keys][64 features], 128-byte
// rows with the 128-byte swizzle (chunk c % 8 at c % 8 ^ kr % 8)
__device__ __forceinline__ uint32_t kv_chunk(int kr, int c) {
  return (c >> 3) * 8192 + kr * 128 + (((c & 7) ^ (kr & 7)) << 4);
}

template <int D, int RB, bool TAGS>
__global__ void __launch_bounds__(TcShape<D, RB, TAGS>::kWarps * 32,
                                  TcShape<D, RB, TAGS>::kMinBlocks)
    flash_tc_kernel(Args a, const __grid_constant__ FlashKVMaps maps) {
  using S = TcShape<D, RB, TAGS>;
  constexpr int kWarps = S::kWarps;
  constexpr int RT = RB / 16;      // 16-row tiles per block
  constexpr int KW = kWarps / RT;  // warps per row tile, each on its own keys
  constexpr int KPW = kKeys / KW;  // keys per warp per tile
  constexpr int NB = KPW / 8;      // n8 score blocks per warp
  constexpr int KD = D / 16;       // k16 steps over D
  constexpr int ND = D / 8;        // n8 output blocks
  constexpr int kThreads = kWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // D = 256: the TMA boxes' swizzle wants 1024-aligned stages
  unsigned char* smem = smem_raw;
  if constexpr (S::kWide)
    smem += ((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw);
  const uint32_t full0 = smem_u32(smem) + S::kRing + S::kQ;  // D = 256: a stage's mbarrier

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = a.H / a.H_kv, TG = a.T * gq;
  const int b = blockIdx.x / a.H_kv, kvh = blockIdx.x % a.H_kv;
  const int row0 = blockIdx.y * RB;
  const int split = blockIdx.z;
  const int s_begin = split * a.keys_per_split;
  const int s_end = min(a.s_lim, s_begin + a.keys_per_split);
  const int n_tiles = (s_end - s_begin + kKeys - 1) / kKeys;
  const int kw0 = (warp % KW) * KPW;  // the warp's first key in a tile
  const int qr = lane >> 2, qc = lane & 3;  // fragment row (and +8), column pair
  const int t_lo = row0 / gq;  // first query position of the block (mask tile row 0)

  const size_t head = (size_t)b * a.batch_stride + (size_t)kvh * a.S_full * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + head;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + head;

  // Copies of key tile j into ring slot j % kStages.
  auto load_tile = [&](int j) {
    unsigned char* st = smem + (j % S::kStages) * S::kStage;
    const uint32_t st32 = smem_u32(st);
    const int s0 = s_begin + j * kKeys;
    if constexpr (S::kWide) {
      // K's four boxes, then V's, by one thread, completing on the stage's
      // mbarrier; keys past s_limit fill zeros, keys of the next split are
      // masked by index
      if (threadIdx.x == 0) {
        const uint32_t bar = full0 + 8 * (j % S::kStages);
        mbar_expect_tx(bar, 2 * S::kKV);
#pragma unroll
        for (int box = 0; box < 8; ++box)
          tma_4d(st32 + (box >> 2) * S::kKV + (box & 3) * 8192, (box >> 2) ? &maps.v : &maps.k,
                 64 * (box & 3), s0, kvh, b, bar);
      }
    } else {
      constexpr int kChunks = D / 8;  // 16-byte chunks per key row
#pragma unroll
      for (int c = threadIdx.x; c < kKeys * kChunks; c += kThreads) {
        const int key = c / kChunks, part = c % kChunks;
        const int s = s0 + key;
        const bool in = s < s_end;
        const size_t off = (size_t)(in ? s : 0) * D + part * 8;
        const uint32_t dst = st32 + key * D * 2 + ((part ^ (key & 7)) << 4);
        cp_async16(dst, kg + off, in);
        cp_async16(dst + S::kKV, vg + off, in);
      }
    }
    unsigned char* ex = st + 2 * S::kKV;
    if (TAGS) {
      const int32_t* tg = a.slot_pos + (size_t)b * a.tag_stride;
      for (int i = threadIdx.x; i < kKeys; i += kThreads) {
        const bool in = s0 + i < s_end;
        cp_async4(smem_u32(ex) + 4 * i, tg + (in ? s0 + i : 0), in);
      }
    } else {
      const int n_t = min(a.T, (row0 + RB - 1) / gq + 1) - t_lo;
      const uint8_t* mrow = a.mask + ((size_t)b * a.T + t_lo) * a.s_lim;
      if (a.mask_vec16) {  // s_lim % 16 == 0: a chunk is wholly in or out
        for (int c = threadIdx.x; c < n_t * (kKeys / 16); c += kThreads) {
          const int tr = c / (kKeys / 16), s = s0 + (c % (kKeys / 16)) * 16;
          const bool in = s < s_end;
          cp_async16(smem_u32(ex) + c * 16, mrow + (size_t)tr * a.s_lim + (in ? s : 0), in);
        }
      } else {  // unaligned rows: plain loads (the slot is free: see the loop)
        for (int e = threadIdx.x; e < n_t * kKeys; e += kThreads) {
          const int tr = e / kKeys, s = s0 + e % kKeys;
          ex[e] = s < s_end ? mrow[(size_t)tr * a.s_lim + s] : 0;
        }
      }
    }
  };

  auto prologue = [&] {
#pragma unroll
    for (int j = 0; j < S::kStages - 1; ++j) {
      if (j < n_tiles) load_tile(j);
      cp_async_commit();
    }
  };

  // q fragments of the warp's 16 rows, rounded to bf16 (A layout of m16n8k16)
  const int rA = row0 + (warp / KW) * 16 + qr;
  const int rows[2] = {rA, rA + 8};
  uint32_t qa[S::kWide ? 1 : KD][4];
  int qpos[2], tl[2], tlr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = rows[hr];
    const bool real = r < TG;
    const int t = real ? r / gq : 0;
    const float* qrow = a.q + (((size_t)b * a.T + t) * a.H + kvh * gq + (real ? r % gq : 0)) * D;
    qpos[hr] = (TAGS && real) ? a.q_pos[(size_t)b * a.T + t] : -1;
    tl[hr] = real ? t - t_lo : -1;
    tlr[hr] = real ? t - t_lo : 0;  // a mask tile row that may be read
    if constexpr (!S::kWide) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // the wrapper passes q 16-byte aligned and D is even: float2 loads
          const float2 v =
              real ? *reinterpret_cast<const float2*>(qrow + kk * 16 + half * 8 + 2 * qc)
                   : make_float2(0.f, 0.f);
          qa[kk][half * 2 + hr] = pack_bf16(v.x, v.y);
        }
      }
    }
  }
  if constexpr (S::kWide) {
    // the block's q rows, bf16, into shared memory after the ring. Every
    // load is in flight before the ring's first tiles are asked for, and
    // those before q is stored: the round trips overlap.
    if (threadIdx.x == 0) {
      for (int st = 0; st < S::kStages; ++st) mbar_init(full0 + 8 * st, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    unsigned char* qs = smem + S::kRing;
    constexpr int kChunks = D / 8;  // 16-byte chunks of a bf16 row
    constexpr int kPer = RB * kChunks / kThreads;  // chunks a thread
    float4 x[kPer][2];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * kThreads, rr = c / kChunks, part = c % kChunks;
      const int r = row0 + rr;
      x[i][0] = x[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < TG) {  // 16-byte aligned: the wrapper aligns q and D * 4 is a multiple of 16
        const int t = r / gq;
        const float4* src = reinterpret_cast<const float4*>(
            a.q + (((size_t)b * a.T + t) * a.H + kvh * gq + (r - t * gq)) * D + part * 8);
        x[i][0] = src[0];
        x[i][1] = src[1];
      }
    }
    prologue();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * kThreads, rr = c / kChunks, part = c % kChunks;
      *reinterpret_cast<uint4*>(qs + rr * D * 2 + ((part ^ (rr & 7)) << 4)) =
          make_uint4(pack_bf16(x[i][0].x, x[i][0].y), pack_bf16(x[i][0].z, x[i][0].w),
                     pack_bf16(x[i][1].x, x[i][1].y), pack_bf16(x[i][1].z, x[i][1].w));
    }  // read after the key loop's first __syncthreads
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m2[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};
  const float scale2 = a.scale * kLog2e;

  if constexpr (!S::kWide) prologue();
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<S::kStages - 2>();
    if constexpr (S::kWide) mbar_wait(full0 + 8 * (j % S::kStages), (j / S::kStages) & 1);
    __syncthreads();  // tile j landed; every warp is done with tile j - 1's slot
    if (j + S::kStages - 1 < n_tiles) load_tile(j + S::kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (j % S::kStages) * S::kStage;
    const uint32_t ks = smem_u32(st), vs = ks + S::kKV;
    const unsigned char* ex = st + 2 * S::kKV;
    const int s0 = s_begin + j * kKeys;

    float sc[NB][4];
    if constexpr (S::kWide) {
      // row (warp / KW) * 16 + (lane & 15) of the q tile: lanes 16-31 read
      // the second 8 columns of a k16 step (A fragments' register order)
      const uint32_t qrow = smem_u32(smem + S::kRing) + ((warp / KW) * 16 + (lane & 15)) * D * 2;
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) sc[jb][0] = sc[jb][1] = sc[jb][2] = sc[jb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; kk += 2) {
        uint32_t qf[2][4];  // A fragments of k16 steps kk and kk + 1
        ldmatrix_x4(qrow + (((kk * 2 + (lane >> 4)) ^ (lane & 7)) << 4), qf[0]);
        ldmatrix_x4(qrow + (((kk * 2 + 2 + (lane >> 4)) ^ (lane & 7)) << 4), qf[1]);
#pragma unroll
        for (int jb = 0; jb < NB; ++jb) {
          uint32_t kb[4];  // B fragments of k16 steps kk and kk + 1
          ldmatrix_x4(ks + kv_chunk(kw0 + jb * 8 + (lane & 7), kk * 2 + (lane >> 3)), kb);
          mma_bf16(sc[jb], qf[0], kb[0], kb[1]);
          mma_bf16(sc[jb], qf[1], kb[2], kb[3]);
        }
      }
    } else {
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        sc[jb][0] = sc[jb][1] = sc[jb][2] = sc[jb][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; kk += 2) {
          uint32_t kb[4];  // B fragments of k16 steps kk and kk + 1
          // rows kw0 + jb*8 + (lane & 7): chunks 2kk .. 2kk + 3, swizzled
          ldmatrix_x4(ks + (kw0 + jb * 8 + (lane & 7)) * D * 2 +
                          (((kk * 2 + (lane >> 3)) ^ (lane & 7)) << 4),
                      kb);
          mma_bf16(sc[jb], qa[kk], kb[0], kb[1]);
          mma_bf16(sc[jb], qa[kk + 1], kb[2], kb[3]);
        }
      }
    }

    float mx[2] = {m2[0], m2[1]};
    const int in_split = s_end - s0;  // keys of this tile inside the split
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      const int key = kw0 + jb * 8 + 2 * qc;  // even: the pair (key, key + 1)
      bool vis[2][2];  // [row A / B][key / key + 1]
      if constexpr (TAGS) {
        const int2 tg = *reinterpret_cast<const int2*>(ex + 4 * key);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          vis[hr][0] = tg.x >= 0 && tg.x <= qpos[hr];
          vis[hr][1] = tg.y >= 0 && tg.y <= qpos[hr];
        }
      } else {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const unsigned mb = *reinterpret_cast<const uint16_t*>(ex + tlr[hr] * kKeys + key);
          vis[hr][0] = tl[hr] >= 0 && (mb & 0xffu);
          vis[hr][1] = tl[hr] >= 0 && (mb >> 8);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, c = e & 1;
        // past the split: -inf, so p = 0 and m is unchanged
        const float v = key + c >= in_split ? -INFINITY
                        : vis[hr][c]        ? sc[jb][e] * scale2
                                            : kNegInf2;
        sc[jb][e] = v;
        mx[hr] = fmaxf(mx[hr], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      alpha[hr] = fast_exp2(m2[hr] - mx[hr]);
      m2[hr] = mx[hr];
    }

    uint32_t pa[NB / 2][4];  // P as A fragments, one per k16 step of keys
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      const float p0 = fast_exp2(sc[jb][0] - m2[0]), p1 = fast_exp2(sc[jb][1] - m2[0]);
      const float p2 = fast_exp2(sc[jb][2] - m2[1]), p3 = fast_exp2(sc[jb][3] - m2[1]);
      ls[0] += p0 + p1;  // l sums the unrounded p
      ls[1] += p2 + p3;
      pa[jb / 2][(jb % 2) * 2] = pack_bf16(p0, p1);
      pa[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + ls[hr];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vb[4];  // B fragments of output blocks n and n + 1
        const int vr = kw0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        if constexpr (S::kWide) {
          ldmatrix_x4_trans(vs + kv_chunk(vr, n + (lane >> 4)), vb);
        } else {
          ldmatrix_x4_trans(vs + vr * D * 2 + (((n + (lane >> 4)) ^ (lane & 7)) << 4), vb);
        }
        mma_bf16(o[n], pa[kk], vb[0], vb[1]);
        mma_bf16(o[n + 1], pa[kk], vb[2], vb[3]);
      }
    }
  }

  if constexpr (KW == 1) {  // the warp saw every key of its rows: store from registers
    cp_async_wait<0>();
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lr = l[hr];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int r = rows[hr];
      if (r >= TG) continue;
      const int t = gq == 1 ? r : r / gq, h = kvh * gq + (r - t * gq);
      if (a.splits == 1) {
        const float inv = 1.f / fmaxf(lr, 1e-20f);
        float* orow = a.out + (((size_t)b * a.T + t) * a.H + h) * D + 2 * qc;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<float2*>(orow + n * 8) =
              make_float2(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
      } else {
        const size_t pr = (((size_t)split * a.B + b) * a.H_kv + kvh) * TG + r;
        if (qc == 0) {
          a.part_m[pr] = m2[hr] * kLn2;  // the combine kernel works in the natural domain
          a.part_l[pr] = lr;
        }
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<float2*>(a.part_acc + pr * D + n * 8 + 2 * qc) =
              make_float2(o[n][2 * hr], o[n][2 * hr + 1]);
      }
    }
    return;
  }
  // Below 64 rows the warps of a row tile saw different keys: merge them in
  // shared memory, then write the rows or the split's partial state (at
  // D = 256: into shared memory, for the cluster's merge below).
  cp_async_wait<0>();
  __syncthreads();  // the ring is no longer read
  float* macc = reinterpret_cast<float*>(smem);  // [warps][16][kMergeStride]
  float* mm = macc + kWarps * 16 * S::kMergeStride;  // [warps][16]
  float* ml = mm + kWarps * 16;
  float* pacc = reinterpret_cast<float*>(smem + S::kMerge);  // D = 256: [RB][D], then m, l [RB]
  float* pm = pacc + RB * D;
  float* pl = pm + RB;
  const bool cluster = S::kWide && a.splits > 1;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    if (qc == 0) {
      mm[warp * 16 + qr + 8 * hr] = m2[hr];
      ml[warp * 16 + qr + 8 * hr] = l[hr];
    }
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float* p = macc + (warp * 16 + qr) * S::kMergeStride + n * 8 + 2 * qc;
    if (!S::kWide || rows[0] < TG)  // D = 256: only the rows that exist
      *reinterpret_cast<float2*>(p) = make_float2(o[n][0], o[n][1]);
    if (!S::kWide || rows[1] < TG)
      *reinterpret_cast<float2*>(p + 8 * S::kMergeStride) = make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();
  constexpr int kLanesPerRow = D / 4;  // each thread merges 4 features of a row
  constexpr int kRowStep = kThreads / kLanesPerRow;
  const int d0 = (threadIdx.x % kLanesPerRow) * 4;
  for (int rr = threadIdx.x / kLanesPerRow; rr < RB; rr += kRowStep) {
    const int r = row0 + rr;
    if (r >= TG) break;  // rows beyond TG come last
    const int w0 = (rr / 16) * KW, fr = rr % 16;
    float mmax = -INFINITY;
#pragma unroll
    for (int w = 0; w < KW; ++w) mmax = fmaxf(mmax, mm[(w0 + w) * 16 + fr]);
    float lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const float wt = fast_exp2(mm[(w0 + w) * 16 + fr] - mmax);
      const float4 v =
          *reinterpret_cast<const float4*>(macc + ((w0 + w) * 16 + fr) * S::kMergeStride + d0);
      lsum += ml[(w0 + w) * 16 + fr] * wt;
      acc.x += v.x * wt;
      acc.y += v.y * wt;
      acc.z += v.z * wt;
      acc.w += v.w * wt;
    }
    const int t = gq == 1 ? r : r / gq, h = kvh * gq + (r - t * gq);
    if (cluster) {
      *reinterpret_cast<float4*>(pacc + rr * D + d0) = acc;
      if (d0 == 0) {
        pm[rr] = mmax;
        pl[rr] = lsum;
      }
    } else if (a.splits == 1) {
      const float inv = 1.f / fmaxf(lsum, 1e-20f);
      *reinterpret_cast<float4*>(a.out + (((size_t)b * a.T + t) * a.H + h) * D + d0) =
          make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    } else if constexpr (!S::kWide) {  // D = 256's splits merge in the cluster, below
      const size_t pr = (((size_t)split * a.B + b) * a.H_kv + kvh) * TG + r;
      if (d0 == 0) {
        a.part_m[pr] = mmax * kLn2;  // the combine kernel works in the natural domain
        a.part_l[pr] = lsum;
      }
      *reinterpret_cast<float4*>(a.part_acc + pr * D + d0) = acc;
    }
  }
  if constexpr (S::kWide) {
    if (!cluster) return;
    // The key splits of these rows are the blocks of one cluster (rank =
    // split): once every block holds its rows, each merges a share of the
    // (row, 4 features) pieces over the blocks' shared memory, splits in
    // rank order, so the sum's order is fixed (graphed == eager, bit for bit).
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every split's rows are in its shared memory
    const int n_splits = a.splits, rank = (int)cl.block_rank();
    const int n_pieces = min(RB, TG - row0) * (D / 4);
    const int lo = rank * n_pieces / n_splits, hi = (rank + 1) * n_pieces / n_splits;
    for (int piece = lo + threadIdx.x; piece < hi; piece += kThreads) {
      const int rr = piece / (D / 4), d0 = (piece % (D / 4)) * 4;
      // every split's m, l and 4 features in flight at once (one round trip)
      float mk[kMaxCluster], lk[kMaxCluster];
      float4 vk[kMaxCluster];
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k < n_splits) {
          mk[k] = cl.map_shared_rank(pm, k)[rr];
          lk[k] = cl.map_shared_rank(pl, k)[rr];
          vk[k] = *reinterpret_cast<const float4*>(cl.map_shared_rank(pacc, k) + rr * D + d0);
        }
      }
      float mmax = -INFINITY;
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < n_splits) mmax = fmaxf(mmax, mk[k]);
      float lsum = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {  // in split order
        if (k < n_splits) {
          const float wt = fast_exp2(mk[k] - mmax);
          lsum += lk[k] * wt;
          acc.x += vk[k].x * wt;
          acc.y += vk[k].y * wt;
          acc.z += vk[k].z * wt;
          acc.w += vk[k].w * wt;
        }
      }
      const int r = row0 + rr, t = r / gq, h = kvh * gq + (r - t * gq);
      const float inv = 1.f / fmaxf(lsum, 1e-20f);
      *reinterpret_cast<float4*>(a.out + (((size_t)b * a.T + t) * a.H + h) * D + d0) =
          make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    }
    cl.sync();  // no block leaves while another reads its shared memory
  }
}

// Merge the key splits: one thread per (b, kvh, row, d).
__global__ void flash_combine_kernel(Args a, int D) {
  const int g = a.H / a.H_kv, TG = a.T * g;
  const size_t rows = (size_t)a.B * a.H_kv * TG;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * D) return;
  const size_t row = e / D;
  const int d = e % D;
  // -inf, not kNegInf: the tensor-core body's m of a fully masked row is
  // -1e30 * log2(e) * ln(2), which may round below -1e30
  float mx = -INFINITY;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, a.part_m[s * rows + row]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const float w = expf(a.part_m[s * rows + row] - mx);
    l += a.part_l[s * rows + row] * w;
    acc += a.part_acc[(s * rows + row) * D + d] * w;
  }
  const int r = row % TG;
  const size_t bk = row / TG;
  const int b = bk / a.H_kv, kvh = bk % a.H_kv;
  const int t = r / g, h = kvh * g + r % g;
  a.out[(((size_t)b * a.T + t) * a.H + h) * D + d] = acc / fmaxf(l, 1e-20f);
}

int grid_y(const Args& a, int rows_per_block) {
  return (a.T * (a.H / a.H_kv) + rows_per_block - 1) / rows_per_block;
}

template <int D, int RPW>
int launch_simt(bool tags, const Args& a, cudaStream_t st) {
  constexpr int kSmem = SimtShape<float, D, RPW>::kSmem;
  void (*kern)(Args) = flash_decode_kernel<float, D, RPW>;
  if (tags) kern = flash_prefill_kernel<float, D, RPW>;
  static bool attr_set[2] = {false, false};  // above 48 KB a block must ask for its shared memory
  if (kSmem > 48 * 1024 && !attr_set[tags]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set[tags] = true;
  }
  const dim3 grid(a.B * a.H_kv, grid_y(a, kWarps * RPW), a.splits);
  kern<<<grid, kWarps * 32, kSmem, st>>>(a);
  return 0;
}

template <int D, int RB, bool TAGS>
int launch_tc(const Args& a, int smem_bytes, cudaStream_t st) {
  using S = TcShape<D, RB, TAGS>;
  if (smem_bytes != S::kSmem) return (int)cudaErrorInvalidValue;  // the plan disagrees
  FlashKVMaps maps = {};
  if (S::kWide && !(flash_kv_map(&maps.k, a.k, a) && flash_kv_map(&maps.v, a.v, a)))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // above 48 KB a block must ask for its shared memory
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D, RB, TAGS>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid(a.B * a.H_kv, grid_y(a, RB), a.splits);
  if constexpr (S::kWide) {  // the splits of a row block form one cluster
    if (a.splits > kMaxCluster) return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = a.splits;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(S::kWarps * 32);
    cfg.dynamicSmemBytes = S::kSmem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, flash_tc_kernel<D, RB, TAGS>, a, maps);
  } else {
    flash_tc_kernel<D, RB, TAGS><<<grid, S::kWarps * 32, S::kSmem, st>>>(a, maps);
    return 0;
  }
}

// Clusters of `cluster` blocks of the "mma_cluster" body at RB rows that
// the card runs at once (cudaOccupancyMaxActiveClusters), or -1.
template <int RB>
int cluster_wave(int cluster) {
  using S = TcShape<256, RB, false>;
  if (cudaFuncSetAttribute(flash_tc_kernel<256, RB, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, cluster);
  cfg.blockDim = dim3(S::kWarps * 32);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, flash_tc_kernel<256, RB, false>, &cfg) == cudaSuccess
             ? n : -1;
}

template <int D, bool TAGS>
int dispatch_tc_rb(int rows_per_block, const Args& a, int smem_bytes, cudaStream_t st) {
  switch (rows_per_block) {
    case 16: return launch_tc<D, 16, TAGS>(a, smem_bytes, st);
    case 32: return launch_tc<D, 32, TAGS>(a, smem_bytes, st);
  }
  if constexpr (D <= 128) {  // D = 256 flash_decode: 16 or 32 rows (64: the wgmma body)
    if (rows_per_block == 64) return launch_tc<D, 64, TAGS>(a, smem_bytes, st);
    if (rows_per_block == 128) return launch_tc<D, 128, TAGS>(a, smem_bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}

// the body ops/flash_attention.py:_plan chose (Plan.body, in _BODIES order)
enum Body { kBodySimt = 0, kBodyMma = 1, kBodyCluster = 2, kBodyWgmma = 3 };

template <int D>
int dispatch(int body, bool tags, int rows_per_block, const Args& a, int smem_bytes,
             cudaStream_t st) {
  switch (body) {
    case kBodyMma:  // bf16 at D 64 / 128
      if constexpr (D <= 128)
        return tags ? dispatch_tc_rb<D, true>(rows_per_block, a, smem_bytes, st)
                    : dispatch_tc_rb<D, false>(rows_per_block, a, smem_bytes, st);
      break;
    case kBodyCluster:  // bf16 flash_decode at D = 256 below 64 rows
      if constexpr (D > 128)
        if (!tags) return dispatch_tc_rb<D, false>(rows_per_block, a, smem_bytes, st);
      break;
    case kBodyWgmma:  // bf16 at D = 256: flash_prefill, flash_decode from 64 rows
      if constexpr (D > 128) return flash_wg_launch(!tags, a, smem_bytes, st);
      break;
    case kBodySimt:  // f32
      if (rows_per_block == kWarps) return launch_simt<D, 1>(tags, a, st);
      if constexpr (D <= 128) {  // D = 256: one row per warp
        if (rows_per_block == 4 * kWarps) return launch_simt<D, 4>(tags, a, st);
      }
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// tags = 0: flash_decode (mask given); tags = 1: flash_prefill (q_pos and
// slot_pos given). k/v point at the layer's [B, H_kv, S_full, D] block,
// batch rows batch_stride elements apart (H_kv * S_full * D when whole).
// D in {64, 128, 256}. `body` is the plan's (enum Body): the tensor-core
// body (kBodyMma, bf16 at D 64 / 128) with rows_per_block in {16, 32, 64,
// 128} and smem_bytes its dynamic shared memory; at D = 256 on a bf16 cache
// the wgmma body (kBodyWgmma: flash_prefill, flash_decode from 64 rows, its
// own shared memory) or the tensor-core body at 16 or 32 rows with its key
// splits (at most 8) merged in the launch (kBodyCluster: flash_decode below
// 64 rows); the SIMT body (kBodySimt, f32 cache) with rows_per_block in
// {4, 16} (1 or 4 rows per warp; D = 256: 4). Other bodies with splits > 1
// keep the per-split state in the part_* buffers, and a combine kernel runs.
extern "C" int flash_launch(int tags, const void* q, const void* k, const void* v,
                            const void* mask, const void* q_pos, const void* slot_pos,
                            void* out, void* part_m, void* part_l, void* part_acc,
                            int B, int T, int H, int H_kv, int D, int S_full, int s_lim,
                            int tag_stride, int body, int rows_per_block, int splits,
                            int keys_per_split, int smem_bytes, long long batch_stride,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.q_pos = static_cast<const int32_t*>(q_pos);
  a.slot_pos = static_cast<const int32_t*>(slot_pos);
  a.out = static_cast<float*>(out);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B; a.T = T; a.H = H; a.H_kv = H_kv; a.S_full = S_full; a.s_lim = s_lim;
  a.tag_stride = tag_stride; a.splits = splits; a.keys_per_split = keys_per_split;
  a.batch_stride = batch_stride;
  a.mask_vec16 = s_lim % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  a.scale = scale;
  int rc;
  if (D == 64) {
    rc = dispatch<64>(body, tags != 0, rows_per_block, a, smem_bytes, st);
  } else if (D == 128) {
    rc = dispatch<128>(body, tags != 0, rows_per_block, a, smem_bytes, st);
  } else if (D == 256) {
    rc = dispatch<256>(body, tags != 0, rows_per_block, a, smem_bytes, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  if (splits > 1 && body != kBodyCluster) {  // kBodyCluster merges in the launch
    const size_t n = (size_t)B * H_kv * T * (H / H_kv) * D;
    flash_combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a, D);
  }
  return (int)cudaGetLastError();
}

// ops/flash_attention.py:cluster_wave: clusters of `cluster` (1-8) blocks of
// flash_decode's D = 256 body below 64 rows, at rows_per_block 16 or 32,
// that the card runs at once; -1 for other arguments or on an error.
extern "C" int flash_cluster_wave(int rows_per_block, int cluster) {
  if (cluster < 1 || cluster > kMaxCluster) return -1;
  if (rows_per_block == 16) return cluster_wave<16>(cluster);
  if (rows_per_block == 32) return cluster_wave<32>(cluster);
  return -1;
}

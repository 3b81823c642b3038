// What the flash kernels' two translation units share: the arguments of
// one call (flash_attention.cu builds them in flash_launch) and the entry
// of the wgmma body (flash_wgmma.cu), which flash_launch calls for a bf16
// cache at head width 256: flash_prefill, and flash_decode at T*g >= 64.
#pragma once

#include <cuda.h>  // CUtensorMap (types only: no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

struct FlashArgs {
  const float* q;          // [B, T, H, D]
  const void* k;           // layer base of [B, H_kv, S_full, D]
  const void* v;
  const uint8_t* mask;     // [B, T, s_lim] (decode)
  const int32_t* q_pos;    // [B, T] (prefill)
  const int32_t* slot_pos; // [B, tag_stride] (prefill)
  float* out;              // [B, T, H, D]
  float* part_m;           // [splits, B, H_kv, TG]
  float* part_l;
  float* part_acc;         // [splits, B, H_kv, TG, D]
  int B, T, H, H_kv, S_full, s_lim, tag_stride, splits, keys_per_split;
  long long batch_stride;  // elements between batch rows of k and v
  int mask_vec16;          // mask rows 16-byte aligned: copied 16 bytes at a time (cp.async, TMA)
  float scale;
};

// bf16 cache, D = 256: one launch of the wgmma body over a.splits key
// splits (the caller merges them), with the mask given (mask = true:
// flash_decode) or rebuilt from the tags (flash_prefill); smem_bytes must
// be the body's dynamic shared memory (ops/flash_attention.py:_plan).
// Returns a cudaError_t.
int flash_wg_launch(bool mask, const FlashArgs& a, int smem_bytes, cudaStream_t st);

// K and V of a bf16 call at D = 256 as TMA tensor maps (flash_wgmma.cu)
struct FlashKVMaps {
  CUtensorMap k, v;
};

// K or V of the layer as a 4-D tensor map (D, slots, kv heads, batch) over
// the cache's strides, the slot extent cut at s_limit (TMA fills zeros past
// it), boxes of 64 features x 64 slots with the 128-byte swizzle; false if
// the encoder refuses it.
bool flash_kv_map(CUtensorMap* map, const void* p, const FlashArgs& a);

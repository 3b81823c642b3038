// What the flash kernels' two translation units share: the arguments of
// one call (flash_attention.cu builds them in flash_launch) and the entry
// of flash_prefill's wgmma body (flash_prefill_wgmma.cu), which
// flash_launch calls for a bf16 cache at head width 256.
#pragma once

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
  int mask_vec16;          // mask rows 16-byte aligned: copied with cp.async
  float scale;
};

// flash_prefill, bf16 cache, D = 256: one launch of the wgmma body over
// a.splits key splits (the caller merges them); smem_bytes must be the
// body's dynamic shared memory (ops/flash_attention.py:_plan). Returns a
// cudaError_t.
int flash_prefill_wg_launch(const FlashArgs& a, int smem_bytes, cudaStream_t st);

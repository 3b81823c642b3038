"""Flash attention over the layer-stacked cache: the `flash_decode` and
`flash_prefill` CUDA kernels (csrc/flash_attention.cu, and
csrc/flash_wgmma.cu for the wgmma body at head width 256), their wrappers
and their plain PyTorch versions.

`flash_attention_cached` replaces eagle_tpu/ops/pallas_attention.py:
_flash_kernel (via `flash_attention_cached`): decode, chain verify and the
EAGLE engine's prompt, with a bool mask computed outside. `flash_attention_
prefill` replaces `_flash_prefill_kernel` (via `flash_attention_prefill`):
the mask is rebuilt in the kernel from query positions and slot tags.

Bound on the H100: at decode and verify the bytes of K and V over [0,
s_limit) (5.0 us at S = 1024, 32 kv heads of 128, bf16); at T = S = 512 the
bytes too (7.5 us), if QK^T and PV run on the tensor cores (4.3 GFLOP, 4.4
us at 989 TFLOP/s); at Gemma-7B's 512-row prompt (D = 256) the bytes, 6.5
us, 16.8 MB of them the f32 q and output. `_plan` picks each call's body
and grid from the cache dtype and the shapes alone:
- a bf16 cache takes the tensor-core body: mma.sync bf16 products with the
  scores kept in registers, K/V tiles of 64 keys in a ring of shared memory
  filled by cp.async, blocks of 16, 32, 64 or 128 query rows (4 warps, 8
  at 128 rows; below 64 rows the warps of a 16-row tile split each key
  tile, so no warp works on rows that do not exist);
- flash_decode on a bf16 cache at D = 256 below 64 rows per kv head
  (decode, verify, trees) takes that body as "mma_cluster"
  (`_cluster_plan`): the q rows in shared memory, not registers, 16- or
  32-row blocks (a warp holding all keys of 16 rows would spill under the
  mask reads), a ring of three stages, and at most 8 key splits that form
  one thread-block cluster and merge over distributed shared memory in the
  same launch, in split order (no combine kernel);
- at D = 256 on a bf16 cache, flash_prefill and flash_decode at 64 rows per
  kv head and more (the EAGLE engine's prompt) take the wgmma body
  (csrc/flash_wgmma.cu, `_wg_plan`): 64-row blocks of one consumer
  warpgroup and a producer warp, one wave without a key split at Gemma's
  prompts, K/V tiles by TMA under mbarriers, S and O in wgmma accumulators,
  tile n's QK^T and softmax beside tile n - 1's PV, and the key tiles that
  no row of a block sees skipped, exactly (rule B from the tags, rule M
  from the mask; `tile_reads` and `tile_reads_mask` are their mirrors);
- an f32 cache takes the SIMT body (exact f32 FMAs, 32-key tiles), so the
  f32 path's numbers stay those of an f32 dot (one row per warp at D = 256).
Both take head widths 64, 128 and 256 (`HEAD_DIMS`); the model reads any
other width through the plain `gqa_attention`, as the reference does.
Both split the key range across blocks (flash-decoding) when the query rows
alone give fewer than 132 blocks (the wgmma body: see `_wg_plan`), merging
the splits with a combine kernel ("mma_cluster": in the launch).
The cache may be a view whose batch rows are apart (the batcher's row of a
[L, B, ...] cache, `KVCache.row`): the kernels take the batch stride, and
each row's [H_kv, S, D] must be contiguous.
The TPU gates (`supports_flash`: S >= 512, T*g <= 256;
`supports_flash_prefill`: T >= 256) and the pad of T*g to 8 rows do not
carry over: on the card every attention of the slice's path takes one of
these two kernels."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from .attention import gqa_attention

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
             + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
_SMS = 132
_WARPS = 4  # warps per block (csrc/flash_attention.cu)
_TILE = 32  # SIMT body: keys per tile
_KEYS = 64  # tensor-core body: keys per ring tile
_ROW_BLOCKS = (128, 64, 32, 16)  # tensor-core body: query rows per block, largest first
_ROW_BLOCKS_256 = (32, 16)  # flash_decode at D = 256 below 64 rows ("mma_cluster")
_MAX_CLUSTER = 8  # "mma_cluster": key splits a cluster (the portable cluster size)
#: "mma_cluster": clusters of c blocks, one block an SM (the body's shared
#: memory), that the H100 80GB HBM3 runs at once, as `cluster_wave` reads them
#: there at 16 and 32 rows (cudaOccupancyMaxActiveClusters; chip_smoke.py prints
#: them beside this table; its SMs sit in GPCs of 14 to 18, so 15 clusters of 8
#: fit, not 16)
_CLUSTER_WAVE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
HEAD_DIMS = (64, 128, 256)  # the head widths both kernels take
_TWO_BLOCK_SMEM = 115712  # a ring that lets two blocks share an SM
_MAX_SMEM = 232448  # what one block may opt into
_WG_ROWS = 64  # the wgmma body (bf16, D = 256): query rows per block
_WG_MAX_KEYS = 32 * 256 * 64  # keys a split: the body's 256 words of skip bits, one per tile


def _wg_smem(mask: bool) -> int:
    """csrc/flash_wgmma.cu:WgShape::kSmem: the q rows [64][256] bf16, the ring
    (K and V [64][256] bf16 a stage: 3 stages for flash_prefill, 2 for
    flash_decode) with each stage's 64 tags or [64][64]-byte mask tile, 16
    bytes of flags, 1 KB of skip bits, a full and an empty mbarrier a stage,
    1 KB to align the base."""
    stages, extra = (2, 64 * _KEYS) if mask else (3, _KEYS * 4)
    return 64 * 256 * 2 + stages * (2 * _KEYS * 256 * 2 + extra + 16) + 16 + 1024 + 1024


_WG_SMEM = _wg_smem(False)  # flash_prefill
_WG_SMEM_MASK = _wg_smem(True)  # flash_decode


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


#: the bodies, in the order of csrc/flash_attention.cu's enum Body (the
#: launch routes on the index): "simt" (f32 cache), "mma" (bf16, mma.sync),
#: "mma_cluster" (the same body, its key splits merged in the launch: bf16
#: flash_decode at D = 256 below 64 rows), "wgmma" (bf16 at D = 256:
#: flash_prefill, flash_decode at 64 rows and more)
_BODIES = ("simt", "mma", "mma_cluster", "wgmma")


class Plan(NamedTuple):
    body: str  # one of _BODIES
    rows_per_block: int
    splits: int
    keys_per_split: int
    smem_bytes: int  # dynamic shared memory (the SIMT body sizes its own)


def _row_block(tg: int, blocks: tuple) -> int:
    """The largest row block that leaves no 16-row warp tile wholly padded."""
    return next(r for r in blocks if _cdiv(tg, r) * r - tg < 16)


def _plan(tg: int, lim: int, d: int, dtype: torch.dtype, units: int, tags: bool) -> Plan:
    """Body, block and key split of one call: `tg` = T*g query rows per kv
    head, keys [0, lim), head_dim d, cache dtype, `units` = B*H_kv, `tags`
    for flash_prefill. Splits are whole tiles, none empty."""
    if dtype == torch.bfloat16 and d > 128:
        if tags or tg >= _WG_ROWS:
            return _wg_plan(tg, lim, units, mask=not tags)
        return _cluster_plan(tg, lim, d, units)
    if dtype == torch.bfloat16:
        rb = _row_block(tg, _ROW_BLOCKS)
        tile = _KEYS
    else:
        rb = _WARPS * (1 if tg <= 2 * _WARPS or d > 128 else 4)
        tile = _TILE
    warps = max(_WARPS, rb // 16) if dtype == torch.bfloat16 else _WARPS
    blocks = units * _cdiv(tg, rb) * warps // _WARPS  # in blocks of 4 warps
    splits = 1
    if dtype != torch.bfloat16 or blocks < _SMS:  # aim at ~2 blocks per SM
        splits = max(1, min(_cdiv(2 * _SMS, blocks), _cdiv(lim, tile)))
    kps = _cdiv(_cdiv(lim, splits), tile) * tile
    splits = _cdiv(lim, kps)
    if dtype != torch.bfloat16:
        return Plan("simt", rb, splits, kps, 0)
    # csrc/flash_attention.cu:TcShape: K and V [64][d] bf16 per stage, then
    # the mask tile [rb][64] bytes or 64 int32 tags; a third stage where it
    # fits beside a second block (one block's limit at 128 rows)
    stage = 2 * _KEYS * d * 2 + (_KEYS * 4 if tags else rb * _KEYS)
    stages = 3 if 3 * stage <= (_MAX_SMEM if rb > 64 else _TWO_BLOCK_SMEM) else 2
    merge = warps * 16 * (d + 4 + 2) * 4
    return Plan("mma", rb, splits, kps, max(stages * stage, merge))


def _cluster_plan(tg: int, lim: int, d: int, units: int) -> Plan:
    """flash_decode's tensor-core body at D = 256 below 64 rows ("mma_cluster"):
    16- or 32-row blocks of 4 warps, one to an SM; the splits of a row block
    (whole tiles, none empty) form one cluster and merge in the launch. As
    many splits as keep every cluster in one wave (`_CLUSTER_WAVE`), at most
    8 and one a tile: at Gemma-2-9B's decode (8 kv heads, 1,024 keys) 8 x 8
    blocks of two tiles, at Gemma-2B's (1 kv head) 8; at Gemma-7B's 16 kv
    heads 16 x 6 blocks of up to three tiles (on the H100 0.0082 ms, against
    0.0119 with 16 clusters of 8 in two waves and 0.0086 with 4: PERF.md §6)."""
    rb = _row_block(tg, _ROW_BLOCKS_256)
    clusters = units * _cdiv(tg, rb)
    tiles = _cdiv(lim, _KEYS)
    splits = max((c for c in range(1, _MAX_CLUSTER + 1)
                  if c <= tiles and clusters <= _CLUSTER_WAVE[c]), default=1)
    kps = _cdiv(_cdiv(lim, splits), _KEYS) * _KEYS
    # csrc/flash_attention.cu:TcShape at D = 256: three stages of K and V
    # [64][d] bf16 and the mask tile [rb][64] bytes, the q rows [rb][d] bf16
    # after them (after the loop: the warps' merge [4][16][d + 6] f32, then
    # the block's rows [rb][d + 2] f32 for the cluster's), a stage's
    # mbarrier, 1 KB to align the base
    stage = 2 * _KEYS * d * 2 + rb * _KEYS
    merge = 4 * 16 * (d + 4 + 2) * 4 + rb * (d + 2) * 4
    smem = max(3 * stage + rb * d * 2, merge) + 3 * 8 + 1024
    return Plan("mma_cluster", rb, _cdiv(lim, kps), kps, smem)


def _wg_plan(tg: int, lim: int, units: int, mask: bool = False) -> Plan:
    """The wgmma body (bf16 cache, D = 256; flash_decode's with `mask`, else
    flash_prefill's): 64-row blocks, one per SM. The keys are split only
    where the row blocks alone would leave most SMs idle (at most half of
    them busy) and a block's key tiles outnumber the blocks; then into as
    many whole-tile splits as keep the grid within one wave of 132 blocks.
    Below that the splits' round trip of (m, l, acc) through memory and the
    combine kernel cost more than the idle SMs: on the H100 a 512-row
    Gemma-2B prompt (64 blocks, 8 tiles)
    takes 0.0120 ms unsplit and 0.0265 in two, a 256-row chat feed over
    1,024 slots (64 blocks, 16 tiles) 0.0167 and 0.0323, while a 16-row feed
    over 1,024 (16 blocks) takes 0.0131 in 8 against 0.0185 unsplit, and 256
    rows over 4,096 slots (64 blocks, 64 tiles) 0.0681 in 2 against 0.0805
    (PERF.md §6). A split holds at most `_WG_MAX_KEYS` keys."""
    blocks = units * _cdiv(tg, _WG_ROWS)
    tiles = _cdiv(lim, _KEYS)
    splits = 1
    if 2 * blocks <= _SMS and tiles >= blocks:
        splits = min(_SMS // blocks, tiles)
    splits = max(splits, _cdiv(lim, _WG_MAX_KEYS))
    kps = _cdiv(_cdiv(lim, splits), _KEYS) * _KEYS
    return Plan("wgmma", _WG_ROWS, _cdiv(lim, kps), kps, _WG_SMEM_MASK if mask else _WG_SMEM)


def cluster_wave(rows_per_block: int) -> dict[int, int]:
    """Clusters of c = 1 to 8 blocks of the "mma_cluster" body at
    `rows_per_block` (16 or 32) rows that the card runs at once
    (cudaOccupancyMaxActiveClusters): what `_CLUSTER_WAVE` holds for the
    H100 80GB HBM3."""
    fn = _build.kernel("flash_cluster_wave", [ctypes.c_int, ctypes.c_int])
    wave = {c: fn(rows_per_block, c) for c in range(1, _MAX_CLUSTER + 1)}
    if min(wave.values()) < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed at {rows_per_block} rows")
    return wave


def tile_reads(q_pos: torch.Tensor, slot_pos: torch.Tensor, lim: int, g: int,
               rows_per_block: int = _WG_ROWS) -> torch.Tensor:
    """Which 64-key tiles of [0, lim) the wgmma body reads, as a bool
    [B, row blocks, tiles] (csrc/flash_wgmma.cu, rule B): a block of
    `rows_per_block` query rows (row r = t*g + i reads q_pos[:, t]) skips a
    tile iff every real row of the block sees some key (its q_pos >= 0 and
    >= the least non-negative tag of [0, lim)) and the tile's least
    non-negative tag is greater than the block's greatest q_pos. Key splits
    do not change it: they are whole tiles."""
    big = 2**40  # above any tag or position
    b, n_t = q_pos.shape
    n_tiles = _cdiv(lim, _KEYS)
    n_blocks = _cdiv(n_t * g, rows_per_block)
    tags = slot_pos[:, :lim].long()
    least = torch.full((b, n_tiles * _KEYS), big, dtype=torch.long, device=tags.device)
    least[:, :lim] = torch.where(tags >= 0, tags, big)
    tile_min = least.view(b, n_tiles, _KEYS).amin(dim=2)  # [B, tiles]
    seen_min = least.amin(dim=1)  # [B]
    rows = q_pos.long().repeat_interleave(g, dim=1)  # [B, T*g]: row r = t*g + i
    lo = torch.full((b, n_blocks * rows_per_block), big, dtype=torch.long, device=rows.device)
    hi = torch.full_like(lo, -big)
    lo[:, :n_t * g] = rows
    hi[:, :n_t * g] = rows
    lo = lo.view(b, n_blocks, -1).amin(dim=2)
    hi = hi.view(b, n_blocks, -1).amax(dim=2)
    may_skip = (lo >= 0) & (lo >= seen_min[:, None])  # [B, blocks]
    return ~(may_skip[:, :, None] & (tile_min[:, None, :] > hi[:, :, None]))


def tile_reads_mask(mask: torch.Tensor, g: int, rows_per_block: int = _WG_ROWS) -> torch.Tensor:
    """Which 64-key tiles of [0, lim) flash_decode's wgmma body reads under
    the bool `mask` [B, T, lim], as a bool [B, row blocks, tiles]
    (csrc/flash_wgmma.cu, rule M): a block of `rows_per_block` query rows
    (row r = t*g + i reads mask row t; rows past T*g are not real) skips a
    tile iff no real row of the block sees a key of the tile and every real
    row of the block sees some key of [0, lim). Key splits do not change
    it: they are whole tiles."""
    b, n_t, lim = mask.shape
    n_tiles = _cdiv(lim, _KEYS)
    n_blocks = _cdiv(n_t * g, rows_per_block)
    tiles = torch.zeros((b, n_t, n_tiles * _KEYS), dtype=torch.bool, device=mask.device)
    tiles[:, :, :lim] = mask
    tile_any = tiles.view(b, n_t, n_tiles, _KEYS).any(dim=3)  # [B, T, tiles]
    pad = n_blocks * rows_per_block - n_t * g  # rows past T*g: no tile, no veto on skipping
    rows_any = F.pad(tile_any.repeat_interleave(g, dim=1), (0, 0, 0, pad))
    rows_see = F.pad(mask.any(dim=2).repeat_interleave(g, dim=1), (0, pad), value=True)
    seen = rows_any.view(b, n_blocks, rows_per_block, n_tiles).any(dim=2)
    may_skip = rows_see.view(b, n_blocks, rows_per_block).all(dim=2)
    return ~(may_skip[:, :, None] & ~seen)


def flash_attention_cached_plain(q, k_cache, v_cache, mask, layer, scale=None, s_limit=None):
    """Plain version of `flash_decode`: `gqa_attention` over the layer's
    cache slots [0, s_limit)."""
    _build.plain_calls["flash_decode"] += 1
    lim = s_limit or k_cache.shape[3]
    return gqa_attention(q, k_cache[layer, :, :, :lim], v_cache[layer, :, :, :lim],
                         mask, scale=scale)


def flash_attention_prefill_plain(q, k_cache, v_cache, q_pos, slot_pos, layer,
                                  scale=None, s_limit=None):
    """Plain version of `flash_prefill`: the tag mask (slot visible iff its
    tag is >= 0 and <= the query position) then `gqa_attention`."""
    _build.plain_calls["flash_prefill"] += 1
    lim = s_limit or k_cache.shape[3]
    tags = slot_pos[:, :lim]
    mask = (tags[:, None, :] >= 0) & (tags[:, None, :] <= q_pos[:, :, None])
    return gqa_attention(q, k_cache[layer, :, :, :lim], v_cache[layer, :, :, :lim],
                         mask, scale=scale)


def _launch(tags: bool, q, k_cache, v_cache, layer: int, scale, s_limit,
            mask=None, q_pos=None, slot_pos=None):
    fn = _build.kernel("flash_launch", _ARGTYPES)
    b, t, h, d = q.shape
    n_layers, cb, h_kv, s_full, dk = k_cache.shape
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError("k and v caches must share shape and dtype")
    if (cb, dk) != (b, d) or h % h_kv or d not in HEAD_DIMS:
        raise ValueError(f"shapes q {tuple(q.shape)} / cache {tuple(k_cache.shape)} "
                         f"not taken (head_dim must be one of {HEAD_DIMS})")
    if k_cache.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cache dtype {k_cache.dtype} not taken")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} outside the cache's {n_layers}")
    lim = s_limit or s_full
    if not 0 < lim <= s_full:
        raise ValueError(f"s_limit {lim} outside (0, {s_full}]")
    row = (h_kv * s_full * dk, s_full * dk, dk, 1)  # a batch row's strides, contiguous
    batch_stride = k_cache.stride(1)
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.device != q.device or x.stride()[2:] != row[1:] or x.stride(1) != batch_stride:
            raise ValueError(f"{name} must be on {q.device} with contiguous batch rows "
                             f"(strides {x.stride()})")
        if x.stride(0) < cb * row[0] and n_layers > 1 or batch_stride < row[0] and cb > 1:
            raise ValueError(f"{name}'s layers or batch rows overlap (strides {x.stride()})")
        if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or batch_stride % 8):
            raise ValueError(f"{name}'s rows must start on 16-byte boundaries")  # cp.async
    for name, x in (("mask", mask), ("q_pos", q_pos), ("slot_pos", slot_pos)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    qf = q.float().contiguous()
    if qf.data_ptr() % 16:  # a view at an odd offset: the kernel reads float2 pairs
        qf = qf.clone()
    if tags:
        if q_pos.shape != (b, t) or slot_pos.shape[0] != b or slot_pos.shape[1] < lim:
            raise ValueError("q_pos must be [B, T] and slot_pos [B, >= s_limit]")
        q_pos = q_pos.to(torch.int32).contiguous()
        if slot_pos.dtype != torch.int32 or slot_pos.stride(1) != 1:
            slot_pos = slot_pos.to(torch.int32).contiguous()
        tag_stride = slot_pos.stride(0)
    else:
        if mask.shape != (b, t, lim) or mask.dtype != torch.bool:
            raise ValueError(f"mask must be bool [B, T, s_limit], got {tuple(mask.shape)}")
        mask = mask.contiguous().view(torch.uint8)
        tag_stride = 0
    tg = t * (h // h_kv)
    plan = _plan(tg, lim, d, k_cache.dtype, b * h_kv, tags)
    splits = plan.splits
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    part = [None, None, None]
    if splits > 1 and plan.body != "mma_cluster":  # "mma_cluster" merges in the launch
        part = [torch.empty((splits, b, h_kv, tg), dtype=torch.float32, device=q.device),
                torch.empty((splits, b, h_kv, tg), dtype=torch.float32, device=q.device),
                torch.empty((splits, b, h_kv, tg, d), dtype=torch.float32, device=q.device)]
    layer_off = layer * k_cache.stride(0) * k_cache.element_size()
    rc = fn(
        int(tags), qf.data_ptr(),
        k_cache.data_ptr() + layer_off, v_cache.data_ptr() + layer_off,
        None if tags else mask.data_ptr(),
        q_pos.data_ptr() if tags else None, slot_pos.data_ptr() if tags else None,
        out.data_ptr(), *[None if p is None else p.data_ptr() for p in part],
        b, t, h, h_kv, d, s_full, lim, tag_stride,
        _BODIES.index(plan.body), plan.rows_per_block, splits,
        plan.keys_per_split, plan.smem_bytes, batch_stride,
        float(d**-0.5 if scale is None else scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_launch")
    _build.launches["flash_prefill" if tags else "flash_decode"] += 1
    if not tags and plan.body in ("mma_cluster", "wgmma"):  # the D = 256 routes, counted apart too
        _build.launches[f"flash_decode_{plan.body}"] += 1
    return out


def flash_attention_cached(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [L, B, H_kv, S, D]
    v_cache: torch.Tensor,
    mask: torch.Tensor,  # [B, T, s_limit] bool
    layer: int,
    scale: float | None = None,
    s_limit: int | None = None,
) -> torch.Tensor:
    """[B, T, H, D] f32 attention of q over cache slots [0, s_limit) of
    `layer` under `mask`. CPU tensors take the plain version; CUDA tensors
    launch `flash_decode`."""
    if q.device.type == "cpu":
        return flash_attention_cached_plain(q, k_cache, v_cache, mask, layer, scale, s_limit)
    return _launch(False, q, k_cache, v_cache, layer, scale, s_limit, mask=mask)


def flash_attention_prefill(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [L, B, H_kv, S, D]
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,  # [B, T] int32 query positions
    slot_pos: torch.Tensor,  # [B, S] int32 cache tags (-1 empty)
    layer: int,
    scale: float | None = None,
    s_limit: int | None = None,
) -> torch.Tensor:
    """Causal attention over the tagged cache with the mask rebuilt from
    tags in the kernel. CPU tensors take the plain version; CUDA tensors
    launch `flash_prefill`."""
    if q.device.type == "cpu":
        return flash_attention_prefill_plain(q, k_cache, v_cache, q_pos, slot_pos, layer,
                                             scale, s_limit)
    return _launch(True, q, k_cache, v_cache, layer, scale, s_limit,
                   q_pos=q_pos, slot_pos=slot_pos)

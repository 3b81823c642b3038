"""The port's plain attention versions (the CPU path and the plain versions
of the flash_decode / flash_prefill CUDA kernels) against the JAX Pallas
flash kernels run in interpret mode: decode T=1 and chain verify T=K+1,
GQA g=2, tag masks with rolled-back holes, an s_limit read bound, and
prefill rows with q_pos = -1 (they see nothing and come out as the uniform
average of V, in both); at head widths 64 and 256 (the reference's kernels
take any `d % 128 == 0`, so a Gemma model reaches them at 256).

Tolerance: f32 cache, rtol 1e-5 (the online softmax and the one-pass
softmax sum in another order). A bf16 cache rounds q and p to bf16 in both;
a p near a rounding boundary may land one bf16 ulp apart, hence 1e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.ops.pallas_attention import flash_attention_cached, flash_attention_prefill
from eagle_tpu.runtime.kvcache import causal_mask_from_tags
from eagle_tpu_torch import _build
from eagle_tpu_torch.ops import flash_attention as fa
from eagle_tpu_torch.ops.attention import gqa_attention
from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags as port_causal_mask
from torch_port_util import background_cpu  # noqa: F401  (background_cpu: a fixture)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

L, B, H, HKV, D, S = 3, 2, 4, 2, 64, 256
TOL = {"f32": 1e-5, "bf16": 1e-2}


def _cache(rng, dtype, d=D):
    k = rng.standard_normal((L, B, HKV, S, d)).astype(np.float32)
    v = rng.standard_normal((L, B, HKV, S, d)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    return jk, jv, torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)


def _tags(m: int, holes=()):
    """Slot tags after a prefill of m tokens with speculative rollback holes
    (slot == position; -1 = empty)."""
    tags = np.full((B, S), -1, np.int32)
    tags[:, :m] = np.arange(m)
    for h in holes:
        tags[:, h] = -1
    return tags


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t,s_limit", [(1, None), (6, None), (1, 128), (6, 128)])
def test_decode_verify_matches_pallas(rng, dtype, t, s_limit):
    _decode_verify_case(rng, dtype, t, s_limit, D)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t,s_limit", [(1, None), (6, None), (1, 128), (6, 128), (32, None),
                                       (40, 128)])
def test_decode_verify_matches_pallas_at_head_width_256(rng, dtype, t, s_limit):
    """The same cases at D = 256 (Gemma's width), against `_flash_call` in
    interpret mode at that width; T = 32 and 40 give 64 and 80 rows per kv
    head (g = 2), which the card's wgmma body takes (fewer: the cluster
    body)."""
    _decode_verify_case(rng, dtype, t, s_limit, 256)


def _decode_verify_case(rng, dtype, t, s_limit, d):
    jk, jv, tk, tv = _cache(rng, dtype, d)
    m = 90
    tags = _tags(m + t, holes=(17, 18, 40))  # rolled-back rows stay tagged -1
    q_pos = (m + np.arange(t, dtype=np.int32))[None].repeat(B, 0)
    lim = s_limit or S
    mask = np.array(causal_mask_from_tags(jnp.asarray(tags), jnp.asarray(q_pos)))[..., :lim]
    mask = np.ascontiguousarray(mask)
    mask[1, 0] = False  # one fully masked row: uniform average in both
    q = rng.standard_normal((B, t, H, d)).astype(np.float32)
    want = flash_attention_cached(jnp.asarray(q), jk, jv, jnp.asarray(mask), jnp.int32(1),
                                  interpret=True, s_limit=s_limit)
    before = _build.plain_calls["flash_decode"]
    got = fa.flash_attention_cached(torch.from_numpy(q), tk, tv, torch.from_numpy(mask), 1,
                                    s_limit=s_limit)
    assert _build.plain_calls["flash_decode"] == before + 1
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s_limit", [None, 128])
def test_prefill_matches_pallas(rng, dtype, s_limit):
    _prefill_case(rng, dtype, s_limit, D)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s_limit", [None, 128])
def test_prefill_matches_pallas_at_head_width_256(rng, dtype, s_limit):
    """The same cases at D = 256, against `_flash_prefill_call` in
    interpret mode at that width."""
    _prefill_case(rng, dtype, s_limit, 256)


def _prefill_case(rng, dtype, s_limit, d):
    jk, jv, tk, tv = _cache(rng, dtype, d)
    t, n = 32, 27  # a padded prompt bucket: rows >= n are padding
    tags = _tags(n)
    q_pos = np.arange(t, dtype=np.int32)[None].repeat(B, 0)
    q_pos[:, n + 2:] = -1  # padded query rows that see nothing
    q = rng.standard_normal((B, t, H, d)).astype(np.float32)
    want = flash_attention_prefill(jnp.asarray(q), jk, jv, jnp.asarray(q_pos),
                                   jnp.asarray(tags), jnp.int32(2), interpret=True,
                                   s_limit=s_limit)
    before = _build.plain_calls["flash_prefill"]
    got = fa.flash_attention_prefill(torch.from_numpy(q), tk, tv, torch.from_numpy(q_pos),
                                     torch.from_numpy(tags), 2, s_limit=s_limit)
    assert _build.plain_calls["flash_prefill"] == before + 1
    _close(got, want, dtype)
    # a row with q_pos = -1 is the uniform average of V over [0, s_limit)
    lim = s_limit or S
    uniform = tv[2, :, :, :lim].float().mean(dim=2)  # [B, H_kv, D]
    np.testing.assert_allclose(got[:, -1].numpy(),
                               uniform.repeat_interleave(H // HKV, dim=1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_prefill_equals_decode_kernel_plain_on_tag_mask(rng):
    """The two plain versions agree where the mask is the tag mask."""
    _, _, tk, tv = _cache(rng, "f32")
    tags = _tags(40, holes=(5,))
    q_pos = np.arange(8, 16, dtype=np.int32)[None].repeat(B, 0)
    mask = causal_mask_from_tags(jnp.asarray(tags), jnp.asarray(q_pos))
    q = torch.from_numpy(rng.standard_normal((B, 8, H, D)).astype(np.float32))
    a = fa.flash_attention_cached(q, tk, tv, torch.from_numpy(np.array(mask)), 0)
    b = fa.flash_attention_prefill(q, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(tags), 0)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# --- GQA g = 4 and s_limit = 300 ----------------------------------------------

H4, S4 = 8, 384  # 8 query heads over 2 kv heads (g = 4), 384 slots


def _cache_g4(rng, dtype):
    k = rng.standard_normal((L, B, HKV, S4, D)).astype(np.float32)
    v = rng.standard_normal((L, B, HKV, S4, D)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    return (jnp.asarray(k, jdt), jnp.asarray(v, jdt), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt))


def _tags_g4(m: int):
    tags = np.full((B, S4), -1, np.int32)
    tags[:, :m] = np.arange(m)
    tags[:, 17:19] = -1  # rolled-back holes
    return tags


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 6])
@pytest.mark.parametrize("s_limit", [256, None])
def test_decode_gqa4_matches_pallas(rng, dtype, t, s_limit):
    """g = 4 (T*g = 4 and 24 rows) with a fully masked row, at read bounds
    that are whole 128-key tiles of the reference kernel."""
    jk, jv, tk, tv = _cache_g4(rng, dtype)
    m = 200
    tags = _tags_g4(m + t)
    q_pos = (m + np.arange(t, dtype=np.int32))[None].repeat(B, 0)
    lim = s_limit or S4
    mask = np.ascontiguousarray(
        np.array(causal_mask_from_tags(jnp.asarray(tags), jnp.asarray(q_pos)))[..., :lim])
    mask[1, t - 1] = False
    q = rng.standard_normal((B, t, H4, D)).astype(np.float32)
    want = flash_attention_cached(jnp.asarray(q), jk, jv, jnp.asarray(mask), jnp.int32(1),
                                  interpret=True, s_limit=s_limit)
    got = fa.flash_attention_cached(torch.from_numpy(q), tk, tv, torch.from_numpy(mask), 1,
                                    s_limit=s_limit)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_gqa4_matches_pallas(rng, dtype):
    jk, jv, tk, tv = _cache_g4(rng, dtype)
    t, n = 24, 20  # 96 rows: a 64-row tile and a ragged one
    tags = _tags_g4(n)
    q_pos = np.arange(t, dtype=np.int32)[None].repeat(B, 0)
    q_pos[:, n:] = -1
    q_pos[0, 5] = -1  # a row inside the tile that sees nothing
    q = rng.standard_normal((B, t, H4, D)).astype(np.float32)
    want = flash_attention_prefill(jnp.asarray(q), jk, jv, jnp.asarray(q_pos),
                                   jnp.asarray(tags), jnp.int32(0), interpret=True)
    got = fa.flash_attention_prefill(torch.from_numpy(q), tk, tv, torch.from_numpy(q_pos),
                                     torch.from_numpy(tags), 0)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_s_limit_300_matches_pallas_on_visible_keys(rng, dtype, kind):
    """s_limit = 300 at g = 4 with visible keys up to slot 299. The reference
    kernel reads whole 128-key tiles below s_limit (see the next test), so it
    runs here at 384 with slots [300, 384) invisible: every row that sees a
    key agrees. A row that sees nothing is the uniform average of V over
    [0, 300) in the port."""
    jk, jv, tk, tv = _cache_g4(rng, dtype)
    t, lim = 6, 300
    tags = _tags_g4(S4)
    q_pos = (294 + np.arange(t, dtype=np.int32))[None].repeat(B, 0)
    q = rng.standard_normal((B, t, H4, D)).astype(np.float32)
    tq = torch.from_numpy(q)
    if kind == "decode":
        mask = np.array(causal_mask_from_tags(jnp.asarray(tags), jnp.asarray(q_pos)))
        mask[:, :, lim:] = False
        mask[1, 2] = False
        want = flash_attention_cached(jnp.asarray(q), jk, jv, jnp.asarray(mask), jnp.int32(1),
                                      interpret=True, s_limit=S4)
        got = fa.flash_attention_cached(tq, tk, tv, torch.from_numpy(
            np.ascontiguousarray(mask[..., :lim])), 1, s_limit=lim)
    else:
        q_pos[1, 2] = -1
        ref_tags = tags.copy()
        ref_tags[:, lim:] = -1
        want = flash_attention_prefill(jnp.asarray(q), jk, jv, jnp.asarray(q_pos),
                                       jnp.asarray(ref_tags), jnp.int32(1), interpret=True,
                                       s_limit=S4)
        got = fa.flash_attention_prefill(tq, tk, tv, torch.from_numpy(q_pos),
                                         torch.from_numpy(tags), 1, s_limit=lim)
    keep = np.ones((B, t), bool)
    keep[1, 2] = False
    _close(got[torch.from_numpy(keep)], np.asarray(want)[keep], dtype)
    uniform = tv[1, 1, :, :lim].float().mean(dim=1).repeat_interleave(H4 // HKV, dim=0)
    _close(got[1, 2], uniform.numpy(), dtype)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_pallas_reads_whole_tiles_below_s_limit(rng, kind):
    """The reference's divergence at an s_limit that is not a multiple of its
    128-key tile: `_flash_call` / `_flash_prefill_call` run s_limit // 128
    tiles, so at 300 they read slots [0, 256) only, which is the port's
    plain version at s_limit = 256. The reference's callers pass buckets of
    128 x 2^k, where the two agree; the port reads [0, s_limit) exactly."""
    jk, jv, tk, tv = _cache_g4(rng, "f32")
    t = 6
    tags = _tags_g4(S4)
    q_pos = (290 + np.arange(t, dtype=np.int32))[None].repeat(B, 0)
    q = rng.standard_normal((B, t, H4, D)).astype(np.float32)
    tq = torch.from_numpy(q)
    if kind == "decode":
        mask = np.array(causal_mask_from_tags(jnp.asarray(tags), jnp.asarray(q_pos)))
        want = flash_attention_cached(jnp.asarray(q), jk, jv, jnp.asarray(mask[..., :300]),
                                      jnp.int32(0), interpret=True, s_limit=300)
        at_256 = fa.flash_attention_cached(tq, tk, tv, torch.from_numpy(
            np.ascontiguousarray(mask[..., :256])), 0, s_limit=256)
        at_300 = fa.flash_attention_cached(tq, tk, tv, torch.from_numpy(
            np.ascontiguousarray(mask[..., :300])), 0, s_limit=300)
    else:
        want = flash_attention_prefill(jnp.asarray(q), jk, jv, jnp.asarray(q_pos),
                                       jnp.asarray(tags), jnp.int32(0), interpret=True,
                                       s_limit=300)
        args = (tq, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(tags), 0)
        at_256 = fa.flash_attention_prefill(*args, s_limit=256)
        at_300 = fa.flash_attention_prefill(*args, s_limit=300)
    _close(at_256, want, "f32")
    assert float(np.abs(at_300.numpy() - np.asarray(want)).max()) > 1e-2


# --- the wrapper's launch plan (pure Python; the card runs what it says) -------

SMS, SMEM_BLOCK, SMEM_SM = 132, 227 * 1024, 228 * 1024


@pytest.mark.parametrize("tags", [False, True], ids=["decode", "prefill"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lim", [96, 300, 512, 1024])
@pytest.mark.parametrize("tg", [1, 6, 24, 80, 512])
def test_plan_covers_keys_and_card(tg, lim, d, dtype, tags):
    """At the main path's 32 kv heads: the body follows the dtype, the splits
    cover [0, lim) in whole tiles with none empty, the grid reaches 132
    blocks of 4 warps where the keys allow it (a 128-row block has 8 warps),
    no 16-row warp tile of the tensor-core body is only padding, and the
    shared memory fits (two tensor-core blocks per SM below 128 rows)."""
    units = 32
    plan = fa._plan(tg, lim, d, dtype, units, tags)
    tile = 64 if dtype == torch.bfloat16 else 32
    assert plan.body == ("mma" if dtype == torch.bfloat16 else "simt")
    assert plan.keys_per_split % tile == 0
    assert (plan.splits - 1) * plan.keys_per_split < lim <= plan.splits * plan.keys_per_split
    warps = max(4, plan.rows_per_block // 16) if plan.body == "mma" else 4
    blocks = units * -(-tg // plan.rows_per_block) * plan.splits * warps // 4
    assert blocks >= SMS or plan.splits == -(-lim // tile)
    if plan.body == "mma":
        assert plan.rows_per_block in (16, 32, 64, 128)
        assert -(-tg // plan.rows_per_block) * plan.rows_per_block - tg < 16
        assert plan.smem_bytes <= SMEM_BLOCK
        if plan.rows_per_block < 128:
            assert 2 * (plan.smem_bytes + 1024) <= SMEM_SM
        stage = 2 * 64 * d * 2 + (256 if tags else plan.rows_per_block * 64)
        assert plan.smem_bytes >= 2 * stage  # a K/V ring of at least two tiles
    else:
        assert plan.rows_per_block in (4, 16) and plan.smem_bytes == 0


def _stage(d: int, rows: int, tags: bool) -> int:
    """Bytes of one ring stage: K and V [64][d] bf16, then 64 int32 tags or
    the mask tile [rows][64]."""
    return 2 * 64 * d * 2 + (256 if tags else rows * 64)


def _wg_smem(mask: bool = False) -> int:
    """Shared memory of the wgmma body (csrc/flash_wgmma.cu): the q rows
    [64][256] bf16, the stages of K and V [64][256] bf16 (flash_prefill
    three, each with its 64 int32 tags; flash_decode two, each with its mask
    tile of 64 t rows x 64 keys), 16 bytes of flags, 1 KB of skip bits (one
    per tile of a split), a full and an empty mbarrier a stage, 1 KB to
    align the base."""
    stages, extra = (2, 64 * 64) if mask else (3, 64 * 4)
    return 64 * 256 * 2 + stages * (2 * 64 * 256 * 2 + extra) + 16 + 1024 + stages * 16 + 1024


def _cluster_smem(rows: int) -> int:
    """Shared memory of flash_decode's tensor-core body at D = 256 below 64
    rows (csrc/flash_attention.cu:TcShape): three ring stages and the q rows
    [rows][256] bf16, which hold more than what the loop's end reuses them
    for (the warps' merge [4][16][262] f32, then the block's rows
    [rows][258] f32 for the cluster's merge), an mbarrier a stage and 1 KB
    to align the base."""
    ring = 3 * _stage(256, rows, False) + rows * 256 * 2
    assert ring >= 4 * 16 * 262 * 4 + rows * 258 * 4
    return ring + 3 * 8 + 1024


@pytest.mark.parametrize("tags", [False, True], ids=["decode", "prefill"])
def test_plan_at_head_width_256(tags):
    """D = 256 on the tensor cores, at Gemma-2B's 1, Gemma-2-9B's 8 and
    Gemma-7B's 16 kv-head units: every T·g in 1-4,096 at 15 read bounds,
    and every s_limit in 96-8,192 at 7 row counts. Each plan fits one
    block's shared memory and splits the keys into whole 64-key tiles that
    cover [0, s_limit) once, none empty. flash_prefill, and flash_decode at
    T·g >= 64, take the wgmma body: 64-row blocks, its own shared memory,
    and a grid within one wave of 132 blocks wherever it splits.
    flash_decode below 64 rows takes the mma.sync body with its splits
    merged in one cluster ("mma_cluster"): at most 32 rows a block, no
    16-row warp tile only padding, at most 8 splits and every cluster in one
    wave (`_CLUSTER_WAVE`, read on the card: at most 132 blocks in all, and
    no more clusters of c + 1 than of c) where the row blocks allow, a ring of three stages
    beside the block's q rows (bf16, after the ring)."""
    wave = fa._CLUSTER_WAVE
    assert sorted(wave) == list(range(1, 9)) and wave[1] == SMS
    assert all(c * wave[c] <= SMS and wave[c + 1] <= wave[c] for c in range(1, 8))
    cases = [(tg, lim) for tg in range(1, 4097)
             for lim in (96, 97, 127, 128, 300, 511, 512, 1000, 1024, 2047, 2048, 4096, 5000,
                         8191, 8192)]
    cases += [(tg, lim) for lim in range(96, 8193) for tg in (1, 6, 8, 16, 42, 512, 4096)]
    for units, (tg, lim) in ((u, c) for u in (1, 8, 16) for c in cases):
        plan = fa._plan(tg, lim, 256, torch.bfloat16, units, tags)
        rb, kps = plan.rows_per_block, plan.keys_per_split
        assert plan.smem_bytes <= SMEM_BLOCK, (tg, lim, plan)
        assert kps % 64 == 0 and (plan.splits - 1) * kps < lim <= plan.splits * kps
        if tags or tg >= 64:
            assert plan.body == "wgmma" and rb == 64, (tg, lim, plan)
            assert plan.smem_bytes == _wg_smem(mask=not tags)
            assert plan.splits == 1 or units * -(-tg // 64) * plan.splits <= SMS, (tg, lim, plan)
        else:
            assert plan.body == "mma_cluster" and rb in (32, 16)
            assert -(-tg // rb) * rb - tg < 16
            assert plan.smem_bytes == _cluster_smem(rb), (tg, lim, plan)
            clusters = units * -(-tg // rb)
            assert plan.splits <= 8 and clusters * plan.splits <= max(SMS, clusters)
            assert plan.splits == 1 or clusters <= wave[plan.splits], (tg, lim, plan)
            # as many splits as keep the clusters in one wave, at most 8 and one a
            # tile, in whole tiles
            want = max([c for c in range(1, 9) if c <= -(-lim // 64)
                        and clusters <= wave[c]], default=1)
            assert kps == -(-(-(-lim // want)) // 64) * 64, (tg, lim, plan)
    # a prompt: both kernels' 64-row wgmma blocks
    big = fa._plan(4096, 1024, 256, torch.bfloat16, 1, tags)
    assert big.rows_per_block == 64 and big.body == "wgmma"
    # the SIMT body (f32 cache) takes one row per warp at D = 256
    assert fa._plan(4096, 1024, 256, torch.float32, 1, tags).rows_per_block == 4


#: (query heads, KV heads) of the head-width-256 layouts (each config.json)
GEMMA_HEADS = {"gemma-7b": (16, 16), "gemma-2-9b": (16, 8), "gemma-2b": (8, 1)}


@pytest.mark.parametrize("model", sorted(GEMMA_HEADS))
def test_wgmma_plan_at_gemma_prompts_is_one_wave(model):
    """A 512-row prompt over 512 slots at each Gemma layout takes one wave
    of 64-row blocks (16 x 8 = 128, 8 x 16 = 128, 1 x 64 = 64) with no key
    split, so no combine kernel runs; its shared memory fits one block."""
    h, h_kv = GEMMA_HEADS[model]
    tg = 512 * (h // h_kv)
    plan = fa._plan(tg, 512, 256, torch.bfloat16, h_kv, True)
    assert plan == fa.Plan("wgmma", 64, 1, 512, _wg_smem())
    assert h_kv * -(-tg // 64) <= SMS and _wg_smem() <= SMEM_BLOCK


@pytest.mark.parametrize("tg,lim,units,splits", [
    (16, 1024, 16, 8),  # a 16-row feed: 16 blocks, 16 tiles
    (64, 1024, 16, 8),
    (64, 1024, 2, 16),  # 2 kv-head units: 2 blocks, 16 tiles
    (256, 4096, 16, 2),  # 256 rows over 4,096 slots: 64 blocks, 64 tiles
    (64, 4096, 16, 8),
    (128, 8192, 16, 4),
    (1, 96, 1, 2),  # one row over two tiles
    (256, 256, 16, 1),  # phase chat's feeds: 64 / 32 / 64 blocks, fewer tiles
    (128, 512, 16, 1),
    (256, 1024, 16, 1),
    (512, 1024, 8, 1),  # the same at g 2
    (4096, 8192, 1, 2),  # Gemma-2B's 64 blocks over 128 tiles: two splits
    (4096, 512, 1, 1),  # its prompt: 64 blocks over 8 tiles
    (8192, 8192, 1, 1),  # 128 blocks: most SMs busy
])
def test_wgmma_plan_splits(tg, lim, units, splits):
    """Where the wgmma body still splits its keys (the row blocks leave more
    than half the SMs idle and a block's key tiles outnumber the blocks),
    the splits are whole 64-key tiles that cover [0, lim) once, none empty,
    within one wave; elsewhere it does not split."""
    plan = fa._plan(tg, lim, 256, torch.bfloat16, units, True)
    blocks = units * -(-tg // 64)
    assert plan.splits == splits, plan
    assert plan.keys_per_split % 64 == 0
    assert (plan.splits - 1) * plan.keys_per_split < lim <= plan.splits * plan.keys_per_split
    assert blocks * plan.splits <= max(SMS, blocks)


@pytest.mark.parametrize("tg,lim,tags,want", [
    (1, 1024, False, (16, 8, 128)),  # decode: 32 heads x 8 splits = 256 blocks
    (6, 1024, False, (16, 8, 128)),  # chain verify
    (1, 512, False, (16, 8, 64)),
    (512, 512, False, (128, 1, 512)),  # the EAGLE engine's prompt: 128 blocks of 8 warps
    (512, 512, True, (128, 1, 512)),  # the greedy prompt
])
def test_plan_at_main_path_shapes(tg, lim, tags, want):
    """(rows per block, splits, keys per split) at Vicuna-7B's 32 kv heads of
    128; and the same calls at Gemma-7B's 16 kv heads of 256, where
    flash_decode below 64 rows merges its 8 splits in the launch and the
    prompts take one wave of 64-row wgmma blocks."""
    plan = fa._plan(tg, lim, 128, torch.bfloat16, 32, tags)
    assert (plan.rows_per_block, plan.splits, plan.keys_per_split) == want
    gemma = fa._plan(tg, lim, 256, torch.bfloat16, 16, tags)
    assert gemma[:4] == GEMMA7B_MAIN_PATH_PLANS[tg, lim, tags]


#: test_plan_at_main_path_shapes' calls at Gemma-7B's 16 kv heads of 256:
#: (body, rows per block, splits, keys per split)
GEMMA7B_MAIN_PATH_PLANS = {
    (1, 1024, False): ("mma_cluster", 16, 6, 192),  # 16 clusters of 6 in one wave, not 8
    (6, 1024, False): ("mma_cluster", 16, 6, 192),
    (1, 512, False): ("mma_cluster", 16, 4, 128),  # at most 6: two tiles a split
    (512, 512, False): ("wgmma", 64, 1, 512),  # the EAGLE engine's prompt: 16 x 8 blocks
    (512, 512, True): ("wgmma", 64, 1, 512),
}


#: T of the D = 256 flash_decode calls on the Gemma cells' paths: a decoded
#: token, a K = 5 verify, the static tree's and EAGLE-2's verifies, the
#: EAGLE engine's prompt bucket
GEMMA_DECODE_T = (1, 6, 29, 32, 512)
#: (body, rows per block, splits, keys per split) of those calls at S = 1,024
#: (the prompt at 512), per GEMMA_HEADS layout
GEMMA_DECODE_PLANS = {
    "gemma-7b": [("mma_cluster", 16, 6, 192), ("mma_cluster", 16, 6, 192),  # 16 clusters
                 ("mma_cluster", 32, 6, 192), ("mma_cluster", 32, 6, 192),
                 ("wgmma", 64, 1, 512)],
    "gemma-2-9b": [("mma_cluster", 16, 8, 128), ("mma_cluster", 16, 8, 128),  # 8 clusters
                   ("mma_cluster", 32, 6, 192), ("wgmma", 64, 16, 64),  # 8 blocks: 16 splits
                   ("wgmma", 64, 1, 512)],
    "gemma-2b": [("mma_cluster", 16, 8, 128), ("mma_cluster", 16, 8, 128),  # 48 rows: 3 blocks
                 ("wgmma", 64, 16, 64), ("wgmma", 64, 16, 64), ("wgmma", 64, 1, 512)],
}


@pytest.mark.parametrize("model", sorted(GEMMA_HEADS))
def test_decode_plan_at_gemma_shapes(model):
    """flash_decode at D = 256 on the Gemma layouts' paths: below 64 rows
    per kv head one launch of the cluster body (no combine kernel: its
    splits, at most 8, merge in the launch) within one wave; from 64 rows
    the wgmma body, one wave of 64-row blocks at the prompt, key splits
    (merged by the combine kernel) only where the row blocks leave most SMs
    idle. Each plan's shared memory is the body's."""
    h, h_kv = GEMMA_HEADS[model]
    g = h // h_kv
    for t, want in zip(GEMMA_DECODE_T, GEMMA_DECODE_PLANS[model]):
        lim = 512 if t == 512 else 1024
        plan = fa._plan(t * g, lim, 256, torch.bfloat16, h_kv, False)
        assert plan[:4] == want, (t, plan)
        rows = h_kv * -(-t * g // plan.rows_per_block)
        if plan.body == "mma_cluster":
            assert plan.smem_bytes == _cluster_smem(plan.rows_per_block)
            assert rows * plan.splits <= SMS and plan.splits <= 8
        else:
            assert plan.smem_bytes == _wg_smem(mask=True) <= SMEM_BLOCK
            assert rows * plan.splits <= SMS


# --- rule B: the key tiles the wgmma body skips (pure Python mirror) ------------


def _shifted_tags(rng, s: int, n: int) -> np.ndarray:
    """Tags of one row of a cache that has lived: n tokens written in slot
    order, a context shift (a kept prefix, a discarded span whose slots
    return to -1, the rest's tags lowered by the span), new tokens written
    into the freed slots with the highest tags (out of slot order), and
    rolled-back holes."""
    tags = np.full(s, -1, np.int64)
    tags[:n] = np.arange(n)
    keep = int(rng.integers(1, n // 2))
    span = int(rng.integers(1, n - keep))
    tags[keep:keep + span] = -1
    tags[keep + span:n] -= span
    top = n - span
    refill = int(rng.integers(0, span + 1))
    tags[keep:keep + refill] = top + np.arange(refill)
    holes = rng.choice(s, size=int(rng.integers(0, s // 8)), replace=False)
    tags[holes] = -1
    return tags


def _tag_case(seed: int, g: int, min_rows: int = 1):
    """q_pos [B, T] and tags [B, S] with out-of-order tags and holes: row 0
    sorted positions, row 1 random ones; at some seeds a q_pos = -1 row.
    T*g >= min_rows."""
    rng = np.random.default_rng(seed)
    b, s = 2, int(rng.integers(100, 400))
    t = int(rng.integers(-(-min_rows // g), 300 // g + 2))
    tags = np.stack([_shifted_tags(rng, s, int(rng.integers(8, s))) for _ in range(b)])
    top = int(tags.max()) + 1
    q_pos = np.stack([np.sort(rng.integers(0, top + 40, size=t)),
                      rng.integers(-1, top + 40, size=t)]).astype(np.int64)
    if seed % 3 == 0:
        q_pos[rng.integers(0, b), rng.integers(0, t)] = -1
    lim = int(rng.integers(1 if min_rows == 1 else 65, s + 1))
    return q_pos, tags, lim


def _brute_reads(q_pos, tags, lim, g, rows=64):
    """Which tiles a block must read, from the (query, key) visibility: a
    tile is skipped iff every row of the block sees some key of [0, lim)
    and no row of the block sees a key of the tile."""
    vis = (tags[:, None, :lim] >= 0) & (tags[:, None, :lim] <= q_pos[:, :, None])
    return _brute_reads_vis(vis, g, rows)


def _brute_reads_vis(vis, g, rows=64):
    """_brute_reads from the visibility [B, T, lim] itself."""
    b, t, lim = vis.shape
    n_blocks, n_tiles = -(-t * g // rows), -(-lim // 64)
    out = np.ones((b, n_blocks, n_tiles), bool)
    for bi in range(b):
        vis_r = np.repeat(vis[bi], g, axis=0)  # row r = t*g + i reads row t
        for blk in range(n_blocks):
            v = vis_r[blk * rows:(blk + 1) * rows]
            if not v.any(axis=1).all():
                continue  # a row that sees nothing: every tile is read
            for j in range(n_tiles):
                out[bi, blk, j] = v[:, 64 * j:64 * j + 64].any()
    return out


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("seed", range(10))
def test_tile_reads_matches_brute_force(seed, g):
    """`tile_reads` (the mirror of the wgmma body's rule B, from tag values)
    against the visibility itself, on out-of-order tags with holes and
    q_pos = -1 rows."""
    q_pos, tags, lim = _tag_case(seed, g)
    got = fa.tile_reads(torch.from_numpy(q_pos).int(), torch.from_numpy(tags).int(), lim, g)
    np.testing.assert_array_equal(got.numpy(), _brute_reads(q_pos, tags, lim, g))


@pytest.mark.parametrize("model,minus,read", [
    ("gemma-7b", (), 30), ("gemma-2-9b", (), 60), ("gemma-2b", (), 240),
    ("gemma-7b", (100, *range(504, 512)), 39),  # 2 of 8 blocks read whole
    ("gemma-2b", (100, 511), 249)])
def test_tile_reads_at_gemma_prompts(model, minus, read):
    """A 512-row prompt over 300 tagged slots of 512, as `Generator._prefill`
    lays it out (positions 0-511, tags -1 past slot 299) and with q_pos = -1
    rows: the tiles the wgmma body reads of the 8 per block (16 / 16 heads:
    1, 2, 3, 4, then 5 for each later block)."""
    h, h_kv = GEMMA_HEADS[model]
    g = h // h_kv
    slots = torch.arange(1024, dtype=torch.int32)[None]
    tags = torch.where(slots < 300, slots, -1)
    q_pos = torch.arange(512, dtype=torch.int32)[None].clone()
    q_pos[:, list(minus)] = -1
    got = fa.tile_reads(q_pos, tags, 512, g)
    assert got.shape == (1, 512 * g // 64, 8) and int(got.sum()) == read


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("seed", range(6))
def test_skipped_tiles_change_no_output(seed, g):
    """For every block that rule B lets skip tiles, attention (f32) over the
    tiles it reads equals attention over all keys of [0, lim) at each of the
    block's rows (rtol 1e-6): a skipped tile holds no key the rows see."""
    for draw in range(100 * seed, 100 * seed + 100):  # the first case that lets a block skip
        q_pos, tags, lim = _tag_case(draw, g, min_rows=128)  # two blocks or more
        b, t = q_pos.shape
        # row 0: a prompt over the cache's tags, so its first blocks see only
        # the low ones; no q_pos = -1 row (a row that sees nothing forbids skipping)
        q_pos[0] = np.arange(t) * (int(tags[0].max()) + 1) // t
        q_pos[q_pos < 0] = 0
        if not fa.tile_reads(torch.from_numpy(q_pos).int(), torch.from_numpy(tags).int(), lim,
                             g).all():
            break
    rng = np.random.default_rng(draw)
    s, d, h_kv = tags.shape[1], 16, 2
    k = torch.from_numpy(rng.standard_normal((b, h_kv, s, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, h_kv, s, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, t, h_kv * g, d)).astype(np.float32))
    tq, tt = torch.from_numpy(q_pos), torch.from_numpy(tags)
    vis = (tt[:, None, :lim] >= 0) & (tt[:, None, :lim] <= tq[:, :, None])
    full = gqa_attention(q, k[:, :, :lim], v[:, :, :lim], vis)
    reads = fa.tile_reads(tq.int(), tt.int(), lim, g)
    skipping = 0
    for bi in range(b):
        for blk in range(reads.shape[1]):
            keep = reads[bi, blk].repeat_interleave(64)[:lim]
            if keep.all():
                continue
            skipping += 1
            kept = torch.nonzero(keep).flatten()
            part = gqa_attention(q[bi:bi + 1], k[bi:bi + 1][:, :, kept],
                                 v[bi:bi + 1][:, :, kept], vis[bi:bi + 1][:, :, kept])
            ts = sorted({r // g for r in range(blk * 64, min(t * g, blk * 64 + 64))})
            want = full[bi, ts].numpy()
            np.testing.assert_allclose(part[0, ts].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want).max()))
    assert skipping, "the case should let some block skip"


# --- rule M: the key tiles flash_decode's wgmma body skips (pure Python mirror)


def _tree_mask(rng, b: int, s: int, n: int) -> np.ndarray:
    """A tree verify's mask [b, n, s]: a committed prefix with holes seen by
    every row, then n tree nodes in slots after it (each node's parent an
    earlier node), each row seeing its ancestors and itself."""
    m = int(rng.integers(1, s - n + 1))
    prefix = np.zeros((b, s), bool)
    prefix[:, :m] = True
    prefix[:, rng.choice(m, size=m // 8, replace=False)] = False
    anc = np.eye(n, dtype=bool)
    for j in range(1, n):
        anc[j] |= anc[int(rng.integers(0, j))]
    mask = np.repeat(prefix[:, None], n, axis=1)
    mask[:, :, m:m + n] = anc[None]
    return mask


def _mask_case(seed: int, g: int, min_rows: int = 1):
    """A flash_decode mask [B, T, lim] of one of three kinds: the causal mask
    of `_tag_case`'s out-of-order tags and positions, a tree verify's, or
    random tiles of keys per row group; at some seeds rows that see
    nothing. T*g >= min_rows."""
    rng = np.random.default_rng(seed)
    kind = seed % 3
    if kind == 0:
        q_pos, tags, lim = _tag_case(seed, g, min_rows)
        mask = (tags[:, None, :lim] >= 0) & (tags[:, None, :lim] <= q_pos[:, :, None])
    elif kind == 1:
        t = int(rng.integers(-(-min_rows // g), 300 // g + 2))
        s = int(rng.integers(t + 1, t + 300))
        mask = _tree_mask(rng, 2, s, t)
        lim = int(rng.integers(1 if min_rows == 1 else 65, s + 1))
        mask = mask[:, :, :lim]
    else:
        t = int(rng.integers(-(-min_rows // g), 300 // g + 2))
        lim = int(rng.integers(1 if min_rows == 1 else 65, 400))
        groups = -(-t // 8)
        live = rng.random((2, groups, -(-lim // 64))) < 0.4  # each 8-row group's tiles
        mask = (np.repeat(np.repeat(live, 8, axis=1)[:, :t], 64, axis=2)[:, :, :lim]
                & (rng.random((2, t, lim)) < 0.3))
    if seed % 4 == 0:
        mask[int(rng.integers(0, 2)), int(rng.integers(0, mask.shape[1]))] = False
    return np.ascontiguousarray(mask)


@pytest.mark.parametrize("g", [1, 2, 6, 8])
@pytest.mark.parametrize("seed", range(12))
def test_tile_reads_mask_matches_brute_force(seed, g):
    """`tile_reads_mask` (the mirror of flash_decode's wgmma body's rule M)
    against the visibility itself, on causal masks over out-of-order tags,
    tree masks and random ones, with rows that see nothing."""
    mask = _mask_case(seed, g)
    got = fa.tile_reads_mask(torch.from_numpy(mask), g)
    np.testing.assert_array_equal(got.numpy(), _brute_reads_vis(mask, g))


@pytest.mark.parametrize("model,minus,read", [
    ("gemma-7b", (), 30), ("gemma-2-9b", (), 60), ("gemma-2b", (), 240),
    ("gemma-7b", (100, 511), 39),  # 2 of 8 blocks read whole
    ("gemma-2b", (100, 511), 249)])
def test_tile_reads_mask_at_gemma_prompts(model, minus, read):
    """The EAGLE engine's 512-row prompt over 300 tagged slots of 512
    (`speculative.py`'s prompt through flash_decode under
    `causal_mask_from_tags`): rule M reads what rule B reads in
    `Generator._prefill`'s layout (30 of 64 tiles at 16 / 16 heads); a block
    with a row that sees nothing (here made so) reads all 8 of its tiles."""
    h, h_kv = GEMMA_HEADS[model]
    g = h // h_kv
    slots = torch.arange(1024, dtype=torch.int32)[None]
    tags = torch.where(slots < 300, slots, -1)
    pos = torch.arange(512, dtype=torch.int32)[None]
    mask = port_causal_mask(tags[:, :512], pos).clone()
    mask[:, list(minus)] = False
    got = fa.tile_reads_mask(mask, g)
    assert got.shape == (1, 512 * g // 64, 8) and int(got.sum()) == read
    if not minus:
        assert torch.equal(got, fa.tile_reads(pos, tags, 512, g))


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("seed", range(9))
def test_skipped_tiles_change_no_output_under_a_mask(seed, g):
    """For every block that rule M lets skip tiles, attention (f32) over the
    tiles it reads equals attention over all keys of [0, lim) at each of the
    block's real rows (rtol 1e-6), under causal, tree and random masks with
    rows that see nothing (their blocks read every tile; others still skip)."""
    for draw in range(100 * seed, 100 * seed + 300):  # the first case that lets a block skip
        if draw % 3 != seed % 3:
            continue  # each seed keeps its kind of mask
        mask = _mask_case(draw, g, min_rows=128)  # two blocks or more
        if not fa.tile_reads_mask(torch.from_numpy(mask), g).all():
            break
    b, t, lim = mask.shape
    rng = np.random.default_rng(draw)
    d, h_kv = 16, 2
    k = torch.from_numpy(rng.standard_normal((b, h_kv, lim, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, h_kv, lim, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, t, h_kv * g, d)).astype(np.float32))
    vis = torch.from_numpy(mask)
    full = gqa_attention(q, k, v, vis)
    reads = fa.tile_reads_mask(vis, g)
    skipping = 0
    for bi in range(b):
        for blk in range(reads.shape[1]):
            keep = reads[bi, blk].repeat_interleave(64)[:lim]
            if keep.all():
                continue
            skipping += 1
            kept = torch.nonzero(keep).flatten()
            part = gqa_attention(q[bi:bi + 1], k[bi:bi + 1][:, :, kept],
                                 v[bi:bi + 1][:, :, kept], vis[bi:bi + 1][:, :, kept])
            ts = sorted({r // g for r in range(blk * 64, min(t * g, blk * 64 + 64))})
            want = full[bi, ts].numpy()
            np.testing.assert_allclose(part[0, ts].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want).max()))
    assert skipping, "the case should let some block skip"

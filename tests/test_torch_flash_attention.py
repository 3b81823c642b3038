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
@pytest.mark.parametrize("t,s_limit", [(1, None), (6, None), (1, 128), (6, 128)])
def test_decode_verify_matches_pallas_at_head_width_256(rng, dtype, t, s_limit):
    """The same cases at D = 256 (Gemma's width), against `_flash_call` in
    interpret mode at that width."""
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


@pytest.mark.parametrize("tags", [False, True], ids=["decode", "prefill"])
def test_plan_at_head_width_256(tags):
    """D = 256 on the tensor-core body, at Gemma-2B's 1, Gemma-2-9B's 8
    and Gemma-7B's 16 kv-head units: every T·g in 1-4,096 at 15 read
    bounds, and every s_limit in 96-8,192 at 7 row counts. Each plan fits
    one block's shared memory, has a ring of two stages beside the block's
    q rows (bf16, after the ring) below 128 rows, takes at most 32 rows a
    block for flash_decode, leaves no 16-row warp tile only padding, and
    splits the keys into whole 64-key tiles that cover [0, s_limit) once,
    none empty."""
    cases = [(tg, lim) for tg in range(1, 4097)
             for lim in (96, 97, 127, 128, 300, 511, 512, 1000, 1024, 2047, 2048, 4096, 5000,
                         8191, 8192)]
    cases += [(tg, lim) for lim in range(96, 8193) for tg in (1, 6, 8, 16, 42, 512, 4096)]
    for units, (tg, lim) in ((u, c) for u in (1, 8, 16) for c in cases):
        plan = fa._plan(tg, lim, 256, torch.bfloat16, units, tags)
        rb, kps = plan.rows_per_block, plan.keys_per_split
        assert plan.body == "mma" and plan.smem_bytes <= SMEM_BLOCK, (tg, lim, plan)
        assert rb in ((128, 64, 32, 16) if tags else (32, 16))
        assert -(-tg // rb) * rb - tg < 16
        assert kps % 64 == 0 and (plan.splits - 1) * kps < lim <= plan.splits * kps
        if rb < 128:
            assert plan.smem_bytes == 2 * _stage(256, rb, tags) + rb * 256 * 2, (tg, lim, plan)
    # a prompt's 128-row blocks: a third stage does not fit beside the q rows either
    big = fa._plan(4096, 1024, 256, torch.bfloat16, 1, tags)
    assert big.rows_per_block == (128 if tags else 32)
    if tags:
        assert big.smem_bytes == 2 * _stage(256, 128, tags) + 128 * 256 * 2
        assert 3 * _stage(256, 128, tags) + 128 * 256 * 2 > SMEM_BLOCK
    # the SIMT body (f32 cache) takes one row per warp at D = 256
    assert fa._plan(4096, 1024, 256, torch.float32, 1, tags).rows_per_block == 4


@pytest.mark.parametrize("tg,lim,tags,want", [
    (1, 1024, False, (16, 8, 128)),  # decode: 32 heads x 8 splits = 256 blocks
    (6, 1024, False, (16, 8, 128)),  # chain verify
    (1, 512, False, (16, 8, 64)),
    (512, 512, False, (128, 1, 512)),  # the EAGLE engine's prompt: 128 blocks of 8 warps
    (512, 512, True, (128, 1, 512)),  # the greedy prompt
])
def test_plan_at_main_path_shapes(tg, lim, tags, want):
    plan = fa._plan(tg, lim, 128, torch.bfloat16, 32, tags)
    assert (plan.rows_per_block, plan.splits, plan.keys_per_split) == want

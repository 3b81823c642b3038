"""The port's paged KV serving (eagle_tpu_torch/runtime/paged_kv.py,
runtime/paged_batcher.py, the paged branch of models/llama.py) against the
reference's on the CPU:

- `PagePool` under one seeded sequence of alloc, retain, release, evict,
  register_prefix, match_prefix and match_cow returns the reference's ids;
- `gather_pages` equals the reference's exactly (unmapped pages read page 0);
- a paged `llama_forward` equals the reference's at rtol 1e-4, pools too;
- every scenario of tests/test_paged_batcher.py (its 12 tests) gives the
  reference `PagedBatcher`'s tokens and its `prefill_tokens_skipped`,
  `prefix_hits` and `pages_copied`, on the tiny Q8_0 pair at page size 8,
  K = 2, max_seq 128, f32 (int8 pools too), and where that file asserts it
  the single-sequence dense engine's tokens;
- the two faults of the reference that the port does not copy (a slot saved
  or restored before the pending admissions land; a freed slot's pending
  admissions and copy-on-write copies), and a row written at or past the
  table's end, which the reference clamps onto the row's last page: each
  has its own test, which the reference's behaviour fails."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models.loader import load_eagle_params, load_llama_params
from eagle_tpu.quant.serving import prepare_params_for_serving
from eagle_tpu.runtime import paged_kv as jpk
from eagle_tpu.runtime.generate import Generator as JaxGenerator
from eagle_tpu.runtime.paged_batcher import PagedBatcher as JaxPaged
from eagle_tpu.runtime.scheduler import ContinuousBatcher as JaxDense
from eagle_tpu.runtime.speculative import EagleChainEngine as JaxEngine
from eagle_tpu_torch.models import loader
from eagle_tpu_torch.quant.serving import prepare_params_for_serving as port_serving
from eagle_tpu_torch.runtime import paged_kv
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.paged_batcher import PagedBatcher
from eagle_tpu_torch.runtime.scheduler import ContinuousBatcher
from eagle_tpu_torch.runtime.speculative import EagleChainEngine
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT,
    background_cpu,
    tiny_engine_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

K, MAX_SEQ, V, PS = 2, 128, 512, 8
DTYPES = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}


# ---- the pool, the gather and the forward


def test_page_pool_matches_reference():
    """One seeded sequence of every PagePool operation on both pools: every
    returned id, count and payload equal, and the same pool state after."""
    rng = np.random.default_rng(0)
    pools = [jpk.PagePool(12, 4), paged_kv.PagePool(12, 4)]
    held: list[int] = []
    base = rng.integers(0, 50, 40).tolist()
    for step in range(300):
        op = rng.choice(["alloc", "retain", "release", "register", "match", "cow"])
        toks = base[: int(rng.integers(4, 40))] + rng.integers(0, 50, 3).tolist()
        shift = int(rng.integers(0, 2))
        if op == "alloc":
            out = []
            for p in pools:
                try:
                    out.append(p.alloc())
                except MemoryError:
                    out.append("full")
            if out[0] != "full":
                held.append(out[0])
        elif op == "retain" and held:
            pg = held[int(rng.integers(len(held)))]
            out = [p.retain(pg) for p in pools]
            held.append(pg)
        elif op == "release" and held:
            pg = held.pop(int(rng.integers(len(held))))
            out = [p.release(pg) for p in pools]
        elif op == "register" and held:
            pages = held[: len(toks) // 4]
            out = [p.register_prefix(toks, pages, payloads=[f"pl{i}" for i in pages],
                                     shift=shift) for p in pools]
        elif op == "match":
            out = [p.match_prefix(toks, want_payloads=True, shift=shift) for p in pools]
            held.extend(out[0][1])
        elif op == "cow":
            idx = int(rng.integers(0, 3))
            out = [p.match_cow(toks, idx) for p in pools]
            if out[0] is not None:
                held.append(out[0])
        else:
            continue
        assert out[0] == out[1], (step, op, out)
        assert pools[0].free == pools[1].free and (pools[0].ref == pools[1].ref).all(), step
        assert [p.available() for p in pools] == [pools[0].available()] * 2
    assert pools[0]._cache == pools[1]._cache and pools[0]._cow == pools[1]._cow


def test_gather_pages_matches_reference():
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((2, 7, 3, 4, 5)).astype(np.float32)
    scales = rng.standard_normal((2, 7, 3, 4)).astype(np.float32)
    table = np.array([[3, -1, 0, 5], [6, 2, -1, -1]], np.int32)
    for arr in (pool, scales):
        for n in (1, 3, 4):
            got = paged_kv.gather_pages(torch.from_numpy(arr), 1, torch.from_numpy(table), n)
            want = jpk.gather_pages(jnp.asarray(arr), 1, jnp.asarray(table), n)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    target, draft = tiny_engine_pair(tmp_path_factory.mktemp("paged"), ENGINE_PROMPT)
    jt, jcfg, _ = load_llama_params(target)
    jd, jdcfg, _ = load_eagle_params(draft)
    tt, tcfg, _ = loader.load_llama_params(target, device="cpu")
    td, tdcfg, _ = loader.load_eagle_params(draft, device="cpu")
    return dict(jt=prepare_params_for_serving(jt), jd=prepare_params_for_serving(jd),
                jcfg=jcfg, jdcfg=jdcfg, tt=port_serving(tt), td=port_serving(td),
                tcfg=tcfg, tdcfg=tdcfg, ref={}, port={}, chunk={})


def _paged_pair(m, dtype: str, n_pages=9, pages_per_slot=4, seed=2):
    """The same paged target cache on both sides (B 2): seeded pool contents,
    a page table with an unmapped page, empty tags."""
    jdt, tdt = DTYPES[dtype]
    cfg = m["tcfg"]
    ref = jpk.PagedKVCache.create(cfg.n_layers, 2, n_pages, pages_per_slot, PS,
                                  cfg.n_kv_heads, cfg.head_dim, jdt)
    port = paged_kv.PagedKVCache.create(cfg.n_layers, 2, n_pages, pages_per_slot, PS,
                                        cfg.n_kv_heads, cfg.head_dim, tdt, device="cpu", spill=6)
    rng = np.random.default_rng(seed)
    table = np.array([[4, 0, 7, -1], [2, 5, 1, 8]], np.int32)
    fill = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(port, name)
        if t is None:
            continue
        a = (rng.integers(-127, 128, t.shape) if t.dtype == torch.int8
             else rng.uniform(-1, 1, t.shape) * (0.02 if "scale" in name else 1))
        fill[name] = a.astype(np.int8 if t.dtype == torch.int8 else np.float32)
        t.copy_(torch.from_numpy(fill[name]))
    port.page_table.copy_(torch.from_numpy(table))
    import dataclasses

    ref = dataclasses.replace(ref, page_table=jnp.asarray(table),
                              **{k: jnp.asarray(v) for k, v in fill.items()})
    return ref, port


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_forward_matches_reference(models, dtype):
    """A 12-token chunk at positions 4..15 of row 0 and 9..20 of row 1 over
    pools holding other rows' data: logits at rtol 1e-4, every pool page
    (scales too) to the same rounding, tags equal."""
    from eagle_tpu.models.llama import llama_forward as jax_forward
    from eagle_tpu.runtime.kvcache import causal_mask_from_tags as jax_mask
    from eagle_tpu_torch.models.llama import llama_forward
    from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags

    m = models
    ref, port = _paged_pair(m, dtype)
    start = np.array([[4], [9]], np.int32)
    pos = start + np.arange(12, dtype=np.int32)[None]
    slots = np.arange(32)[None]
    tags = np.where(slots <= pos[:, -1:], slots, -1)  # the history below and the chunk
    tokens = np.random.default_rng(3).integers(3, V, (2, 12)).astype(np.int32)
    import dataclasses

    ref = dataclasses.replace(ref, slot_pos=jnp.asarray(tags.astype(np.int32)))
    port.slot_pos[:, :32] = torch.from_numpy(tags.astype(np.int32))
    jp = jnp.asarray(pos)
    want = jax_forward(m["jt"], m["jcfg"], jnp.asarray(tokens), jp, ref, jp,
                       jax_mask(ref.slot_pos, jp), compute_dtype=jnp.float32, kv_limit=24)
    tp = torch.from_numpy(pos)
    got = llama_forward(m["tt"], m["tcfg"], torch.from_numpy(tokens), tp, port, tp,
                        causal_mask_from_tags(port.slot_pos, tp), compute_dtype=torch.float32,
                        kv_limit=24)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(port, name)
        if t is None:
            continue
        w = np.asarray(getattr(want.kv, name))[:, :-1]  # the scratch pages differ by design
        if t.dtype == torch.int8:
            assert np.abs(t[:, :-1].numpy().astype(int) - w.astype(int)).max() <= 1, name
        else:
            np.testing.assert_allclose(t[:, :-1].numpy(), w, rtol=1e-4, atol=1e-5)


def test_rows_past_the_table_go_to_the_scratch_page(models):
    """A row written at slot >= MP * page (a parked row's cycle, a prompt's
    padding past the cache) lands on the scratch page; the row's last page
    keeps its content. The reference clamps such a slot onto the table's
    last entry, row slot % page: the copy of that behaviour below overwrites
    the last page, which this test would catch."""
    from eagle_tpu_torch.models.llama import _page_rows, llama_forward
    from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags

    m = models
    _, port = _paged_pair(m, "f32")
    table = port.page_table
    last = int(table[1, -1])
    before = port.k[:, last].clone()
    pos = torch.tensor([[30, 31, 32, 33], [32, 33, 34, 37]], dtype=torch.int32)  # MP*PS = 32
    port.with_tags(pos, pos)
    tokens = torch.tensor([[5, 6, 7, 8]] * 2, dtype=torch.int32)
    scratch_before = port.k[:, -1].clone()
    llama_forward(m["tt"], m["tcfg"], tokens, pos, port, pos,
                  causal_mask_from_tags(port.slot_pos, pos), compute_dtype=torch.float32,
                  kv_limit=32)
    assert torch.equal(port.k[:, last], before)  # row 1's last page: untouched
    assert not torch.equal(port.k[:, -1], scratch_before)  # the scratch page took them
    phys, rows = _page_rows(pos, table, PS, port.scratch_page)
    assert phys.tolist() == [[port.scratch_page] * 4] * 2  # unmapped, or past the table
    # the reference's mapping: page index clamped to MP - 1, row slot % page
    ref_phys = table.gather(1, torch.clamp(pos // PS, max=table.shape[1] - 1).long())
    assert ref_phys[1].tolist() == [last] * 4  # would have overwritten row 1's live page


# ---- the batcher scenarios of tests/test_paged_batcher.py, on either package


def _ref_engine(m, batch, dtype):
    key = (batch, dtype)
    if key not in m["ref"]:
        m["ref"][key] = JaxEngine(m["jt"], m["jd"], m["jcfg"], m["jdcfg"], n_draft=K,
                                  max_seq=MAX_SEQ, batch=batch, kv_dtype=DTYPES[dtype][0],
                                  compute_dtype=jnp.float32, backend="xla", eos_id=-1)
    return m["ref"][key]


def _port_engine(m, batch, dtype, role="batcher"):
    key = (batch, dtype, role)
    if key not in m["port"]:
        m["port"][key] = EagleChainEngine(
            m["tt"], m["td"], m["tcfg"], m["tdcfg"], n_draft=K, max_seq=MAX_SEQ, batch=batch,
            kv_dtype=DTYPES[dtype][1], compute_dtype=torch.float32, eos_id=-1, device="cpu")
    return m["port"][key]


class Side:
    """One package's batchers over its module-wide engines."""

    def __init__(self, m, port: bool, tmp):
        self.m, self.port, self.tmp = m, port, tmp

    def paged(self, batch, n_pages, dtype="f32", **kw):
        if self.port:
            return PagedBatcher(_port_engine(self.m, batch, dtype), n_pages=n_pages,
                                page_size=PS, **kw)
        b = JaxPaged(_ref_engine(self.m, batch, dtype), n_pages=n_pages, page_size=PS, **kw)
        # the chunk program reads nothing of its batcher but the engine: share it
        b._chunk_c = self.m["chunk"].setdefault((batch, dtype), b._chunk_c)
        return b

    def dense(self, batch, dtype="f32"):
        if self.port:
            return ContinuousBatcher(_port_engine(self.m, batch, dtype), prefill_chunk=PS)
        b = JaxDense(_ref_engine(self.m, batch, dtype), prefill_chunk=PS)
        b._chunk_c = self.m["chunk"].setdefault((batch, dtype), b._chunk_c)
        return b

    def path(self, name):
        return self.tmp / f"{'port' if self.port else 'ref'}_{name}"


def prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, V, size=n).tolist() for n in lengths]


def sc_batched(x):
    ps = prompts(1, 5, 11, 8)
    b = x.paged(4, 40)
    slots = [b.submit(p, max_new_tokens=10, stop_at_eos=False) for p in ps]
    b.run_until_done(max_steps=200)
    return dict(tokens=[s.generated[:10] for s in slots], stats=b.stats,
                single=[(p, 10) for p in ps])


def sc_draft_off(x):
    (p,) = prompts(2, 9)
    b = x.paged(2, 40)
    s = b.submit(p, max_new_tokens=12, stop_at_eos=False)
    b.run_until_done(max_steps=100)
    return dict(tokens=[s.generated[:12]], stats=b.stats, plain=[(p, 12)])


def sc_oversubscribed(x):
    ps = prompts(3, 6, 13, 9, 11)
    b = x.paged(4, 24, dft_n_pages=24, prefix_cache=False)
    slots = [b.submit(p, max_new_tokens=8, stop_at_eos=False) for p in ps]
    b.run_until_done(max_steps=200)
    assert all(s.state == "free" for s in slots)
    return dict(tokens=[s.generated[:8] for s in slots], stats=b.stats,
                single=[(p, 8) for p in ps])


def sc_prefix_skips(x):
    (prompt,) = prompts(4, 3 * PS + 3)
    b = x.paged(2, 40)
    s1 = b.submit(prompt, max_new_tokens=8, stop_at_eos=False)
    b.run_until_done(max_steps=100)
    first = list(s1.generated[:8])
    assert b.stats["prefix_hits"] == 0
    chunks = []
    orig = b._advance_prefill
    b._advance_prefill = lambda: (chunks.append(1), orig())[1]
    s2 = b.submit(prompt, max_new_tokens=8, stop_at_eos=False)
    consumed = s2.consumed
    b.run_until_done(max_steps=100)
    assert consumed == 3 * PS and len(chunks) == 1
    return dict(tokens=[first, s2.generated[:8]], stats=b.stats, consumed=consumed,
                single=[(prompt, 8), (prompt, 8)])


def sc_divergent(x):
    (base,) = prompts(5, 2 * PS)
    s1p, s2p = (base + q for q in prompts(6, 5, 7))
    b = x.paged(2, 48)
    s1 = b.submit(s1p, max_new_tokens=8, stop_at_eos=False)
    b.run_until_done(max_steps=100)
    got1 = list(s1.generated)
    s2 = b.submit(s2p, max_new_tokens=8, stop_at_eos=False)
    b.run_until_done(max_steps=100)
    assert b.stats["pages_copied"] >= 1 and b.stats["prefix_hits"] == 1
    return dict(tokens=[got1[:8], s2.generated[:8]], stats=b.stats,
                single=[(s1p, 8), (s2p, 8)])


def sc_concurrent_writer(x):
    (prompt,) = prompts(7, 2 * PS)
    b = x.paged(2, 48)
    s1 = b.submit(prompt, max_new_tokens=16, stop_at_eos=False)
    while len(s1.generated) < 4:
        b.step()
    s2 = b.submit(prompt, max_new_tokens=16, stop_at_eos=False)
    b.run_until_done(max_steps=200)
    return dict(tokens=[s1.generated[:16], s2.generated[:16]], stats=b.stats,
                single=[(prompt, 16), (prompt, 16)])


def sc_int8_pool(x):
    (p,) = prompts(8, 10)
    b = x.paged(2, 40, "int8")
    s = b.submit(p, max_new_tokens=8, stop_at_eos=False)
    b.run_until_done(max_steps=100)
    return dict(tokens=[s.generated[:8]], stats=b.stats, single_int8=[(p, 8)])


def sc_released(x):
    b = x.paged(2, 16, dft_n_pages=16, prefix_cache=False)
    out, ps = [], prompts(9, 7, 11, 5, 9, 10)
    for p in ps:
        s = b.submit(p, max_new_tokens=6, stop_at_eos=False)
        b.run_until_done(max_steps=100)
        out.append(s.generated[:6])
    assert len(b.pools["tgt"].free) == 16 and len(b.pools["dft"].free) == 16
    return dict(tokens=out, stats=b.stats, single=[(p, 6) for p in ps])


def sc_large_chunks(x):
    (base,) = prompts(10, 3 * PS)
    p1, p2 = (base + q for q in prompts(11, 2 * PS, 2 * PS + 3))
    b = x.paged(2, 48, prefill_chunk=4 * PS)
    s1 = b.submit(p1, max_new_tokens=8, stop_at_eos=False)
    b.run_until_done(max_steps=100)
    got1 = list(s1.generated)
    s2 = b.submit(p2, max_new_tokens=8, stop_at_eos=False)
    consumed = s2.consumed
    b.run_until_done(max_steps=100)
    assert consumed == 3 * PS and b.stats["pages_copied"] >= 1
    return dict(tokens=[got1[:8], s2.generated[:8]], stats=b.stats, consumed=consumed,
                single=[(p1, 8), (p2, 8)])


def sc_save_restore(x):
    (p,) = prompts(12, 6)
    b1 = x.paged(2, 40)
    s = b1.submit(p, max_new_tokens=20, stop_at_eos=False)
    for _ in range(50):
        if len(s.generated) >= 6:
            break
        b1.step()
    first = list(s.generated)
    b1.save_slot(s.id, x.path("slot.bin"))
    b2 = x.paged(2, 40)  # paged -> paged, into another slot
    s2 = b2.restore_slot(x.path("slot.bin"), slot_id=1)
    assert s2.state == "restored" and s2.generated == first
    b2.resume_slot(1, max_new_tokens=14)
    b2.run_until_done(max_steps=60)
    b3 = x.dense(2)  # paged -> dense
    s3 = b3.restore_slot(x.path("slot.bin"), slot_id=0)
    b3.resume_slot(0, max_new_tokens=14)
    b3.run_until_done(max_steps=60)
    b4 = x.dense(2)  # dense -> paged
    s4 = b4.submit(p, max_new_tokens=6, stop_at_eos=False)
    b4.run_until_done(max_steps=50)
    b4.save_slot(s4.id, x.path("slot_dense.bin"))
    b5 = x.paged(2, 40)
    s5 = b5.restore_slot(x.path("slot_dense.bin"), slot_id=1)
    b5.resume_slot(1, max_new_tokens=14)
    b5.run_until_done(max_steps=60)
    return dict(tokens=[first, s2.generated[:14], s3.generated[:14], s5.generated[:14]],
                stats=b2.stats, single=[(p, 14)] * 3, single_of=[1, 2, 3])


def sc_save_restore_int8(x):
    (p,) = prompts(13, 5)
    b1 = x.paged(2, 40, "int8")
    s = b1.submit(p, max_new_tokens=18, stop_at_eos=False)
    for _ in range(50):
        if len(s.generated) >= 5:
            break
        b1.step()
    first = list(s.generated)
    b1.save_slot(s.id, x.path("slot8.bin"))
    b2 = x.paged(2, 40, "int8")
    s2 = b2.restore_slot(x.path("slot8.bin"))
    b2.resume_slot(s2.id, max_new_tokens=12)
    b2.run_until_done(max_steps=60)
    return dict(tokens=[first, s2.generated[:12]], stats=b2.stats, single_int8=[(p, 12)],
                single_of=[1])


def sc_free_then_admit(x):
    (prompt,) = prompts(14, 3 * PS)
    b = x.paged(2, 40)
    s1 = b.submit(prompt, max_new_tokens=4, stop_at_eos=False)
    b.run_until_done(max_steps=60)
    assert s1.state == "free"
    first = list(s1.generated)
    s2 = b.submit(prompt, max_new_tokens=8, stop_at_eos=False)
    assert s2.id == s1.id and b.stats["prefix_hits"] == 1 and s2.consumed >= 2 * PS
    b.run_until_done(max_steps=60)
    return dict(tokens=[first, list(s2.generated)[:8]], stats=b.stats,
                single=[(prompt, 4), (prompt, 8)])


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_batched, sc_draft_off, sc_oversubscribed, sc_prefix_skips, sc_divergent,
    sc_concurrent_writer, sc_int8_pool, sc_released, sc_large_chunks, sc_save_restore,
    sc_save_restore_int8, sc_free_then_admit)}


def _single(m, p, n, dtype="f32"):
    eng = _port_engine(m, 1, dtype, "single")
    return eng.generate(p, max_new_tokens=n, stop_at_eos=False)[0][:n]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_paged_batcher_matches_reference(models, name, tmp_path):
    want = SCENARIOS[name](Side(models, False, tmp_path))
    got = SCENARIOS[name](Side(models, True, tmp_path))
    assert got["tokens"] == want["tokens"]
    assert got["stats"] == want["stats"]
    assert got.get("consumed") == want.get("consumed")
    which = got.get("single_of", range(len(got["tokens"])))
    for key, dtype in (("single", "f32"), ("single_int8", "int8")):
        for i, (p, n) in zip(which, got.get(key, [])):
            assert got["tokens"][i] == _single(models, p, n, dtype), (key, i)
    for toks, (p, n) in zip(got["tokens"], got.get("plain", [])):
        gen = Generator(models["tt"], models["tcfg"], max_seq=MAX_SEQ,
                        compute_dtype=torch.float32, kv_dtype=torch.float32, eos_id=-1,
                        device="cpu")
        assert toks == gen.generate(p, max_new_tokens=n)[:n]


# ---- the faults of the reference, not copied


def test_save_before_a_step_holds_the_pending_admission(models, tmp_path):
    """Submit a prefix hit and save its slot before any step: the file holds
    the admission (the shared prefix's tags, n_past parked at max_seq).
    The reference saves before its deferred flush, so its file holds the
    previous request's tags and n_past instead."""
    from eagle_tpu_torch.runtime.state_io import read_seq_state

    (prompt,) = prompts(15, 3 * PS + 2)
    b = PagedBatcher(_port_engine(models, 2, "f32"), n_pages=40, page_size=PS)
    b.submit(prompt, max_new_tokens=3, stop_at_eos=False)
    b.run_until_done(max_steps=40)
    s = b.submit(prompt, max_new_tokens=3, stop_at_eos=False)
    assert b.stats["prefix_hits"] == 1 and b._pending_admits
    b.save_slot(s.id, tmp_path / "early.bin")
    sub, _ = read_seq_state(tmp_path / "early.bin")
    assert sub.tgt_kv.slot_pos[0].tolist() == list(range(3 * PS))
    assert sub.dft_kv.slot_pos[0].tolist() == list(range(3 * PS - 1))
    assert int(sub.n_past[0]) == MAX_SEQ
    assert not b._pending_admits and not b._pending_quar


def test_restore_applies_what_is_pending_first(models, tmp_path):
    """A slot freed (its quarantine pending) and restored before any step:
    the restored n_past survives the next step's flush (the reference's
    deferred quarantine would land after the restore and park the row)."""
    (p,) = prompts(16, 6)
    b = PagedBatcher(_port_engine(models, 2, "f32"), n_pages=40, page_size=PS)
    s = b.submit(p, max_new_tokens=20, stop_at_eos=False)
    for _ in range(4):
        b.step()
    b.save_slot(s.id, tmp_path / "slot.bin")
    n_past = int(b.state.n_past[s.id])
    b._free(s)  # freed: its quarantine pends
    assert b._pending_quar
    r = b.restore_slot(tmp_path / "slot.bin", slot_id=s.id)
    b.resume_slot(r.id, max_new_tokens=len(r.generated) + 4)
    b._flush_admissions()
    assert int(b.state.n_past[s.id]) == n_past and b.n_past[s.id] == n_past
    b.run_until_done(max_steps=40)
    assert r.generated == _single(models, p, len(r.generated))


def test_freed_slot_cancels_its_pending_admission_and_copies(models, monkeypatch):
    """A prefix hit whose draft boundary page is copied on write, freed
    before any step, then a new request on the same slot: the flush makes
    only the live admission's copy and preset (the reference's flush would
    also copy into the page the freed slot gave back, and preset the freed
    admission's row), and the new request's tokens are the single engine's."""
    from eagle_tpu_torch.runtime import paged_batcher as pb

    (base,) = prompts(17, 2 * PS)
    p1, p2 = (base + q for q in prompts(18, 5, 7))
    (p3,) = prompts(19, 9)
    b = PagedBatcher(_port_engine(models, 2, "f32"), n_pages=48, page_size=PS)
    b.submit(p1, max_new_tokens=3, stop_at_eos=False)
    b.run_until_done(max_steps=40)
    s = b.submit(p2, max_new_tokens=6, stop_at_eos=False, request_id="gone")
    assert b._pending_copies["dft"] and b._pending_admits
    assert b.abort("gone")
    assert not b._pending_copies["dft"] and not b._pending_admits
    copies, admits = [], []
    real_copy, real_rows = pb.copy_pool_pages, pb._flush_rows
    monkeypatch.setattr(pb, "copy_pool_pages", lambda kv, s_, d_: (
        copies.append((list(s_), list(d_))), real_copy(kv, s_, d_))[1])
    monkeypatch.setattr(pb, "_flush_rows", lambda st, ms, q, a, *r: (
        admits.append(list(a)), real_rows(st, ms, q, a, *r))[1])
    s3 = b.submit(p3, max_new_tokens=6, stop_at_eos=False)
    assert s3.id == s.id
    b.run_until_done(max_steps=40)
    assert copies == [] and all(a == [] for a in admits)
    assert s3.generated == _single(models, p3, 6)

"""The port's chat over a live cache against the reference on the CPU:
`Generator._extend` (the prefill at an offset), `kvcache.context_shift`,
`Generator.generate(context_shift_keep=)`, `runtime/chat.py:ChatSession`,
`Engine.chat_session`, `Engine.embed` / `rerank` and the CLI's `--chat`.

Both packages load one tiny GGUF pair minted with the reference's writer
(`tiny_engine_pair`: the tiny_cfgs shapes, Q8_0, an SPM vocabulary of 512
pieces), f32 compute and cache, max_seq 128 (so the conversations shift
their context). The reference runs once per module: its engines and
sessions are module fixtures shared by the parametrised cases.

- `_extend`'s logits at rtol 1e-4 and its tags equal to the reference's,
  padding past the cache's end included; `_extend` after `_prefill` equals
  one `_prefill` of the whole sequence;
- `context_shift` in place: f32 k and v at 1e-5, bf16 at one bf16 step,
  tags equal; the cache keeps its data pointers;
- `generate(context_shift_keep=)` gives the reference's tokens;
- three-turn sessions (template on and off, with a system prompt), a
  mid-chunk EOS and its rollback, the overflow that shifts the context and
  a turn that cannot fit: `fed`, `pos`, `keep`, the replies, `last_out`
  and the tags equal the reference session's; a sampled session is
  reproducible from its seed; after a shift a turn replays its step graphs
  (capture stubbed) and captures none;
- `embed` (mean and last pooling) and `rerank` at rtol 1e-4;
- the CLI's `--chat` over stdin prints the session's replies;
- the refusals: `--jinja`, a stateful sampler with a draft (whose engine
  would drop its state), a bert target, a `cls` head."""

from __future__ import annotations

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.api import Engine as JaxEngine
from eagle_tpu.api import EngineConfig as JaxEngineConfig
from eagle_tpu.ops.rope import rope_freqs_cfg as jax_rope_freqs_cfg
from eagle_tpu.runtime import kvcache as jkv
from eagle_tpu_torch import _build
from eagle_tpu_torch.ops.rope import rope_freqs_cfg
from eagle_tpu_torch.runtime import graphs
from eagle_tpu_torch.runtime.kvcache import KVCache, context_shift
from eagle_tpu_torch.runtime.sampling import SamplerConfig
from eagle_tpu_torch.tools import cli
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT,
    background_cpu,
    tiny_cfgs,
    tiny_engine_pair,
    tiny_port_engine,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

MAX_SEQ = 128
TURNS = ["the quick brown fox", "a lazy dog jumps over the fox", "then the fox"]
SESSIONS = {"vicuna": dict(template="vicuna"), "detected": dict(),
            "system": dict(template="vicuna", system="be brief")}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tiny_engine_pair(tmp_path_factory.mktemp("chat"), ENGINE_PROMPT)


@pytest.fixture(scope="module")
def ref(pair):
    """The reference's plain Engine and a cache of its runs: each scenario
    runs there once per module."""
    eng = JaxEngine(JaxEngineConfig(model_path=str(pair[0]), max_seq=MAX_SEQ, backend="xla",
                                    compute_dtype=jnp.float32, kv_dtype=jnp.float32))
    return eng, {}


@pytest.fixture(scope="module")
def port(pair):
    return tiny_port_engine(pair, "plain")


def once(ref, name, fn):
    eng, runs = ref
    if name not in runs:
        runs[name] = fn(eng)
    return runs[name]


def clear(gen):
    """Empty a generator's tags (a session or feed starts on a clean cache)."""
    if hasattr(gen.kv, "spill"):
        gen.kv.rollback(torch.zeros((gen.batch,), dtype=torch.int32))
    else:
        gen.kv = gen.kv.rollback(jnp.zeros((gen.batch,), jnp.int32))


def tags(gen):
    """The tags of the cache's max_seq slots (the port's spill slot apart)."""
    return np.asarray(gen.kv.slot_pos)[:, :gen.max_seq]


class Eos:
    """A tokenizer whose EOS is another token: a chosen reply token ends the turn."""

    def __init__(self, tok, eos_id):
        self._tok, self.eos_id = tok, eos_id

    def __getattr__(self, name):
        return getattr(self._tok, name)


def ids_of(seed, n):
    return np.random.default_rng(seed).integers(3, 512, size=n).tolist()


# ---- Generator._extend ----------------------------------------------------

EXTEND = {"offset": (11, 7), "two_buckets": (40, 33), "padding_past_the_end": (100, 20),
          "real_rows_past_the_end": (120, 20)}


def _ref_extend(eng, n0, n):
    gen = eng.engine
    clear(gen)
    ids = ids_of(n0 + n, n0 + n)
    t0, t = _bucket(n0), _bucket(n)
    p0 = np.zeros((1, t0), np.int32)
    p0[0, :n0] = ids[:n0]
    _, _, gen.kv = gen._prefill_jit(gen.params, gen.kv, jnp.asarray(p0),
                                    jnp.asarray([n0], np.int32), t=t0)
    p1 = np.zeros((1, t), np.int32)
    p1[0, :n] = ids[n0:]
    logits, gen.kv = gen._extend_jit(gen.params, gen.kv, jnp.asarray(p1),
                                     jnp.asarray([n0], np.int32), jnp.asarray([n], np.int32),
                                     t=t, kv_limit=gen.kv_read_bucket(n0 + t))
    return ids, np.asarray(logits), tags(gen), np.asarray(gen.kv.k), np.asarray(gen.kv.v)


def _bucket(n):
    from eagle_tpu_torch.runtime.generate import pad_bucket

    return pad_bucket(n)


def _port_prefill(gen, ids):
    t = _bucket(len(ids))
    p = torch.zeros((1, t), dtype=torch.int32)
    p[0, :len(ids)] = torch.tensor(ids)
    return gen._prefill(p, torch.tensor([len(ids)], dtype=torch.int32), t)[0]


def _port_extend(gen, ids, start):
    n, t = len(ids), _bucket(len(ids))
    p = torch.zeros((1, t), dtype=torch.int32)
    p[0, :n] = torch.tensor(ids)
    return gen._extend(p, start, n, t, kv_limit=gen.kv_read_bucket(start + t))[0]


@pytest.mark.parametrize("case", list(EXTEND))
def test_extend_matches_reference(ref, port, case):
    n0, n = EXTEND[case]
    ids, want, want_tags, want_k, want_v = once(ref, ("extend", case),
                                                lambda e: _ref_extend(e, n0, n))
    gen = port.engine
    clear(gen)
    _port_prefill(gen, ids[:n0])
    ptrs = [t.data_ptr() for t in (gen.kv.k, gen.kv.v, gen.kv.slot_pos)]
    got = _port_extend(gen, ids[n0:], n0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tags(gen), want_tags)
    assert (gen.kv.slot_pos[:, MAX_SEQ:] == -1).all()  # the spill slot stays invisible
    end = min(n0 + n, MAX_SEQ)  # the rows written: the reference drops rows past the cache
    np.testing.assert_allclose(gen.kv.k[:, :, :, :end].numpy(), want_k[:, :, :, :end],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gen.kv.v[:, :, :, :end].numpy(), want_v[:, :, :, :end],
                               rtol=1e-4, atol=1e-4)
    assert [t.data_ptr() for t in (gen.kv.k, gen.kv.v, gen.kv.slot_pos)] == ptrs


@pytest.mark.parametrize("k", [9, 16, 30])
def test_extend_after_prefill_equals_one_prefill(port, k):
    gen = port.engine
    ids = ids_of(7, 37)
    clear(gen)
    want = _port_prefill(gen, ids)
    want_tags = tags(gen).copy()
    clear(gen)
    _port_prefill(gen, ids[:k])
    got = _port_extend(gen, ids[k:], k)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tags(gen), want_tags)


def test_extend_refuses_rows_past_the_cache(port):
    """Rows before the cache's first slot, and a feed whose real rows are
    not 1..t of its padded rows, are refused; rows past its last slot are
    taken as the reference takes them (`real_rows_past_the_end` above)."""
    gen = port.engine
    p = torch.zeros((1, 16), dtype=torch.int32)
    for start, n in ((-1, 4), (0, 0), (0, 17)):
        with pytest.raises(ValueError, match="a feed of"):
            gen._extend(p, start, n, 16, kv_limit=128)


# ---- kvcache.context_shift ------------------------------------------------

SHIFTS = [(4, 20), (0, 30), (16, 1)]


@pytest.mark.parametrize("keep,discard", SHIFTS, ids=[f"keep{k}-drop{d}" for k, d in SHIFTS])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_context_shift_matches_reference(dtype, keep, discard):
    jcfg, tcfg = tiny_cfgs()
    rng = np.random.default_rng(keep * 100 + discard)
    shape = (2, 1, 2, 64, 64)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    slot_pos = np.where(np.arange(64) < 50, np.arange(64), -1)[None].astype(np.int32)
    slot_pos[0, 7] = -1
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcache = jkv.KVCache(k=jnp.asarray(k).astype(jd), v=jnp.asarray(v).astype(jd),
                         slot_pos=jnp.asarray(slot_pos))
    want = jkv.context_shift(jcache, jax_rope_freqs_cfg(jcfg)[0], keep, discard)
    cache = KVCache(k=torch.from_numpy(k).to(td), v=torch.from_numpy(v).to(td),
                    slot_pos=torch.from_numpy(slot_pos.copy()))
    before_k = cache.k.clone()
    ptrs = [t.data_ptr() for t in (cache.k, cache.v, cache.slot_pos)]
    got = context_shift(cache, rope_freqs_cfg(tcfg, device="cpu")[0], keep, discard)
    assert got is cache and [t.data_ptr() for t in (cache.k, cache.v, cache.slot_pos)] == ptrs
    np.testing.assert_array_equal(cache.slot_pos.numpy(), np.asarray(want.slot_pos))
    step = 1e-5 if dtype == "f32" else 2.0 ** -7  # bf16: one step of its 8-bit mantissa
    for name, a, b in (("k", cache.k, want.k), ("v", cache.v, want.v)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=step, atol=step, err_msg=name)
    assert torch.equal(cache.k[:, :, :, :keep], before_k[:, :, :, :keep])  # the header stays


@pytest.mark.parametrize("keep", [4, 10])
def test_generate_with_context_shift_matches_reference(ref, port, keep):
    prompt = ids_of(keep, 20)

    def run(eng):
        return eng.engine.generate(prompt, max_new_tokens=170, stop_at_eos=False,
                                   context_shift_keep=keep)

    want = once(ref, ("shift_generate", keep), run)
    assert len(want) == 170  # past max_seq: the context shifted
    assert run(port) == want


# ---- ChatSession ----------------------------------------------------------


def _session(eng, kw, turns=TURNS, n=40, eos=None):
    s = eng.chat_session(**kw)
    if eos is not None:
        s.tokenizer = Eos(s.tokenizer, eos)
    clear(s.gen)
    replies, keeps, n_fed, head = [], [], 0, None
    for text in turns:
        n_fed += len(s.turn_tokens(text))
        replies.append(s.ask(text, max_new_tokens=n))
        head = head or list(s.fed[:s.keep])
        n_fed += len(s.last_out) - 1  # the last token stays pending
        keeps.append((s.pos, s.keep, s.last_prompt_len, list(s.last_out), s.pending))
    return dict(replies=replies, keeps=keeps, fed=list(s.fed), messages=list(s.messages),
                tags=tags(s.gen).copy(), n_fed=n_fed, head=head)


@pytest.mark.parametrize("name", list(SESSIONS))
def test_chat_session_matches_reference(ref, port, name):
    want = once(ref, ("session", name), lambda e: _session(e, SESSIONS[name]))
    got = _session(port, SESSIONS[name])
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key], dtype=object),
                                      np.asarray(want[key], dtype=object), err_msg=key)
    assert got["messages"][-1]["role"] == "assistant"
    if name == "system":
        assert got["messages"][0] == {"role": "system", "content": "be brief"}


def test_session_shifts_its_context_as_the_reference(ref):
    """The scenarios above overflow the 128-slot cache: fewer tokens stay in
    it than were fed, while the header (the first turn's prompt, at most a
    quarter of the cache) survives."""
    for name in SESSIONS:
        runs = once(ref, ("session", name), lambda e: _session(e, SESSIONS[name]))
        assert runs["keeps"][-1][0] == len(runs["fed"]) < runs["n_fed"], name
        head = runs["head"][:MAX_SEQ // 4]
        assert runs["fed"][:len(head)] == head != []


def _eos_index(out):
    """The first reply index from 8 whose token is new: mid-chunk, since
    out[0] is drawn from the feed and out[1:33] is the first chunk."""
    return next(i for i in range(8, 30) if out[i] not in out[:i])


def test_eos_mid_chunk_rolls_back_as_the_reference(ref, port):
    first = once(ref, ("session", "vicuna"), lambda e: _session(e, SESSIONS["vicuna"]))
    i = _eos_index(first["keeps"][0][3])
    eos = first["keeps"][0][3][i]
    want = once(ref, "eos", lambda e: _session(e, SESSIONS["vicuna"], eos=eos))
    got = _session(port, SESSIONS["vicuna"], eos=eos)
    pos, _, plen, out, pending = got["keeps"][0]
    assert out[-1] == eos == pending and len(out) == i + 1 and pos == plen + i
    assert (got["tags"][0, pos:] == -1).all() or got["keeps"][1][0] > pos
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key], dtype=object),
                                      np.asarray(want[key], dtype=object), err_msg=key)


def test_turn_that_cannot_fit_is_refused(ref, port):
    long = " ".join(["the quick brown fox"] * 12)

    def run(eng):
        s = eng.chat_session(template="vicuna")
        clear(s.gen)
        with pytest.raises(ValueError, match="cannot fit"):
            s.ask(long, max_new_tokens=4)
        return len(s.turn_tokens(long))

    assert once(ref, "too_long", run) == run(port) >= MAX_SEQ // 2


def test_sampled_session_is_reproducible_from_its_seed(port):
    hot = SamplerConfig(greedy=False, temperature=1.5, top_k=0, top_p=1.0, min_p=0.0)

    def run(seed):
        s = port.chat_session(template="vicuna")
        clear(s.gen)
        return [s.ask(t, max_new_tokens=20, sampler=hot, seed=seed) for t in TURNS]

    a = run(5)
    assert run(5) == a and run(6) != a


class _ReplayGraph:
    """A stand-in graph whose replay runs the captured body again."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def test_turn_after_a_shift_replays_its_graphs(ref, port, monkeypatch):
    """With capture stubbed (a replay reruns the body), a session whose turns
    shift the context captures one step graph per read bucket on its first
    turn and none after: the shift keeps the cache's pointers. The tokens
    stay the reference's."""
    monkeypatch.setattr(graphs.StepGraphs, "_warm_up", lambda self, body: body())
    monkeypatch.setattr(graphs.StepGraphs, "_capture", lambda self, body: _ReplayGraph(body))
    monkeypatch.delenv("EAGLE_TPU_FUSED_FFN", raising=False)
    gen = port.engine
    monkeypatch.setattr(gen, "graphs", graphs.StepGraphs(enabled=True))
    shifts = []
    real_shift = gen.shift_context
    monkeypatch.setattr(gen, "shift_context", lambda *a: (shifts.append(a), real_shift(*a)))
    s = port.chat_session(template="vicuna")
    clear(gen)
    s.ask(TURNS[0], max_new_tokens=40)
    captured = gen.graphs.captures
    assert captured >= 1 and not shifts
    for text in TURNS[1:]:
        s.ask(text, max_new_tokens=40)
    assert shifts and gen.graphs.captures == captured and gen.graphs.replays > 0
    want = once(ref, ("session", "vicuna"), lambda e: _session(e, SESSIONS["vicuna"]))
    assert s.fed == want["fed"]
    _build.reset_counts()


# ---- embed and rerank -----------------------------------------------------

TEXTS = ["the quick brown fox", "a lazy dog", "jumps over the lazy dog and then the fox"]


@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_embed_matches_reference(ref, port, pooling):
    want = once(ref, ("embed", pooling), lambda e: e.embed(TEXTS, pooling=pooling))
    got = port.embed(TEXTS, pooling=pooling)
    assert len(got) == len(TEXTS)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (256,)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        assert abs(np.linalg.norm(g) - 1) < 1e-4


def test_rerank_matches_reference(ref, port):
    want = once(ref, "rerank", lambda e: e.rerank(TEXTS[0], TEXTS[1:]))
    np.testing.assert_allclose(port.rerank(TEXTS[0], TEXTS[1:]), want, rtol=1e-4, atol=1e-5)


# ---- the CLI ----------------------------------------------------------------


def test_cli_chat_over_stdin(pair, port, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(TURNS + ["/exit", "unread"]) + "\n"))
    assert cli.main(["-m", str(pair[0]), "--chat", "--chat-template", "vicuna", "--temp", "0",
                     "-n", "12", "--device", "cpu", "--ctx", str(MAX_SEQ)]) == 0
    out, err = capsys.readouterr()
    s = port.chat_session(template="vicuna")
    clear(s.gen)
    dec = port.tokenizer
    want = ["".join(dec.decode([t], skip_special=True) for t in _streamed(s, text))
            for text in TURNS]
    assert out == "".join(f"> {w}" for w in want) + "> "  # the newline goes to stderr
    assert err.count("[perf]") == 3 and "chat mode" in err


def _streamed(s, text):
    toks = []
    s.ask(text, max_new_tokens=12, on_token=toks.append)
    return toks


# ---- refusals ---------------------------------------------------------------


def _stateful(pair):
    """A session runs a stateful sampler (tests/test_torch_sampling_stateful.py
    holds it against the reference); `--chat` with a draft and a penalty is
    refused with the engine, whose cycles would drop the sampler's state."""
    cli.main(["-m", str(pair[0]), "--draft", str(pair[1]), "--chat", "--repeat-penalty", "1.1",
              "--device", "cpu"])


def _bert(port):
    port.model_cfg = dataclasses.replace(port.model_cfg, arch="bert")
    port.embed(["the fox"])


def _cls(port):
    port.params["cls"] = torch.zeros(1)
    port.rerank("the fox", ["a dog"])


REFUSALS = {
    "jinja": (lambda port, pair: cli.main(["-m", str(pair[0]), "--chat", "--jinja",
                                           "--device", "cpu"]), "jinja2"),
    "stateful_sampler": (lambda port, pair: _stateful(pair), "drops the sampler's state"),
    "bert_target": (lambda port, pair: _bert(port), "item 8"),
    "cls_head": (lambda port, pair: _cls(port), "item 8"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_name_their_reason(pair, port, name, monkeypatch):
    monkeypatch.setattr(port, "model_cfg", port.model_cfg)
    monkeypatch.setattr(port, "params", dict(port.params))
    call, reason = REFUSALS[name]
    with pytest.raises(NotImplementedError, match=reason):
        call(port, pair)

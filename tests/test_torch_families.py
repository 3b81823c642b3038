"""The Qwen2, Qwen3 and Gemma-2 families in the port on the CPU, against the
reference, on tiny Q8_0 pairs (`tiny_family_pair`: 2-4 layers, width 256):

- qwen2: q/k/v biases (nonzero), GQA 4:1, rope base 1e6, a BPE vocabulary
  with the "qwen2" pre-tokenizer and a chatml template;
- qwen3: per-head q/k RMSNorm before rope, head_dim 128 decoupled from
  n_embd / n_heads;
- gemma2: 4 layers, a sliding window of 8 on layers 0 and 2 only, over 30
  tokens; softcaps 1.0 (attention) and 2.0 (final), each moving the logits
  past the tolerance; query_pre_attn_scalar 96 over head_dim 64; sandwich
  norms, GELU, the sqrt(n_embd) embedding scale, a tied head, an SPM
  vocabulary and a gemma template.

For each: the config and the loaded params bit-equal to the reference's
`load_llama_params` (NEOX rows, not un-permuted); prefill and decode logits
at rtol 1e-4 in f32, and each branch moving them; `Generator`, the EAGLE
chain, the static tree, lookahead, `LookupEngine` and `ContinuousBatcher`
tokens (and stats) equal to the reference's; `Engine` text, the CLI and
the server equal to the reference's; the kernels' plans at the published
shapes (g = 7; K = 3,584 and 18,944). Then
one int8 and one paged case (gemma2: the window and the softcap on both
branches), `ChatSession` over a shifting qwen2 cache against the reference
and its shifted keys against a recompute, `causal_mask_from_tags`'
`swa_window` against the reference's, a gemma2 at head_dim 256 without its
attention softcap (the flash functions at D = 256) against the reference,
and the refusals (ROADMAP queue 1, item 8)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eagle_tpu.api as jax_api
import eagle_tpu_torch.api as port_api
from eagle_tpu.models.llama import llama_forward as jax_llama_forward
from eagle_tpu.models.loader import load_llama_params as jax_load
from eagle_tpu.runtime import kvcache as jkv
from eagle_tpu.tools import cli as jax_cli
from eagle_tpu_torch.models.config import check_ported
from eagle_tpu_torch.models.llama import llama_forward
from eagle_tpu_torch.models.loader import load_eagle_params, load_llama_params
from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags
from eagle_tpu_torch.server.chat_templates import detect_template
from eagle_tpu_torch.tokenizer import BPETokenizer
from eagle_tpu_torch.tools import cli
from test_torch_loader import _same_tree
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT,
    background_cpu,
    jax_cfg_to_torch,
    tiny_family_pair,
    write_tiny_gguf_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

ARCHS = ["qwen2", "qwen3", "gemma2"]
MAX_SEQ = 128
K = 3
N_PROMPT = 30  # past gemma2's window of 8
PROMPT = ENGINE_PROMPT + " naïve café"
TEMPLATES = {"qwen2": "chatml", "qwen3": "chatml", "gemma2": "gemma"}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return {a: tiny_family_pair(tmp_path_factory.mktemp(a), a) for a in ARCHS}


@pytest.fixture(scope="module")
def models(pairs):
    out = {}
    for a, (target, _) in pairs.items():
        tt, tcfg, _ = load_llama_params(target, device="cpu")
        jt, jcfg, _ = jax_load(target)
        out[a] = dict(tt=tt, tcfg=tcfg, jt=jt, jcfg=jcfg)
    return out


@pytest.fixture(scope="module")
def ref_engines(pairs):
    """The reference's engines, built once per module and (arch, kind)."""
    cache = {}

    def get(arch, kind="chain", **kw):
        key = (arch, kind, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = _jax_engine(pairs[arch], kind, **kw)
        return cache[key]

    return get


KINDS = {"plain": {}, "chain": {}, "tree": {"tree_branching": (3,)}}


def _jax_engine(pair, kind, **kw):
    kv = {"int8": jnp.int8}.get(kw.pop("kv", None), jnp.float32)
    return jax_api.Engine(jax_api.EngineConfig(
        model_path=str(pair[0]), draft_path=None if kind == "plain" else str(pair[1]),
        n_draft=K, max_seq=MAX_SEQ, backend="xla", compute_dtype=jnp.float32, kv_dtype=kv,
        **KINDS[kind], **kw))


def _port_engine(pair, kind, **kw):
    kv = {"int8": torch.int8}.get(kw.pop("kv", None), torch.float32)
    return port_api.Engine(port_api.EngineConfig(
        model_path=pair[0], draft_path=None if kind == "plain" else pair[1], n_draft=K,
        max_seq=MAX_SEQ, compute_dtype=torch.float32, kv_dtype=kv, device="cpu",
        **KINDS[kind], **kw))


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _tokens(n, seed=3, v=512):
    return np.random.default_rng(seed).integers(0, v, size=(1, n)).astype(np.int32)


def _forward(params, cfg, kv, tokens, positions, prefill=False):
    """The port's forward in f32; `prefill` passes the tag mask for the
    prompt path (`causal_tags_prefill`)."""
    positions = torch.from_numpy(np.asarray(positions, np.int32))
    kv.with_tags(positions, positions)
    mask = causal_mask_from_tags(kv.slot_pos, positions)
    return llama_forward(params, cfg, torch.from_numpy(tokens), positions, kv, positions, mask,
                         compute_dtype=torch.float32, causal_tags_prefill=prefill)


def _jax_forward(params, cfg, kv, tokens, positions):
    positions = jnp.asarray(positions)
    kv = kv.with_tags(positions, positions)
    mask = jkv.causal_mask_from_tags(kv.slot_pos, positions)
    return jax_llama_forward(params, cfg, jnp.asarray(tokens), positions, kv, positions, mask,
                             backend="xla", compute_dtype=jnp.float32)


def _caches(cfg):
    return (jkv.KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim,
                               jnp.float32),
            KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim,
                           torch.float32, device="cpu"))


# ---- config and loader ------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_reads_the_family(models, arch):
    m = models[arch]
    tcfg, jcfg = m["tcfg"], m["jcfg"]
    assert tcfg == jax_cfg_to_torch(jcfg)
    check_ported(tcfg)
    assert tcfg.attn_bias == (arch == "qwen2") == ("bqkv" in m["tt"]["layers"])
    assert ("attn_q_norm" in m["tt"]["layers"]) == (arch == "qwen3")
    if arch == "qwen3":
        assert tcfg.head_dim == 128 != tcfg.n_embd // tcfg.n_heads
    if arch == "gemma2":
        assert (tcfg.swa_window, tcfg.swa_every, tcfg.post_norms, tcfg.act) == (8, 2, True,
                                                                                "gelu")
        assert (tcfg.attn_softcap, tcfg.final_softcap, tcfg.embd_scale) == (1.0, 2.0, 16.0)
        assert tcfg.attn_scale == 96 ** -0.5 != tcfg.head_dim ** -0.5
        assert m["tt"]["output"] is m["tt"]["tok_embd"]
    else:
        assert (tcfg.swa_window, tcfg.act, tcfg.embd_scale) == (0, "silu", 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_loaded_params_bit_equal(models, arch):
    """Every leaf bit-equal to the reference's `load_llama_params`: the q/k
    rows as the file holds them (NEOX), `bqkv` and the norms stacked f32."""
    m = models[arch]
    _same_tree(m["tt"], m["jt"])


# ---- the forward ------------------------------------------------------------


def _branches(arch):
    """(name, config or params change) that each must move the logits."""
    if arch == "qwen2":
        return [("bqkv", lambda c, p: (c, {**p, "layers": {
            k: v for k, v in p["layers"].items() if k != "bqkv"}}))]
    if arch == "qwen3":
        return [("q/k norms", lambda c, p: (c, {**p, "layers": {
            k: v for k, v in p["layers"].items() if k not in ("attn_q_norm", "attn_k_norm")}}))]
    r = dataclasses.replace
    return [("attn_softcap", lambda c, p: (r(c, attn_softcap=0.0), p)),
            ("final_softcap", lambda c, p: (r(c, final_softcap=0.0), p)),
            ("window", lambda c, p: (r(c, swa_window=0), p)),
            ("window on every layer", lambda c, p: (r(c, swa_every=1), p)),
            ("attn_scale", lambda c, p: (r(c, attn_scale=None), p)),
            ("embd_scale", lambda c, p: (r(c, embd_scale=1.0), p)),
            ("sandwich norms", lambda c, p: (c, {**p, "layers": {
                k: v for k, v in p["layers"].items() if not k.startswith("post_")}}))]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    """A 30-token prefill, then 3 decoded tokens one at a time: logits and
    the hidden state at rtol 1e-4 in f32. Each of the family's branches,
    taken out, moves the prefill's logits by more than the tolerance."""
    m = models[arch]
    toks = _tokens(N_PROMPT + 3)
    jcache, cache = _caches(m["tcfg"])
    pos = np.arange(N_PROMPT, dtype=np.int32)[None]
    want = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, :N_PROMPT], pos)
    got = _forward(m["tt"], m["tcfg"], cache, toks[:, :N_PROMPT], pos)
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden)
    jcache = want.kv
    for i in range(N_PROMPT, N_PROMPT + 3):
        p = np.asarray([[i]], np.int32)
        want_i = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, i:i + 1], p)
        jcache = want_i.kv
        _close(_forward(m["tt"], m["tcfg"], cache, toks[:, i:i + 1], p).logits, want_i.logits)
    tol = 1e-4 * float(np.abs(np.asarray(want.logits)).max())
    for name, change in _branches(arch):
        cfg, params = change(m["tcfg"], m["tt"])
        other = _forward(params, cfg, _caches(cfg)[1], toks[:, :N_PROMPT], pos).logits
        assert float((other - got.logits).abs().max()) > 10 * tol, name


def test_window_only_on_even_layers(models):
    """The window hides slots only on layers 0 and 2: with the window (and
    the rest) as configured, the first 8 positions' logits equal those of a
    run without a window (nothing is yet 8 behind), and a position past 8
    differs from both a windowless run and one windowed on every layer."""
    m = models["gemma2"]
    toks, pos = _tokens(N_PROMPT), np.arange(N_PROMPT, dtype=np.int32)[None]
    got = _forward(m["tt"], m["tcfg"], _caches(m["tcfg"])[1], toks, pos).logits
    for cfg in (dataclasses.replace(m["tcfg"], swa_window=0),
                dataclasses.replace(m["tcfg"], swa_every=1)):
        other = _forward(m["tt"], cfg, _caches(cfg)[1], toks, pos).logits
        _close(other[:, :8], got[:, :8].numpy(), rtol=1e-6)
        assert float((other[:, 8:] - got[:, 8:]).abs().amax(dim=-1).min()) > 0


# ---- the engines and the entry points ---------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_reference(pairs, ref_engines, arch, kind):
    """`Generator`, the EAGLE chain and the static tree (3,): tokens and the
    speculative stats equal to the reference's on the prompt's ids; the
    chain's `Engine.generate_text` equal to the reference's too."""
    jeng, eng = ref_engines(arch, kind), _port_engine(pairs[arch], kind)
    ids = eng.tokenizer.encode(PROMPT)
    assert ids == jeng.tokenizer.encode(PROMPT) and len(ids) >= 10
    if kind == "plain":
        want = jeng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
        got = eng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
    else:
        want, want_stats = jeng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
        got, stats = eng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
        assert stats == want_stats and stats["n_cycles"] > 0
    assert [int(t) for t in got] == [int(t) for t in want]
    if kind == "chain":
        text, stats = eng.generate_text(PROMPT, max_new_tokens=16)
        assert (text, stats) == jeng.generate_text(PROMPT, max_new_tokens=16)


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_matches_reference(pairs, ref_engines, arch):
    """`Engine(batch=2)`'s `ContinuousBatcher`: three prompts of 5-31
    tokens over two slots (the third waits for a free slot), each slot's
    tokens equal to the reference batcher's."""
    jeng, eng = ref_engines(arch, "chain", batch=2), _port_engine(pairs[arch], "chain", batch=2)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (5, 31, 12)]

    def run(b):
        slots = [b.submit(p, max_new_tokens=12, stop_at_eos=False) for p in prompts[:2]]
        b.step()
        slots.append(b.submit(prompts[2], max_new_tokens=12, stop_at_eos=False))
        b.run_until_done(max_steps=200)
        return [list(map(int, s.generated[:12])) for s in slots if s is not None]

    want = run(jeng.batcher)
    assert run(eng.batcher) == want and len(want) >= 2


@pytest.mark.parametrize("arch", ARCHS)
def test_model_free_engines_match_reference(pairs, ref_engines, arch):
    """Lookahead (W, N, G) = (4, 3, 2) through `Engine` and `LookupEngine`
    (K = 4) on the loaded params: tokens and stats equal to the
    reference's, on a prompt said twice (so lookup drafts from it)."""
    from eagle_tpu.runtime.lookup import LookupEngine as JaxLookup
    from eagle_tpu_torch.runtime.lookup import LookupEngine

    jeng = ref_engines(arch, "plain", lookahead=(4, 3, 2))
    eng = _port_engine(pairs[arch], "plain", lookahead=(4, 3, 2))
    ids = eng.tokenizer.encode(PROMPT + " " + PROMPT)
    want = jeng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
    assert eng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False) == (list(want[0]),
                                                                             want[1])
    ref = JaxLookup(jeng.params, jeng.model_cfg, n_draft=4, max_seq=MAX_SEQ,
                    kv_dtype=jnp.float32, compute_dtype=jnp.float32, backend="xla", eos_id=-1)
    port = LookupEngine(eng.params, eng.model_cfg, n_draft=4, max_seq=MAX_SEQ,
                        kv_dtype=torch.float32, compute_dtype=torch.float32, eos_id=-1,
                        device="cpu")
    want = ref.generate(ids, max_new_tokens=20, stop_at_eos=False)
    assert port.generate(ids, max_new_tokens=20, stop_at_eos=False) == (list(want[0]), want[1])


def test_int8_cache_matches_reference(pairs, ref_engines):
    """gemma2 on int8 caches: the windowed, softcapped attention over the
    dequantized cache; `Generator` and chain tokens equal to the
    reference's."""
    for kind in ("plain", "chain"):
        jeng = ref_engines("gemma2", kind, kv="int8")
        eng = _port_engine(pairs["gemma2"], kind, kv="int8")
        ids = eng.tokenizer.encode(PROMPT)
        want = jeng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
        got = eng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
        if kind == "chain":
            (want, want_stats), (got, stats) = want, got
            assert stats == want_stats
        assert [int(t) for t in got] == [int(t) for t in want], kind


def test_paged_batcher_matches_reference(pairs, ref_engines):
    """gemma2 on a paged pool (`Engine(batch=2, paged=True)`, pages of 16
    rows): the window and the softcap over the gathered pages; each slot's
    tokens equal to the reference's `PagedBatcher`'s."""
    kw = dict(batch=2, paged=True, page_size=16, kv_pages=12)
    jeng, eng = ref_engines("gemma2", "chain", **kw), _port_engine(pairs["gemma2"], "chain", **kw)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (20, 33)]

    def run(b):
        slots = [b.submit(p, max_new_tokens=14, stop_at_eos=False) for p in prompts]
        b.run_until_done(max_steps=200)
        return [list(map(int, s.generated[:14])) for s in slots]

    assert run(eng.batcher) == run(jeng.batcher)


@pytest.fixture
def f32_configs(monkeypatch):
    """Both CLIs' engines at f32 (their default compute is bf16)."""
    monkeypatch.setattr(jax_api, "EngineConfig", functools.partial(
        jax_api.EngineConfig, compute_dtype=jnp.float32, kv_dtype=jnp.float32))
    monkeypatch.setattr(port_api, "EngineConfig", functools.partial(
        port_api.EngineConfig, compute_dtype=torch.float32, kv_dtype=torch.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_matches_reference_cli(pairs, f32_configs, capsys, arch):
    """`--draft --temp 0`: the same text as the reference's CLI; the
    tokenizer and the chat template are the ones the file's metadata names."""
    pair = pairs[arch]
    argv = ["-m", str(pair[0]), "--draft", str(pair[1]), "-p", PROMPT, "--ctx", str(MAX_SEQ),
            "-n", "12", "--temp", "0"]
    assert jax_cli.main(argv + ["--backend", "xla"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out == want and out.strip() and "[speculative]" in err
    eng = _port_engine(pair, "plain")
    assert isinstance(eng.tokenizer, BPETokenizer) == arch.startswith("qwen")
    assert detect_template(eng.metadata["tokenizer.chat_template"]) == TEMPLATES[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_reference(pairs, arch):
    """The port's server and the reference's on the same files (the chain,
    one slot): `/v1/chat/completions` under the file's template (chatml or
    gemma) and a streamed `/completion`, the same bodies apart from ids and
    times."""
    import json

    from eagle_tpu_torch.server.server import InferenceServer
    from test_torch_server import _frames, _reference, _strip, post

    pair = pairs[arch]
    srv = InferenceServer(_port_engine(pair, "chain"), model_name="tiny")
    host, port = srv.start("127.0.0.1", 0)
    ref, stop_ref = _reference((str(pair[0]), str(pair[1])), 1)
    try:
        chat = [{"role": "system", "content": "the lazy dog"},
                {"role": "user", "content": "naïve café fox"}]
        for path, body in (
                ("/v1/chat/completions", {"messages": chat, "max_tokens": 10, "temperature": 0}),
                ("/completion", {"prompt": PROMPT, "n_predict": 8, "temperature": 0,
                                 "stream": True})):
            got = post(f"http://{host}:{port}{path}", body, raw=True)[1]
            want = post(ref + path, body, raw=True)[1]
            if body.get("stream"):
                assert [_strip(json.loads(f)) for f in _frames(got) if f != "[DONE]"] == \
                    [_strip(json.loads(f)) for f in _frames(want) if f != "[DONE]"]
            else:
                assert _strip(json.loads(got)) == _strip(json.loads(want))
    finally:
        srv.stop()
        stop_ref()


# ---- chat over a shifting cache ---------------------------------------------


TURNS = ["the quick brown fox jumps", "a lazy dog and then naïve café", "then the fox"]


def _session(eng, on_shift=None):
    s = eng.chat_session()
    gen = s.gen
    if hasattr(gen.kv, "spill"):  # an empty cache: the engines' earlier runs left tags
        gen.kv.rollback(torch.zeros((gen.batch,), dtype=torch.int32))
    else:
        gen.kv = gen.kv.rollback(jnp.zeros((gen.batch,), jnp.int32))
    if on_shift is not None:
        real = gen.shift_context

        def shift(keep, discard):
            kept = s.fed[:keep] + s.fed[keep + discard:s.pos]
            real(keep, discard)
            on_shift(kept, gen.kv.k.clone(), gen.kv.slot_pos.clone())

        gen.shift_context = shift
    replies = [s.ask(text, max_new_tokens=40) for text in TURNS]
    if on_shift is not None:
        del gen.shift_context
    return replies, list(s.fed), s.pos


def test_chat_session_shifts_as_the_reference(pairs, ref_engines):
    """qwen2 (biased keys), chatml from the file, a 128-slot cache: three
    turns overflow it, so the session shifts. Replies, the tokens kept and
    the position equal the reference's; after the first shift layer 0's
    moved keys equal a fresh forward of the kept tokens at their new
    positions."""
    eng = _port_engine(pairs["qwen2"], "plain")
    shifts = []
    got = _session(eng, lambda *a: shifts.append(a))
    assert got == _session(ref_engines("qwen2", "plain")) and shifts
    kept, k_after, tags = shifts[0]
    n = len(kept)
    assert torch.equal(tags[0, :n], torch.arange(n, dtype=torch.int32))
    cfg = eng.model_cfg
    fresh = KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim,
                           torch.float32, device="cpu")
    _forward(eng.params, cfg, fresh, np.asarray([kept], np.int32), np.arange(n)[None])
    # layer 0's keys are a function of the token and its position alone
    np.testing.assert_allclose(k_after[0, :, :, :n].numpy(), fresh.k[0, :, :, :n].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_causal_mask_window_matches_reference():
    """`causal_mask_from_tags(swa_window=)` against the reference's
    (kvcache.py:198) on holed tags, for windows 0, 1, 8 and past the cache."""
    rng = np.random.default_rng(0)
    tags = np.arange(64, dtype=np.int32)[None].repeat(2, 0)
    tags[0, 10:20] = -1
    tags[1, 40:] = -1
    q = rng.integers(0, 70, size=(2, 5)).astype(np.int32)
    for w in (0, 1, 8, 100):
        want = np.asarray(jkv.causal_mask_from_tags(jnp.asarray(tags), jnp.asarray(q), w))
        got = causal_mask_from_tags(torch.from_numpy(tags), torch.from_numpy(q), swa_window=w)
        np.testing.assert_array_equal(got.numpy(), want)


# ---- the kernels' plans at the published shapes --------------------------------

#: (N, K) of the published shapes' products (Qwen2.5-7B, Qwen3-8B, Gemma-2-9B;
#: Gemma-7B: the query 4,096 wide over n_embd 3,072; Gemma-2B: 8 heads of 256
#: over 1 KV head on 2,048)
FAMILY_SHAPES = {"gemma_7b_wqkv": (12288, 3072), "gemma_7b_wo": (3072, 4096),
                 "gemma_7b_w_gate_up": (49152, 3072), "gemma_7b_w_down": (3072, 24576),
                 "gemma_2b_wqkv": (2560, 2048), "gemma_2b_w_gate_up": (32768, 2048),
                 "gemma_2b_w_down": (2048, 16384),
                 "qwen2.5_wqkv": (4608, 3584), "qwen2.5_wo": (3584, 3584),
                 "qwen2.5_w_gate_up": (37888, 3584), "qwen2.5_w_down": (3584, 18944),
                 "qwen2.5_lm_head": (152064, 3584), "qwen2.5_draft_fc": (3584, 7168),
                 "qwen3_w_gate_up": (24576, 4096), "qwen3_w_down": (4096, 12288),
                 "qwen3_lm_head": (151936, 4096), "gemma2_wqkv": (8192, 3584),
                 "gemma2_wo": (3584, 4096), "gemma2_w_down": (3584, 14336)}


@pytest.mark.parametrize("name", sorted(FAMILY_SHAPES))
def test_qmm_plans_cover_the_family_shapes(name):
    """At 1, 6 and 300 rows the three tensor-core bodies' plans, for the
    coded Q4_K / Q6_K forms and Q8_0's, fit shared memory and cut K into
    splits that cover it once, on whole 256-row super-blocks for coded
    weights (K = 3,584 is 14 of them, 18,944 is 74)."""
    from eagle_tpu_torch.ops.qmm import TcForm, _gemv_plan, _mma_plan, _route, _tc_plan

    n, k = FAMILY_SHAPES[name]
    forms = (TcForm("packed", 1, True, 1), TcForm("int8", 1, True, 1),
             TcForm("int8", 4, False, 0))
    for f in forms:
        for rows, plan in ((1, lambda: _gemv_plan(k, n, 16, f)),
                           (6, lambda: _mma_plan(6, k, n, 16, f)),
                           (300, lambda: _tc_plan(300, k, n, 16, f))):
            assert _route(rows, k, n, torch.bfloat16, f) == {1: "gemv", 6: "mma", 300: "tc"}[rows]
            p = plan()
            assert p.smem_bytes <= 232448
            steps = k // 64
            assert p.splits * p.steps_per_split >= steps > (p.splits - 1) * p.steps_per_split
            assert not f.coded or p.steps_per_split % 4 == 0, (rows, f, p)


@pytest.mark.parametrize("tg", [7, 42, 3584])
def test_flash_plan_at_g7(tg):
    """The flash kernels' plan at Qwen2.5's g = 7 (28 query heads over 4 KV
    heads of 128, bf16): T·g = 7 and 42 rows take 16-row blocks whose one
    warp tile is not wholly padding, with key splits over 1,024 slots;
    3,584 rows (a 512-row prompt) take 128-row blocks, 28 of them a head,
    with no split; the ring fits shared memory."""
    from eagle_tpu_torch.ops import flash_attention as fa

    for tags in (False, True):
        p = fa._plan(tg, 1024, 128, torch.bfloat16, 4, tags)
        assert p.body == "mma" and p.smem_bytes <= 232448
        assert p.rows_per_block == (128 if tg == 3584 else 16)
        assert -(-tg // p.rows_per_block) * p.rows_per_block - tg < 16
        assert (p.splits > 1) == (tg < 3584)
        assert p.splits * p.keys_per_split >= 1024 > (p.splits - 1) * p.keys_per_split


# ---- Gemma-2 without its attention softcap: the flash kernels at D = 256 -------


@pytest.fixture(scope="module")
def gemma2_256(tmp_path_factory):
    """A tiny gemma2 at head_dim 256 (2 query heads over 1 KV head) with
    no attention softcap: the window, sandwich norms, final softcap and tied
    head as `tiny_family_pair`'s, its attention on the flash functions."""
    from eagle_tpu.gguf.constants import GGMLType

    from torch_port_util import FAMILIES, GEMMA_TEMPLATE, spm_metadata

    q8 = GGMLType.Q8_0
    md = {k: v for k, v in FAMILIES["gemma2"]["md"].items() if "attn_logit" not in k}
    pair = write_tiny_gguf_pair(
        tmp_path_factory.mktemp("gemma2_256"), q8, q8, q8, q8, seed=17, arch="gemma2",
        target_metadata={**spm_metadata(ENGINE_PROMPT), "tokenizer.chat_template":
                         GEMMA_TEMPLATE, **md},
        n_layers=4, tied=True, out_scale=0.1, n_heads=2, n_kv_heads=1, head_dim=256)
    tt, tcfg, _ = load_llama_params(pair[0], device="cpu")
    jt, jcfg, _ = jax_load(pair[0])
    return pair, dict(tt=tt, tcfg=tcfg, jt=jt, jcfg=jcfg)


def test_gemma2_without_softcap_matches_reference(gemma2_256):
    """Once refused (no kernel took D = 256): the config admitted, every
    layer's attention on the flash functions (their plain versions here,
    the window's layers on `flash_decode` under the windowed mask), the
    prefill and decode logits at rtol 1e-4 and `Generator`'s greedy tokens
    equal to the reference's."""
    from eagle_tpu_torch import _build

    pair, m = gemma2_256
    cfg = m["tcfg"]
    check_ported(cfg)
    assert (cfg.head_dim, cfg.attn_softcap, cfg.swa_window) == (256, 0.0, 8)
    toks = _tokens(N_PROMPT + 2)
    jcache, cache = _caches(cfg)
    pos = np.arange(N_PROMPT, dtype=np.int32)[None]
    want = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, :N_PROMPT], pos)
    before = _build.plain_calls["flash_decode"]
    _close(_forward(m["tt"], cfg, cache, toks[:, :N_PROMPT], pos).logits, want.logits)
    assert _build.plain_calls["flash_decode"] - before == cfg.n_layers
    jcache = want.kv
    for i in range(N_PROMPT, N_PROMPT + 2):
        p = np.asarray([[i]], np.int32)
        want = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, i:i + 1], p)
        jcache = want.kv
        _close(_forward(m["tt"], cfg, cache, toks[:, i:i + 1], p).logits, want.logits)
    jeng, eng = _jax_engine(pair, "plain"), _port_engine(pair, "plain")
    ids = eng.tokenizer.encode(PROMPT)
    assert ids == jeng.tokenizer.encode(PROMPT)
    want = jeng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
    assert eng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False) == [int(t)
                                                                             for t in want]


# ---- what stays refused -----------------------------------------------------


REFUSED = {"swa_window on every layer": dict(swa_window=8, swa_every=0),
           "learned positions": dict(has_pos_embd=True), "v_head_dim": dict(v_head_dim=32),
           "alibi": dict(use_alibi=True), "relu2": dict(act="relu2"),
           "hetero GQA": dict(head_counts=(4, 2))}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_configs_name_item_8(models, name):
    cfg = dataclasses.replace(models["qwen2"]["tcfg"], **REFUSED[name])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        check_ported(cfg)


def test_refused_files(tmp_path, models):
    """Another architecture (phi3) at `Engine`, a flat q/k norm (olmo2's
    [H * Dh] weight) at the forward, both naming item 8, and an EAGLE draft
    with biases at its loader."""
    from eagle_tpu.gguf.constants import GGMLType
    from eagle_tpu_torch.gguf import GGUFReader, GGUFWriter

    q8 = GGMLType.Q8_0
    target, draft = write_tiny_gguf_pair(tmp_path, q8, q8, q8, q8, arch="phi3")
    with pytest.raises(NotImplementedError, match="item 8"):
        port_api.Engine(port_api.EngineConfig(model_path=target, device="cpu"))

    m = models["qwen3"]
    cfg, layers = m["tcfg"], m["tt"]["layers"]
    flat = torch.ones((cfg.n_layers, cfg.n_heads * cfg.head_dim))
    params = {**m["tt"], "layers": {**layers, "attn_q_norm": flat, "attn_k_norm": flat}}
    pos = torch.zeros((1, 1), dtype=torch.int32)
    kv = _caches(cfg)[1]
    with pytest.raises(NotImplementedError, match="item 8"):
        llama_forward(params, cfg, pos, pos, kv, pos, causal_mask_from_tags(kv.slot_pos, pos))

    src = GGUFReader(draft)
    biased = tmp_path / "biased.gguf"
    w = GGUFWriter(biased)
    for k, v in src.metadata.items():
        w.add(k, v)
    for name, info in src.tensors.items():
        if len(info.shape) == 2:
            w.add_tensor(name, src.tensor_bytes(name), info.ggml_type, raw_shape=info.shape)
        else:
            w.add_tensor(name, src.tensor_f32(name))
    w.add_tensor("blk.0.attn_q.bias", np.zeros(256, np.float32))
    w.write()
    with pytest.raises(NotImplementedError, match="drops them"):
        load_eagle_params(biased, device="cpu")

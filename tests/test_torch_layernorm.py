"""The rotary LayerNorm families in the port on the CPU, against the
reference, on tiny Q8_0 pairs (`tiny_layernorm_pair`: 2 layers, width 256,
a byte-level BPE vocabulary with each family's pre-tokenizer):

- phi2: 4 heads of 80 (the plain attention: no flash kernel takes D = 80),
  32 of 80 features rotary, one shared LayerNorm (with its bias) feeding
  attention and a no-gate GELU MLP in parallel, biases on q/k/v, the
  attention output, fc1 / fc2 and the head;
- starcoder2: LayerNorm with biases, GQA 4:2, q/k/v and output biases, a
  no-gate GELU MLP with biases, rope base 1e6, sequential;
- stablelm: LayerNorm with biases, q/k/v biases, 16 of 64 rotary, a gated
  SiLU FFN with its own LayerNorm, sequential;
- gptneox: a fused `attn_qkv` with its bias, 16 of 64 rotary, a no-gate GELU
  MLP with biases, parallel with its own FFN norm ("gptneox") or sequential
  ("gptneox-seq");
- command-r: LayerNorm without biases, parallel from one norm, the
  adjacent-pair rope rows (un-permuted at load), a logit scale of 0.25, a
  tied head and a command-r template.

For each: the config and the loaded params bit-equal to the reference's
`load_llama_params` (and carried across by `convert.params_from_numpy`); prefill and decode logits at rtol 1e-4 in f32, and each
branch moving them. For phi2 and starcoder2: `Generator`, the EAGLE chain,
the static tree, lookahead, `LookupEngine` and `ContinuousBatcher` tokens
and stats equal to the reference's, `Engine` text, the CLI and the server.
One int8 and one paged case; a shift with partial rotary against a
recompute (the reference's context shift raises there); the fused-FFN gate;
the kernels' plans at StarCoder2-7B's and Phi-2's shapes; the refusals."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models.loader import load_llama_params as jax_load
from eagle_tpu.ops import rope as jrope
from eagle_tpu.runtime import kvcache as jkv
from eagle_tpu.tools import cli as jax_cli
from eagle_tpu_torch import _build
from eagle_tpu_torch.models.config import LAYERNORM_TARGETS, ModelConfig, check_ported
from eagle_tpu_torch.models.llama import llama_forward
from eagle_tpu_torch.models.loader import load_llama_params
from eagle_tpu_torch.ops.ffn import supports_ffn_block
from eagle_tpu_torch.ops.flash_attention import HEAD_DIMS
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags
from eagle_tpu_torch.server.chat_templates import detect_template
from eagle_tpu_torch.tokenizer import BPETokenizer
from eagle_tpu_torch.tools import cli
from test_torch_families import (  # noqa: F401  (f32_configs: a fixture)
    KINDS,
    MAX_SEQ,
    _close,
    _jax_engine,
    _port_engine,
    f32_configs,
)
from test_torch_loader import _same_tree
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    LN_FAMILIES,
    LN_FAMILIES2,
    LN_PRE,
    background_cpu,
    jax_cfg_to_torch,
    tiny_layernorm_pair,
    tiny_lnfamily_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

NAMES = list(LN_FAMILIES)
ENGINE_ARCHS = ["phi2", "starcoder2"]
N_PROMPT = 30
PROMPT = "the quick brown fox jumps over a lazy dog and then naïve café"
FLASH = ("flash_decode", "flash_prefill")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return {n: tiny_layernorm_pair(tmp_path_factory.mktemp(n), n) for n in NAMES}


@pytest.fixture(scope="module")
def models(pairs):
    out = {}
    for n, (target, _) in pairs.items():
        tt, tcfg, _ = load_llama_params(target, device="cpu")
        jt, jcfg, _ = jax_load(target)
        out[n] = dict(tt=tt, tcfg=tcfg, jt=jt, jcfg=jcfg)
    return out


@pytest.fixture(scope="module")
def ref_engines(pairs):
    """The reference's engines, built once per module and (name, kind)."""
    cache = {}

    def get(name, kind="chain", **kw):
        key = (name, kind, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = _jax_engine(pairs[name], kind, **kw)
        return cache[key]

    return get


def _tokens(n, seed=3):
    return np.random.default_rng(seed).integers(0, 505, size=(1, n)).astype(np.int32)


def _forward(params, cfg, kv, tokens, positions, slots=None, prefill=False):
    """The port's forward in f32; `prefill` passes the tag mask for the
    prompt path (`causal_tags_prefill`)."""
    positions = torch.from_numpy(np.asarray(positions, np.int32))
    slots = positions if slots is None else torch.from_numpy(np.asarray(slots, np.int32))
    kv.with_tags(slots, positions)
    mask = causal_mask_from_tags(kv.slot_pos, positions)
    return llama_forward(params, cfg, torch.from_numpy(tokens), positions, kv, slots, mask,
                         compute_dtype=torch.float32, causal_tags_prefill=prefill)


def _jax_forward(params, cfg, kv, tokens, positions):
    from eagle_tpu.models.llama import llama_forward as jax_llama_forward

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

#: (norm_type, parallel_blocks, rope_dim, head_dim, act, attn_bias, logit_scale)
WANT_CFG = {"phi2": ("layer", True, 32, 80, "gelu", False, 1.0),
            "starcoder2": ("layer", False, 64, 64, "gelu", True, 1.0),
            "stablelm": ("layer", False, 16, 64, "silu", False, 1.0),
            "gptneox": ("layer", True, 16, 64, "gelu", False, 1.0),
            "gptneox-seq": ("layer", False, 16, 64, "gelu", False, 1.0),
            "command-r": ("layer", True, 64, 64, "silu", False, 0.25)}
#: the optional tensors each file carries (layer keys, then top-level keys)
WANT_KEYS = {
    "phi2": ({"attn_norm_b", "bqkv", "bo", "w_up", "b_up", "b_down"}, {"output_norm_b",
                                                                       "output_b"}),
    "starcoder2": ({"attn_norm_b", "ffn_norm", "ffn_norm_b", "bqkv", "bo", "w_up", "b_up",
                    "b_down"}, {"output_norm_b"}),
    "stablelm": ({"attn_norm_b", "ffn_norm", "ffn_norm_b", "bqkv", "w_gate_up"},
                 {"output_norm_b"}),
    "gptneox": ({"attn_norm_b", "ffn_norm", "ffn_norm_b", "bqkv", "bo", "w_up", "b_up",
                 "b_down"}, {"output_norm_b"}),
    "command-r": ({"w_gate_up"}, set()),
}
WANT_KEYS["gptneox-seq"] = WANT_KEYS["gptneox"]
_BASE_LAYER = {"attn_norm", "wqkv", "wo", "w_down"}


@pytest.mark.parametrize("name", NAMES)
def test_config_reads_the_family(models, name):
    m = models[name]
    tcfg, jcfg = m["tcfg"], m["jcfg"]
    assert tcfg == jax_cfg_to_torch(jcfg)
    check_ported(tcfg)
    assert tcfg.arch in LAYERNORM_TARGETS
    assert (tcfg.norm_type, tcfg.parallel_blocks, tcfg.rope_dim, tcfg.head_dim, tcfg.act,
            tcfg.attn_bias, tcfg.logit_scale) == WANT_CFG[name]
    assert tcfg.rms_eps == float(np.float32(1e-5))  # layer_norm_epsilon, not the RMS key
    layer_keys, top_keys = WANT_KEYS[name]
    assert set(m["tt"]["layers"]) == _BASE_LAYER | layer_keys
    assert set(m["tt"]) - {"tok_embd", "layers", "output_norm", "output"} == top_keys
    assert (m["tt"]["output"] is m["tt"]["tok_embd"]) == (name == "command-r")


@pytest.mark.parametrize("name", NAMES)
def test_loaded_params_bit_equal(models, name):
    """Every leaf bit-equal to the reference's `load_llama_params`: the
    biases stacked f32 (gptneox's fused `attn_qkv.bias` as `bqkv`),
    command-r's q/k rows un-permuted, the rest as the file holds them."""
    m = models[name]
    _same_tree(m["tt"], m["jt"])


@pytest.mark.parametrize("name", ["phi2", "gptneox"])
def test_params_carried_across(models, name):
    """The reference's loaded params, every leaf turned to numpy on the JAX
    side, come through `convert.params_from_numpy` bit-equal to the port's
    own load (the biases, `w_up`, `output_b` and `output_norm_b` included)
    and give the same logits."""
    from eagle_tpu_torch.convert import params_from_numpy
    from torch_port_util import tree_to_numpy

    m = models[name]
    carried = params_from_numpy(tree_to_numpy(m["jt"]), device="cpu")
    _same_tree(carried, m["jt"])
    toks, pos = _tokens(N_PROMPT), np.arange(N_PROMPT, dtype=np.int32)[None]
    want = _forward(m["tt"], m["tcfg"], _caches(m["tcfg"])[1], toks, pos).logits
    assert torch.equal(_forward(carried, m["tcfg"], _caches(m["tcfg"])[1], toks, pos).logits,
                       want)


# ---- the forward ------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(models, name):
    """A 30-token prefill through the tag-mask path, then 3 decoded tokens one
    at a time: logits, the hidden state and the final norm's input (the
    feature the engines hand the EAGLE draft) at rtol 1e-4 in f32. Head width 64
    takes the flash functions (their plain versions here: `flash_prefill` once
    a layer for the prompt, `flash_decode` once a layer a token); Phi-2's 80
    reads the plain attention, as the reference's einsums."""
    m = models[name]
    cfg = m["tcfg"]
    toks = _tokens(N_PROMPT + 3)
    jcache, cache = _caches(cfg)
    pos = np.arange(N_PROMPT, dtype=np.int32)[None]
    want = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, :N_PROMPT], pos)
    before = {k: _build.plain_calls[k] for k in FLASH}
    got = _forward(m["tt"], cfg, cache, toks[:, :N_PROMPT], pos, prefill=True)
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden)
    _close(got.hidden_pre, want.hidden_pre)  # the EAGLE draft's feature ("pre_norm")
    jcache = want.kv
    for i in range(N_PROMPT, N_PROMPT + 3):
        p = np.asarray([[i]], np.int32)
        want_i = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, i:i + 1], p)
        jcache = want_i.kv
        _close(_forward(m["tt"], cfg, cache, toks[:, i:i + 1], p).logits, want_i.logits)
    calls = {k: _build.plain_calls[k] - before[k] for k in FLASH}
    flash = cfg.head_dim in HEAD_DIMS
    assert flash == (name != "phi2")
    assert calls == ({"flash_prefill": cfg.n_layers, "flash_decode": 3 * cfg.n_layers}
                     if flash else {"flash_prefill": 0, "flash_decode": 0})


def _drop(*keys, top=False):
    """A params change that leaves out `keys` (of the layers, or at the top)."""
    def change(c, p):
        if top:
            return c, {k: v for k, v in p.items() if k not in keys}
        return c, {**p, "layers": {k: v for k, v in p["layers"].items() if k not in keys}}
    return change


def _cfg(**kw):
    return lambda c, p: (dataclasses.replace(c, **kw), p)


#: (name, branch, change): each must move the prefill's logits
BRANCHES = [
    ("phi2", "LayerNorm (as RMSNorm)", _cfg(norm_type="rms")),
    ("phi2", "the norms' biases", _drop("attn_norm_b")),
    ("phi2", "parallel (as sequential)", _cfg(parallel_blocks=False)),
    ("phi2", "partial rotary (as full)", _cfg(rope_dim=80)),
    ("phi2", "bo", _drop("bo")),
    ("phi2", "b_up / b_down", _drop("b_up", "b_down")),
    ("phi2", "output_b", _drop("output_b", top=True)),
    ("phi2", "output_norm_b", _drop("output_norm_b", top=True)),
    ("starcoder2", "the norms' biases", _drop("attn_norm_b", "ffn_norm_b")),
    ("starcoder2", "bqkv", _drop("bqkv")),
    ("stablelm", "partial rotary (as full)", _cfg(rope_dim=64)),
    ("stablelm", "ffn_norm_b", _drop("ffn_norm_b")),
    ("gptneox", "the FFN's own norm (as shared)", _drop("ffn_norm", "ffn_norm_b")),
    ("gptneox", "parallel (as sequential)", _cfg(parallel_blocks=False)),
    ("command-r", "logit_scale", _cfg(logit_scale=1.0)),
    ("command-r", "parallel (as sequential: no ffn_norm)", _cfg(parallel_blocks=False)),
]


@pytest.mark.parametrize("name,branch,change", BRANCHES, ids=[f"{n}-{b}" for n, b, _ in BRANCHES])
def test_each_branch_moves_the_logits(models, name, branch, change):
    m = models[name]
    toks, pos = _tokens(N_PROMPT), np.arange(N_PROMPT, dtype=np.int32)[None]
    base = _forward(m["tt"], m["tcfg"], _caches(m["tcfg"])[1], toks, pos).logits
    cfg, params = change(m["tcfg"], m["tt"])
    other = _forward(params, cfg, _caches(cfg)[1], toks, pos).logits
    assert float((other - base).abs().max()) > 1e-3 * float(base.abs().max()), branch


# ---- the engines and the entry points ---------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", ENGINE_ARCHS)
def test_engines_match_reference(pairs, ref_engines, name, kind):
    """`Generator`, the EAGLE chain and the static tree (3,): tokens and the
    speculative stats equal to the reference's on the prompt's ids; the
    chain's `Engine.generate_text` equal to the reference's too."""
    jeng, eng = ref_engines(name, kind), _port_engine(pairs[name], kind)
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


@pytest.mark.parametrize("name", ENGINE_ARCHS)
def test_model_free_engines_match_reference(pairs, ref_engines, name):
    """Lookahead (W, N, G) = (4, 3, 2) through `Engine` and `LookupEngine`
    (K = 4) on the loaded params: tokens and stats equal to the
    reference's, on a prompt said twice (so lookup drafts from it)."""
    from eagle_tpu.runtime.lookup import LookupEngine as JaxLookup
    from eagle_tpu_torch.runtime.lookup import LookupEngine

    jeng = ref_engines(name, "plain", lookahead=(4, 3, 2))
    eng = _port_engine(pairs[name], "plain", lookahead=(4, 3, 2))
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


@pytest.mark.parametrize("name", ENGINE_ARCHS)
def test_batcher_matches_reference(pairs, ref_engines, name):
    """`Engine(batch=2)`'s `ContinuousBatcher`: three prompts of 5-31
    tokens over two slots (the third waits for a free slot), each slot's
    tokens equal to the reference batcher's."""
    jeng, eng = ref_engines(name, "chain", batch=2), _port_engine(pairs[name], "chain", batch=2)
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


def test_int8_cache_matches_reference(pairs, ref_engines):
    """phi2's EAGLE chain on int8 caches (partial rotary keys quantized as
    written, the dequantized plain read at D = 80, the draft's cache int8
    too): tokens and stats equal to the reference's."""
    jeng = ref_engines("phi2", "chain", kv="int8")
    eng = _port_engine(pairs["phi2"], "chain", kv="int8")
    ids = eng.tokenizer.encode(PROMPT)
    want, want_stats = jeng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
    got, stats = eng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
    assert stats == want_stats
    assert [int(t) for t in got] == [int(t) for t in want]


def test_paged_batcher_matches_reference(pairs, ref_engines):
    """gptneox (parallel, fused qkv, partial rotary) on a paged pool
    (`Engine(batch=2, paged=True)`, pages of 16 rows): each slot's tokens
    equal to the reference's `PagedBatcher`'s."""
    kw = dict(batch=2, paged=True, page_size=16, kv_pages=12)
    jeng, eng = ref_engines("gptneox", "chain", **kw), _port_engine(pairs["gptneox"], "chain",
                                                                    **kw)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (20, 33)]

    def run(b):
        slots = [b.submit(p, max_new_tokens=14, stop_at_eos=False) for p in prompts]
        b.run_until_done(max_steps=200)
        return [list(map(int, s.generated[:14])) for s in slots]

    assert run(eng.batcher) == run(jeng.batcher)


@pytest.mark.parametrize("name", ["phi2", "command-r"])
def test_cli_matches_reference_cli(pairs, f32_configs, capsys, name):
    """`--draft --temp 0`: the same text as the reference's CLI; the BPE
    tokenizer with the family's pre-tokenizer, and command-r's template."""
    pair = pairs[name]
    argv = ["-m", str(pair[0]), "--draft", str(pair[1]), "-p", PROMPT, "--ctx", str(MAX_SEQ),
            "-n", "12", "--temp", "0"]
    assert jax_cli.main(argv + ["--backend", "xla"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out == want and out.strip() and "[speculative]" in err
    eng = _port_engine(pair, "plain")
    assert isinstance(eng.tokenizer, BPETokenizer)
    assert eng.metadata["tokenizer.ggml.pre"] == LN_PRE[eng.model_cfg.arch]
    assert detect_template(eng.metadata.get("tokenizer.chat_template")) == (
        "command-r" if name == "command-r" else "chatml")


def test_server_matches_reference(pairs):
    """The port's server and the reference's on starcoder2's files (the
    chain, one slot): `/v1/chat/completions` and a streamed `/completion`,
    the same bodies apart from ids and times."""
    from eagle_tpu_torch.server.server import InferenceServer
    from test_torch_server import _frames, _reference, _strip, post

    pair = pairs["starcoder2"]
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


# ---- a shift under partial rotary ---------------------------------------------


@pytest.mark.parametrize("kind", ["context_shift", "self_extend"])
def test_partial_rotary_shift_equals_recompute(models, kind):
    """phi2 (32 of 80 features rotary): prefill 80 tokens, then a context
    shift or a Self-Extend step. The port's `Generator` re-rotates the first
    32 features of each key only, as its forward does, so layer 0's keys (a
    function of the token and its position) equal a fresh forward's at the
    new positions. The reference's shift applies `inv_freq` [16] to the
    whole 80-wide key's halves and raises."""
    m = models["phi2"]
    cfg = m["tcfg"]
    n, keep, discard = 80, 6, 30
    toks = _tokens(n, seed=8)
    pos = np.arange(n, dtype=np.int32)[None]
    gen = Generator(m["tt"], cfg, max_seq=MAX_SEQ, kv_dtype=torch.float32,
                    compute_dtype=torch.float32, eos_id=-1, device="cpu")
    _forward(m["tt"], cfg, gen.kv, toks, pos)
    jcache = _jax_forward(m["jt"], m["jcfg"], _caches(cfg)[0], toks, pos).kv
    j_inv = jrope.rope_freqs_cfg(m["jcfg"])[0]
    assert j_inv.shape == (16,)
    if kind == "context_shift":
        gen.shift_context(keep, discard)
        with pytest.raises(Exception):
            jkv.context_shift(jcache, j_inv, keep, discard)
        kept = np.concatenate([toks[:, :keep], toks[:, keep + discard:]], axis=1)
        new_pos = np.arange(n - discard, dtype=np.int32)[None]
        slots = new_pos[0]
    else:
        gen.self_extend(n, 0, 2, 32)
        with pytest.raises(Exception):
            jkv.self_extend_shift(jcache, j_inv, n, 0, 2, 32)
        new_pos = gen.kv.slot_pos.numpy()[:, :n]
        kept, slots = toks, np.arange(n)
    fresh = _forward(m["tt"], cfg, _caches(cfg)[1], kept, new_pos,
                     np.arange(kept.shape[1])[None]).kv
    got = gen.kv.k[0, :, :, slots].numpy()
    recompute = fresh.k[0, :, :, :kept.shape[1]].numpy()
    np.testing.assert_allclose(got, recompute, rtol=1e-5, atol=1e-5)
    # the features past rope_dim never move
    np.testing.assert_array_equal(got[..., 32:], recompute[..., 32:])


TURNS = ["the quick brown fox jumps", "a lazy dog and then naïve café", "then the fox"]


def test_chat_session_shifts_with_partial_rotary(pairs):
    """phi2's `ChatSession` on a 128-slot cache: three turns overflow it, so
    the session shifts; after the first shift layer 0's moved keys equal a
    fresh forward of the kept tokens at their new positions, and every turn
    gives a reply."""
    eng = _port_engine(pairs["phi2"], "plain")
    s = eng.chat_session()
    gen = s.gen
    shifts = []
    real = gen.shift_context

    def shift(keep, discard):
        kept = s.fed[:keep] + s.fed[keep + discard:s.pos]
        real(keep, discard)
        shifts.append((kept, gen.kv.k.clone()))

    gen.shift_context = shift
    replies = [s.ask(text, max_new_tokens=40) for text in TURNS]
    assert shifts and all(isinstance(r, str) for r in replies)
    kept, k_after = shifts[0]
    cfg = eng.model_cfg
    fresh = KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim,
                           torch.float32, device="cpu")
    _forward(eng.params, cfg, fresh, np.asarray([kept], np.int32), np.arange(len(kept))[None])
    np.testing.assert_allclose(k_after[0, :, :, :len(kept)].numpy(),
                               fresh.k[0, :, :, :len(kept)].numpy(), rtol=1e-5, atol=1e-5)


# ---- the fused-FFN gate -------------------------------------------------------


def test_fused_ffn_gate_keeps_layernorm_models_off(models, monkeypatch, tmp_path):
    """stablelm (a gated FFN with its own LayerNorm) is what the reference's
    gate would admit: under EAGLE_TPU_FUSED_FFN=1 its FFN norm would become
    an RMSNorm without its bias. The gate reads False for it, for the
    parallel and biased families and for the other LayerNorm families
    (nemotron, olmo, orion, codeshell, falcon, gptj: orion's and olmo's
    gated FFNs too), and True for the same weights under an RMSNorm config
    without the biases (the weights themselves fit the block); fused and
    unfused logits are equal at decode and verify rows."""
    m = models["stablelm"]
    cfg, layers = m["tcfg"], m["tt"]["layers"]
    assert not supports_ffn_block(layers, cfg)
    plain = {k: v for k, v in layers.items() if k != "ffn_norm_b"}
    assert supports_ffn_block(plain, dataclasses.replace(cfg, norm_type="rms"))
    assert not supports_ffn_block(plain, dataclasses.replace(cfg, norm_type="rms",
                                                             parallel_blocks=True))
    for name in ("phi2", "starcoder2", "gptneox", "command-r"):
        assert not supports_ffn_block(models[name]["tt"]["layers"], models[name]["tcfg"]), name
    for name in LN_FAMILIES2:
        (tmp_path / name).mkdir()
        tt, tcfg, _ = load_llama_params(tiny_lnfamily_pair(tmp_path / name, name)[0],
                                        device="cpu")
        assert not supports_ffn_block(tt["layers"], tcfg), name
    toks = _tokens(N_PROMPT + 6)
    for mode in ("0", "1"):
        monkeypatch.setenv("EAGLE_TPU_FUSED_FFN", mode)
        cache = _caches(cfg)[1]
        _forward(m["tt"], cfg, cache, toks[:, :N_PROMPT], np.arange(N_PROMPT)[None])
        out = [_forward(m["tt"], cfg, cache, toks[:, N_PROMPT:N_PROMPT + 1],
                        [[N_PROMPT]]).logits,
               _forward(m["tt"], cfg, cache, toks[:, N_PROMPT + 1:],
                        np.arange(N_PROMPT + 1, N_PROMPT + 6)[None]).logits]
        if mode == "0":
            want = out
    for got, ref in zip(out, want):
        assert torch.equal(got, ref)


# ---- the kernels' plans at the published shapes --------------------------------

#: (N, K) of StarCoder2-7B's products (36 query / 4 KV heads of 128 over
#: 4,608, n_ff 18,432, vocab 49,152) and Phi-2's (32 heads of 80 over
#: 2,560, n_ff 10,240, vocab 51,200)
LN_SHAPES = {"starcoder2_wqkv": (5632, 4608), "starcoder2_wo": (4608, 4608),
             "starcoder2_w_up": (18432, 4608), "starcoder2_w_down": (4608, 18432),
             "starcoder2_lm_head": (49152, 4608), "starcoder2_draft_fc": (4608, 9216),
             "phi2_wqkv": (7680, 2560), "phi2_wo": (2560, 2560), "phi2_w_up": (10240, 2560),
             "phi2_w_down": (2560, 10240), "phi2_lm_head": (51200, 2560)}


@pytest.mark.parametrize("name", sorted(LN_SHAPES))
def test_qmm_plans_cover_the_shapes(name):
    """At 1, 6 and 300 rows the three tensor-core bodies' plans, for the
    coded Q4_K / Q6_K forms and Q8_0's, fit shared memory and cut K into
    splits that cover it once, on whole 256-row super-blocks for coded
    weights (K = 4,608 is 18 of them, 18,432 is 72, 2,560 10, 10,240 40)."""
    from eagle_tpu_torch.ops.qmm import TcForm, _gemv_plan, _mma_plan, _route, _tc_plan

    n, k = LN_SHAPES[name]
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


@pytest.mark.parametrize("tg", [9, 54, 4608])
def test_flash_plan_at_g9(tg):
    """The flash kernels' plan at StarCoder2-7B's g = 9 (36 query heads over
    4 KV heads of 128, bf16): T·g = 9 and 54 rows take 16- or 64-row blocks
    whose last warp tile is not wholly padding, with key splits over 1,024
    slots; 4,608 rows (a 512-row prompt) take 128-row blocks, 36 of them a
    head, with no split; the ring fits shared memory."""
    from eagle_tpu_torch.ops import flash_attention as fa

    for tags in (False, True):
        p = fa._plan(tg, 1024, 128, torch.bfloat16, 4, tags)
        assert p.body == "mma" and p.smem_bytes <= 232448
        if tg == 4608:
            assert p.rows_per_block == 128 and p.splits == 1
        else:
            assert -(-tg // p.rows_per_block) * p.rows_per_block - tg < 16
            assert p.splits > 1
        assert p.splits * p.keys_per_split >= 1024 > (p.splits - 1) * p.keys_per_split


# ---- what stays refused -----------------------------------------------------

REFUSED = {"learned positions": dict(has_pos_embd=True), "alibi": dict(use_alibi=True),
           "hetero GQA": dict(head_counts=(4, 2)), "m-rope": dict(mrope_sections=(8, 8, 16)),
           "mla": dict(kv_lora_rank=16), "relu2": dict(act="relu2"),
           "non-parametric norms": dict(nonparam_norms=True), "no rotary": dict(rope_dim=0),
           "LayerNorm of another arch": dict(arch="cohere2"),
           "LayerNorm of a llama": dict(arch="llama")}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_configs_name_item_8(models, name):
    cfg = dataclasses.replace(models["phi2"]["tcfg"], **REFUSED[name])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        check_ported(cfg)


def test_refused_weights_name_item_8(models):
    """q/k norms on a LayerNorm model (command-r-plus: llama.cpp norms them
    with LayerNorm, the reference with RMSNorm) and an up bias on a gated
    FFN (the reference drops it without `b_gate`) are refused at the
    forward, naming item 8; the other LayerNorm archs at `Engine`."""
    m = models["stablelm"]
    cfg, layers = m["tcfg"], m["tt"]["layers"]
    pos = torch.zeros((1, 1), dtype=torch.int32)
    for extra in ({"attn_q_norm": torch.ones(cfg.n_layers, cfg.head_dim),
                   "attn_k_norm": torch.ones(cfg.n_layers, cfg.head_dim)},
                  {"b_up": torch.zeros(cfg.n_layers, cfg.n_ff)}):
        params = {**m["tt"], "layers": {**layers, **extra}}
        kv = _caches(cfg)[1]
        with pytest.raises(NotImplementedError, match="item 8"):
            llama_forward(params, cfg, pos, pos, kv, pos,
                          causal_mask_from_tags(kv.slot_pos, pos))
    with pytest.raises(NotImplementedError, match="item 8"):
        ModelConfig.from_gguf_metadata({"general.architecture": "cohere2"})

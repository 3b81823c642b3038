"""The position families in the port on the CPU, against the reference, on
tiny Q8_0 pairs (`tiny_position_pair`: 2 layers, width 256, 4 query heads of
64, a byte-level BPE vocabulary with each family's pre-tokenizer). None of
them rotates q or k:

- gpt2: learned positions (`position_embd`, 160 rows), LayerNorm with
  biases, a fused `attn_qkv` with its bias, a no-gate GELU MLP with biases,
  a tied head;
- starcoder: the same with multi-query attention (one KV head) and its own
  head;
- bloom: ALiBi, the embedding LayerNorm, biases everywhere, a tied head;
- mpt: ALiBi, LayerNorm without biases, no bias anywhere, a tied head;
- refact: ALiBi, RMSNorm, multi-query attention, a gated SiLU FFN;
- jais: ALiBi, a gated SiLU FFN with gate / up / down biases (`b_gate_up`),
  the 1 / head_dim score scale and an embedding scale.

For each: the config and the loaded params bit-equal to the reference's
`load_llama_params` (and carried across by `convert.params_from_numpy`);
prefill and decode logits at rtol 1e-4 in f32, and each branch moving them;
`Generator`, the EAGLE chain and `ContinuousBatcher` tokens (and stats)
equal to the reference's, with the family's tokenizer. One int8 (bloom) and
one paged (jais) case on an ALiBi model; the CLI and the server. A position
past `pos_embd` and a pad row take the reference's clamped rows. The tree
verify under ALiBi: the port's verify logits are its greedy forward's at
every node, and the tree engines' tokens its greedy tokens; the reference's
slot-index distance moves its verify logits (ROADMAP queue 3). Self-Extend
refused on ALiBi; the context shift keeps slot == tag; no rotary at
`rope_dim` 0; refact's fused FFN block against the unfused one; the kernels'
plans at StarCoder-15B's g = 48 and at both cells' shapes; the refusals."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models import llama as jllama
from eagle_tpu.models.llama import llama_forward as jax_llama_forward
from eagle_tpu.models.loader import load_llama_params as jax_load
from eagle_tpu.runtime import kvcache as jkv
from eagle_tpu.runtime import tree as jtree
from eagle_tpu.tools import cli as jax_cli
from eagle_tpu_torch import _build
from eagle_tpu_torch.api import Engine, EngineConfig
from eagle_tpu_torch.models.config import (
    ALIBI_ARCHS,
    NO_ROPE_ARCHS,
    POS_EMBD_ARCHS,
    POSITION_TARGETS,
    TARGET_ARCHS,
    ModelConfig,
    check_ported,
)
from eagle_tpu_torch.models.llama import alibi_slopes, llama_forward, position_rows
from eagle_tpu_torch.models.loader import load_llama_params
from eagle_tpu_torch.ops.ffn import supports_ffn_block
from eagle_tpu_torch.ops.rope import apply_rope, rope_inv_freq
from eagle_tpu_torch.runtime import tree, tree2
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags, context_shift
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
    LN_PRE,
    POS_FAMILIES,
    background_cpu,
    jax_cfg_to_torch,
    oracle,
    tiny_position_pair,
    tree_to_numpy,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

NAMES = list(POS_FAMILIES)
ALIBI = [n for n in NAMES if n in ALIBI_ARCHS]
N_PROMPT = 30
N_POS = 160  # rows of the tiny files' position_embd
PROMPT = "the quick brown fox jumps over a lazy dog and then naïve café"
FLASH = ("flash_decode", "flash_prefill")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return {n: tiny_position_pair(tmp_path_factory.mktemp(n), n, n_pos=N_POS) for n in NAMES}


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


def _cache(cfg):
    return KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, torch.float32,
                          device="cpu")


def _jcache(cfg):
    return jkv.KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim,
                              jnp.float32)


def _forward(params, cfg, kv, tokens, positions, slots=None, mask=None, prefill=False):
    """The port's forward in f32: `slots` tagged with `positions` (slots ==
    positions by default), the tag mask unless `mask` is given; `prefill`
    passes `causal_tags_prefill`."""
    positions = torch.from_numpy(np.asarray(positions, np.int32))
    slots = positions if slots is None else torch.from_numpy(np.asarray(slots, np.int32))
    kv.with_tags(slots, positions)
    if mask is None:
        mask = causal_mask_from_tags(kv.slot_pos, positions)
    return llama_forward(params, cfg, torch.from_numpy(np.asarray(tokens)), positions, kv, slots,
                         mask, compute_dtype=torch.float32, causal_tags_prefill=prefill)


def _jax_forward(params, cfg, kv, tokens, positions, slots=None, mask=None):
    """The reference's forward (XLA, f32); returns its output (the new
    cache in `.kv`)."""
    positions = jnp.asarray(np.asarray(positions, np.int32))
    slots = positions if slots is None else jnp.asarray(np.asarray(slots, np.int32))
    kv = kv.with_tags(slots, positions)
    if mask is None:
        mask = jkv.causal_mask_from_tags(kv.slot_pos, positions)
    return jax_llama_forward(params, cfg, jnp.asarray(tokens), positions, kv, slots, mask,
                             backend="xla", compute_dtype=jnp.float32)


# ---- config and loader ------------------------------------------------------

#: (norm_type, act, has_pos_embd, use_alibi, n_kv_heads, attn_scale, embd_scale)
WANT_CFG = {"gpt2": ("layer", "gelu", True, False, 4, None, 1.0),
            "starcoder": ("layer", "gelu", True, False, 1, None, 1.0),
            "bloom": ("layer", "gelu", False, True, 4, None, 1.0),
            "mpt": ("layer", "gelu", False, True, 4, None, 1.0),
            "refact": ("rms", "silu", False, True, 1, None, 1.0),
            "jais": ("layer", "silu", False, True, 4, 1 / 64, 1.5)}
_LN_LAYER = {"attn_norm_b", "ffn_norm_b", "bqkv", "bo", "b_up", "b_down"}
#: the optional tensors each file carries (layer keys, then top-level keys)
WANT_KEYS = {"gpt2": (_LN_LAYER | {"w_up"}, {"pos_embd", "output_norm_b"}),
             "starcoder": (_LN_LAYER | {"w_up"}, {"pos_embd", "output_norm_b"}),
             "bloom": (_LN_LAYER | {"w_up"}, {"tok_embd_norm", "tok_embd_norm_b",
                                              "output_norm_b"}),
             "mpt": ({"w_up"}, set()),
             "refact": ({"w_gate_up"}, set()),
             "jais": (_LN_LAYER - {"b_up"} | {"w_gate_up", "b_gate_up"}, {"output_norm_b"})}
_BASE_LAYER = {"attn_norm", "ffn_norm", "wqkv", "wo", "w_down"}
TIED = {"gpt2", "bloom", "mpt"}


@pytest.mark.parametrize("name", NAMES)
def test_config_reads_the_family(models, name):
    """No rotary (`rope_dim` 0), learned positions on gpt2 / starcoder only,
    ALiBi on the other four, LayerNorm but for refact, GELU for the no-gate
    MLPs, jais's 1 / head_dim and embedding scale: the reference's config
    field for field."""
    m = models[name]
    tcfg, jcfg = m["tcfg"], m["jcfg"]
    assert tcfg == jax_cfg_to_torch(jcfg)
    check_ported(tcfg)
    assert tcfg.arch in POSITION_TARGETS and tcfg.arch in TARGET_ARCHS
    assert tcfg.rope_dim == 0 == jcfg.rope_dim and tcfg.arch in NO_ROPE_ARCHS
    assert (tcfg.norm_type, tcfg.act, tcfg.has_pos_embd, tcfg.use_alibi, tcfg.n_kv_heads,
            tcfg.attn_scale, tcfg.embd_scale) == WANT_CFG[name]
    layer_keys, top_keys = WANT_KEYS[name]
    assert set(m["tt"]["layers"]) == _BASE_LAYER | layer_keys
    assert set(m["tt"]) - {"tok_embd", "layers", "output_norm", "output"} == top_keys
    assert (m["tt"]["output"] is m["tt"]["tok_embd"]) == (name in TIED)
    if tcfg.has_pos_embd:
        assert tuple(m["tt"]["pos_embd"].shape) == (N_POS, tcfg.n_embd)
        assert m["tt"]["pos_embd"].dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_loaded_params_bit_equal(models, name):
    """Every leaf bit-equal to the reference's `load_llama_params`: the
    fused `attn_qkv` and its bias as they are (no rope rows to un-permute),
    `position_embd` f32, bloom's embedding LayerNorm, jais's gate bias fused
    with the up bias into `b_gate_up`."""
    m = models[name]
    _same_tree(m["tt"], m["jt"])


@pytest.mark.parametrize("name", ["gpt2", "bloom", "jais"])
def test_params_carried_across(models, name):
    """The reference's loaded params, every leaf turned to numpy on the JAX
    side, come through `convert.params_from_numpy` bit-equal to the port's
    own load (`pos_embd`, `tok_embd_norm(_b)` and `b_gate_up` included) and
    give the same logits."""
    from eagle_tpu_torch.convert import params_from_numpy

    m = models[name]
    carried = params_from_numpy(tree_to_numpy(m["jt"]), device="cpu")
    _same_tree(carried, m["jt"])
    toks, pos = _tokens(N_PROMPT), np.arange(N_PROMPT)[None]
    want = _forward(m["tt"], m["tcfg"], _cache(m["tcfg"]), toks, pos).logits
    assert torch.equal(_forward(carried, m["tcfg"], _cache(m["tcfg"]), toks, pos).logits, want)


# ---- the forward ------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(models, name):
    """A 30-token prefill through the tag-mask path, then 3 decoded tokens one
    at a time: logits, the hidden state and the final norm's input at rtol
    1e-4 in f32. The learned-position models keep the flash functions (their
    plain versions here: `flash_prefill` once a layer for the prompt,
    `flash_decode` once a layer a token); the ALiBi models read the plain
    attention, as the reference's flash gates require `alibi is None`."""
    m = models[name]
    cfg = m["tcfg"]
    toks = _tokens(N_PROMPT + 3)
    jcache, cache = _jcache(cfg), _cache(cfg)
    pos = np.arange(N_PROMPT)[None]
    want = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, :N_PROMPT], pos)
    before = {k: _build.plain_calls[k] for k in FLASH}
    got = _forward(m["tt"], cfg, cache, toks[:, :N_PROMPT], pos, prefill=True)
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden)
    _close(got.hidden_pre, want.hidden_pre)
    jcache = want.kv
    for i in range(N_PROMPT, N_PROMPT + 3):
        p = np.asarray([[i]], np.int32)
        want_i = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, i:i + 1], p)
        jcache = want_i.kv
        _close(_forward(m["tt"], cfg, cache, toks[:, i:i + 1], p).logits, want_i.logits)
    calls = {k: _build.plain_calls[k] - before[k] for k in FLASH}
    flash = not cfg.use_alibi
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
    ("gpt2", "learned positions (off)", _cfg(has_pos_embd=False)),
    ("starcoder", "learned positions (off)", _cfg(has_pos_embd=False)),
    ("bloom", "ALiBi (off)", _cfg(use_alibi=False)),
    ("bloom", "the embedding LayerNorm", _drop("tok_embd_norm", "tok_embd_norm_b", top=True)),
    ("mpt", "ALiBi (off)", _cfg(use_alibi=False)),
    ("refact", "ALiBi (off)", _cfg(use_alibi=False)),
    ("jais", "ALiBi (off)", _cfg(use_alibi=False)),
    ("jais", "b_gate_up", _drop("b_gate_up")),
    ("jais", "the 1 / head_dim scale (as 1 / sqrt)", _cfg(attn_scale=None)),
    ("jais", "the embedding scale", _cfg(embd_scale=1.0)),
]


@pytest.mark.parametrize("name,branch,change", BRANCHES, ids=[f"{n}-{b}" for n, b, _ in BRANCHES])
def test_each_branch_moves_the_logits(models, name, branch, change):
    m = models[name]
    toks, pos = _tokens(N_PROMPT), np.arange(N_PROMPT)[None]
    base = _forward(m["tt"], m["tcfg"], _cache(m["tcfg"]), toks, pos).logits
    cfg, params = change(m["tcfg"], m["tt"])
    other = _forward(params, cfg, _cache(cfg), toks, pos).logits
    assert float((other - base).abs().max()) > 1e-3 * float(base.abs().max()), branch


@pytest.mark.parametrize("name", ["gpt2", "starcoder"])
def test_positions_past_the_table_take_the_clamped_row(models, name):
    """A pad row (position -1) and positions at and past the table's 160
    rows take the rows the reference's JAX gather takes: -1 wraps to the
    last row, a position past the end clamps to it. The logits of such a
    prompt equal the reference's at rtol 1e-4."""
    m = models[name]
    cfg, table = m["tcfg"], m["tt"]["pos_embd"]
    pos = torch.tensor([[-1, 0, 5, N_POS - 1, N_POS, N_POS + 37, -N_POS, -N_POS - 3]])
    rows = position_rows(table, pos)[0]
    for i, j in enumerate([N_POS - 1, 0, 5, N_POS - 1, N_POS - 1, N_POS - 1, 0, 0]):
        assert torch.equal(rows[i], table[j]), (i, j)
    want = np.asarray(jnp.asarray(m["jt"]["pos_embd"])[jnp.asarray(pos.numpy())])
    np.testing.assert_array_equal(position_rows(table, pos).numpy(), want)
    # a prompt whose rows sit past the table (slots 0-11, positions from 150)
    positions = np.arange(12)[None] + N_POS - 10
    positions[0, 3] = -1  # a pad row: tag -1, it sees nothing and nothing sees it
    toks = _tokens(12, seed=5)
    slots = np.arange(12)[None]
    want = _jax_forward(m["jt"], m["jcfg"], _jcache(cfg), toks, positions, slots)
    got = _forward(m["tt"], cfg, _cache(cfg), toks, positions, slots)
    _close(got.logits, want.logits)


def test_alibi_slopes_match_reference():
    """The slopes at 1-80 heads bit-equal to the reference's (the geometric
    series over the largest power of two, then the interleaved ones), kept
    on the device per head count."""
    for n in range(1, 81):
        got = alibi_slopes(n, "cpu")
        np.testing.assert_array_equal(got.numpy(), jllama.alibi_slopes(n))
        assert alibi_slopes(n, "cpu") is got


def test_no_rotary_at_rope_dim_zero(models):
    """`rope_dim` 0: `rope_inv_freq` is empty and `apply_rope` returns its
    input itself; a context shift moves the keys as they are (no
    re-rotation), and the forward never rotates q or k."""
    m = models["mpt"]
    cfg = m["tcfg"]
    inv = rope_inv_freq(cfg, None, device="cpu")
    assert inv.shape == (0,)
    x = torch.randn(1, 5, 4, 64)
    assert apply_rope(x, torch.arange(5)[None], inv) is x
    kv = _cache(cfg)
    _forward(m["tt"], cfg, kv, _tokens(40), np.arange(40)[None])
    k_before, v_before = kv.k.clone(), kv.v.clone()
    context_shift(kv, inv, 4, 10)
    assert torch.equal(kv.k[:, :, :, 4:30], k_before[:, :, :, 14:40])
    assert torch.equal(kv.v[:, :, :, 4:30], v_before[:, :, :, 14:40])
    assert kv.slot_pos[0, :30].tolist() == list(range(30))
    assert (kv.slot_pos[0, 30:] == -1).all()


# ---- the engines and the entry points ---------------------------------------


@pytest.mark.parametrize("kind", ["plain", "chain"])
@pytest.mark.parametrize("name", NAMES)
def test_engines_match_reference(pairs, ref_engines, name, kind):
    """`Generator` and the EAGLE chain: tokens and the speculative stats
    equal to the reference's on the prompt's ids, which the family's BPE
    pre-tokenizer gives both packages alike; the chain's
    `Engine.generate_text` equal to the reference's too."""
    jeng, eng = ref_engines(name, kind), _port_engine(pairs[name], kind)
    assert isinstance(eng.tokenizer, BPETokenizer)
    assert eng.metadata["tokenizer.ggml.pre"] == LN_PRE[eng.model_cfg.arch]
    ids = eng.tokenizer.encode(PROMPT)
    assert ids == jeng.tokenizer.encode(PROMPT) and len(ids) >= 10
    if kind == "plain":
        want = jeng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
        got = eng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
    else:
        want, want_stats = jeng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
        got, stats = eng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
        assert stats == want_stats and stats["n_cycles"] > 0
        text, stats = eng.generate_text(PROMPT, max_new_tokens=16)
        assert (text, stats) == jeng.generate_text(PROMPT, max_new_tokens=16)
    assert [int(t) for t in got] == [int(t) for t in want]


@pytest.mark.parametrize("name", ["gpt2", "mpt", "refact"])
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
    """bloom's EAGLE chain on int8 caches (keys and values quantized as
    written, the dequantized plain read with the ALiBi bias, the draft's
    cache int8 too): tokens and stats equal to the reference's."""
    jeng = ref_engines("bloom", "chain", kv="int8")
    eng = _port_engine(pairs["bloom"], "chain", kv="int8")
    ids = eng.tokenizer.encode(PROMPT)
    want, want_stats = jeng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
    got, stats = eng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
    assert stats == want_stats
    assert [int(t) for t in got] == [int(t) for t in want]


def test_paged_batcher_matches_reference(pairs, ref_engines):
    """jais (ALiBi, gate biases) on a paged pool (`Engine(batch=2,
    paged=True)`, pages of 16 rows): the ALiBi read over the gathered pages
    with the slots' tags; each slot's tokens equal to the reference's
    `PagedBatcher`'s."""
    kw = dict(batch=2, paged=True, page_size=16, kv_pages=12)
    jeng, eng = ref_engines("jais", "chain", **kw), _port_engine(pairs["jais"], "chain", **kw)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (20, 33)]

    def run(b):
        slots = [b.submit(p, max_new_tokens=14, stop_at_eos=False) for p in prompts]
        b.run_until_done(max_steps=200)
        return [list(map(int, s.generated[:14])) for s in slots]

    assert run(eng.batcher) == run(jeng.batcher)


@pytest.mark.parametrize("name", ["gpt2", "mpt"])
def test_cli_matches_reference_cli(pairs, f32_configs, capsys, name):
    """`--draft --temp 0`: the same text as the reference's CLI, through
    the family's BPE tokenizer."""
    pair = pairs[name]
    argv = ["-m", str(pair[0]), "--draft", str(pair[1]), "-p", PROMPT, "--ctx", str(MAX_SEQ),
            "-n", "12", "--temp", "0"]
    assert jax_cli.main(argv + ["--backend", "xla"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out == want and out.strip() and "[speculative]" in err


def test_server_matches_reference(pairs):
    """The port's server and the reference's on starcoder's files (the
    chain, one slot): `/v1/completions` and a streamed `/completion`, the
    same bodies apart from ids and times."""
    from eagle_tpu_torch.server.server import InferenceServer
    from test_torch_server import _frames, _reference, _strip, post

    pair = pairs["starcoder"]
    srv = InferenceServer(_port_engine(pair, "chain"), model_name="tiny")
    host, port = srv.start("127.0.0.1", 0)
    ref, stop_ref = _reference((str(pair[0]), str(pair[1])), 1)
    try:
        for path, body in (
                ("/v1/completions", {"prompt": PROMPT, "max_tokens": 10, "temperature": 0}),
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


# ---- the tree verify under ALiBi -----------------------------------------------

SPEC = (2, 2)  # 7 nodes: node j at slot base + j, position base + depth[j]


def _verify_rows(models, name, jax_side: bool):
    """(verify logits [N, V], greedy logits [N, V]) of one static-tree
    verify over a 20-token prompt: row j of the verify forward, and the last
    row of a plain causal forward of the prompt and node j's path (the
    greedy forward at that accepted prefix), each on a fresh cache."""
    m = models[name]
    spec = (jtree if jax_side else tree).TreeSpec(SPEC)
    n, nn = 20, spec.n_nodes
    toks = _tokens(n + nn, seed=11)
    prompt, nodes = toks[:, :n], toks[:, n:]
    v_pos = (n + spec.depth)[None].astype(np.int32)
    v_slots = (n + np.arange(nn))[None].astype(np.int32)
    if jax_side:
        params, cfg = m["jt"], m["jcfg"]
        kv = _jax_forward(params, cfg, _jcache(m["tcfg"]), prompt, np.arange(n)[None]).kv
        kv = kv.with_tags(jnp.asarray(v_slots), jnp.asarray(v_pos))
        mask = jtree._tree_mask(kv.slot_pos, jnp.asarray(v_pos), jnp.asarray([n]),
                                jnp.arange(nn), jnp.asarray(spec.ancestor), nn)
        verify = np.asarray(_jax_forward(params, cfg, kv, nodes, v_pos, v_slots, mask).logits)[0]
    else:
        params, cfg = m["tt"], m["tcfg"]
        kv = _cache(cfg)
        _forward(params, cfg, kv, prompt, np.arange(n)[None])
        kv.with_tags(torch.from_numpy(v_slots), torch.from_numpy(v_pos))
        mask = tree._tree_mask(kv.slot_pos, torch.from_numpy(v_pos), torch.tensor([n]),
                               torch.arange(nn), torch.from_numpy(spec.ancestor), nn)
        verify = _forward(params, cfg, kv, nodes, v_pos, v_slots, mask).logits[0].numpy()
    greedy = []
    for j in range(nn):
        path = [a for a in range(nn) if spec.ancestor[j, a]]  # root .. j, by depth
        seq = np.concatenate([prompt, nodes[:, path]], axis=1)
        pos = np.arange(seq.shape[1])[None]
        if jax_side:
            out = _jax_forward(params, cfg, _jcache(m["tcfg"]), seq, pos).logits
        else:
            out = _forward(params, cfg, _cache(cfg), seq, pos).logits
        greedy.append(np.asarray(out)[0, -1])
    return verify, np.stack(greedy), spec


@pytest.mark.parametrize("name", ["mpt", "refact"])
def test_tree_verify_logits_equal_greedy(models, name):
    """The port's static-tree verify forward under ALiBi: node j's row (at
    slot base + j, position base + depth j) equals the greedy forward of the
    prompt and j's path at rtol 1e-4, because the distance is taken tag to
    tag. The reference's verify (its distance from the slot index) matches
    greedy only at the nodes whose path lies at slot == position (the root
    and the first child) and moves every other row past the tolerance: the
    fault ROADMAP queue 3 records."""
    verify, greedy, spec = _verify_rows(models, name, jax_side=False)
    _close(torch.from_numpy(verify), greedy)
    j_verify, j_greedy, _ = _verify_rows(models, name, jax_side=True)
    np.testing.assert_allclose(j_greedy, greedy, rtol=1e-4, atol=1e-4 * np.abs(greedy).max())
    rng = np.abs(j_greedy).max()
    for j in range(spec.n_nodes):
        off = np.abs(j_verify[j] - j_greedy[j]).max() / rng
        aligned = all(spec.depth[a] == a for a in range(spec.n_nodes) if spec.ancestor[j, a])
        assert (off < 1e-4) == aligned, (j, off)


def _greedy_ids(eng, ids, n):
    gen = Generator(eng.params, eng.model_cfg, max_seq=MAX_SEQ, kv_dtype=torch.float32,
                    compute_dtype=torch.float32, eos_id=-1, device="cpu")
    return gen.generate(ids, max_new_tokens=n, stop_at_eos=False)


@pytest.mark.parametrize("kind", ["tree", "tree2"])
def test_tree_engines_equal_greedy_under_alibi(pairs, monkeypatch, kind):
    """mpt through `Engine` with a static tree (2, 2) or EAGLE-2 (2, 2, 4):
    with an oracle draft (its logits boosted at the greedy continuation) every
    cycle accepts its full depth, so each verify row at an accepted node
    decides a token; the tokens equal the port's greedy tokens, and so do
    the random draft's."""
    eng_kw = {"tree": dict(tree_branching=SPEC), "tree2": dict(tree2=(2, 2, 4))}[kind]
    pair = pairs["mpt"]

    def engine():
        return Engine(EngineConfig(model_path=pair[0], draft_path=pair[1], max_seq=MAX_SEQ,
                                   compute_dtype=torch.float32, kv_dtype=torch.float32,
                                   device="cpu", **eng_kw))

    eng = engine()
    ids = eng.tokenizer.encode(PROMPT)
    greedy = _greedy_ids(eng, ids, 24)
    toks, _ = eng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
    assert toks == greedy
    mod = tree if kind == "tree" else tree2
    seq = torch.tensor(list(ids) + greedy, dtype=torch.int64)
    monkeypatch.setattr(mod, "eagle_forward", oracle(mod.eagle_forward, seq))
    eng = engine()
    toks, stats = eng.engine.generate(ids, max_new_tokens=24, stop_at_eos=False)
    assert toks == greedy
    assert stats["mean_accept_len"] == len(SPEC) + 1


# ---- the runtime around ALiBi ---------------------------------------------------


def test_self_extend_refused_on_alibi(pairs):
    """Self-Extend remaps the tags of slots that stay put: the port's
    distance would follow the remap, the reference's slot-index distance
    would not, so the port refuses it on an ALiBi model, naming queue 3, at
    `generate(grp_attn_n > 1)` and at `Generator.self_extend`; a learned-
    position model runs it."""
    eng = _port_engine(pairs["bloom"], "plain")
    ids = eng.tokenizer.encode(PROMPT)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        eng.engine.generate(ids, max_new_tokens=4, grp_attn_n=2, grp_attn_w=8)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        eng.engine.self_extend(len(ids), 0, 2, 8)
    gpt2 = _port_engine(pairs["gpt2"], "plain")
    out = gpt2.engine.generate(gpt2.tokenizer.encode(PROMPT), max_new_tokens=8, grp_attn_n=2,
                               grp_attn_w=8, stop_at_eos=False)
    assert len(out) == 8


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8], ids=["f32", "int8"])
def test_context_shift_keeps_alibi_distances(models, kv_dtype):
    """A context shift on refact's cache (f32 or int8): the moved slots'
    tags stay their indices, so every ALiBi distance is a recompute's, and
    the keys and values (an int8 cache's codes and scales) move bit for
    bit, with no re-rotation; in f32 layer 0's moved keys equal a fresh
    forward's of the kept tokens at their new positions."""
    m = models["refact"]
    cfg = m["tcfg"]
    n, keep, discard = 60, 4, 20
    toks = _tokens(n, seed=13)
    gen = Generator(m["tt"], cfg, max_seq=MAX_SEQ, kv_dtype=kv_dtype,
                    compute_dtype=torch.float32, eos_id=-1, device="cpu")
    _forward(m["tt"], cfg, gen.kv, toks, np.arange(n)[None])
    before = [t.clone() for t in gen.kv.tensors()]
    gen.shift_context(keep, discard)
    m_ = n - keep - discard
    assert gen.kv.slot_pos[0, :keep + m_].tolist() == list(range(keep + m_))
    assert (gen.kv.slot_pos[0, keep + m_:MAX_SEQ] == -1).all()
    for got, old in zip(gen.kv.tensors(), before):
        if got.dim() >= 4:  # k, v and the int8 scales
            assert torch.equal(got[:, :, :, keep:keep + m_], old[:, :, :, keep + discard:n])
    kept = np.concatenate([toks[:, :keep], toks[:, keep + discard:]], axis=1)
    if kv_dtype == torch.float32:
        fresh = _forward(m["tt"], cfg, _cache(cfg), kept, np.arange(kept.shape[1])[None]).kv
        np.testing.assert_allclose(gen.kv.k[0, :, :, :kept.shape[1]].numpy(),
                                   fresh.k[0, :, :, :kept.shape[1]].numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---- the fused-FFN gate -------------------------------------------------------


def test_refact_fused_ffn_block_equals_unfused(models, monkeypatch):
    """refact (RMSNorm, a gated SiLU FFN, no biases) is what the gate
    admits, as the reference's; jais (LayerNorm, `b_gate_up`) and the
    no-gate families are refused, and so is refact's layers with a
    `b_gate_up`. Under EAGLE_TPU_FUSED_FFN=1 refact's logits at a decode row
    and a 5-row verify equal the unfused ones at rtol 1e-5 (the block's
    plain versions here)."""
    m = models["refact"]
    cfg, layers = m["tcfg"], m["tt"]["layers"]
    assert supports_ffn_block(layers, cfg)
    b = torch.zeros(cfg.n_layers, 2 * cfg.n_ff)
    assert not supports_ffn_block({**layers, "b_gate_up": b}, cfg)
    for name in ("gpt2", "starcoder", "bloom", "mpt", "jais"):
        assert not supports_ffn_block(models[name]["tt"]["layers"], models[name]["tcfg"]), name
    toks = _tokens(N_PROMPT + 6)
    outs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("EAGLE_TPU_FUSED_FFN", mode)
        before = _build.plain_calls["ffn_out_norm"]
        cache = _cache(cfg)
        _forward(m["tt"], cfg, cache, toks[:, :N_PROMPT], np.arange(N_PROMPT)[None])
        outs[mode] = [_forward(m["tt"], cfg, cache, toks[:, N_PROMPT:N_PROMPT + 1],
                               [[N_PROMPT]]).logits,
                      _forward(m["tt"], cfg, cache, toks[:, N_PROMPT + 1:],
                               np.arange(N_PROMPT + 1, N_PROMPT + 6)[None]).logits]
        assert (_build.plain_calls["ffn_out_norm"] > before) == (mode == "1")
    for got, want in zip(outs["1"], outs["0"]):
        _close(got, want.numpy(), rtol=1e-5)


# ---- the kernels' plans at the published shapes --------------------------------

#: (N, K) of StarCoder-15B's products (48 query heads over 1 KV head of 128
#: on 6,144, n_inner 24,576, vocab 49,152, the draft's fc) and MPT-7B's (32
#: heads of 128 on 4,096, 16,384, the draft's fc; its tied head is "nk")
POS_SHAPES = {"starcoder_wqkv": (6400, 6144), "starcoder_wo": (6144, 6144),
              "starcoder_w_up": (24576, 6144), "starcoder_w_down": (6144, 24576),
              "starcoder_lm_head": (49152, 6144), "starcoder_draft_fc": (6144, 12288),
              "mpt_wqkv": (12288, 4096), "mpt_wo": (4096, 4096), "mpt_w_up": (16384, 4096),
              "mpt_w_down": (4096, 16384), "mpt_draft_fc": (4096, 8192)}


@pytest.mark.parametrize("name", sorted(POS_SHAPES))
def test_qmm_plans_cover_the_shapes(name):
    """At 1, 6 and 300 rows the three tensor-core bodies' plans, for the
    coded Q4_K / Q6_K forms and Q8_0's, fit shared memory and cut K into
    splits that cover it once, on whole 256-row super-blocks for coded
    weights (K = 6,144 is 24 of them, 24,576 96, 4,096 16, 16,384 64)."""
    from eagle_tpu_torch.ops.qmm import TcForm, _gemv_plan, _mma_plan, _route, _tc_plan

    n, k = POS_SHAPES[name]
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


@pytest.mark.parametrize("tg", [48, 288, 14400, 24576])
def test_flash_plan_at_g48(tg):
    """The flash kernels' plan at StarCoder-15B's g = 48 (48 query heads over
    one KV head of 128, bf16): a decoded row (48 rows) and a K = 5 verify
    (288) take blocks whose last warp tile is not wholly padding, split over
    the 1,024 keys to fill the card; a 300-row prompt (14,400 rows) takes 225
    blocks of 64 rows and its 512-row bucket (24,576) 192 of 128, with no
    split; the ring fits shared memory; the splits cover the keys once."""
    from eagle_tpu_torch.ops import flash_attention as fa

    for tags in (False, True):
        p = fa._plan(tg, 1024, 128, torch.bfloat16, 1, tags)
        assert p.body == "mma" and p.smem_bytes <= 232448
        assert -(-tg // p.rows_per_block) * p.rows_per_block - tg < 16
        if tg >= 14400:
            assert p.rows_per_block == {14400: 64, 24576: 128}[tg] and p.splits == 1
        else:
            assert p.splits > 1
        assert p.splits * p.keys_per_split >= 1024 > (p.splits - 1) * p.keys_per_split


# ---- what stays refused -----------------------------------------------------

#: (arch of the config changed, change): each branch on another family
REFUSED = {"learned positions on mpt": ("mpt", dict(has_pos_embd=True)),
           "alibi on gpt2": ("gpt2", dict(use_alibi=True)),
           "rotary on bloom": ("bloom", dict(rope_dim=64)),
           "no rotary on a llama": ("refact", dict(arch="llama")),
           "alibi on baichuan": ("refact", dict(arch="baichuan")),
           "LayerNorm on refact": ("refact", dict(norm_type="layer"))}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_configs_name_item_8(models, name):
    base, change = REFUSED[name]
    cfg = dataclasses.replace(models[base]["tcfg"], **change)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        check_ported(cfg)


@pytest.mark.parametrize("md", [
    {"general.architecture": "baichuan"}, {"general.architecture": "jina-bert-v2"},
    {"general.architecture": "mpt", "mpt.attention.max_alibi_bias": 4.0},
], ids=["baichuan", "jina-bert-v2", "max_alibi_bias"])
def test_refused_files_name_item_8(md):
    """Baichuan-13B (the reference's other ALiBi reading) and jina-bert-v2
    (an encoder) stay refused by architecture; an ALiBi maximum bias other
    than the slopes' 8 is refused too."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        ModelConfig.from_gguf_metadata(md)


def test_position_archs_are_the_reference_sets():
    """The port's copies of the reference's architecture sets: its
    NO_ROPE_ARCHS and POS_EMBD_ARCHS whole, its ALIBI_ARCHS less jina-bert-v2."""
    from eagle_tpu.models import config as jconfig

    assert NO_ROPE_ARCHS == jconfig.NO_ROPE_ARCHS
    assert POS_EMBD_ARCHS == jconfig.POS_EMBD_ARCHS
    assert ALIBI_ARCHS == jconfig.ALIBI_ARCHS - {"jina-bert-v2"}
    assert set(POSITION_TARGETS) == NO_ROPE_ARCHS


# ---- synthetic weights in the families' layouts ---------------------------------


@pytest.mark.parametrize("arch,kw", [
    ("gpt2", dict(gate=False, tied=True)), ("bloom", dict(gate=False, tied=True, embd_norm=True)),
    ("jais", {})], ids=["gpt2", "bloom", "jais"])
def test_synth_params_take_the_layouts(arch, kw):
    """`synth_llama_params` mints the position families' layouts (learned
    positions [n_ctx_train, D], a no-gate `w_up`, the embedding LayerNorm, a
    tied head) in the serving form, and the forward runs them to finite
    logits: moved when every position moves by 7 under learned positions,
    unmoved (within f32 rounding) under ALiBi, whose bias reads distances."""
    from eagle_tpu_torch.models.synth import synth_llama_params

    cfg = ModelConfig(arch=arch, vocab_size=512, n_embd=256, n_layers=2, n_heads=4,
                      n_kv_heads=4, head_dim=64, n_ff=512, rope_dim=0, n_ctx_train=64,
                      norm_type="layer", act="gelu" if arch != "jais" else "silu",
                      has_pos_embd=arch == "gpt2", use_alibi=arch != "gpt2")
    p = synth_llama_params(cfg, seed=3, packed=True, coded=True, device="cpu", **kw)
    assert ("w_up" in p["layers"]) == (not kw.get("gate", True))
    assert (p["output"] is p["tok_embd"]) == kw.get("tied", False)
    assert ("pos_embd" in p) == cfg.has_pos_embd and ("tok_embd_norm" in p) == (arch == "bloom")
    if cfg.has_pos_embd:
        assert tuple(p["pos_embd"].shape) == (64, 256)
    toks, pos = _tokens(20), np.arange(20)[None]
    base = _forward(p, cfg, _cache(cfg), toks, pos).logits
    assert bool(torch.isfinite(base).all())
    later = _forward(p, cfg, _cache(cfg), toks, pos + 7).logits  # slots and tags move too
    off = float((later - base).abs().max()) / float(base.abs().max())
    assert (off > 1e-3) if cfg.has_pos_embd else (off < 1e-5), off

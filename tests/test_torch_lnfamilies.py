"""The other LayerNorm families in the port on the CPU, against the
reference, on tiny Q8_0 pairs (`tiny_lnfamily_pair`: 2 layers, width 256,
each family's tokenizer):

- nemotron: LayerNorm with biases, a no-gate squared-ReLU MLP, 32 of 64
  features rotary (NEOX rows), a query (6 heads of 64) wider than the model
  over 2 KV heads, an SPM vocabulary;
- olmo: no norm tensor at all (the non-parametric LayerNorms), q/k/v
  clipped to +-0.6 after the projection, the adjacent-pair rope rows, a
  gated SiLU FFN, BPE "gpt-2";
- orion: a gated SiLU FFN under LayerNorms with biases, the interleaved
  rope rows, an SPM vocabulary;
- codeshell: a gpt2-style layer (a fused `attn_qkv` with its bias, a
  no-gate GELU MLP with biases, attn_output.bias) with rotary GQA 4:2, BPE
  "codeshell" (the "starcoder" pattern);
- falcon: the parallel block from one shared LayerNorm, multi-query
  attention through a fused `attn_qkv`, a no-bias GELU MLP, BPE "falcon";
- gptj: the parallel block, separate q/k/v, 64 of 256 features rotary, FFN
  biases and an lm_head bias, BPE "gpt-2".

For each: the config and the loaded params bit-equal to the reference's
`load_llama_params` (and carried across by `convert.params_from_numpy`);
prefill and decode logits at rtol 1e-4 in f32 through the flash functions'
plain versions, and each new branch moving them; `Generator` and the EAGLE
chain tokens (and stats) equal to the reference's, `ContinuousBatcher` for
two families, one int8 (olmo) and one paged (falcon) case, the CLI and the
server on falcon; nemotron's context shift under partial rotary against a
recompute; the kernels' plans at the Falcon-7B and Minitron-8B shapes;
synthetic weights in the new layouts; the refusals.

The reference counts the layers of its scan from the first tensor of the
layers dict (`eagle_tpu/models/llama.py:786`: `shape[0]`); an olmo file
has no norm tensor, so that is a quantized weight whose logical shape
starts with its N (n_embd), and the reference runs 256 layers, its layer
index clamped to the last (ROADMAP queue 3). Its olmo side here therefore
takes a zero q/k/v bias [L, ...] put first in the layers dict (`_ref_fix`):
it counts L layers, and x + 0 leaves every sum as it was."""

import contextlib
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu import api as jax_api
from eagle_tpu.models.llama import llama_forward as jax_llama_forward
from eagle_tpu.models.loader import load_llama_params as jax_load
from eagle_tpu.quant.qtensor import QTensor as JaxQTensor
from eagle_tpu.runtime import kvcache as jkv
from eagle_tpu.tools import cli as jax_cli
from eagle_tpu_torch import _build
from eagle_tpu_torch.models.config import (
    CLAMP_KQV_ARCHS,
    LAYERNORM_TARGETS,
    NONPARAM_NORM_ARCHS,
    PARALLEL_BLOCK_ARCHS,
    TARGET_ARCHS,
    ModelConfig,
    check_ported,
)
from eagle_tpu_torch.models.llama import llama_forward
from eagle_tpu_torch.models.loader import load_llama_params
from eagle_tpu_torch.ops.ffn import supports_ffn_block
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags
from eagle_tpu_torch.tokenizer import BPETokenizer, SPMTokenizer
from eagle_tpu_torch.tools import cli
from test_torch_families import (  # noqa: F401  (f32_configs: a fixture)
    MAX_SEQ,
    _close,
    _jax_engine,
    _port_engine,
    f32_configs,
)
from test_torch_loader import _same_tree
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    LN_FAMILIES2,
    LN_PRE,
    background_cpu,
    jax_cfg_to_torch,
    tiny_lnfamily_pair,
    tree_to_numpy,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

NAMES = list(LN_FAMILIES2)
N_PROMPT = 30
PROMPT = "the quick brown fox jumps over a lazy dog and then naïve café"
FLASH = ("flash_decode", "flash_prefill")


def _ref_fix(params: dict) -> dict:
    """The reference's params with a zero `bqkv` first in the layers dict
    where its first layer tensor is a quantized weight (olmo): its scan then
    counts `n_layers` layers, not that weight's N."""
    layers = params["layers"]
    if not isinstance(next(iter(layers.values())), JaxQTensor):
        return params
    wqkv = layers["wqkv"]
    n_layers, n = wqkv.q.shape[0], wqkv.shape[0]
    return {**params, "layers": {"bqkv": jnp.zeros((n_layers, n), jnp.float32), **layers}}


@contextlib.contextmanager
def _ref_loader():
    """The reference's `api.Engine` loading its params through `_ref_fix`."""
    real = jax_api.load_llama_params

    def load(path):
        params, cfg, md = real(path)
        return _ref_fix(params), cfg, md

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_api, "load_llama_params", load)
        yield


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return {n: tiny_lnfamily_pair(tmp_path_factory.mktemp(n), n) for n in NAMES}


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
            with _ref_loader():
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


def _forward(params, cfg, kv, tokens, positions, slots=None, prefill=False):
    """The port's forward in f32 (slots == positions by default); `prefill`
    passes `causal_tags_prefill`."""
    positions = torch.from_numpy(np.asarray(positions, np.int32))
    slots = positions if slots is None else torch.from_numpy(np.asarray(slots, np.int32))
    kv.with_tags(slots, positions)
    mask = causal_mask_from_tags(kv.slot_pos, positions)
    return llama_forward(params, cfg, torch.from_numpy(np.asarray(tokens)), positions, kv, slots,
                         mask, compute_dtype=torch.float32, causal_tags_prefill=prefill)


def _jax_forward(params, cfg, kv, tokens, positions):
    """The reference's forward (XLA, f32) on `_ref_fix(params)`."""
    positions = jnp.asarray(np.asarray(positions, np.int32))
    kv = kv.with_tags(positions, positions)
    mask = jkv.causal_mask_from_tags(kv.slot_pos, positions)
    return jax_llama_forward(_ref_fix(params), cfg, jnp.asarray(tokens), positions, kv,
                             positions, mask, backend="xla", compute_dtype=jnp.float32)


# ---- config and loader ------------------------------------------------------

#: (act, parallel_blocks, rope_dim, head_dim, n_heads, n_kv_heads,
#: nonparam_norms, clamp_kqv)
WANT_CFG = {"nemotron": ("relu2", False, 32, 64, 6, 2, False, 0.0),
            "olmo": ("silu", False, 64, 64, 4, 4, True, np.float32(0.6)),
            "orion": ("silu", False, 64, 64, 4, 4, False, 0.0),
            "codeshell": ("gelu", False, 64, 64, 4, 2, False, 0.0),
            "falcon": ("gelu", True, 64, 64, 4, 1, False, 0.0),
            "gptj": ("gelu", True, 64, 256, 2, 2, False, 0.0)}
_NORMS = {"attn_norm", "attn_norm_b"}
#: each file's layer keys beside wqkv / wo / w_down, then its top-level keys
#: beside tok_embd / layers / output
WANT_KEYS = {
    "nemotron": (_NORMS | {"ffn_norm", "ffn_norm_b", "w_up"}, {"output_norm", "output_norm_b"}),
    "olmo": ({"w_gate_up"}, set()),
    "orion": (_NORMS | {"ffn_norm", "ffn_norm_b", "w_gate_up"}, {"output_norm", "output_norm_b"}),
    "codeshell": (_NORMS | {"ffn_norm", "ffn_norm_b", "bqkv", "bo", "w_up", "b_up", "b_down"},
                  {"output_norm", "output_norm_b"}),
    "falcon": (_NORMS | {"w_up"}, {"output_norm", "output_norm_b"}),
    "gptj": (_NORMS | {"w_up", "b_up", "b_down"}, {"output_norm", "output_norm_b", "output_b"}),
}
#: the tokenizer each family's file names: SPM, or BPE with its pre-tokenizer
WANT_TOKENIZER = {"nemotron": "spm", "orion": "spm", "olmo": "gpt-2", "gptj": "gpt-2",
                  "codeshell": "codeshell", "falcon": "falcon"}


@pytest.mark.parametrize("name", NAMES)
def test_config_reads_the_family(models, name):
    """LayerNorm, and each family's branches as the reference reads them:
    the squared ReLU (nemotron), the non-parametric norms and the clamp
    (olmo), the parallel block (falcon, gptj), partial rotary (nemotron,
    gptj), GELU (codeshell, falcon, gptj); the config field for field."""
    m = models[name]
    tcfg, jcfg = m["tcfg"], m["jcfg"]
    assert tcfg == jax_cfg_to_torch(jcfg)
    check_ported(tcfg)
    assert tcfg.arch in LAYERNORM_TARGETS and tcfg.arch in TARGET_ARCHS
    assert tcfg.norm_type == "layer" and not tcfg.use_alibi and not tcfg.has_pos_embd
    assert (tcfg.act, tcfg.parallel_blocks, tcfg.rope_dim, tcfg.head_dim, tcfg.n_heads,
            tcfg.n_kv_heads, tcfg.nonparam_norms, tcfg.clamp_kqv) == WANT_CFG[name]
    layer_keys, top_keys = WANT_KEYS[name]
    assert set(m["tt"]["layers"]) == {"wqkv", "wo", "w_down"} | layer_keys
    assert set(m["tt"]) - {"tok_embd", "layers", "output"} == top_keys


@pytest.mark.parametrize("name", NAMES)
def test_loaded_params_bit_equal(models, name):
    """Every leaf bit-equal to the reference's `load_llama_params`: olmo's
    and orion's q/k rows un-permuted, codeshell's and falcon's fused
    `attn_qkv` (and codeshell's bias) as they are, gptj's `output.bias`,
    olmo's file without a norm tensor."""
    m = models[name]
    _same_tree(m["tt"], m["jt"])


@pytest.mark.parametrize("name", ["olmo", "falcon", "gptj"])
def test_params_carried_across(models, name):
    """The reference's loaded params, every leaf turned to numpy, come
    through `convert.params_from_numpy` bit-equal to the port's own load and
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
    1e-4 in f32, through the flash functions (their plain versions here:
    `flash_prefill` once a layer for the prompt, `flash_decode` once a layer
    a token; gptj's at D = 256)."""
    m = models[name]
    cfg = m["tcfg"]
    toks = _tokens(N_PROMPT + 3)
    cache = _cache(cfg)
    pos = np.arange(N_PROMPT)[None]
    want = _jax_forward(m["jt"], m["jcfg"], _jcache(cfg), toks[:, :N_PROMPT], pos)
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
    assert calls == {"flash_prefill": cfg.n_layers, "flash_decode": 3 * cfg.n_layers}


def test_reference_layer_count_fault(models):
    """What `_ref_fix` works around: on the olmo file as loaded, the
    reference's forward runs the first weight's N (256) layers, so its
    logits move far from its own with the layer count fixed; the port's
    equal the fixed ones (test_forward_matches_reference)."""
    from eagle_tpu.models.llama import llama_forward as ref_forward

    m = models["olmo"]
    toks, pos = _tokens(8), jnp.asarray(np.arange(8, dtype=np.int32)[None])
    first = next(iter(m["jt"]["layers"].values()))
    assert first.shape[0] == m["tcfg"].n_embd != m["tcfg"].n_layers
    outs = []
    for params in (m["jt"], _ref_fix(m["jt"])):
        kv = _jcache(m["tcfg"]).with_tags(pos, pos)
        mask = jkv.causal_mask_from_tags(kv.slot_pos, pos)
        outs.append(np.asarray(ref_forward(params, m["jcfg"], jnp.asarray(toks), pos, kv, pos,
                                           mask, backend="xla",
                                           compute_dtype=jnp.float32).logits))
    assert np.abs(outs[0] - outs[1]).max() > 0.1 * np.abs(outs[1]).max()


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
    ("nemotron", "the squared ReLU (as GELU)", _cfg(act="gelu")),
    ("nemotron", "partial rotary (whole head)", _cfg(rope_dim=64)),
    ("olmo", "the non-parametric norms (off)", _cfg(nonparam_norms=False)),
    ("olmo", "the q/k/v clamp (off)", _cfg(clamp_kqv=0.0)),
    ("codeshell", "the fused q/k/v bias", _drop("bqkv")),
    ("falcon", "the shared parallel norm (sequential)", _cfg(parallel_blocks=False)),
    ("gptj", "the lm_head bias", _drop("output_b", top=True)),
    ("gptj", "the shared parallel norm (sequential)", _cfg(parallel_blocks=False)),
    ("gptj", "partial rotary (whole head)", _cfg(rope_dim=256)),
    ("orion", "the norm biases", _drop("attn_norm_b", "ffn_norm_b")),
]


@pytest.mark.parametrize("name,branch,change", BRANCHES, ids=[f"{n}-{b}" for n, b, _ in BRANCHES])
def test_each_branch_moves_the_logits(models, name, branch, change):
    m = models[name]
    toks, pos = _tokens(N_PROMPT), np.arange(N_PROMPT)[None]
    base = _forward(m["tt"], m["tcfg"], _cache(m["tcfg"]), toks, pos).logits
    cfg, params = change(m["tcfg"], m["tt"])
    other = _forward(params, cfg, _cache(cfg), toks, pos).logits
    assert float((other - base).abs().max()) > 1e-3 * float(base.abs().max()), branch


def test_clamp_binds(models):
    """olmo's q/k/v projection reaches past +-0.6 on these weights, so the
    clamp changes the values attention reads (the branch is exercised)."""
    from eagle_tpu_torch.models.llama import embed_lookup
    from eagle_tpu_torch.ops.matmul import qmatmul_layer
    from eagle_tpu_torch.ops.norms import layer_norm

    m = models["olmo"]
    cfg = m["tcfg"]
    x = layer_norm(embed_lookup(m["tt"]["tok_embd"], torch.from_numpy(_tokens(N_PROMPT))),
                   None, None, cfg.rms_eps)
    qkv = qmatmul_layer(x, m["tt"]["layers"]["wqkv"], 0, torch.float32)
    share = float((qkv.abs() > cfg.clamp_kqv).float().mean())
    assert 0.05 < share < 0.95, share


# ---- the engines and the entry points ---------------------------------------


@pytest.mark.parametrize("kind", ["plain", "chain"])
@pytest.mark.parametrize("name", NAMES)
def test_engines_match_reference(pairs, ref_engines, name, kind):
    """`Generator` and the EAGLE chain: tokens and the speculative stats
    equal to the reference's on the prompt's ids, which the family's
    tokenizer (SPM, or BPE with its pre-tokenizer) gives both packages
    alike; the chain's `Engine.generate_text` equal to the reference's too."""
    jeng, eng = ref_engines(name, kind), _port_engine(pairs[name], kind)
    want_tok = WANT_TOKENIZER[name]
    if want_tok == "spm":
        assert isinstance(eng.tokenizer, SPMTokenizer)
    else:
        assert isinstance(eng.tokenizer, BPETokenizer)
        assert eng.metadata["tokenizer.ggml.pre"] == want_tok == LN_PRE[name]
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


@pytest.mark.parametrize("name", ["nemotron", "gptj"])
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
    """olmo's EAGLE chain on int8 caches (keys and values quantized as
    written after the clamp, the dequantized plain read, the draft's cache
    int8 too): tokens and stats equal to the reference's."""
    jeng = ref_engines("olmo", "chain", kv="int8")
    eng = _port_engine(pairs["olmo"], "chain", kv="int8")
    ids = eng.tokenizer.encode(PROMPT)
    want, want_stats = jeng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
    got, stats = eng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
    assert stats == want_stats
    assert [int(t) for t in got] == [int(t) for t in want]


def test_paged_batcher_matches_reference(pairs, ref_engines):
    """falcon (multi-query, the parallel block) on a paged pool
    (`Engine(batch=2, paged=True)`, pages of 16 rows): each slot's tokens
    equal to the reference's `PagedBatcher`'s."""
    kw = dict(batch=2, paged=True, page_size=16, kv_pages=12)
    jeng, eng = ref_engines("falcon", "chain", **kw), _port_engine(pairs["falcon"], "chain", **kw)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (20, 33)]

    def run(b):
        slots = [b.submit(p, max_new_tokens=14, stop_at_eos=False) for p in prompts]
        b.run_until_done(max_steps=200)
        return [list(map(int, s.generated[:14])) for s in slots]

    assert run(eng.batcher) == run(jeng.batcher)


def test_cli_matches_reference_cli(pairs, f32_configs, capsys):
    """falcon, `--draft --temp 0`: the same text as the reference's CLI,
    through the "falcon" pre-tokenizer."""
    pair = pairs["falcon"]
    argv = ["-m", str(pair[0]), "--draft", str(pair[1]), "-p", PROMPT, "--ctx", str(MAX_SEQ),
            "-n", "12", "--temp", "0"]
    assert jax_cli.main(argv + ["--backend", "xla"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out == want and out.strip() and "[speculative]" in err


def test_server_matches_reference(pairs):
    """The port's server and the reference's on falcon's files (the chain,
    one slot): `/v1/completions` and a streamed `/completion`, the same
    bodies apart from ids and times."""
    from eagle_tpu_torch.server.server import InferenceServer
    from test_torch_server import _frames, _reference, _strip, post

    pair = pairs["falcon"]
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


# ---- the runtime under partial rotary -------------------------------------------


def test_context_shift_under_partial_rotary_equals_recompute(models):
    """nemotron (32 of 64 features rotary, NEOX): prefill 70 tokens, shift
    the context; the port's `Generator` re-rotates the first 32 features of
    each moved key only, so layer 0's keys equal a fresh forward's of the
    kept tokens at their new positions, and the other 32 features never
    move."""
    m = models["nemotron"]
    cfg = m["tcfg"]
    n, keep, discard = 70, 5, 25
    toks = _tokens(n, seed=8)
    gen = Generator(m["tt"], cfg, max_seq=MAX_SEQ, kv_dtype=torch.float32,
                    compute_dtype=torch.float32, eos_id=-1, device="cpu")
    _forward(m["tt"], cfg, gen.kv, toks, np.arange(n)[None])
    gen.shift_context(keep, discard)
    kept = np.concatenate([toks[:, :keep], toks[:, keep + discard:]], axis=1)
    fresh = _forward(m["tt"], cfg, _cache(cfg), kept, np.arange(kept.shape[1])[None]).kv
    got = gen.kv.k[0, :, :, :kept.shape[1]].numpy()
    want = fresh.k[0, :, :, :kept.shape[1]].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., 32:], want[..., 32:])


# ---- the fused-FFN gate and the kernels' plans ----------------------------------


def test_fused_ffn_gate_keeps_the_families_off(models):
    """No family here takes the fused FFN block: each is a LayerNorm model
    (the block applies RMSNorm), and olmo's gated FFN has no norm tensor."""
    for name in NAMES:
        assert not supports_ffn_block(models[name]["tt"]["layers"], models[name]["tcfg"]), name


#: (N, K, form) of Falcon-7B's products (71 heads of 64 over one KV head on
#: 4,544: Q5_0 wqkv / wo / w_up, a Q4_K w_down, a Q8_0 head of 65,024 rows
#: and its EAGLE draft's fc) and Minitron-8B's (48 heads of 128 over 8 KV
#: heads on 4,096, n_ff 16,384, all Q4_K, a Q6_K head of 256,000 rows)
#: (TcForm fields, group) of each serving form: Q5_0 (int8 codes, f32 scale
#: and bias), Q8_0 (int8, f32 scale), coded Q4_K (packed) and Q6_K (int8)
Q5_0, Q8_0 = (("int8", 4, False, 4), 32), (("int8", 4, False, 0), 32)
Q4K, Q6K = (("packed", 1, True, 1), 32), (("int8", 1, True, 0), 16)
LNF_SHAPES = {"falcon_wqkv": (4672, 4544, Q5_0), "falcon_wo": (4544, 4544, Q5_0),
              "falcon_w_up": (18176, 4544, Q5_0), "falcon_w_down": (4544, 18176, Q4K),
              "falcon_lm_head": (65024, 4544, Q8_0), "falcon_draft_fc": (4544, 9088, Q8_0),
              "minitron_wqkv": (8192, 4096, Q4K), "minitron_wo": (4096, 6144, Q4K),
              "minitron_w_up": (16384, 4096, Q4K), "minitron_w_down": (4096, 16384, Q4K),
              "minitron_lm_head": (256000, 4096, Q6K)}


@pytest.mark.parametrize("name", sorted(LNF_SHAPES))
def test_qmm_plans_cover_the_shapes(name):
    """At 1, 6 and 300 rows the three tensor-core bodies' plans for each
    product's serving form fit shared memory and cut K into splits that
    cover it once: K = 4,544 is 71 steps of 64 (no 256-row boundary under
    it, the forms there not coded), Falcon's coded w_down 71 super-blocks of
    256 (18,176), Minitron's wo 24 (6,144)."""
    from eagle_tpu_torch.ops.qmm import TcForm, _gemv_plan, _mma_plan, _route, _tc_plan

    n, k, (form, group) = LNF_SHAPES[name]
    f = TcForm(*form)
    for rows, plan in ((1, lambda: _gemv_plan(k, n, group, f)),
                       (6, lambda: _mma_plan(6, k, n, group, f)),
                       (300, lambda: _tc_plan(300, k, n, group, f))):
        assert _route(rows, k, n, torch.bfloat16, f) == {1: "gemv", 6: "mma", 300: "tc"}[rows]
        p = plan()
        assert p.smem_bytes <= 232448
        steps = k // 64
        assert p.splits * p.steps_per_split >= steps > (p.splits - 1) * p.steps_per_split
        assert not f.coded or p.steps_per_split % 4 == 0, (rows, f, p)
        assert p.groups_per_split * group == p.steps_per_split * 64


@pytest.mark.parametrize("tg", [71, 426, 36352])
def test_flash_plan_at_g71(tg):
    """The flash kernels' plan at Falcon-7B's g = 71 (71 query heads over
    one KV head of 64, bf16): a decoded row (71 rows, prime: no tile of 16
    or 64 divides it) and a K = 5 verify (426) take 16-row blocks whose last
    warp tile is not wholly padding, split over the 1,024 keys to fill the
    card; the EAGLE prompt's 512 rows (36,352) take 284 blocks of 128 with
    no split; the ring fits shared memory; the splits cover the keys once."""
    from eagle_tpu_torch.ops import flash_attention as fa

    for tags in (False, True):
        p = fa._plan(tg, 1024, 64, torch.bfloat16, 1, tags)
        assert p.body == "mma" and p.smem_bytes <= 232448
        assert -(-tg // p.rows_per_block) * p.rows_per_block - tg < 16
        if tg == 36352:
            assert p.rows_per_block == 128 and p.splits == 1
        else:
            assert p.rows_per_block == 16 and p.splits > 1
        assert p.splits * p.keys_per_split >= 1024 > (p.splits - 1) * p.keys_per_split


# ---- synthetic weights in the families' layouts ---------------------------------


@pytest.mark.parametrize("arch", ["nemotron", "olmo", "falcon", "gptj"])
def test_synth_params_take_the_layouts(arch):
    """`synth_llama_params` mints the new layouts in the serving form: no
    norm tensor under `nonparam_norms` (olmo), one shared input norm
    (falcon, gptj), an lm_head bias (gptj), a no-gate `w_up` (nemotron,
    falcon, gptj); the forward runs them to finite logits, unmoved (within
    f32 rounding) when every position moves by 7: rotary scores read
    distances."""
    from eagle_tpu_torch.models.synth import synth_llama_params

    gate = arch == "olmo"
    cfg = ModelConfig(arch=arch, vocab_size=512, n_embd=256, n_layers=2, n_heads=4,
                      n_kv_heads=1 if arch == "falcon" else 4, head_dim=64, n_ff=512,
                      rope_dim=32 if arch in ("nemotron", "gptj") else 64, norm_type="layer",
                      act={"nemotron": "relu2", "olmo": "silu"}.get(arch, "gelu"),
                      parallel_blocks=arch in PARALLEL_BLOCK_ARCHS,
                      nonparam_norms=arch in NONPARAM_NORM_ARCHS,
                      clamp_kqv=0.5 if arch in CLAMP_KQV_ARCHS else 0.0)
    check_ported(cfg)
    p = synth_llama_params(cfg, seed=3, packed=True, coded=True, device="cpu", gate=gate,
                           ffn_norm=not cfg.parallel_blocks, out_bias=arch == "gptj")
    layers = p["layers"]
    assert ("w_up" in layers) == (not gate)
    assert ("attn_norm" in layers) == ("output_norm" in p) == (arch != "olmo")
    assert ("ffn_norm" in layers) == (arch == "nemotron")
    assert ("output_b" in p) == (arch == "gptj")
    toks, pos = _tokens(20), np.arange(20)[None]
    base = _forward(p, cfg, _cache(cfg), toks, pos).logits
    assert bool(torch.isfinite(base).all())
    later = _forward(p, cfg, _cache(cfg), toks, pos + 7).logits  # slots and tags move too
    assert float((later - base).abs().max()) < 1e-4 * float(base.abs().max())


# ---- what stays refused -----------------------------------------------------

#: (family whose config is changed, change): each branch on another family
REFUSED = {"relu2 on falcon": ("falcon", dict(act="relu2")),
           "relu2 on olmo": ("olmo", dict(act="relu2")),
           "non-parametric norms on falcon": ("falcon", dict(nonparam_norms=True)),
           "non-parametric norms under RMSNorm": ("olmo", dict(norm_type="rms",
                                                               arch="llama")),
           "clamp on gptj": ("gptj", dict(clamp_kqv=8.0)),
           "clamp on orion": ("orion", dict(clamp_kqv=8.0)),
           "a negative clamp": ("olmo", dict(clamp_kqv=-1.0)),
           "hetero GQA on nemotron": ("nemotron", dict(head_counts=(6, 4)))}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_configs_name_item_8(models, name):
    base, change = REFUSED[name]
    cfg = dataclasses.replace(models[base]["tcfg"], **change)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        check_ported(cfg)


@pytest.mark.parametrize("arch", ["cohere2", "dbrx"])
def test_refused_files_name_item_8(arch):
    """cohere2 and dbrx, LayerNorm archs of the reference, stay refused by
    architecture."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        ModelConfig.from_gguf_metadata({"general.architecture": arch})


def test_falcon_ffn_norm_refused(tmp_path):
    """A falcon file with `attn_norm_2` (Falcon-40B / 180B's FFN norm, which
    the reference never reads and silently drops) is refused at load,
    naming item 8, by the loader and by `Engine`."""
    from eagle_tpu_torch.api import Engine, EngineConfig

    d = 256
    extra = {f"blk.{i}.attn_norm_2.{s}": np.ones(d, np.float32)
             for i in range(2) for s in ("weight", "bias")}
    target, _ = tiny_lnfamily_pair(tmp_path, "falcon", extra=extra)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        load_llama_params(target, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        Engine(EngineConfig(model_path=target, device="cpu"))


def test_mpt_clamp_admitted(models):
    """MPT's `clip_qkv` (the reference reads it as `clamp_kqv` from
    `mpt.attention.clamp_kqv`) is admitted on mpt, as on olmo."""
    cfg = dataclasses.replace(models["falcon"]["tcfg"], arch="mpt", rope_dim=0, use_alibi=True,
                              parallel_blocks=False, clamp_kqv=6.0)
    check_ported(cfg)
    md = {"general.architecture": "mpt", "mpt.embedding_length": 256, "mpt.block_count": 2,
          "mpt.attention.head_count": 4, "mpt.feed_forward_length": 512, "mpt.vocab_size": 512,
          "mpt.attention.clamp_kqv": 6.0}
    got = ModelConfig.from_gguf_metadata(md)
    assert got.clamp_kqv == 6.0 and got.use_alibi
    check_ported(got)


def test_lnfamily_archs_are_the_reference_sets():
    """The port's copies of the reference's architecture sets: its
    LAYERNORM_ARCHS among the ported targets, its PARALLEL_BLOCK_ARCHS less
    cohere2 and plamo, its NONPARAM_NORM_ARCHS whole."""
    from eagle_tpu.models import config as jconfig
    from eagle_tpu_torch.models.config import GELU_ARCHS, LAYERNORM_ARCHS

    assert set(LAYERNORM_TARGETS) <= jconfig.LAYERNORM_ARCHS
    assert LAYERNORM_ARCHS == jconfig.LAYERNORM_ARCHS & set(TARGET_ARCHS)
    assert PARALLEL_BLOCK_ARCHS == jconfig.PARALLEL_BLOCK_ARCHS - {"cohere2", "plamo"}
    assert NONPARAM_NORM_ARCHS == jconfig.NONPARAM_NORM_ARCHS
    assert GELU_ARCHS == jconfig.GELU_ARCHS & set(TARGET_ARCHS)

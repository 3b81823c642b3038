"""The Gemma family in the port on the CPU, against the reference, on a tiny
Q8_0 pair (`tiny_family_pair(path, "gemma")`): 2 layers of width 256, 2
query heads over 1 KV head of 256 (Gemma-7B's head width; the query is
twice n_embd), GELU, the sqrt(n_embd) embedding scale, a tied head, an SPM
vocabulary and a gemma template; no softcap, window or sandwich norm, so
its attention takes the flash functions at D = 256 (here their plain
versions).

The config and the loaded params bit-equal to the reference's
`load_llama_params` (NEOX rows, not un-permuted; the norms as the file
holds them); prefill and decode logits at rtol 1e-4 in f32; `Generator`,
the EAGLE chain and the static tree, int8 and paged, tokens (and stats)
equal to the reference's; `Engine` text, the CLI and the template equal to
the reference's. Then the head widths the kernels do not take: a tiny
llama at head_dim 96 reads through the plain attention (no flash function
is reached) and its logits equal the reference's, which reads it through
its einsums (`d % 128 != 0`)."""

import dataclasses

import numpy as np
import pytest

from eagle_tpu.gguf.constants import GGMLType
from eagle_tpu.models.loader import load_llama_params as jax_load
from eagle_tpu.tools import cli as jax_cli
from eagle_tpu_torch import _build
from eagle_tpu_torch.models.config import check_ported
from eagle_tpu_torch.models.loader import load_llama_params
from eagle_tpu_torch.ops.flash_attention import HEAD_DIMS
from eagle_tpu_torch.server.chat_templates import detect_template
from eagle_tpu_torch.tokenizer import SPMTokenizer
from eagle_tpu_torch.tools import cli
from test_torch_families import (  # noqa: F401  (f32_configs: a fixture)
    KINDS,
    MAX_SEQ,
    N_PROMPT,
    PROMPT,
    _caches,
    _close,
    _forward,
    _jax_engine,
    _jax_forward,
    _port_engine,
    _tokens,
    f32_configs,
)
from test_torch_loader import _same_tree
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    background_cpu,
    jax_cfg_to_torch,
    tiny_family_pair,
    write_tiny_gguf_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

FLASH = ("flash_decode", "flash_prefill")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tiny_family_pair(tmp_path_factory.mktemp("gemma"), "gemma")


@pytest.fixture(scope="module")
def model(pair):
    tt, tcfg, _ = load_llama_params(pair[0], device="cpu")
    jt, jcfg, _ = jax_load(pair[0])
    return dict(tt=tt, tcfg=tcfg, jt=jt, jcfg=jcfg)


@pytest.fixture(scope="module")
def ref_engines(pair):
    """The reference's engines, built once per module and kind."""
    cache = {}

    def get(kind="chain", **kw):
        key = (kind, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = _jax_engine(pair, kind, **kw)
        return cache[key]

    return get


def _flash_calls():
    return {k: _build.plain_calls[k] for k in FLASH}


def _prefill_then_decode(m, n_decode=3):
    """A 30-token prefill through the tag-mask path, then `n_decode` tokens
    one at a time: the logits against the reference's at rtol 1e-4. Returns
    the flash functions' plain calls of the prefill and of the decodes."""
    toks = _tokens(N_PROMPT + n_decode)
    jcache, cache = _caches(m["tcfg"])
    pos = np.arange(N_PROMPT, dtype=np.int32)[None]
    want = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, :N_PROMPT], pos)
    before = _flash_calls()
    got = _forward(m["tt"], m["tcfg"], cache, toks[:, :N_PROMPT], pos, prefill=True)
    calls = [{k: _build.plain_calls[k] - before[k] for k in FLASH}]
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden)
    jcache = want.kv
    before = _flash_calls()
    for i in range(N_PROMPT, N_PROMPT + n_decode):
        p = np.asarray([[i]], np.int32)
        want_i = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, i:i + 1], p)
        jcache = want_i.kv
        _close(_forward(m["tt"], m["tcfg"], cache, toks[:, i:i + 1], p).logits, want_i.logits)
    calls.append({k: _build.plain_calls[k] - before[k] for k in FLASH})
    return calls


# ---- config and loader ------------------------------------------------------


def test_config_reads_gemma(model):
    tcfg, jcfg = model["tcfg"], model["jcfg"]
    assert tcfg == jax_cfg_to_torch(jcfg)
    check_ported(tcfg)
    assert (tcfg.arch, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim, tcfg.n_embd) == (
        "gemma", 2, 1, 256, 256)
    assert tcfg.head_dim in HEAD_DIMS and tcfg.n_q_dim == 2 * tcfg.n_embd
    assert (tcfg.act, tcfg.embd_scale, tcfg.attn_scale) == ("gelu", 16.0, None)
    assert (tcfg.attn_softcap, tcfg.final_softcap, tcfg.swa_window, tcfg.post_norms) == (
        0.0, 0.0, 0, False)
    assert model["tt"]["output"] is model["tt"]["tok_embd"]
    assert not any(k.startswith(("post_", "attn_q_norm")) or k == "bqkv"
                   for k in model["tt"]["layers"])


def test_loaded_params_bit_equal(model):
    """Every leaf bit-equal to the reference's `load_llama_params`: the q/k
    rows as the file holds them (NEOX), the norms unchanged."""
    _same_tree(model["tt"], model["jt"])


# ---- the forward ------------------------------------------------------------


def test_forward_matches_reference(model):
    """Prefill and decode logits at rtol 1e-4 in f32. D = 256 is a width the
    flash kernels take: the prompt reaches `flash_prefill` and each decoded
    token `flash_decode`, once a layer (their plain versions here)."""
    n_layers = model["tcfg"].n_layers
    prefill, decode = _prefill_then_decode(model)
    assert prefill == {"flash_decode": 0, "flash_prefill": n_layers}
    assert decode == {"flash_decode": 3 * n_layers, "flash_prefill": 0}


def test_each_branch_moves_the_logits(model):
    """The embedding scale and GELU, each taken out, move the prefill's
    logits by more than the tolerance."""
    toks = _tokens(N_PROMPT)
    pos = np.arange(N_PROMPT, dtype=np.int32)[None]
    m = model
    base = _forward(m["tt"], m["tcfg"], _caches(m["tcfg"])[1], toks, pos).logits
    tol = 1e-4 * float(base.abs().max())
    for change in (dict(embd_scale=1.0), dict(act="silu")):
        cfg = dataclasses.replace(m["tcfg"], **change)
        other = _forward(m["tt"], cfg, _caches(cfg)[1], toks, pos).logits
        assert float((other - base).abs().max()) > 10 * tol, change


# ---- the engines and the entry points ---------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_engines_match_reference(pair, ref_engines, kind):
    """`Generator`, the EAGLE chain and the static tree (3,): tokens and the
    speculative stats equal to the reference's on the prompt's ids; the
    chain's `Engine.generate_text` equal to the reference's too."""
    jeng, eng = ref_engines(kind), _port_engine(pair, kind)
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


@pytest.mark.parametrize("kind", ["plain", "chain"])
def test_int8_cache_matches_reference(pair, ref_engines, kind):
    """Int8 caches (the dequantized plain read at D = 256): `Generator` and
    chain tokens equal to the reference's."""
    jeng, eng = ref_engines(kind, kv="int8"), _port_engine(pair, kind, kv="int8")
    ids = eng.tokenizer.encode(PROMPT)
    want = jeng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
    got = eng.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
    if kind == "chain":
        (want, want_stats), (got, stats) = want, got
        assert stats == want_stats
    assert [int(t) for t in got] == [int(t) for t in want]


def test_paged_batcher_matches_reference(pair, ref_engines):
    """A paged pool (`Engine(batch=2, paged=True)`, pages of 16 rows) at D =
    256: each slot's tokens equal to the reference's `PagedBatcher`'s."""
    kw = dict(batch=2, paged=True, page_size=16, kv_pages=12)
    jeng, eng = ref_engines("chain", **kw), _port_engine(pair, "chain", **kw)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (20, 33)]

    def run(b):
        slots = [b.submit(p, max_new_tokens=14, stop_at_eos=False) for p in prompts]
        b.run_until_done(max_steps=200)
        return [list(map(int, s.generated[:14])) for s in slots]

    assert run(eng.batcher) == run(jeng.batcher)


def test_cli_matches_reference_cli(pair, f32_configs, capsys):
    """`--draft --temp 0`: the same text as the reference's CLI; the SPM
    tokenizer and the gemma template are the ones the file's metadata
    names."""
    argv = ["-m", str(pair[0]), "--draft", str(pair[1]), "-p", PROMPT, "--ctx", str(MAX_SEQ),
            "-n", "12", "--temp", "0"]
    assert jax_cli.main(argv + ["--backend", "xla"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out == want and out.strip() and "[speculative]" in err
    eng = _port_engine(pair, "plain")
    assert isinstance(eng.tokenizer, SPMTokenizer)
    assert detect_template(eng.metadata["tokenizer.chat_template"]) == "gemma"


# ---- head widths the flash kernels do not take ------------------------------


@pytest.fixture(scope="module")
def llama96(tmp_path_factory):
    """A tiny llama at head_dim 96 (4 heads of 96 on a width of 256)."""
    q8 = GGMLType.Q8_0
    target, _ = write_tiny_gguf_pair(tmp_path_factory.mktemp("hd96"), q8, q8, q8, q8, seed=13,
                                     head_dim=96)
    tt, tcfg, _ = load_llama_params(target, device="cpu")
    jt, jcfg, _ = jax_load(target)
    return dict(tt=tt, tcfg=tcfg, jt=jt, jcfg=jcfg)


def test_head_width_96_reads_plain_attention(llama96):
    """At head_dim 96 (outside `HEAD_DIMS`) the forward takes the plain
    `gqa_attention` on every layer, prompt and decode alike, as the
    reference's einsums do: no flash function is reached, so the card
    launches no kernel that would refuse the width. Logits equal the
    reference's at rtol 1e-4."""
    assert llama96["tcfg"].head_dim == 96 not in HEAD_DIMS
    check_ported(llama96["tcfg"])
    prefill, decode = _prefill_then_decode(llama96)
    assert prefill == decode == {"flash_decode": 0, "flash_prefill": 0}

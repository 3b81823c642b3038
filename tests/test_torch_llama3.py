"""The Llama-3 family in the port on the CPU, against the reference:

- the loader reads a Llama-3.1 file's `rope_freqs.weight` into
  `params["rope_factors"]` and takes `token_embd` as the head of a file
  without `output.weight` (tied, "nk");
- the forward over 48 positions (past the factors' original 32): logits at
  rtol 1e-4 against the reference's, tied and untied, and unlike those
  without the factors; the reference's HF case
  (tests/test_rope_scaling.py:test_llama31_rope_factors_parity) on the port;
- the "nk" head (`ops/matmul.py:_qmatmul_nk`) against the reference's
  `_qmatmul_xla` in f32 and bf16;
- `Generator` and the EAGLE chain's tokens and stats, `Engine` text, the
  CLI (plain, `--draft`, `--grammar`, `--chat`), `tools/tokenize.py` and the
  server's `/v1/chat/completions` (the llama3 template) equal to the
  reference's on a tiny Llama-3-style pair (`tiny_llama3_pair`: GQA 4:1,
  rope factors, a byte-level BPE vocabulary with Llama-3's specials; tied
  and untied);
- a context shift and a Self-Extend step on a factored config: the port's
  shifted keys equal a recompute at the new positions, where the
  reference's (its `Generator` shifts with `rope_freqs_cfg` alone,
  generate.py:332 and :365) do not."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eagle_tpu.api as jax_api
import eagle_tpu_torch.api as port_api
from eagle_tpu.models.llama import llama_forward as jax_llama_forward
from eagle_tpu.models.loader import load_llama_params as jax_load
from eagle_tpu.ops import rope as jrope
from eagle_tpu.ops.matmul import _qmatmul_xla
from eagle_tpu.quant.qtensor import QTensor as JaxQTensor
from eagle_tpu.runtime import kvcache as jkv
from eagle_tpu.tools import cli as jax_cli
from eagle_tpu.tools import tokenize as jax_tokenize
from eagle_tpu_torch.models.llama import llama_forward
from eagle_tpu_torch.models.loader import load_llama_params
from eagle_tpu_torch.ops import rope
from eagle_tpu_torch.ops.matmul import qmatmul
from eagle_tpu_torch.quant.qtensor import QTensor
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags
from eagle_tpu_torch.tokenizer import BPETokenizer
from eagle_tpu_torch.tools import cli, tokenize
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    LLAMA3_PROMPT as PROMPT,
    background_cpu,
    tiny_llama3_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

MAX_SEQ = 128
K = 3
TIES = ["untied", "tied"]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return {t: tiny_llama3_pair(tmp_path_factory.mktemp(t), tied=t == "tied") for t in TIES}


@pytest.fixture(scope="module")
def models(pairs):
    out = {}
    for t, (target, _) in pairs.items():
        tt, tcfg, _ = load_llama_params(target, device="cpu")
        jt, jcfg, _ = jax_load(target)
        out[t] = dict(tt=tt, tcfg=tcfg, jt=jt, jcfg=jcfg)
    return out


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _forward(params, cfg, kv, tokens, positions, slots=None):
    positions = torch.from_numpy(np.asarray(positions, np.int32))
    slots = positions if slots is None else torch.from_numpy(np.asarray(slots, np.int32))
    kv.with_tags(slots, positions)
    mask = causal_mask_from_tags(kv.slot_pos, positions)
    return llama_forward(params, cfg, torch.from_numpy(tokens), positions, kv, slots, mask,
                         compute_dtype=torch.float32)


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


@pytest.mark.parametrize("tied", TIES)
def test_loader_reads_factors_and_tied_head(models, tied):
    m = models[tied]
    tt, jt = m["tt"], m["jt"]
    assert m["tcfg"].n_kv_heads == 1 and m["tcfg"].n_heads == 4
    np.testing.assert_array_equal(tt["rope_factors"].numpy(), np.asarray(jt["rope_factors"]))
    assert float(tt["rope_factors"].max()) == 8.0 and float(tt["rope_factors"].min()) == 1.0
    assert isinstance(tt["output"], QTensor)
    if tied == "tied":
        assert tt["output"] is tt["tok_embd"] and tt["output"].layout == "nk"
    else:
        assert tt["output"].layout == "kn"
    assert tt["output"].shape == tuple(jt["output"].shape)


@pytest.mark.parametrize("tied", TIES)
def test_forward_matches_reference(models, tied):
    """48 positions, past the factors' original 32: logits and the
    final hidden state at rtol 1e-4; without the factors the logits move."""
    m = models[tied]
    toks = np.random.default_rng(3).integers(0, 512, size=(1, 48)).astype(np.int32)
    pos = np.arange(48, dtype=np.int32)[None]
    jcache, cache = _caches(m["tcfg"])
    want = _jax_forward(m["jt"], m["jcfg"], jcache, toks, pos)
    got = _forward(m["tt"], m["tcfg"], cache, toks, pos)
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden)
    plain = {k: v for k, v in m["tt"].items() if k != "rope_factors"}
    base = _forward(plain, m["tcfg"], _caches(m["tcfg"])[1], toks, pos)
    assert (base.logits - got.logits).abs().max() > 1e-3


def test_rope_inv_freq_is_kept():
    """The factored frequencies are made once per factors tensor, config
    and device; another factors tensor gets its own."""
    from eagle_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(arch="llama", vocab_size=1, n_embd=64, n_layers=1, n_heads=1,
                      n_kv_heads=1, head_dim=64, n_ff=1, rope_dim=64, rope_base=500000.0)
    f = torch.linspace(1.0, 8.0, 32)
    a = rope.rope_inv_freq(cfg, f, device="cpu")
    assert rope.rope_inv_freq(cfg, f, device="cpu") is a
    np.testing.assert_allclose(a.numpy(), np.asarray(jrope.rope_freqs_cfg(cfg)[0]) / f.numpy(),
                               rtol=1e-6)
    assert rope.rope_inv_freq(cfg, f.clone(), device="cpu") is not a
    assert torch.equal(rope.rope_inv_freq(cfg, None, device="cpu"),
                       rope.rope_freqs_cfg(cfg, device="cpu")[0])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias", [False, True])
def test_nk_head_matches_reference(dtype, bias):
    """The "nk" product against the reference's `_qmatmul_xla`: the same
    dequant rounding, f32 accumulation and output."""
    rng = np.random.default_rng(1)
    n, k, g = 96, 128, 16
    q = rng.integers(-32, 32, (n, k)).astype(np.int8)
    scale = (rng.random((n, k // g)) * 0.01).astype(np.float32)
    b = (rng.standard_normal((n, k // g)) * 0.01).astype(np.float32) if bias else None
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    cd_j, cd_t = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    want = _qmatmul_xla(jnp.asarray(x), JaxQTensor(q=jnp.asarray(q), scale=jnp.asarray(scale),
                                                   bias=None if b is None else jnp.asarray(b),
                                                   group=g, layout="nk"), compute_dtype=cd_j)
    w = QTensor(q=torch.from_numpy(q), scale=torch.from_numpy(scale),
                bias=None if b is None else torch.from_numpy(b), group=g, layout="nk")
    got = qmatmul(torch.from_numpy(x), w, cd_t)
    assert got.dtype == torch.float32 and got.shape == (2, 3, n)
    _close(got, want, rtol=1e-5)


def test_rope_factors_hf_parity(tmp_path):
    """The reference's HF case on the port: an HF Llama-3.1 (llama3 rope
    scaling) converted with its factors by the reference's converter, read
    by the port's loader: logits at rtol 1e-4 against the reference's
    forward on the file, at the reference's own tolerance against HF, and
    closer to HF than without the factors."""
    transformers = pytest.importorskip("transformers")
    from eagle_tpu.gguf.constants import GGMLType
    from eagle_tpu.models.hf_convert import config_from_hf, convert_hf_to_gguf
    from eagle_tpu.models.hf_convert import llama3_rope_factors

    torch.manual_seed(121)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, attn_implementation="eager",
        tie_word_embeddings=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32},
    )
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    path = tmp_path / "llama31.gguf"
    convert_hf_to_gguf(model.state_dict(), config_from_hf(hf_cfg), path,
                       qtype=GGMLType.F32, rope_factors=llama3_rope_factors(hf_cfg))
    params, cfg, _ = load_llama_params(path, device="cpu")
    jparams, jcfg, _ = jax_load(path)
    assert "rope_factors" in params
    tokens = np.random.default_rng(0).integers(0, 128, size=(1, 48)).astype(np.int32)
    pos = np.arange(48, dtype=np.int32)[None]
    jcache, cache = _caches(cfg)
    want = _jax_forward(jparams, jcfg, jcache, tokens, pos).logits
    ours = _forward(params, cfg, cache, tokens, pos).logits
    _close(ours, want)
    with torch.no_grad():
        hf = model(torch.tensor(tokens, dtype=torch.long)).logits
    np.testing.assert_allclose(ours.numpy(), hf.numpy(), atol=3e-3, rtol=1e-2)
    plain = {k: v for k, v in params.items() if k != "rope_factors"}
    base = _forward(plain, cfg, _caches(cfg)[1], tokens, pos).logits
    assert (ours - hf).abs().max() < (base - hf).abs().max()


# ---- the engines and the entry points ------------------------------------------


def _jax_engine(pair, draft: bool):
    return jax_api.Engine(jax_api.EngineConfig(
        model_path=str(pair[0]), draft_path=str(pair[1]) if draft else None, n_draft=K,
        max_seq=MAX_SEQ, backend="xla", compute_dtype=jnp.float32, kv_dtype=jnp.float32))


def _port_engine(pair, draft: bool):
    return port_api.Engine(port_api.EngineConfig(
        model_path=pair[0], draft_path=pair[1] if draft else None, n_draft=K, max_seq=MAX_SEQ,
        compute_dtype=torch.float32, kv_dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("draft", [False, True], ids=["greedy", "chain"])
@pytest.mark.parametrize("tied", TIES)
def test_engines_match_reference(pairs, tied, draft):
    """Greedy `Generator` and the EAGLE chain: tokens and stats, then
    `Engine.generate_text`'s text, equal to the reference's."""
    pair = pairs[tied]
    jeng, eng = _jax_engine(pair, draft), _port_engine(pair, draft)
    assert isinstance(eng.tokenizer, BPETokenizer)
    ids = eng.tokenizer.encode(PROMPT)
    assert ids == jeng.tokenizer.encode(PROMPT)
    assert ids[0] == eng.tokenizer.token_to_id["<|begin_of_text|>"]
    if draft:
        want, want_stats = jeng.engine.generate(ids, max_new_tokens=20)
        got, stats = eng.engine.generate(ids, max_new_tokens=20)
        assert stats == want_stats and stats["n_cycles"] > 0
    else:
        want = jeng.engine.generate(ids, max_new_tokens=20)
        got = eng.engine.generate(ids, max_new_tokens=20)
    assert list(got) == [int(t) for t in want]
    text, stats = eng.generate_text(PROMPT, max_new_tokens=16)
    assert (text, stats) == jeng.generate_text(PROMPT, max_new_tokens=16)


@pytest.fixture
def f32_configs(monkeypatch):
    """Both CLIs' engines at f32 (their default compute is bf16)."""
    monkeypatch.setattr(jax_api, "EngineConfig", functools.partial(
        jax_api.EngineConfig, compute_dtype=jnp.float32, kv_dtype=jnp.float32))
    monkeypatch.setattr(port_api, "EngineConfig", functools.partial(
        port_api.EngineConfig, compute_dtype=torch.float32, kv_dtype=torch.float32))


CLI_RUNS = {
    "greedy": ["--temp", "0"],
    "draft": ["--draft", "DRAFT", "--temp", "0"],
    "grammar": ["--grammar", "root ::= [a-z ]+", "--temp", "0"],
    "grammar_draft": ["--draft", "DRAFT", "--grammar", 'root ::= ("café" | "日本" | " ")+'],
}


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_matches_reference_cli(pairs, f32_configs, capsys, name):
    pair = pairs["untied"]
    flags = [str(pair[1]) if f == "DRAFT" else f for f in CLI_RUNS[name]]
    base = ["-m", str(pair[0]), "-p", PROMPT, "--ctx", str(MAX_SEQ), "-n", "12"]
    assert jax_cli.main(base + ["--backend", "xla"] + flags) == 0
    want, want_err = capsys.readouterr()
    assert cli.main(base + ["--device", "cpu"] + flags) == 0
    out, err = capsys.readouterr()
    assert out == want and out.strip()
    assert ("[speculative]" in err) == ("[speculative]" in want_err) == (name == "draft")


def test_cli_chat_matches_reference_cli(pairs, f32_configs, capsys, monkeypatch):
    """`--chat` over the llama3 template: each reply streamed piece by
    piece (a character split across byte-level pieces prints as the
    reference prints it)."""
    import io

    pair = pairs["tied"]
    argv = ["-m", str(pair[0]), "--chat", "--temp", "0", "-n", "10", "--ctx", str(MAX_SEQ)]
    lines = "the quick fox\nnaïve café 日本語\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    assert jax_cli.main(argv + ["--backend", "xla"]) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


def test_tokenize_tool_matches_reference(pairs, capsys):
    pair = pairs["untied"]
    for flags in (["--ids"], [], ["--ids", "--no-bos"]):
        argv = ["-m", str(pair[0]), "-p", PROMPT + "<|eot_id|>", *flags]
        assert jax_tokenize.main(argv) == 0
        want = capsys.readouterr().out
        assert tokenize.main(argv) == 0
        assert capsys.readouterr().out == want and want


def test_server_chat_matches_reference(pairs):
    """`/v1/chat/completions` (the GGUF's template, read as "llama3") and
    `/completion` streamed, on both servers: the same bodies apart from
    ids and times."""
    import json

    from eagle_tpu_torch.server.chat_templates import detect_template
    from eagle_tpu_torch.server.server import InferenceServer
    from test_torch_server import _frames, _reference, _strip, post

    pair = pairs["untied"]
    eng = _port_engine(pair, True)
    assert detect_template(eng.metadata["tokenizer.chat_template"]) == "llama3"
    srv = InferenceServer(eng, model_name="tiny")
    host, port = srv.start("127.0.0.1", 0)
    ref, stop_ref = _reference((str(pair[0]), str(pair[1])), 1)
    try:
        chat = [{"role": "system", "content": "naïve café"}, {"role": "user", "content": "日本"}]
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


# ---- the context shift and Self-Extend with the factors -------------------------


@pytest.mark.parametrize("kind", ["context_shift", "self_extend"])
def test_shift_with_factors_equals_recompute(models, kind):
    """Prefill 80 tokens, shift: the port's `Generator` re-rotates with the
    forward's factored frequencies, so layer 0's keys (a function of the
    token and its position only) equal a fresh forward's at the new
    positions; the reference's shift, with `rope_freqs_cfg` alone, gives
    keys that differ from its own recompute."""
    m = models["untied"]
    n, keep, discard = 80, 6, 30
    toks = np.random.default_rng(8).integers(0, 512, size=(1, n)).astype(np.int32)
    pos = np.arange(n, dtype=np.int32)[None]
    gen = Generator(m["tt"], m["tcfg"], max_seq=MAX_SEQ, kv_dtype=torch.float32,
                    compute_dtype=torch.float32, eos_id=-1, device="cpu")
    _forward(m["tt"], m["tcfg"], gen.kv, toks, pos)
    jcache = _jax_forward(m["jt"], m["jcfg"], _caches(m["tcfg"])[0], toks, pos).kv
    j_inv = jrope.rope_freqs_cfg(m["jcfg"])[0]  # the reference's generate.py:332 / :365
    if kind == "context_shift":
        gen.shift_context(keep, discard)
        jcache = jkv.context_shift(jcache, j_inv, keep, discard)
        kept = np.concatenate([toks[:, :keep], toks[:, keep + discard:]], axis=1)
        new_pos = np.arange(n - discard, dtype=np.int32)[None]
        slots = new_pos[0]
    else:
        got_n, _ = gen.self_extend(n, 0, 2, 32)
        jcache, want_n, _ = jkv.self_extend_shift(jcache, j_inv, n, 0, 2, 32)
        assert got_n == want_n
        new_pos = gen.kv.slot_pos.numpy()[:, :n]
        np.testing.assert_array_equal(new_pos, np.asarray(jcache.slot_pos)[:, :n])
        kept, slots = toks, np.arange(n)
    fresh = _forward(m["tt"], m["tcfg"], _caches(m["tcfg"])[1], kept, new_pos,
                     np.arange(kept.shape[1])[None]).kv
    got = gen.kv.k[0, :, :, slots].numpy()
    recompute = fresh.k[0, :, :, :kept.shape[1]].numpy()
    np.testing.assert_allclose(got, recompute, rtol=1e-5, atol=1e-5)
    ref_keys = np.asarray(jcache.k)[0][:, :, slots]
    assert np.abs(ref_keys - recompute).max() > 1e-3

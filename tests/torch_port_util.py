"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
carry JAX-side arrays and params across as numpy, and the tiny model config
those tests use.

Importing this module sets PyTorch to one intra-op thread: the suite runs
in parallel pytest workers, and one thread per core in each worker
oversubscribes the host and slows the timing tests of other files, while
the tiny shapes here gain nothing from more threads. The reference's side
is not held by that: compiling its engines on XLA's CPU runtime keeps two
to three cores busy per worker, whatever XLA's thread flags say. The
`background_cpu` fixture runs a module's threads at idle priority instead
(the modules that run reference engines use it)."""

from __future__ import annotations

import dataclasses
import functools
import os
import threading

import numpy as np
import pytest
import torch

from eagle_tpu.quant.qtensor import QTensor as JaxQTensor

torch.set_num_threads(1)


def _set_policy(policy: int) -> None:
    """Every thread of this process to scheduling `policy` (threads made
    later inherit their creator's)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setscheduler(int(tid), policy, os.sched_param(0))
        except ProcessLookupError:  # the thread ended meanwhile
            pass


def _can_leave_idle() -> bool:
    """Whether a thread of this process may return from SCHED_IDLE (that
    takes CAP_SYS_NICE or a high enough RLIMIT_NICE), tried on a thread
    made for it."""
    ok = []

    def probe():
        try:
            os.sched_setscheduler(0, os.SCHED_IDLE, os.sched_param(0))
            os.sched_setscheduler(0, os.SCHED_OTHER, os.sched_param(0))
            ok.append(True)
        except OSError:
            pass

    t = threading.Thread(target=probe)
    t.start()
    t.join()
    return bool(ok)


@pytest.fixture(scope="module")
def background_cpu():
    """Run the module with every thread of this worker at idle priority
    (SCHED_IDLE): the port's modules, which compile and run the reference's
    engines on XLA, use any core, but only the cycles no other test of the
    parallel run wants, so they cannot slow the reference's wall-clock
    tests. The former policy is restored afterwards; where it could not be
    (no CAP_SYS_NICE), the module runs at normal priority."""
    if not hasattr(os, "SCHED_IDLE") or not _can_leave_idle():
        yield False
        return
    before = os.sched_getscheduler(0)
    _set_policy(os.SCHED_IDLE)
    yield True
    _set_policy(before)


def qtensor_to_numpy(qt: JaxQTensor) -> dict:
    """A JAX QTensor as the dict `eagle_tpu_torch.convert` takes."""
    d = {k: None if getattr(qt, k) is None else np.asarray(getattr(qt, k))
         for k in ("q", "scale", "bias", "sup", "sup_min")}
    d.update(group=qt.group, layout=qt.layout, packed=qt.packed, ggml_type=qt.ggml_type)
    return d


def tree_to_numpy(tree):
    """A JAX param tree with every leaf as numpy (QTensors as dicts)."""
    if isinstance(tree, JaxQTensor):
        return qtensor_to_numpy(tree)
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if tree is None:
        return None
    return np.asarray(tree)


def tiny_cfgs():
    """(JAX ModelConfig, port ModelConfig) of the tiny llama: 2 layers,
    n_embd 256, 4 heads, 2 kv heads, head_dim 64, n_ff 512, vocab 512."""
    from eagle_tpu.models.config import ModelConfig as JaxCfg
    from eagle_tpu_torch.models.config import ModelConfig as TorchCfg

    fields = dict(arch="llama", vocab_size=512, n_embd=256, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=64, n_ff=512, rms_eps=1e-6, rope_base=10000.0,
                  rope_dim=64, n_ctx_train=2048)
    return JaxCfg(**fields), TorchCfg(**fields)


def jax_cfg_to_torch(cfg):
    from eagle_tpu_torch.models.config import ModelConfig as TorchCfg

    names = {f.name for f in dataclasses.fields(TorchCfg)}
    return TorchCfg(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


def random_blocks(rng, qtype, n: int, k: int, d_mag: float = 2e-3) -> np.ndarray:
    """Random block bytes of an [n, k] tensor of `qtype` (a reference
    GGMLType) whose f16 fields are finite, in [0.5, 1.5) x d_mag with a
    random sign; IQ1_M's scale nibbles likewise. Every code and sub-scale
    pattern occurs."""
    from eagle_tpu.gguf.constants import GGML_TYPE_TRAITS, GGMLType
    from eagle_tpu_torch.gguf.constants import F16_FIELDS

    tr = GGML_TYPE_TRAITS[qtype]
    nb = n * k // tr.block_size
    raw = rng.integers(0, 256, (nb, tr.type_size), dtype=np.uint8)

    def scales():
        d = rng.uniform(0.5, 1.5, nb) * d_mag * rng.choice([-1.0, 1.0], nb)
        return d.astype(np.float16).view(np.uint8).reshape(nb, 2)

    for at in F16_FIELDS[int(qtype)]:
        raw[:, at:at + 2] = scales()
    if qtype == GGMLType.IQ1_M:
        bits = scales().view("<u2")[:, 0].astype(np.int32)
        for word in range(4):  # nibble `word` of d: the top nibble of scale word `word`
            hi = 48 + 2 * word + 1
            raw[:, hi] = (raw[:, hi] & 0x0F) | (((bits >> (4 * word)) & 0xF) << 4)
    return raw.reshape(-1)


def has_encoder(qtype) -> bool:
    """Whether the reference's writer can quantize float weights to `qtype`
    (the codebook formats have no encoder)."""
    from eagle_tpu.quant.blocks import SUPPORTED_QUANT_TYPES

    return qtype in SUPPORTED_QUANT_TYPES


def write_tiny_gguf_pair(tmp_path, layer_type, out_type, emb_type, draft_type, seed=0,
                         target_metadata: dict | None = None, out_scale: float = 0.05,
                         n_kv_heads: int | None = None, rope_factors=None,
                         tied: bool = False):
    """A tiny llama target GGUF and EAGLE draft GGUF (the tiny_cfgs shapes),
    minted with the reference's GGUFWriter, which quantizes float weights:
    layer matmul weights in `layer_type`, output in `out_type`, token_embd in
    `emb_type`, the draft's matmul weights and embedding in `draft_type`;
    norms and fc.bias F32. A format without an encoder (the codebook ones)
    gets `random_blocks`. `target_metadata` adds keys to the target's
    metadata (a tokenizer). `out_scale` is the output weights' standard
    deviation (larger: more peaked logits). `n_kv_heads` sets both files'
    KV heads (GQA), `rope_factors` [head_dim/2] adds the target's
    `rope_freqs.weight` (Llama-3.1), `tied` leaves out its `output.weight`
    (the head is token_embd, in `emb_type` at `out_scale`). Returns (target
    path, draft path)."""
    from eagle_tpu.gguf.writer import GGUFWriter
    from eagle_tpu.tools.train_draft import _base_metadata

    jcfg, _ = tiny_cfgs()
    if n_kv_heads is not None:
        jcfg = dataclasses.replace(jcfg, n_kv_heads=n_kv_heads)
    rng = np.random.default_rng(seed)
    d, f, v = jcfg.n_embd, jcfg.n_ff, jcfg.vocab_size
    nq, nkv = jcfg.n_heads * jcfg.head_dim, jcfg.n_kv_heads * jcfg.head_dim

    def qmat(w, name, n, k, qtype, scale=0.05):
        if has_encoder(qtype):
            w.add_tensor(name, (rng.standard_normal((n, k)) * scale).astype(np.float32),
                         ggml_type=qtype)
        else:
            w.add_tensor(name, random_blocks(rng, qtype, n, k), ggml_type=qtype,
                         raw_shape=(n, k))

    def norm():
        return rng.uniform(0.8, 1.2, d).astype(np.float32)

    def layer(w, i, qtype, attn_norm=True):
        if attn_norm:
            w.add_tensor(f"blk.{i}.attn_norm.weight", norm())
        for name, (n, k) in (("attn_q", (nq, d)), ("attn_k", (nkv, d)), ("attn_v", (nkv, d)),
                             ("attn_output", (d, nq)), ("ffn_gate", (f, d)), ("ffn_up", (f, d)),
                             ("ffn_down", (d, f))):
            qmat(w, f"blk.{i}.{name}.weight", n, k, qtype)
        w.add_tensor(f"blk.{i}.ffn_norm.weight", norm())

    target = tmp_path / "target.gguf"
    w = GGUFWriter(target)
    for k, val in {**_base_metadata(jcfg, "llama"), **(target_metadata or {})}.items():
        w.add(k, val)
    qmat(w, "token_embd.weight", v, d, emb_type, out_scale if tied else 0.5)
    for i in range(jcfg.n_layers):
        layer(w, i, layer_type)
    w.add_tensor("output_norm.weight", norm())
    if rope_factors is not None:
        w.add_tensor("rope_freqs.weight", np.asarray(rope_factors, np.float32))
    if not tied:
        qmat(w, "output.weight", v, d, out_type, out_scale)
    w.write()

    draft = tmp_path / "draft.gguf"
    w = GGUFWriter(draft)
    for k, val in _base_metadata(dataclasses.replace(jcfg, n_layers=1), "eagle").items():
        w.add(k, val)
    qmat(w, "token_embd.weight", v, d, draft_type, 0.5)
    qmat(w, "fc.weight", d, 2 * d, draft_type)
    w.add_tensor("fc.bias", (rng.standard_normal(d) * 0.01).astype(np.float32))
    layer(w, 0, draft_type, attn_norm=False)
    w.write()
    return target, draft


def spm_metadata(words: str, v: int = 512, seed: int = 0) -> dict:
    """An SPM vocabulary of `v` pieces as GGUF metadata, built as
    tests/test_tokenizer.py builds one: <unk>, <s>, </s>, the 256 byte
    tokens, then '▁' and the letters with and without it, every '▁'-prefix
    of the `words` given, then seeded prefix-closed words; scores descend."""
    rng = np.random.default_rng(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    ttypes = [2, 3, 3] + [6] * 256
    pieces = ["▁"] + list(letters) + ["▁" + c for c in letters]
    for word in words.split():
        pieces += ["▁" + word[:i] for i in range(2, len(word) + 1)]
    pieces = list(dict.fromkeys(pieces))
    while len(tokens) + len(pieces) < v:
        w = "▁" + "".join(rng.choice(list(letters), size=int(rng.integers(2, 6))))
        pieces = list(dict.fromkeys(pieces + [w[:i] for i in range(2, len(w) + 1)]))
    pieces = pieces[: v - len(tokens)]
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens + pieces,
            "tokenizer.ggml.scores": np.asarray(
                [0.0] * len(tokens) + [-float(i) for i in range(len(pieces))], np.float32),
            "tokenizer.ggml.token_type": np.asarray(ttypes + [1] * len(pieces), np.int32),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.add_bos_token": True}


def tiny_engine_pair(tmp_path, words: str):
    """A tiny Q8_0 target and draft GGUF pair whose target carries
    `spm_metadata(words)`: what `eagle_tpu_torch.api.Engine` and the CLI
    load."""
    from eagle_tpu.gguf.constants import GGMLType

    q8 = GGMLType.Q8_0
    return write_tiny_gguf_pair(tmp_path, q8, q8, q8, q8, seed=3,
                                target_metadata=spm_metadata(words))


LLAMA3_SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                   "<|end_header_id|>", "<|eot_id|>")
#: a chat template string the server's detection reads as "llama3"
LLAMA3_TEMPLATE = ("{% for message in messages %}<|start_header_id|>{{ message['role'] }}"
                   "<|end_header_id|>\n\n{{ message['content'] | trim }}<|eot_id|>"
                   "{% endfor %}")


def learn_merges(corpus: str, n_pieces: int) -> tuple[list[str], list[str]]:
    """(pieces, merges) of a byte-level BPE vocabulary: the 256 byte
    symbols, then merges learned greedily from `corpus` (split by the
    Llama-3 pattern), the most frequent pair first (ties: the larger pair),
    until there are `n_pieces` pieces. Each merge's result is a piece."""
    from eagle_tpu_torch.tokenizer import bpe

    words: dict[tuple, int] = {}
    for w in bpe.regex_split(corpus, [bpe.compile_pattern(bpe._LLAMA3)]):
        key = tuple(bpe._BYTE_ENC[b] for b in w.encode("utf-8"))
        words[key] = words.get(key, 0) + 1
    pieces = [bpe._BYTE_ENC[b] for b in range(256)]
    seen, merges = set(pieces), []
    while len(pieces) < n_pieces:
        counts: dict = {}
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                counts[pair] = counts.get(pair, 0) + c
        if not counts:
            raise ValueError(f"the corpus makes only {len(pieces)} pieces")
        (a, b), _ = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        if a + b not in seen:
            seen.add(a + b)
            pieces.append(a + b)
        merged = {}
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + c
        words = merged
    return pieces, merges


def bpe_metadata(corpus: str, v: int = 512) -> dict:
    """A Llama-3-style byte-level BPE vocabulary of `v` pieces as GGUF
    metadata: `learn_merges(corpus)` then LLAMA3_SPECIALS (control tokens;
    BOS <|begin_of_text|>, EOS and EOT <|eot_id|>), pre "llama-bpe",
    add_bos, and LLAMA3_TEMPLATE."""
    pieces, merges = learn_merges(corpus, v - len(LLAMA3_SPECIALS))
    tokens = pieces + list(LLAMA3_SPECIALS)
    ids = {t: i for i, t in enumerate(tokens)}
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "llama-bpe",
            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.token_type": np.asarray(
                [1] * len(pieces) + [3] * len(LLAMA3_SPECIALS), np.int32),
            "tokenizer.ggml.bos_token_id": ids["<|begin_of_text|>"],
            "tokenizer.ggml.eos_token_id": ids["<|eot_id|>"],
            "tokenizer.ggml.eot_token_id": ids["<|eot_id|>"],
            "tokenizer.ggml.add_bos_token": True,
            "tokenizer.chat_template": LLAMA3_TEMPLATE}


def llama3_factors(head_dim: int, base: float, factor: float = 8.0, low: float = 1.0,
                   high: float = 4.0, orig_ctx: int = 8192) -> np.ndarray:
    """Llama-3.1's `rope_freqs.weight` by the reference converter's rule
    (eagle_tpu/models/hf_convert.py:llama3_rope_factors)."""
    from types import SimpleNamespace

    from eagle_tpu.models.hf_convert import llama3_rope_factors

    return llama3_rope_factors(SimpleNamespace(
        rope_theta=base, head_dim=head_dim, rope_scaling={
            "rope_type": "llama3", "factor": factor, "low_freq_factor": low,
            "high_freq_factor": high, "original_max_position_embeddings": orig_ctx}))


def llama3_corpus(n_words: int = 1500, seed: int = 0) -> str:
    """Text to learn a tiny vocabulary's merges from: a fixed sentence with
    multi-byte characters, contractions and digits, then `n_words` seeded
    words of ASCII letters and a few accented and CJK characters."""
    rng = np.random.default_rng(seed)
    chars = list("abcdefghijklmnopqrstuvwxyz") * 4 + list("éüß日本語の")
    words = ["".join(rng.choice(chars, size=int(rng.integers(1, 8)))) for _ in range(n_words)]
    return ("the quick brown fox jumps over a lazy dog and then naïve café Straße 日本語 "
            "😀 It's they're we'll I'd don't 12345 hello world, Hello World!\n\t " * 3
            + " ".join(words))


LLAMA3_PROMPT = "the quick brown fox jumps over a naïve café dog 日本語 and then"


@functools.lru_cache(maxsize=None)
def llama3_vocab() -> dict:
    """`bpe_metadata(llama3_corpus())`, learned once per process."""
    return bpe_metadata(llama3_corpus())


def tiny_llama3_pair(tmp_path, tied: bool = False):
    """A tiny Llama-3-style Q8_0 target and draft GGUF pair: GQA 4:1 (one KV
    head), Llama-3.1 rope factors (factor 8 over an original 32 positions,
    base 500,000), a 512-piece byte-level BPE vocabulary (`bpe_metadata`),
    tied or not."""
    from eagle_tpu.gguf.constants import GGMLType

    q8 = GGMLType.Q8_0
    md = {**llama3_vocab(), "llama.rope.freq_base": 500000.0}
    return write_tiny_gguf_pair(
        tmp_path, q8, q8, q8, q8, seed=5, target_metadata=md, n_kv_heads=1,
        rope_factors=llama3_factors(64, 500000.0, orig_ctx=32), tied=tied)


ENGINE_PROMPT = "the quick brown fox jumps over a lazy dog and then"
ENGINE_KINDS = {"plain": {}, "chain": {}, "tree": {"tree_branching": (3,)},
                "tree2": {"tree2": (2, 1, 3)}}  # one level each: the reference compiles them fast


def tiny_port_engine(pair, kind: str):
    """The port's `Engine` of ENGINE_KINDS `kind` on a `tiny_engine_pair`,
    f32 on the CPU."""
    from eagle_tpu_torch.api import Engine, EngineConfig

    return Engine(EngineConfig(model_path=pair[0], draft_path=None if kind == "plain" else pair[1],
                               max_seq=128, compute_dtype=torch.float32,
                               kv_dtype=torch.float32, device="cpu", **ENGINE_KINDS[kind]))


def oracle(real, seq: torch.Tensor, boost: float = 1e4):
    """`eagle_forward` with `boost` added to its logits at the target's
    greedy continuation: the pair at draft position p proposes x_{p+2}
    (`seq` holds the prompt and the greedy tokens). Device ops only."""

    def forward(*args, **kw):
        out = real(*args, **kw)
        if out.logits is None:  # the prompt's draft pass
            return out
        want = seq[(args[5].long() + 2).clamp(min=0, max=seq.numel() - 1)]  # [B, T]
        boosted = out.logits.scatter_add(-1, want[..., None],
                                         torch.full_like(out.logits[..., :1], boost))
        return out._replace(logits=boosted)

    return forward


def assert_bits_equal(got, want, what=""):
    """A port tensor and a reference array hold the same bits (floats are
    compared as integers, so -0.0 and NaN payloads count)."""
    got = got.detach().cpu()
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape), want.shape)
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        got, want = got.view(f"i{got.itemsize}"), want.view(f"i{want.itemsize}")
    np.testing.assert_array_equal(got, want, err_msg=what)


class ReplayGraph:
    """A stand-in CUDA graph whose replay runs the captured body again."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def stub_capture(monkeypatch, engine):
    """Give `engine` enabled `StepGraphs` whose warm-up runs the body and
    whose capture returns a `ReplayGraph`: on the CPU, the engine's graph
    keys, captures and replays run as on the card."""
    from eagle_tpu_torch.runtime import graphs

    monkeypatch.setattr(graphs.StepGraphs, "_warm_up", lambda self, body: body())
    monkeypatch.setattr(graphs.StepGraphs, "_capture", lambda self, body: ReplayGraph(body))
    monkeypatch.delenv("EAGLE_TPU_FUSED_FFN", raising=False)
    monkeypatch.setattr(engine, "graphs", graphs.StepGraphs(enabled=True))
    return engine.graphs


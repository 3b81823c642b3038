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


#: the tensors of a llama-family layer
LLAMA_LAYOUT = dict(fused_qkv=False, gate=True, ffn_norm=True, norm_b=False, qkv_b=False,
                    bo=False, ffn_b=False, out_b=False, gate_b=False, pos_embd=False,
                    embd_norm=False, norms=True)
#: the LayerNorm families' tensors, as llama.cpp's tensor tables hold them:
#: a fused attn_qkv, an FFN gate, an ffn_norm, the norms' biases, q/k/v
#: biases, attn_output.bias, ffn_up / ffn_down biases, output.bias
LN_LAYOUTS = {
    "phi2": dict(LLAMA_LAYOUT, gate=False, ffn_norm=False, norm_b=True, qkv_b=True, bo=True,
                 ffn_b=True, out_b=True),
    "starcoder2": dict(LLAMA_LAYOUT, gate=False, norm_b=True, qkv_b=True, bo=True, ffn_b=True),
    "stablelm": dict(LLAMA_LAYOUT, norm_b=True, qkv_b=True),
    "gptneox": dict(LLAMA_LAYOUT, fused_qkv=True, gate=False, norm_b=True, qkv_b=True, bo=True,
                    ffn_b=True),
    "command-r": dict(LLAMA_LAYOUT, ffn_norm=False),
    # the position families (no rotary): GPT-2 and StarCoder with learned
    # positions, BLOOM with its embedding LayerNorm, MPT without any bias,
    # JAIS with a gated FFN whose gate carries a bias too (refact is the
    # llama layout: RMSNorm, separate q/k/v, a gated FFN, no biases)
    "gpt2": dict(LLAMA_LAYOUT, fused_qkv=True, gate=False, norm_b=True, qkv_b=True, bo=True,
                 ffn_b=True, pos_embd=True),
    "starcoder": dict(LLAMA_LAYOUT, fused_qkv=True, gate=False, norm_b=True, qkv_b=True,
                      bo=True, ffn_b=True, pos_embd=True),
    "bloom": dict(LLAMA_LAYOUT, fused_qkv=True, gate=False, norm_b=True, qkv_b=True, bo=True,
                  ffn_b=True, embd_norm=True),
    "mpt": dict(LLAMA_LAYOUT, fused_qkv=True, gate=False),
    "jais": dict(LLAMA_LAYOUT, fused_qkv=True, norm_b=True, qkv_b=True, bo=True, ffn_b=True,
                 gate_b=True),
    # the other LayerNorm families: Nemotron's no-gate MLP; OLMo without any
    # norm tensor (`norms`); Orion's gated FFN under LayerNorms with biases;
    # CodeShell's gpt2-style layer; Falcon's and GPT-J's one shared input
    # norm (GPT-J with separate q/k/v and an output.bias)
    "nemotron": dict(LLAMA_LAYOUT, gate=False, norm_b=True),
    "olmo": dict(LLAMA_LAYOUT, norms=False),
    "orion": dict(LLAMA_LAYOUT, norm_b=True),
    "codeshell": dict(LLAMA_LAYOUT, fused_qkv=True, gate=False, norm_b=True, qkv_b=True,
                      bo=True, ffn_b=True),
    "falcon": dict(LLAMA_LAYOUT, fused_qkv=True, gate=False, ffn_norm=False, norm_b=True),
    "gptj": dict(LLAMA_LAYOUT, gate=False, ffn_norm=False, norm_b=True, ffn_b=True, out_b=True),
}


def write_tiny_gguf_pair(tmp_path, layer_type, out_type, emb_type, draft_type, seed=0,
                         target_metadata: dict | None = None, out_scale: float = 0.05,
                         n_kv_heads: int | None = None, rope_factors=None,
                         tied: bool = False, arch: str = "llama", head_dim: int | None = None,
                         n_layers: int | None = None, n_heads: int | None = None,
                         rope_dim: int | None = None, n_pos: int = 160,
                         extra: dict | None = None, moe: dict | None = None,
                         pos_type=None):
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
    (the head is token_embd, in `emb_type` at `out_scale`). `arch` "qwen2",
    "qwen3", "gemma" or "gemma2" writes the target under that architecture
    with its optional tensors (qwen2: q/k/v biases; qwen3: per-head q/k
    norms [Dh]; gemma2: the post-attention and post-FFN norms; gemma: none),
    the q/k rows as they come (NEOX: no permutation to invert); an arch of
    `LN_LAYOUTS` (phi2, starcoder2, stablelm, gptneox, command-r) writes its
    tensors as llama.cpp names them: the norms' biases, q/k/v biases or a
    fused `attn_qkv`, `attn_output.bias`, the FFN without a gate and with
    biases, no `ffn_norm`, `output.bias`, each as the layout says, and
    `layer_norm_epsilon` 1e-5 (the position families of `LN_LAYOUTS` also
    `position_embd.weight` [n_pos, D], f32 or `pos_type`, `token_embd_norm` and an
    `ffn_gate.bias`, each as the layout says; refact is written with the
    llama layout); `head_dim`, `n_heads`, `n_layers` and
    `rope_dim` (partial rotary) set the target's (the draft keeps the tiny
    llama's); the other LayerNorm families of `LN_LAYOUTS` likewise (olmo:
    no norm tensor at all), and `extra` adds F32 tensors (name -> array) to
    the target. `moe` (a dict: n_expert, n_used, n_ff_exp, type, shexp: the
    shared expert's width or 0) gives the target's layers experts in place of the dense
    FFN, as llama.cpp names them: an F32 router `ffn_gate_inp` [E, D], the
    stacks `ffn_{gate,up}_exps` [E, F, D] and `ffn_down_exps` [E, D, F] in
    `type`, and with `shexp` the shared expert `ffn_{gate,up,down}_shexp`
    with its F32 gate `ffn_gate_inp_shexp` [1, D]. Returns (target path,
    draft path)."""
    from eagle_tpu.gguf.writer import GGUFWriter
    from eagle_tpu.tools.train_draft import _base_metadata

    dcfg, _ = tiny_cfgs()
    if n_kv_heads is not None:
        dcfg = dataclasses.replace(dcfg, n_kv_heads=n_kv_heads)
    hd = head_dim or dcfg.head_dim
    jcfg = dataclasses.replace(dcfg, head_dim=hd, rope_dim=rope_dim or hd,
                               n_layers=n_layers or dcfg.n_layers,
                               n_heads=n_heads or dcfg.n_heads)
    rng = np.random.default_rng(seed)
    d, f, v = jcfg.n_embd, jcfg.n_ff, jcfg.vocab_size

    def qmat(w, name, n, k, qtype, scale=0.05):
        if has_encoder(qtype):
            w.add_tensor(name, (rng.standard_normal((n, k)) * scale).astype(np.float32),
                         ggml_type=qtype)
        else:
            w.add_tensor(name, random_blocks(rng, qtype, n, k), ggml_type=qtype,
                         raw_shape=(n, k))

    def norm():
        return rng.uniform(0.8, 1.2, d).astype(np.float32)

    def bias(n):
        return (rng.standard_normal(n) * 0.5).astype(np.float32)

    ln = LN_LAYOUTS.get(arch)

    def experts(w, i):
        n_exp, f_exp, etype = moe["n_expert"], moe["n_ff_exp"], moe["type"]
        w.add_tensor(f"blk.{i}.ffn_gate_inp.weight",
                     (rng.standard_normal((n_exp, d)) * 0.05).astype(np.float32))
        for name, shape in (("ffn_gate_exps", (n_exp, f_exp, d)),
                            ("ffn_up_exps", (n_exp, f_exp, d)),
                            ("ffn_down_exps", (n_exp, d, f_exp))):
            w.add_tensor(f"blk.{i}.{name}.weight",
                         (rng.standard_normal(shape) * 0.05).astype(np.float32), ggml_type=etype)
        if moe["shexp"]:
            fs = moe["shexp"]
            for name, (n, k) in (("ffn_gate_shexp", (fs, d)), ("ffn_up_shexp", (fs, d)),
                                 ("ffn_down_shexp", (d, fs))):
                qmat(w, f"blk.{i}.{name}.weight", n, k, etype)
            w.add_tensor(f"blk.{i}.ffn_gate_inp_shexp.weight",
                         (rng.standard_normal((1, d)) * 0.1).astype(np.float32))

    def layer(w, i, qtype, cfg, attn_norm=True, arch="llama"):
        nq, nkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        lay = LN_LAYOUTS.get(arch, LLAMA_LAYOUT)
        mats = [("attn_output", (d, nq)), ("ffn_up", (f, d)), ("ffn_down", (d, f))]
        if lay["fused_qkv"]:
            mats.insert(0, ("attn_qkv", (nq + 2 * nkv, d)))
        else:
            mats[:0] = [("attn_q", (nq, d)), ("attn_k", (nkv, d)), ("attn_v", (nkv, d))]
        if lay["gate"]:
            mats.insert(-2, ("ffn_gate", (f, d)))
        if moe is not None and attn_norm:  # the target's experts replace its FFN
            mats = [m for m in mats if not m[0].startswith("ffn_")]
            experts(w, i)
        if attn_norm and lay["norms"]:
            w.add_tensor(f"blk.{i}.attn_norm.weight", norm())
            if lay["norm_b"]:
                w.add_tensor(f"blk.{i}.attn_norm.bias", bias(d) * 0.2)
        for name, (n, k) in mats:
            qmat(w, f"blk.{i}.{name}.weight", n, k, qtype)
        if lay["ffn_norm"] and lay["norms"]:
            w.add_tensor(f"blk.{i}.ffn_norm.weight", norm())
            if lay["norm_b"]:
                w.add_tensor(f"blk.{i}.ffn_norm.bias", bias(d) * 0.2)
        if lay["qkv_b"] and lay["fused_qkv"]:
            w.add_tensor(f"blk.{i}.attn_qkv.bias", bias(nq + 2 * nkv))
        elif lay["qkv_b"] or arch in ("qwen2", "qwen2moe"):
            for name, n in (("attn_q", nq), ("attn_k", nkv), ("attn_v", nkv)):
                w.add_tensor(f"blk.{i}.{name}.bias", bias(n))
        if lay["bo"]:
            w.add_tensor(f"blk.{i}.attn_output.bias", bias(d) * 0.1)
        if lay["ffn_b"]:
            w.add_tensor(f"blk.{i}.ffn_up.bias", bias(f) * 0.2)
            w.add_tensor(f"blk.{i}.ffn_down.bias", bias(d) * 0.1)
        if lay["gate_b"]:
            w.add_tensor(f"blk.{i}.ffn_gate.bias", bias(f) * 0.2)
        if arch == "qwen3":
            for name in ("attn_q_norm", "attn_k_norm"):
                w.add_tensor(f"blk.{i}.{name}.weight",
                             rng.uniform(0.5, 1.5, cfg.head_dim).astype(np.float32))
        elif arch == "gemma2":
            for name in ("attn_post_norm", "ffn_post_norm"):
                w.add_tensor(f"blk.{i}.{name}.weight", norm())

    target = tmp_path / "target.gguf"
    w = GGUFWriter(target)
    md = _base_metadata(jcfg, arch)
    if ln is not None:
        md[f"{arch}.attention.layer_norm_epsilon"] = 1e-5
    if moe is not None:
        md.update({f"{arch}.expert_count": moe["n_expert"],
                   f"{arch}.expert_used_count": moe["n_used"]})
        if arch == "qwen2moe":
            md[f"{arch}.expert_feed_forward_length"] = moe["n_ff_exp"]
    for k, val in {**md, **(target_metadata or {})}.items():
        w.add(k, val)
    qmat(w, "token_embd.weight", v, d, emb_type, out_scale if tied else 0.5)
    if ln is not None and ln["pos_embd"]:
        w.add_tensor("position_embd.weight",
                     (rng.standard_normal((n_pos, d)) * 0.3).astype(np.float32),
                     ggml_type=pos_type)
    if ln is not None and ln["embd_norm"]:
        w.add_tensor("token_embd_norm.weight", norm())
        w.add_tensor("token_embd_norm.bias", bias(d) * 0.2)
    for i in range(jcfg.n_layers):
        layer(w, i, layer_type, jcfg, arch=arch)
    if ln is None or ln["norms"]:
        w.add_tensor("output_norm.weight", norm())
    if ln is not None and ln["norm_b"]:
        w.add_tensor("output_norm.bias", bias(d) * 0.2)
    if rope_factors is not None:
        w.add_tensor("rope_freqs.weight", np.asarray(rope_factors, np.float32))
    for name, arr in (extra or {}).items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    if not tied:
        qmat(w, "output.weight", v, d, out_type, out_scale)
    if ln is not None and ln["out_b"]:
        w.add_tensor("output.bias", bias(v))
    w.write()

    draft = tmp_path / "draft.gguf"
    w = GGUFWriter(draft)
    dcfg = dataclasses.replace(dcfg, n_layers=1)
    for k, val in _base_metadata(dcfg, "eagle").items():
        w.add(k, val)
    qmat(w, "token_embd.weight", v, d, draft_type, 0.5)
    qmat(w, "fc.weight", d, 2 * d, draft_type)
    w.add_tensor("fc.bias", (rng.standard_normal(d) * 0.01).astype(np.float32))
    layer(w, 0, draft_type, dcfg, attn_norm=False)
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



QWEN_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
#: chat templates the server's detection reads as "chatml" and "gemma"
CHATML_TEMPLATE = ("{% for message in messages %}{{'<|im_start|>' + message['role'] + '\\n' + "
                   "message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}")
GEMMA_TEMPLATE = ("{% for message in messages %}{{ '<start_of_turn>' + message['role'] + '\\n' "
                  "+ message['content'] | trim + '<end_of_turn>\\n' }}{% endfor %}")


@functools.lru_cache(maxsize=None)
def qwen_vocab() -> dict:
    """A Qwen2-style byte-level BPE vocabulary of 512 pieces as GGUF
    metadata: merges learned from `llama3_corpus()`, then QWEN_SPECIALS
    (control), pre "qwen2", no BOS added, EOS <|im_end|>, CHATML_TEMPLATE."""
    pieces, merges = learn_merges(llama3_corpus(), 512 - len(QWEN_SPECIALS))
    tokens = pieces + list(QWEN_SPECIALS)
    ids = {t: i for i, t in enumerate(tokens)}
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "qwen2",
            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.token_type": np.asarray(
                [1] * len(pieces) + [3] * len(QWEN_SPECIALS), np.int32),
            "tokenizer.ggml.bos_token_id": ids["<|endoftext|>"],
            "tokenizer.ggml.eos_token_id": ids["<|im_end|>"],
            "tokenizer.ggml.add_bos_token": False,
            "tokenizer.chat_template": CHATML_TEMPLATE}


#: the tiny families: write_tiny_gguf_pair's arguments and the target's metadata
FAMILIES = {
    # Qwen2.5: qkv biases, rope base 1e6, GQA 4:1
    "qwen2": dict(kw=dict(n_kv_heads=1), md={"qwen2.rope.freq_base": 1e6}),
    # Qwen3: per-head q/k norms, head_dim 128 decoupled from n_embd / n_heads = 64
    "qwen3": dict(kw=dict(head_dim=128), md={"qwen3.rope.freq_base": 1e6}),
    # Gemma-2: 4 layers, a window of 8 on layers 0 and 2, softcaps small enough
    # to move the logits, query_pre_attn_scalar 96 over head_dim 64, tied
    "gemma2": dict(kw=dict(n_layers=4, tied=True, out_scale=0.1),
                   md={"gemma2.attn_logit_softcapping": 1.0,
                       "gemma2.final_logit_softcapping": 2.0,
                       "gemma2.attention.sliding_window": 8,
                       "gemma2.attention.query_pre_attn_scalar": 96}),
    # Gemma (Gemma-7B's head width): 2 query heads over 1 KV head of 256 on a
    # width of 256 (the query is twice n_embd), GELU, the sqrt(n_embd)
    # embedding scale, tied; no softcap, window or sandwich norm
    "gemma": dict(kw=dict(n_heads=2, n_kv_heads=1, head_dim=256, tied=True, out_scale=0.1),
                  md={}),
}


def tiny_family_pair(tmp_path, arch: str):
    """A tiny Q8_0 target of `arch` (FAMILIES) and an EAGLE draft: qwen2 and
    qwen3 with `qwen_vocab()` (BPE, pre "qwen2", chatml), gemma and gemma2
    with `spm_metadata(ENGINE_PROMPT)` and a gemma template."""
    from eagle_tpu.gguf.constants import GGMLType

    q8 = GGMLType.Q8_0
    fam = FAMILIES[arch]
    vocab = (qwen_vocab() if arch.startswith("qwen")
             else {**spm_metadata(ENGINE_PROMPT), "tokenizer.chat_template": GEMMA_TEMPLATE})
    return write_tiny_gguf_pair(tmp_path, q8, q8, q8, q8, seed=11, arch=arch,
                                target_metadata={**vocab, **fam["md"]}, **fam["kw"])


COMMAND_R_SPECIALS = ("<BOS_TOKEN>", "<|END_OF_TURN_TOKEN|>", "<|START_OF_TURN_TOKEN|>",
                      "<|USER_TOKEN|>", "<|CHATBOT_TOKEN|>", "<|SYSTEM_TOKEN|>")
#: a chat template string the server's detection reads as "command-r"
COMMAND_R_TEMPLATE = ("{{ bos_token }}{% for message in messages %}<|START_OF_TURN_TOKEN|>"
                      "{% if message['role'] == 'user' %}<|USER_TOKEN|>{% else %}"
                      "<|CHATBOT_TOKEN|>{% endif %}{{ message['content'] }}"
                      "<|END_OF_TURN_TOKEN|>{% endfor %}")
#: each LayerNorm family's pre-tokenizer (llama.cpp's names for its files)
LN_PRE = {"phi2": "phi-2", "starcoder2": "starcoder", "stablelm": "stablelm2",
          "gptneox": "gpt-2", "command-r": "command-r", "gpt2": "gpt-2",
          "starcoder": "starcoder", "bloom": "bloom", "mpt": "mpt", "refact": "refact",
          "jais": "jais", "olmo": "gpt-2", "gptj": "gpt-2", "codeshell": "codeshell",
          "falcon": "falcon"}


@functools.lru_cache(maxsize=None)
def _ln_pieces() -> tuple:
    return learn_merges(llama3_corpus(), 512 - 1 - len(COMMAND_R_SPECIALS))


def ln_vocab(arch: str) -> dict:
    """A byte-level BPE vocabulary of 512 pieces for a LayerNorm family's
    tiny file: merges learned from `llama3_corpus()`, then <|endoftext|>
    and COMMAND_R_SPECIALS (control), pre `LN_PRE[arch]`. command-r: BOS
    <BOS_TOKEN> added, EOS <|END_OF_TURN_TOKEN|>, COMMAND_R_TEMPLATE; the
    others: no BOS added, EOS <|endoftext|>, no template."""
    pieces, merges = _ln_pieces()
    specials = ["<|endoftext|>", *COMMAND_R_SPECIALS]
    tokens = list(pieces) + specials
    ids = {t: i for i, t in enumerate(tokens)}
    md = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": LN_PRE[arch],
          "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": list(merges),
          "tokenizer.ggml.token_type": np.asarray([1] * len(pieces) + [3] * len(specials),
                                                  np.int32)}
    if arch == "command-r":
        md.update({"tokenizer.ggml.bos_token_id": ids["<BOS_TOKEN>"],
                   "tokenizer.ggml.eos_token_id": ids["<|END_OF_TURN_TOKEN|>"],
                   "tokenizer.ggml.add_bos_token": True,
                   "tokenizer.chat_template": COMMAND_R_TEMPLATE})
    else:
        md.update({"tokenizer.ggml.bos_token_id": ids["<|endoftext|>"],
                   "tokenizer.ggml.eos_token_id": ids["<|endoftext|>"],
                   "tokenizer.ggml.add_bos_token": False})
    return md


#: the tiny LayerNorm families: (arch, write_tiny_gguf_pair's arguments, the
#: target's metadata). "gptneox-seq" is gptneox with the sequential residual.
LN_FAMILIES = {
    # Phi-2: 4 heads of 80 (Phi-2's width: the plain attention) over n_embd
    # 256, 32 of 80 features rotary, one shared LayerNorm, parallel
    "phi2": ("phi2", dict(n_heads=4, n_kv_heads=4, head_dim=80, rope_dim=32), {}),
    # StarCoder2: GQA 4:2, rope base 1e6, full rotary, sequential
    "starcoder2": ("starcoder2", dict(), {"starcoder2.rope.freq_base": 1e6}),
    # StableLM-2: a gated SiLU FFN with its own LayerNorm, 16 of 64 rotary
    "stablelm": ("stablelm", dict(n_kv_heads=4, rope_dim=16), {}),
    # GPT-NeoX / Pythia: a fused attn_qkv, 16 of 64 rotary, parallel with its
    # own FFN norm, or sequential
    "gptneox": ("gptneox", dict(n_kv_heads=4, rope_dim=16),
                {"gptneox.use_parallel_residual": True}),
    "gptneox-seq": ("gptneox", dict(n_kv_heads=4, rope_dim=16),
                    {"gptneox.use_parallel_residual": False}),
    # Command-R: LayerNorm without biases, parallel from one norm, the
    # adjacent-pair rope rows, a logit scale, a tied head
    "command-r": ("command-r", dict(tied=True, out_scale=0.1),
                  {"command-r.logit_scale": 0.25}),
}


def tiny_layernorm_pair(tmp_path, name: str):
    """A tiny Q8_0 target of `LN_FAMILIES[name]` (2 layers, width 256) with
    `ln_vocab(arch)`, and an EAGLE draft."""
    from eagle_tpu.gguf.constants import GGMLType

    q8 = GGMLType.Q8_0
    arch, kw, md = LN_FAMILIES[name]
    return write_tiny_gguf_pair(tmp_path, q8, q8, q8, q8, seed=19, arch=arch,
                                target_metadata={**ln_vocab(arch), **md}, **kw)


#: the tiny position families (no rotary): (arch, write_tiny_gguf_pair's
#: arguments, the target's metadata); 4 heads of 64 over n_embd 256
POS_FAMILIES = {
    # GPT-2: learned positions, LayerNorm with biases, a fused attn_qkv with
    # its bias, a no-gate GELU MLP with biases, a tied head
    "gpt2": ("gpt2", dict(n_kv_heads=4, tied=True, out_scale=0.1), {}),
    # StarCoder: the same layers with multi-query attention (one KV head)
    # and an output.weight
    "starcoder": ("starcoder", dict(n_kv_heads=1), {}),
    # BLOOM: ALiBi, the embedding LayerNorm, biases everywhere, tied
    "bloom": ("bloom", dict(n_kv_heads=4, tied=True, out_scale=0.1), {}),
    # MPT: ALiBi, LayerNorm without biases, no bias anywhere, tied
    "mpt": ("mpt", dict(n_kv_heads=4, tied=True, out_scale=0.1), {}),
    # Refact: ALiBi, RMSNorm, multi-query attention, a gated SiLU FFN
    "refact": ("refact", dict(n_kv_heads=1), {}),
    # JAIS: ALiBi, a gated SiLU FFN with gate / up / down biases, the
    # 1 / head_dim score scale and an embedding scale
    "jais": ("jais", dict(n_kv_heads=4), {"jais.embedding_scale": 1.5}),
}


def tiny_position_pair(tmp_path, name: str, n_pos: int = 160):
    """A tiny Q8_0 target of `POS_FAMILIES[name]` (2 layers, width 256,
    learned positions [n_pos, 256] where the family has them) with
    `ln_vocab(arch)`, and an EAGLE draft."""
    from eagle_tpu.gguf.constants import GGMLType

    q8 = GGMLType.Q8_0
    arch, kw, md = POS_FAMILIES[name]
    return write_tiny_gguf_pair(tmp_path, q8, q8, q8, q8, seed=23, arch=arch,
                                target_metadata={**ln_vocab(arch), **md}, n_pos=n_pos, **kw)


#: the other LayerNorm families (ROADMAP queue 1, item 8's last LayerNorm
#: archs): (arch, write_tiny_gguf_pair's arguments, the target's metadata,
#: the vocabulary: "spm" or a BPE pre-tokenizer of `LN_PRE`)
LN_FAMILIES2 = {
    # Nemotron / Minitron: LayerNorm with biases, a no-gate squared-ReLU MLP,
    # 32 of 64 features rotary (NEOX rows), a query (6 heads of 64) wider
    # than the model (256) over 2 KV heads
    "nemotron": ("nemotron", dict(n_heads=6, n_kv_heads=2, rope_dim=32), {}, "spm"),
    # OLMo: no norm tensor (non-parametric LayerNorms), q/k/v clipped to
    # +-0.6 (binding at these weights), the adjacent-pair rope rows, a gated
    # SiLU FFN
    "olmo": ("olmo", dict(n_kv_heads=4), {"olmo.attention.clamp_kqv": 0.6}, "bpe"),
    # Orion: a gated SiLU FFN under LayerNorms with biases, interleaved rows
    "orion": ("orion", dict(n_kv_heads=4), {}, "spm"),
    # CodeShell: a fused attn_qkv with its bias over GQA 4:2, a no-gate GELU
    # MLP with biases, attn_output.bias
    "codeshell": ("codeshell", dict(n_kv_heads=2), {}, "bpe"),
    # Falcon-7B: one shared LayerNorm (with its bias) feeding attention and a
    # no-bias GELU MLP in parallel, multi-query attention, a fused attn_qkv
    "falcon": ("falcon", dict(n_kv_heads=1), {}, "bpe"),
    # GPT-J: the parallel block, separate q/k/v, 64 of 256 features rotary
    # (2 heads of 256: a query twice the model's width), FFN biases and an
    # lm_head bias
    "gptj": ("gptj", dict(n_heads=2, n_kv_heads=2, head_dim=256, rope_dim=64), {}, "bpe"),
}


def tiny_lnfamily_pair(tmp_path, name: str, extra: dict | None = None):
    """A tiny Q8_0 target of `LN_FAMILIES2[name]` (2 layers, width 256)
    with an SPM vocabulary (`spm_metadata(ENGINE_PROMPT)`) or `ln_vocab(arch)`,
    and an EAGLE draft. `extra` adds F32 tensors to the target (name ->
    array)."""
    from eagle_tpu.gguf.constants import GGMLType

    q8 = GGMLType.Q8_0
    arch, kw, md, vocab = LN_FAMILIES2[name]
    vocab_md = spm_metadata(ENGINE_PROMPT) if vocab == "spm" else ln_vocab(arch)
    return write_tiny_gguf_pair(tmp_path, q8, q8, q8, q8, seed=29, arch=arch,
                                target_metadata={**vocab_md, **md}, extra=extra, **kw)

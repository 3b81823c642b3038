"""The port's SPM tokenizer (eagle_tpu_torch/tokenizer/) against the reference
(eagle_tpu/tokenizer/spm.py): `encode` ids, `decode` text and `piece`
identical

- on the handcrafted vocab of tests/test_tokenizer.py;
- on a seeded random vocab of ~2,000 pieces (words and fragments with and
  without the '▁' space, prefix-closed so that merges reach long pieces,
  plus user-defined specials);
- on a tiny GGUF carrying that vocab, written by the port's writer and read
  by both packages' readers and factories;

over a seeded set of texts: spaces (leading, repeated, trailing), unicode
(byte fallback for pieces the vocab lacks), special tokens inside text, with
and without BOS/EOS and special parsing. Plain Python: no device."""

import numpy as np
import pytest

from eagle_tpu.gguf.constants import TokenType as JaxTokenType
from eagle_tpu.gguf.reader import GGUFReader as JaxReader
from eagle_tpu.tokenizer.bpe import tokenizer_from_gguf_metadata as jax_factory
from eagle_tpu.tokenizer.spm import SPMTokenizer as JaxSPM
from eagle_tpu_torch.gguf import GGUFReader, GGUFWriter
from eagle_tpu_torch.gguf.constants import TokenType
from eagle_tpu_torch.tokenizer import SPMTokenizer, tokenizer_from_gguf_metadata

SPACE = "▁"
LETTERS = "abcdefghijklmnopqrstuvwxyz"


def handcrafted():
    """tests/test_tokenizer.py's vocab: specials, 256 byte tokens, 8 pieces."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    ttypes = [2, 3, 3] + [6] * 256
    tokens += ["▁", "a", "b", "c", "ab", "▁a", "▁ab", "bc"]
    scores = [0.0] * 259 + [-1.0, -2.0, -3.0, -4.0, -5.0, -6.0, -7.0, -8.0]
    ttypes += [1] * 8
    return tokens, scores, ttypes


def random_vocab(seed: int = 0, n: int = 2000):
    """Specials, the 256 byte tokens, every letter with and without '▁', then
    seeded words and fragments with all their prefixes, two user-defined
    specials; scores descend with the order (random ties between pairs)."""
    rng = np.random.default_rng(seed)
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    ttypes = [2, 3, 3] + [6] * 256
    pieces = [SPACE] + list(LETTERS) + [SPACE + c for c in LETTERS] + list("éü,.")
    seen = set(pieces)
    while len(tokens) + len(pieces) < n - 2:
        word = "".join(rng.choice(list(LETTERS), size=int(rng.integers(2, 9))))
        if rng.random() < 0.6:
            word = SPACE + word
        for i in range(2, len(word) + 1):
            if word[:i] not in seen:
                seen.add(word[:i])
                pieces.append(word[:i])
    pieces = pieces[: n - 2 - len(tokens)]
    tokens += pieces + ["<|user|>", "<|end|>"]
    ttypes += [1] * len(pieces) + [4, 4]
    scores = [0.0] * 259 + [-float(i // 2) for i in range(len(pieces))] + [0.0, 0.0]
    return tokens, scores, ttypes


def texts(tokens, seed: int = 1, n: int = 60):
    """Seeded texts: vocab words joined by one or more spaces, leading and
    trailing spaces, unicode the vocab lacks (byte fallback), specials."""
    rng = np.random.default_rng(seed)
    words = [t.replace(SPACE, "") for t in tokens[259:] if t.replace(SPACE, "").isalpha()]
    extra = ["日本語", "naïve", "😀", "x\ty", "\n", "Ωmega", "</s>", "<s>", "<|user|>",
             "<|end|>", "<0x41>", "▁", "ab", "abc"]
    out = ["", " ", "  ", "a", " a", "a ", "ab", "abc", "aZ", "a</s>b", "  ab  bc "]
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 12))):
            pool = extra if rng.random() < 0.2 else words
            parts.append(pool[int(rng.integers(len(pool)))])
            parts.append(" " * int(rng.integers(0, 3)))
        out.append(("" if rng.random() < 0.7 else " ") + "".join(parts))
    return out


def both(tokens, scores, ttypes, **kw):
    return (SPMTokenizer(tokens=tokens, scores=scores, token_types=ttypes, **kw),
            JaxSPM(tokens=tokens, scores=scores, token_types=ttypes, **kw))


def assert_same(port, ref, text_set):
    for text in text_set:
        for kw in ({}, {"add_bos": False}, {"add_eos": True}, {"parse_special": False}):
            ids = port.encode(text, **kw)
            assert ids == ref.encode(text, **kw), (text, kw)
            for skip in (False, True):
                assert port.decode(ids, skip_special=skip) == ref.decode(ids, skip_special=skip)
    for tid in range(len(port.tokens)):
        assert port.piece(tid) == ref.piece(tid), tid


def test_token_types_match_reference():
    assert {t.name: int(t) for t in TokenType} == {t.name: int(t) for t in JaxTokenType}


@pytest.mark.parametrize("kw", [{}, {"add_space_prefix": False}, {"add_bos": False},
                                {"add_eos": True}])
def test_handcrafted_vocab_matches_reference(kw):
    tokens, scores, ttypes = handcrafted()
    port, ref = both(tokens, scores, ttypes, **kw)
    assert_same(port, ref, texts(tokens, seed=3, n=20) + ["abcabc", "bca", "cab ab"])


@pytest.mark.parametrize("seed", [0, 1])
def test_random_vocab_matches_reference(seed):
    tokens, scores, ttypes = random_vocab(seed)
    port, ref = both(tokens, scores, ttypes)
    assert_same(port, ref, texts(tokens, seed=seed + 10))
    # the vocab really merges: long pieces come out whole
    long = [t for t in tokens if len(t) >= 6 and t.startswith(SPACE) and t[1:].isalpha()]
    ids = port.encode(" ".join(t[1:] for t in long[:20]), add_bos=False)
    assert len(ids) < sum(len(t) for t in long[:20]) // 2


def test_gguf_vocab_read_by_both_packages(tmp_path):
    tokens, scores, ttypes = random_vocab(2)
    path = tmp_path / "vocab.gguf"
    w = GGUFWriter(path)
    w.add("general.architecture", "llama")
    w.add("tokenizer.ggml.model", "llama")
    w.add("tokenizer.ggml.tokens", tokens)
    w.add("tokenizer.ggml.scores", np.asarray(scores, np.float32))
    w.add("tokenizer.ggml.token_type", np.asarray(ttypes, np.int32))
    w.add("tokenizer.ggml.bos_token_id", 1)
    w.add("tokenizer.ggml.eos_token_id", 2)
    w.add("tokenizer.ggml.add_bos_token", True)
    w.write()
    with GGUFReader(path) as r:
        port = tokenizer_from_gguf_metadata(r.metadata)
    ref = jax_factory(JaxReader(path).metadata)
    assert isinstance(port, SPMTokenizer) and port.tokens == tokens
    assert (port.bos_id, port.eos_id, port.add_bos) == (ref.bos_id, ref.eos_id, ref.add_bos)
    assert_same(port, ref, texts(tokens, seed=5, n=30))


def test_factory_refuses_other_tokenizers():
    md = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": ["a"]}
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        tokenizer_from_gguf_metadata(md)

"""The port's byte-level BPE tokenizer (eagle_tpu_torch/tokenizer/bpe.py)
against the reference (eagle_tpu/tokenizer/bpe.py), which splits text with
the `regex` package:

- the committed Unicode classes (`tokenizer/unicode_classes.py`) equal the
  ranges `regex` gives here, and the port imports without `regex`;
- the pattern lists and their aliases are the reference's, and every one of
  its 37 names splits seeded random text (mixed scripts, digits,
  contractions in either case, CR / LF / tabs, U+001C-U+001F, U+0085,
  U+017F, U+212A, combining marks, CJK, astral code points) exactly as the
  reference's `regex_split`;
- every BPE case of tests/test_tokenizer.py and tests/test_tokenizer_families.py
  on the port;
- `encode` ids, `decode` text and `piece` equal on a byte-level vocabulary
  with consistent merges and Llama-3 specials, for every pre-tokenizer.

Regenerate the classes with `python tests/test_torch_bpe.py` (needs
`regex`); the port reads only the written module."""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import pytest

CLASS_NAMES = ("L", "N", "P", "S", "M", "Lu", "Ll", "Lt", "Lm", "Lo", "s")
CLASSES_PY = (pathlib.Path(__file__).resolve().parents[1] / "eagle_tpu_torch" / "tokenizer"
              / "unicode_classes.py")


def regex_class_ranges() -> dict[str, list[tuple[int, int]]]:
    """{class: [(lo, hi), ...]} of `regex`'s \\p{X} (and its \\s as "s")
    over every code point, surrogates included."""
    import regex

    every = "".join(chr(c) for c in range(0x110000))
    return {name: [(m.start(), m.end() - 1)
                   for m in regex.finditer(r"\s+" if name == "s" else r"\p{%s}+" % name, every)]
            for name in CLASS_NAMES}


def render_classes(ranges: dict) -> str:
    """The text of tokenizer/unicode_classes.py for `ranges`."""
    import regex

    lines = [
        'r"""Code-point ranges of the Unicode classes the BPE pre-tokenizer patterns',
        "use: `\\p{L}`, `\\p{N}`, `\\p{P}`, `\\p{S}`, `\\p{M}`, `\\p{Lu}`, `\\p{Ll}`, `\\p{Lt}`,",
        "`\\p{Lm}`, `\\p{Lo}` and `\\s` (\"s\") as the `regex` package "
        f"{regex.__version__} matches them.",
        "",
        "Generated by `python tests/test_torch_bpe.py`; do not edit. Each class is",
        'a string of hex ranges "lo-hi" or single code points "c", ascending."""',
        "",
        "from __future__ import annotations",
        "",
        f'REGEX_VERSION = "{regex.__version__}"',
        "",
        "_RANGES = {",
    ]
    for name in CLASS_NAMES:
        words = [f"{lo:x}" if lo == hi else f"{lo:x}-{hi:x}" for lo, hi in ranges[name]]
        lines.append(f'    "{name}": (')
        cur = ""
        for w in words:
            if cur and len(cur) + len(w) > 84:
                lines.append(f'        "{cur.rstrip()} "')
                cur = ""
            cur += w + " "
        lines.append(f'        "{cur.rstrip()}"),')
    lines += [
        "}",
        "",
        "",
        "def class_ranges(name: str) -> list[tuple[int, int]]:",
        '    """[(lo, hi), ...] of class `name` (a key of _RANGES)."""',
        "    out = []",
        "    for word in _RANGES[name].split():",
        '        lo, _, hi = word.partition("-")',
        "        out.append((int(lo, 16), int(hi or lo, 16)))",
        "    return out",
        "",
    ]
    return "\n".join(lines)


if __name__ == "__main__":
    CLASSES_PY.write_text(render_classes(regex_class_ranges()))
    sys.exit(0)


import regex  # noqa: E402

from eagle_tpu.gguf.constants import Keys, TokenType  # noqa: E402
from eagle_tpu.tokenizer import bpe as ref  # noqa: E402
from eagle_tpu_torch.tokenizer import bpe, tokenizer_from_gguf_metadata  # noqa: E402
from eagle_tpu_torch.tokenizer.unicode_classes import class_ranges  # noqa: E402
from torch_port_util import LLAMA3_SPECIALS, learn_merges  # noqa: E402

#: code points the text generator mixes in, beside ASCII
SPECIAL_CPS = [0x1C, 0x1D, 0x1E, 0x1F, 0x85, 0xA0, 0x17F, 0x212A, 0x301, 0x308, 0x200B,
               0x2028, 0x3000, 0xFEFF, 0x1F600, 0x20000, 0xE9, 0xDF, 0x130, 0x1C5, 0x2160,
               0x663, 0xBE6, 0x1D7CE, 0x10400]
WORDS = ["hello", "World", "it's", "THEY'RE", "we'Ve", "I'M", "you'll", "he'D", "don'T",
         "naïve", "Straße", "ǅemal", "Ⅻ", "日本語", "中文", "한국어", "Ελληνικά", "русский",
         "عربى", "हिन्दी", "ſtop", "Kelvin", "é", "ẍy", "😀👍", "𝟎𝟏", "123456",
         "3.14", "$100", "<|x|>", "a/b", "(paren)", "«q»", "—", "…", "IMGIMGABZ",
         "<sentinel:12>", "𐐀𐐨"]
SEPS = [" ", "  ", "\n", "\r\n", "\t", " \n ", "\r", "\x1c", "\x1f", "　", " ",
        "", "", "", "\n\n", "   "]


def random_texts(seed: int, n: int) -> list[str]:
    """Seeded texts: words from WORDS, random code points (ASCII, the
    special list, any code point below U+30000 but surrogates) and
    separators, 1-30 items each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 30))):
            r = rng.random()
            if r < 0.4:
                parts.append(str(rng.choice(WORDS)))
            elif r < 0.55:
                parts.append(chr(int(rng.integers(0x20, 0x7F))))
            elif r < 0.7:
                parts.append(chr(int(rng.choice(SPECIAL_CPS))))
            elif r < 0.8:
                c = int(rng.integers(0, 0x30000))
                parts.append(chr(c if not 0xD800 <= c < 0xE000 else 0x41))
            else:
                parts.append(str(rng.choice(SEPS)))
        out.append("".join(parts))
    return out


def test_classes_equal_regex_ranges():
    want = regex_class_ranges()
    for name in CLASS_NAMES:
        assert class_ranges(name) == want[name], name


def test_classes_module_is_the_generator_output():
    assert CLASSES_PY.read_text() == render_classes(regex_class_ranges())


def test_classes_differ_from_the_standard_library():
    """Why the port carries the data: the host's tables disagree with
    `regex` (a Unicode version apart, and `re`'s \\s takes U+001C-U+001F)."""
    import re

    s = set()
    for lo, hi in class_ranges("s"):
        s.update(range(lo, hi + 1))
    std = {c for c in range(0x110000) if re.match(r"\s", chr(c))}
    assert {0x1C, 0x1D, 0x1E, 0x1F} <= std - s


def test_port_imports_without_regex():
    code = ("import sys; sys.modules['regex'] = None; "
            "from eagle_tpu_torch.tokenizer import bpe; "
            "print(bpe.regex_split('Hello 123', [bpe.compile_pattern(bpe._LLAMA3)]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "['Hello', ' ', '123']"


def test_pattern_lists_are_the_reference():
    assert bpe._PRE_REGEX_LISTS == ref._PRE_REGEX_LISTS
    assert len(bpe._PRE_REGEX_LISTS) == 37


#: lists whose second pattern holds a descending range ("Ὗ-ώ", U+1F5F-U+03CE):
#: the reference's `regex` refuses to compile it, and so does the port's `re`
REFUSED_LISTS = ("deepseek-llm", "deepseek-r1-qwen")


@pytest.mark.parametrize("name", sorted(ref._PRE_REGEX_LISTS))
def test_split_equals_reference(name):
    pats = ref._PRE_REGEX_LISTS[name]
    if name in REFUSED_LISTS:
        with pytest.raises(regex.error, match="bad character range"):
            [regex.compile(p) for p in pats]
        with pytest.raises(bpe.re.error, match="bad character range"):
            [bpe.compile_pattern(p) for p in pats]
        return
    want_res = [regex.compile(p) for p in pats]
    got_res = [bpe.compile_pattern(p) for p in pats]
    for text in random_texts(sum(map(ord, name)), 300):
        assert bpe.regex_split(text, got_res) == ref.regex_split(text, want_res), (name, text)


def test_split_llama3_many_texts():
    """The Llama-3 pattern over 3,000 more texts."""
    want_res = [regex.compile(ref._LLAMA3)]
    got_res = [bpe.compile_pattern(ref._LLAMA3)]
    for text in random_texts(19, 3000):
        assert bpe.regex_split(text, got_res) == ref.regex_split(text, want_res), text


# ---------------------------------------------------------------------------
# tests/test_tokenizer.py's BPE cases, on both packages


def make_bpe(mod, **kw):
    tokens = ["<unk>", "<s>", "</s>"]
    ttypes = [TokenType.UNKNOWN, TokenType.CONTROL, TokenType.CONTROL]
    tokens += [mod._BYTE_ENC[b] for b in range(256)]
    ttypes += [TokenType.NORMAL] * 256
    merged = ["he", "ll", "llo", "hello", "Ġw", "Ġwo", "or", "ld", "Ġworld"]
    tokens += merged
    ttypes += [TokenType.NORMAL] * len(merged)
    merges = ["h e", "l l", "ll o", "he llo", "Ġ w", "Ġw o", "o r", "l d", "Ġwo r l d",
              "Ġwo rld"]
    return mod.BPETokenizer(tokens=tokens, merges=merges, token_types=ttypes, **kw)


@pytest.mark.parametrize("mod", [ref, bpe], ids=["reference", "port"])
def test_bpe_cases_of_the_reference(mod):
    tok = make_bpe(mod)
    assert [tok.tokens[i] for i in tok.encode("hello", add_bos=False)] == ["hello"]
    pieces = [tok.tokens[i] for i in tok.encode("hello world", add_bos=False)]
    assert pieces[0] == "hello" and pieces[1].startswith("Ġ")
    for text in ["hello world", "héllo", "日本語 text", "a\nb", "  spaces  "]:
        assert tok.decode(tok.encode(text, add_bos=False)) == text
    ids = tok.encode("hello</s>", add_bos=False)
    assert ids[-1] == 2
    assert tok.decode(ids, skip_special=True) == "hello"


@pytest.mark.parametrize("factory", [ref.tokenizer_from_gguf_metadata,
                                     tokenizer_from_gguf_metadata],
                         ids=["reference", "port"])
def test_tokenizer_factory_case(factory):
    t = make_bpe(ref)
    md = {Keys.Tokenizer.MODEL: "gpt2", Keys.Tokenizer.LIST: t.tokens,
          Keys.Tokenizer.MERGES: t.merges,
          Keys.Tokenizer.TOKEN_TYPE: np.asarray(t.token_types, np.int32)}
    tok = factory(md)
    assert tok.encode("hello", add_bos=False)
    want = ref.tokenizer_from_gguf_metadata(md)
    for text in ("hello", "hello world</s>", "中a", "abc ab 中"):
        assert tok.encode(text) == want.encode(text)
        assert tok.decode(tok.encode(text)) == text


@pytest.mark.parametrize("mod", [ref, bpe], ids=["reference", "port"])
def test_families_cases_of_the_reference(mod):
    """tests/test_tokenizer_families.py's BPE cases (the port's split takes
    its own compiled patterns)."""
    comp = regex.compile if mod is ref else bpe.compile_pattern
    assert mod.regex_split("ab12\ncd3", [comp("[\r\n]"), comp(r"\p{N}+")]) == [
        "ab", "12", "\n", "cd", "3"]
    pats = [comp(p) for p in mod._PRE_REGEX_LISTS["starcoder"]]
    assert mod.regex_split("x 123", pats) == ["x", " ", "1", "2", "3"]
    for name in ("llama-bpe", "dbrx", "stablelm2", "command-r", "olmo",
                 "deepseek-r1-qwen", "tekken", "falcon"):
        assert name in mod._PRE_REGEX_LISTS


# ---------------------------------------------------------------------------
# a byte-level vocabulary with consistent merges


@pytest.fixture(scope="module")
def vocab():
    """(tokens, merges, token_types): 1,000 pieces learned from seeded text
    (`learn_merges`), then Llama-3's specials."""
    pieces, merges = learn_merges(" ".join(random_texts(0, 200)), 1000)
    return (pieces + list(LLAMA3_SPECIALS), merges,
            [TokenType.NORMAL] * len(pieces) + [TokenType.CONTROL] * len(LLAMA3_SPECIALS))


@pytest.mark.parametrize("pre", ["llama-bpe", "gpt2", "qwen2", "deepseek-v3", "tekken",
                                 "falcon", "chameleon", "deepseek-coder", "poro-chat",
                                 "starcoder", "viking", "no-such-pre"])
def test_encode_decode_equal_reference(vocab, pre):
    tokens, merges, ttypes = vocab
    kw = dict(tokens=tokens, merges=merges, token_types=[int(t) for t in ttypes], pre=pre,
              bos_id=len(tokens) - 5, eos_id=len(tokens) - 1, add_bos=True)
    want, got = ref.BPETokenizer(**kw), bpe.BPETokenizer(**kw)
    texts = random_texts(7, 200) + [
        "<|start_header_id|>user<|end_header_id|>\n\nHi<|eot_id|>", "", " ", "日本"]
    for text in texts:
        for special in (True, False):
            ids = got.encode(text, parse_special=special)
            assert ids == want.encode(text, parse_special=special), (pre, text)
            for skip in (True, False):
                assert got.decode(ids, skip_special=skip) == want.decode(ids, skip_special=skip)
        assert got.encode(text, add_bos=False, add_eos=True) == want.encode(
            text, add_bos=False, add_eos=True)
    for i in range(len(tokens)):
        assert got.piece(i) == want.piece(i)


def test_gguf_metadata_factory(vocab):
    """Both factories on the same GGUF metadata (Llama-3's keys)."""
    tokens, merges, ttypes = vocab
    md = {Keys.Tokenizer.MODEL: "gpt2", Keys.Tokenizer.PRE: "llama-bpe",
          Keys.Tokenizer.LIST: tokens, Keys.Tokenizer.MERGES: merges,
          Keys.Tokenizer.TOKEN_TYPE: np.asarray(ttypes, np.int32),
          Keys.Tokenizer.BOS_ID: len(tokens) - 5, Keys.Tokenizer.EOS_ID: len(tokens) - 1,
          Keys.Tokenizer.ADD_BOS: True}
    got, want = tokenizer_from_gguf_metadata(md), ref.tokenizer_from_gguf_metadata(md)
    assert isinstance(got, bpe.BPETokenizer)
    assert got.pre == "llama-bpe" and got.add_bos and got.bos_id == len(tokens) - 5
    for text in random_texts(11, 50):
        assert got.encode(text) == want.encode(text)
    md[Keys.Tokenizer.MODEL] = "bpe"
    assert isinstance(tokenizer_from_gguf_metadata(md), bpe.BPETokenizer)


@pytest.mark.parametrize("model", ["bert", "wpm", "t5", "ugm", "rwkv", "nope"])
def test_other_tokenizer_models_refused(model):
    with pytest.raises(NotImplementedError, match="queue 1, item 8|not ported"):
        tokenizer_from_gguf_metadata({Keys.Tokenizer.MODEL: model, Keys.Tokenizer.LIST: ["a"]})

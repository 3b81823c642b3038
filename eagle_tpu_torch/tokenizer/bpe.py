"""Byte-level BPE tokenizer from GGUF vocab metadata, GPT-2 / Llama-3 style
(port of eagle_tpu/tokenizer/bpe.py, whole: `_PRE_REGEX_LISTS` with its
aliases, `regex_split`, `BPETokenizer`; the same ids and text).

The reference splits text with the `regex` package's `\\p{...}` classes. The
port carries those classes as data (`unicode_classes.py`, the code-point
ranges `regex` gives) and translates every pattern to the standard `re`, so
its pieces depend neither on `regex` nor on the host's Unicode tables
(`unicodedata` and `re`'s own `\\s` differ from `regex` on thousands of code
points)."""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..gguf.constants import Keys, TokenType
from .unicode_classes import class_ranges


# gpt2-style printable byte mapping
def _bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENC = _bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}

# pretokenizer pattern LISTS keyed by tokenizer.ggml.pre, in the `regex`
# package's syntax, as the reference holds them (llama.cpp's tokenizer_pre
# dispatch, src/llama-vocab.cpp:279-400). Multiple patterns apply
# SEQUENTIALLY: each one further splits the not-yet-matched spans.
_GPT2 = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
_LLAMA3 = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
_QWEN2 = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""

_PRE_REGEX_LISTS: dict[str, list[str]] = {
    "default": [_GPT2],
    "gpt-2": [_GPT2],
    "llama3": [_LLAMA3],
    "qwen2": [_QWEN2],
    "falcon": [
        r"""[\p{P}\$\+<=>\^~\|`]+""",
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)""",
        r"""[0-9][0-9][0-9]""",
    ],
    "starcoder": [
        r"""\p{N}""",
        _GPT2,
    ],
    "deepseek-llm": [
        "[\r\n]",
        r"""\s?[A-Za-zµÀ-ÖØ-öø-ƺƼ-ƿǄ-ʓʕ-ʯͰ-ͳͶͷͻ-ͽͿΆΈ-ΊΌΎ-ΡΣ-ϵϷ-ҁҊ-ԯԱ-ՖႠ-ჅᎠ-Ᏽᏸ-ᏽᲐ-ᲺᲽ-Ჿᴀ-ᴫᵫ-ᵷᵹ-ᶚḀ-ἕἘ-Ἕἠ-ὅὈ-Ὅὐ-ὗὙὛὝὟ-ώᾀ-ᾴᾶ-ᾼιῂ-ῄῆ-ῌῐ-ΐῖ-Ίῠ-Ῥῲ-ῴῶ-ῼℂℇℊ-ℓℕℙ-ℝℤΩℨK-ℭℯ-ℴℹℼ-ℿⅅ-ⅉⅎↃↄⰀ-ⱻⱾ-ⳤⳫ-ⳮⳲⳳꙀ-ꙭꚀ-ꚛꜢ-ꝯꝱ-ꞇꞋ-ꞎꭰ-ꮿﬀ-ﬆﬓ-ﬗＡ-Ｚａ-ｚ𐐀-𐑏𐒰-𐓓𐓘-𐓻𐲀-𐲲𐳀-𐳲𑢠-𑣟𞤀-𞥃]+""",
        r"""\s?[!-/:-~！-／：-～‘-‟　-。]+""",
        r"""\s+$""",
        r"""[一-龥ࠀ-一가-퟿]+""",
        r"""\p{N}+""",
    ],
    "deepseek-coder": [
        "[\r\n]",
        r"""\s?\p{L}+""",
        r"""\s?\p{P}+""",
        r"""[一-龥ࠀ-一가-퟿]+""",
        r"""\p{N}""",
    ],
    "deepseek-v3": [
        r"""\p{N}{1,3}""",
        r"""[一-龥぀-ゟ゠-ヿ]+""",
        "[!\"#$%&'()*+,\\-./:;<=>?@\\[\\\\\\]^_`{|}~][A-Za-z]+|[^\r\n\\p{L}\\p{P}\\p{S}]?[\\p{L}\\p{M}]+| ?[\\p{P}\\p{S}]+[\r\n]*|\\s*[\r\n]+|\\s+(?!\\S)|\\s+",
    ],
    "poro-chat": [r""" ?[^(\s|.,!?…。，、।۔،)]+"""],
    "viking": [r""" ?[^(\s|.,!?…。，、।۔،)]+""", r"""\p{N}"""],
    "chatglm-bpe": [_LLAMA3],
    "tekken": [
        r"""[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+""",
    ],
    "chameleon": [
        r"""<sentinel:[0-9]+>""",
        r"""(IMGIMG)((A|B|C|D|E|F|G|H|I){1,4})Z""",
        "([\\t\\n]|    |  )",
        r"""\p{N}""",
        _GPT2,
    ],
}
# aliases sharing another family's pattern list (llama-vocab.cpp case labels)
for _alias, _canon in {
    "llama-v3": "llama3", "llama-bpe": "llama3", "dbrx": "llama3",
    "smaug-bpe": "llama3", "falcon3": "llama3", "pixtral": "llama3",
    "stablelm2": "qwen2", "refact": "starcoder", "command-r": "starcoder",
    "smollm": "starcoder", "codeshell": "starcoder", "exaone": "starcoder",
    "minerva-7b": "starcoder", "megrez": "qwen2",
    "gpt2": "gpt-2", "mpt": "gpt-2", "olmo": "gpt-2", "jais": "gpt-2",
    "phi-2": "gpt-2", "bloom": "poro-chat", "gpt3-finnish": "poro-chat",
    "gigachat": "deepseek-v3", "deepseek-r1-qwen": "deepseek-llm",
}.items():
    _PRE_REGEX_LISTS[_alias] = _PRE_REGEX_LISTS[_canon]


def _escape(c: int) -> str:
    return f"\\x{c:02x}" if c < 0x100 else f"\\u{c:04x}" if c < 0x10000 else f"\\U{c:08x}"


_BODIES: dict[str, str] = {}


def _body(name: str) -> str:
    """The inside of a `re` character class matching `regex`'s \\p{name}
    (or its \\s for "s")."""
    if name not in _BODIES:
        _BODIES[name] = "".join(_escape(lo) if lo == hi else f"{_escape(lo)}-{_escape(hi)}"
                                for lo, hi in class_ranges(name))
    return _BODIES[name]


def to_std_re(pattern: str) -> str:
    """A `regex`-syntax pattern as a standard-`re` one: each \\p{X} and \\s
    becomes the code-point ranges of the `regex` class, inside brackets as
    they are and outside as a class of their own; \\S (used outside
    brackets only) becomes the negated \\s class. Everything else is
    copied."""
    out: list[str] = []
    in_class = False
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt == "p" and pattern.startswith("{", i + 2):
                end = pattern.index("}", i + 3)
                body = _body(pattern[i + 3:end])
                out.append(body if in_class else f"[{body}]")
                i = end + 1
                continue
            if nxt in "sS":
                neg = "^" if nxt == "S" else ""
                out.append(_body("s") if in_class else f"[{neg}{_body('s')}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


_COMPILED: dict[str, re.Pattern] = {}


def compile_pattern(pattern: str) -> re.Pattern:
    """`to_std_re(pattern)` compiled, once per pattern."""
    if pattern not in _COMPILED:
        _COMPILED[pattern] = re.compile(to_std_re(pattern))
    return _COMPILED[pattern]


def regex_split(text: str, patterns: list) -> list[str]:
    """Sequential regex splitting (unicode.cpp unicode_regex_split): each
    pattern splits the still-unmatched spans; matched spans become atomic
    pieces. Returns all pieces in order (matched and residual)."""
    segments: list[tuple[str, bool]] = [(text, False)]
    for pat in patterns:
        out: list[tuple[str, bool]] = []
        for seg, final in segments:
            if final or not seg:
                if seg:
                    out.append((seg, final))
                continue
            last = 0
            for m in pat.finditer(seg):
                if m.start() > last:
                    out.append((seg[last:m.start()], False))
                if m.group():
                    out.append((m.group(), True))
                last = m.end()
            if last < len(seg):
                out.append((seg[last:], False))
        segments = out
    return [s for s, _ in segments if s]


@dataclass
class BPETokenizer:
    tokens: list[str]
    merges: list[str]
    token_types: list[int]
    pre: str = "default"
    bos_id: int = 1
    eos_id: int = 2
    add_bos: bool = False
    add_eos: bool = False

    def __post_init__(self):
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        self.ranks = {}
        for i, m in enumerate(self.merges):
            a, b = m.split(" ", 1)
            self.ranks[(a, b)] = i
        patterns = _PRE_REGEX_LISTS.get(self.pre, _PRE_REGEX_LISTS["default"])
        self._pre_res = [compile_pattern(p) for p in patterns]
        self.special_tokens = {
            t: i
            for i, (t, tt) in enumerate(zip(self.tokens, self.token_types))
            if tt in (TokenType.CONTROL, TokenType.USER_DEFINED)
        }

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # ------------------------------------------------------------------

    def _bpe_word(self, word: str) -> list[int]:
        parts = list(word)
        while len(parts) > 1:
            best, best_rank = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts[best : best + 2] = [parts[best] + parts[best + 1]]
        out = []
        for p in parts:
            tid = self.token_to_id.get(p)
            if tid is not None:
                out.append(tid)
            else:  # decompose to single mapped bytes
                for ch in p:
                    out.append(self.token_to_id.get(ch, 0))
        return out

    def encode(self, text: str, add_bos: bool | None = None, add_eos: bool | None = None,
               parse_special: bool = True) -> list[int]:
        add_bos = self.add_bos if add_bos is None else add_bos
        add_eos = self.add_eos if add_eos is None else add_eos
        fragments: list[tuple[bool, str]] = [(False, text)]
        if parse_special and self.special_tokens:
            for sp in sorted(self.special_tokens, key=len, reverse=True):
                new_frags = []
                for is_tok, frag in fragments:
                    if is_tok:
                        new_frags.append((is_tok, frag))
                        continue
                    parts = frag.split(sp)
                    for pi, part in enumerate(parts):
                        if pi > 0:
                            new_frags.append((True, sp))
                        if part:
                            new_frags.append((False, part))
                fragments = new_frags
        ids: list[int] = []
        if add_bos and self.bos_id >= 0:
            ids.append(self.bos_id)
        for is_tok, frag in fragments:
            if is_tok:
                ids.append(self.special_tokens[frag])
                continue
            for piece in regex_split(frag, self._pre_res):
                mapped = "".join(_BYTE_ENC[b] for b in piece.encode("utf-8"))
                ids.extend(self._bpe_word(mapped))
        if add_eos and self.eos_id >= 0:
            ids.append(self.eos_id)
        return ids

    def _bytes(self, piece: str) -> bytearray:
        buf = bytearray()
        for ch in piece:
            b = _BYTE_DEC.get(ch)
            if b is None:
                buf.extend(ch.encode("utf-8"))
            else:
                buf.append(b)
        return buf

    def decode(self, ids, skip_special: bool = False) -> str:
        buf = bytearray()
        for tid in ids:
            if not (0 <= tid < len(self.tokens)):
                continue
            tt = self.token_types[tid]
            piece = self.tokens[tid]
            if tt == TokenType.CONTROL:
                if not skip_special:
                    buf.extend(piece.encode("utf-8"))
                continue
            buf.extend(self._bytes(piece))
        return buf.decode("utf-8", errors="replace")

    def piece(self, tid: int) -> str:
        """Raw text a single token contributes (for grammar matching): ""
        for control and unknown tokens and for a piece that is not whole
        UTF-8 on its own."""
        tt = self.token_types[tid]
        if tt in (TokenType.CONTROL, TokenType.UNKNOWN):
            return ""
        try:
            return self._bytes(self.tokens[tid]).decode("utf-8")
        except UnicodeDecodeError:
            return ""

    # ------------------------------------------------------------------

    @staticmethod
    def from_gguf_metadata(md: dict) -> "BPETokenizer":
        tokens = list(md[Keys.Tokenizer.LIST])
        return BPETokenizer(
            tokens=tokens,
            merges=list(md.get(Keys.Tokenizer.MERGES, [])),
            token_types=[int(t) for t in md.get(Keys.Tokenizer.TOKEN_TYPE, [1] * len(tokens))],
            pre=str(md.get(Keys.Tokenizer.PRE, "default")),
            bos_id=int(md.get(Keys.Tokenizer.BOS_ID, 1)),
            eos_id=int(md.get(Keys.Tokenizer.EOS_ID, 2)),
            add_bos=bool(md.get(Keys.Tokenizer.ADD_BOS, False)),
            add_eos=bool(md.get(Keys.Tokenizer.ADD_EOS, False)),
        )

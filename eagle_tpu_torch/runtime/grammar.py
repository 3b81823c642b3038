"""GBNF grammar-constrained generation.

The port's own copy of eagle_tpu/runtime/grammar.py,
unchanged but for this note: pure Python, kept here because the port
imports nothing of the JAX package.

The functional equivalent of src/llama-grammar.cpp: parse GBNF (llama.cpp's
grammar dialect — rules, alternates, char classes, repetition), then run a
pushdown automaton over candidate token strings to mask disallowed tokens.
Grammar evaluation is host-side per token (as in the reference); the engine
exposes `allowed_mask(vocab_pieces)` for the sampler and `accept(piece)` to
advance. JSON-schema -> GBNF conversion lives in json_schema.py.

Grammar elements follow the reference's representation: each rule is a list of
alternates; an alternate is a list of elements; an element is CHAR/CHAR_RNG/
CHAR_NOT/CHAR_NOT_RNG/RULE_REF/END.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, auto


class ElType(Enum):
    CHAR = auto()  # literal codepoint (value)
    CHAR_ALT = auto()  # additional alternative codepoint attached to prev CHAR/RNG
    CHAR_RNG = auto()  # range upper bound attached to previous CHAR
    NOT_CHAR = auto()  # negated class start
    RULE_REF = auto()
    END = auto()


@dataclass(frozen=True)
class El:
    t: ElType
    v: int = 0


class GrammarParseError(ValueError):
    pass


class _Parser:
    """GBNF text -> {rule_name: [[El, ...], ...]} (list of alternates)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: dict[str, list[list[El]]] = {}
        self._anon = 0
        self._ref_names: list[str] = []
        self._ref_map: dict[str, int] = {}

    # -- lexing helpers -------------------------------------------------

    def _ws(self, newlines=True):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":  # comment to EOL
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            else:
                break

    def _peek(self):
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name(self) -> str:
        start = self.pos
        # note: `"" in "-_"` is True (substring test) — compare explicitly
        while self._peek().isalnum() or self._peek() in ("-", "_"):
            self.pos += 1
        if start == self.pos:
            raise GrammarParseError(f"expected name at {self.pos}")
        return self.text[start : self.pos]

    def _escape(self) -> int:
        c = self.text[self.pos]
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = self.text[self.pos]
        self.pos += 1
        if e == "x":
            v = int(self.text[self.pos : self.pos + 2], 16)
            self.pos += 2
            return v
        if e == "u":
            v = int(self.text[self.pos : self.pos + 4], 16)
            self.pos += 4
            return v
        if e == "U":
            v = int(self.text[self.pos : self.pos + 8], 16)
            self.pos += 8
            return v
        return {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91, "]": 93}.get(e, ord(e))

    # -- parsing --------------------------------------------------------

    def parse(self):
        self._ws()
        while self.pos < len(self.text):
            name = self._name()
            self._ws()
            if self.text[self.pos : self.pos + 3] != "::=":
                raise GrammarParseError(f"expected ::= after {name}")
            self.pos += 3
            self._ws()
            self.rules[name] = self._alternates(name)
            self._ws()
        if "root" not in self.rules:
            raise GrammarParseError("grammar missing 'root' rule")
        return self.rules

    def _alternates(self, base: str) -> list[list[El]]:
        alts = [self._sequence(base)]
        self._ws(newlines=False)
        while self._peek() == "|":
            self.pos += 1
            self._ws()
            alts.append(self._sequence(base))
            self._ws(newlines=False)
        return alts

    def _new_rule(self, base: str, alts: list[list[El]]) -> str:
        self._anon += 1
        name = f"{base}_{self._anon}"
        self.rules[name] = alts
        return name

    def _sequence(self, base: str) -> list[El]:
        seq: list[El] = []
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c == '"':
                self.pos += 1
                while self._peek() != '"':
                    seq.append(El(ElType.CHAR, self._escape()))
                self.pos += 1
            elif c == "[":
                self.pos += 1
                neg = self._peek() == "^"
                if neg:
                    self.pos += 1
                cls: list[El] = []
                first = True
                while self._peek() != "]":
                    v = self._escape()
                    t = (
                        (ElType.NOT_CHAR if neg else ElType.CHAR)
                        if first
                        else ElType.CHAR_ALT
                    )
                    cls.append(El(t, v))
                    first = False
                    if self._peek() == "-" and self.text[self.pos + 1] != "]":
                        self.pos += 1
                        cls.append(El(ElType.CHAR_RNG, self._escape()))
                self.pos += 1
                seq.extend(cls)
            elif c == "(":
                self.pos += 1
                self._ws()
                alts = self._alternates(base)
                self._ws()
                if self._peek() != ")":
                    raise GrammarParseError("expected )")
                self.pos += 1
                seq.append(El(ElType.RULE_REF, self._ref_id(self._new_rule(base, alts))))
            elif c.isalnum() or c in ("-", "_"):
                seq.append(El(ElType.RULE_REF, self._ref_id(self._name())))
            else:
                break
            # repetition suffix applies to the LAST unit in seq
            self._rep_suffix(seq, base)
            self._ws(newlines=False)
            if self._peek() in ("|", ")", "") or self.text[self.pos : self.pos + 1] in "\r\n":
                # a newline followed by `name ::=` ends the rule; check lookahead
                save = self.pos
                self._ws()
                look = self.pos
                try:
                    self._name()
                    self._ws()
                    is_next_rule = self.text[self.pos : self.pos + 3] == "::="
                except GrammarParseError:
                    is_next_rule = False
                self.pos = save
                if self._peek() in ("|", ")", "") or is_next_rule:
                    break
        return seq

    def _last_unit(self, seq: list[El]) -> list[El]:
        """Pop the last logical unit (a char class or a single element)."""
        if not seq:
            raise GrammarParseError("repetition with no preceding element")
        if seq[-1].t in (ElType.CHAR, ElType.NOT_CHAR, ElType.RULE_REF):
            return [seq.pop()]
        # char class: walk back through ALT/RNG to its head
        i = len(seq) - 1
        while i >= 0 and seq[i].t in (ElType.CHAR_ALT, ElType.CHAR_RNG):
            i -= 1
        unit = seq[i:]
        del seq[i:]
        return unit

    def _rep_suffix(self, seq: list[El], base: str):
        c = self._peek()
        if c == "*":
            self.pos += 1
            unit = self._last_unit(seq)
            name = self._new_rule(base, [[]])
            self.rules[name] = [unit + [El(ElType.RULE_REF, self._ref_id(name))], []]
            seq.append(El(ElType.RULE_REF, self._ref_id(name)))
        elif c == "+":
            self.pos += 1
            unit = self._last_unit(seq)
            name = self._new_rule(base, [[]])
            self.rules[name] = [unit + [El(ElType.RULE_REF, self._ref_id(name))], []]
            seq.extend(unit + [El(ElType.RULE_REF, self._ref_id(name))])
        elif c == "?":
            self.pos += 1
            unit = self._last_unit(seq)
            name = self._new_rule(base, [unit, []])
            seq.append(El(ElType.RULE_REF, self._ref_id(name)))
        elif c == "{":
            # {m,n} bounded repetition
            end = self.text.index("}", self.pos)
            spec = self.text[self.pos + 1 : end]
            self.pos = end + 1
            unit = self._last_unit(seq)
            if "," in spec:
                lo_s, hi_s = spec.split(",", 1)
                lo = int(lo_s) if lo_s else 0
                hi = int(hi_s) if hi_s else -1
            else:
                lo = hi = int(spec)
            for _ in range(lo):
                seq.extend(unit)
            if hi < 0:
                name = self._new_rule(base, [[]])
                self.rules[name] = [unit + [El(ElType.RULE_REF, self._ref_id(name))], []]
                seq.append(El(ElType.RULE_REF, self._ref_id(name)))
            else:
                for _ in range(hi - lo):
                    name = self._new_rule(base, [unit, []])
                    seq.append(El(ElType.RULE_REF, self._ref_id(name)))

    _ref_ids: dict[str, int]

    def _ref_id(self, name: str) -> int:
        if name not in self._ref_map:
            self._ref_map[name] = len(self._ref_names)
            self._ref_names.append(name)
        return self._ref_map[name]


def _class_matches(seq: list[El], i: int, cp: int) -> tuple[bool, int]:
    """Match codepoint against the element (class) starting at i; returns
    (matched, next_index_after_class)."""
    head = seq[i]
    neg = head.t == ElType.NOT_CHAR
    found = False
    last = head.v
    if cp == head.v:
        found = True
    j = i + 1
    while j < len(seq) and seq[j].t in (ElType.CHAR_ALT, ElType.CHAR_RNG):
        e = seq[j]
        if e.t == ElType.CHAR_ALT:
            if cp == e.v:
                found = True
            last = e.v
        else:  # range upper bound for `last`
            if last <= cp <= e.v:
                found = True
        j += 1
    return (found != neg), j


class TokenTrie:
    """Codepoint prefix trie over the vocabulary, built once per tokenizer.

    Per-step token masking walks this trie instead of testing every vocab
    piece independently: automaton advances are shared across all tokens with
    a common prefix and dead subtrees are pruned at their first rejected
    character. This is the production-speed equivalent of the reference's
    incremental candidate application (llama_grammar_apply_impl,
    src/llama-grammar.cpp:1120) — sublinear in vocab size, where the naive
    per-piece check is O(V * len * stacks) per token."""

    __slots__ = ("children", "tokens", "n_vocab")

    def __init__(self, pieces: list[str]):
        # nodes as parallel dicts: node id -> {cp: child_id}, node id -> [tok]
        self.children: list[dict[int, int]] = [{}]
        self.tokens: list[list[int]] = [[]]
        self.n_vocab = len(pieces)
        for tid, piece in enumerate(pieces):
            if not piece:
                continue
            node = 0
            for ch in piece:
                cp = ord(ch)
                nxt = self.children[node].get(cp)
                if nxt is None:
                    nxt = len(self.children)
                    self.children[node][cp] = nxt
                    self.children.append({})
                    self.tokens.append([])
                node = nxt
            self.tokens[node].append(tid)


class Grammar:
    """Pushdown automaton state over a parsed grammar (llama_grammar).

    `lazy` grammars (llama_grammar.h:118-121) start dormant: tokens are
    unconstrained until a trigger token or trigger word appears in the
    output, at which point the automaton activates and consumes the text
    from the trigger onward."""

    def __init__(self, gbnf: str, root: str = "root", *, lazy: bool = False,
                 trigger_tokens: list[int] | None = None,
                 trigger_words: list[str] | None = None):
        self.lazy = lazy
        self.awaiting_trigger = lazy
        self.trigger_tokens = set(trigger_tokens or [])
        self.trigger_words = list(trigger_words or [])
        self.trigger_buffer = ""
        self._init_rules(gbnf, root)

    def _init_rules(self, gbnf: str, root: str):
        p = _Parser(gbnf)
        rules = p.parse()
        self.rule_names = list(p._ref_names)
        self.rules_by_id: list[list[list[El]]] = []
        for name in self.rule_names:
            if name not in rules:
                raise GrammarParseError(f"undefined rule {name!r}")
            self.rules_by_id.append(rules[name])
        if root not in rules:
            raise GrammarParseError(f"no {root} rule")
        # stack entries: (rule_id, alt_idx, el_idx)
        root_id = p._ref_map.get(root)
        if root_id is None:
            root_id = len(self.rules_by_id)
            self.rule_names.append(root)
            self.rules_by_id.append(rules[root])
        self.stacks: list[tuple] = []
        for ai in range(len(self.rules_by_id[root_id])):
            self.stacks.extend(self._expand(((root_id, ai, 0),)))

    # ------------------------------------------------------------------

    def _expand(self, stack: tuple) -> list[tuple]:
        """Expand until top of stack is a char-consuming element (or empty)."""
        if not stack:
            return [stack]
        rid, ai, ei = stack[-1]
        seq = self.rules_by_id[rid][ai]
        if ei >= len(seq):  # rule finished -> pop and continue caller
            return self._expand(stack[:-1])
        el = seq[ei]
        if el.t == ElType.RULE_REF:
            rest = stack[:-1] + ((rid, ai, ei + 1),)
            out = []
            for sub_ai in range(len(self.rules_by_id[el.v])):
                out.extend(self._expand(rest + ((el.v, sub_ai, 0),)))
            return out
        return [stack]

    def _advance(self, stack: tuple, cp: int) -> list[tuple]:
        if not stack:
            return []
        rid, ai, ei = stack[-1]
        seq = self.rules_by_id[rid][ai]
        ok, nxt = _class_matches(seq, ei, cp)
        if not ok:
            return []
        return self._expand(stack[:-1] + ((rid, ai, nxt),))

    # ------------------------------------------------------------------

    def accepts_text(self, text: str, partial: bool = True) -> bool:
        stacks = self.stacks
        for ch in text:
            new = []
            seen = set()
            for st in stacks:
                for ns in self._advance(st, ord(ch)):
                    if ns not in seen:
                        seen.add(ns)
                        new.append(ns)
            stacks = new
            if not stacks:
                return False
        if partial:
            return True
        return any(len(s) == 0 for s in stacks)

    def accept_text(self, text: str):
        """Advance the live state (llama_grammar_accept)."""
        for ch in text:
            new = []
            seen = set()
            for st in self.stacks:
                for ns in self._advance(st, ord(ch)):
                    if ns not in seen:
                        seen.add(ns)
                        new.append(ns)
            if not new:
                raise ValueError(f"grammar rejected {ch!r}")
            self.stacks = new

    @property
    def can_end(self) -> bool:
        return any(len(s) == 0 for s in self.stacks)

    def allowed_mask(self, pieces: list[str]) -> list[bool]:
        """For each vocab piece, whether appending it keeps the grammar alive
        (llama_grammar_apply_impl). Naive per-piece reference path — use
        token_mask(TokenTrie) on real vocabularies."""
        if self.awaiting_trigger:
            return [True] * len(pieces)
        return [bool(p) and self.accepts_text(p) for p in pieces]

    def token_mask(self, trie: TokenTrie):
        """Boolean numpy mask [n_vocab] of tokens the grammar allows next.

        DFS over the vocab trie carrying the automaton stacks; each trie edge
        advances the stacks once for every token sharing that prefix, and a
        rejected edge prunes its whole subtree."""
        import numpy as np

        mask = np.zeros(trie.n_vocab, dtype=bool)
        if self.awaiting_trigger:
            mask[:] = True
            return mask
        children, tokens = trie.children, trie.tokens
        work = [(0, self.stacks)]
        while work:
            node, stacks = work.pop()
            for cp, child in children[node].items():
                new = []
                seen = set()
                for st in stacks:
                    for ns in self._advance(st, cp):
                        if ns not in seen:
                            seen.add(ns)
                            new.append(ns)
                if not new:
                    continue
                toks = tokens[child]
                if toks:
                    mask[toks] = True
                if children[child]:
                    work.append((child, new))
        return mask

    # -- lazy/trigger handling (llama_grammar.h:118-121) -----------------

    def accept_token(self, tok_id: int, piece: str):
        """Advance on a sampled token, handling lazy-trigger activation:
        trigger tokens activate immediately (the piece is consumed from its
        start); trigger words activate at their match position within the
        accumulated output."""
        if not self.awaiting_trigger:
            self.accept_text(piece)
            return
        if tok_id in self.trigger_tokens:
            self.awaiting_trigger = False
            self.trigger_buffer = ""
            self.accept_text(piece)
            return
        self.trigger_buffer += piece
        for word in self.trigger_words:
            idx = self.trigger_buffer.find(word)
            if idx >= 0:
                self.awaiting_trigger = False
                text = self.trigger_buffer[idx:]
                self.trigger_buffer = ""
                self.accept_text(text)
                return

"""SentencePiece-style tokenizer built from GGUF vocab metadata (port of
eagle_tpu/tokenizer/spm.py, whole; plain Python, the same ids and text).

Implements the same algorithm as the reference's llm_tokenizer_spm
(src/llama-vocab.cpp): greedy highest-score bigram merging over UTF-8
characters, with byte-fallback for unknown sequences, '▁' space encoding, and
optional leading-space prefix. No sentencepiece dependency — the GGUF carries
the whole vocab (tokens, scores, types)."""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from ..gguf.constants import Keys, TokenType

SPM_SPACE = "▁"  # ▁


@dataclass
class SPMTokenizer:
    tokens: list[str]
    scores: list[float]
    token_types: list[int]
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 0
    pad_id: int = -1
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True

    def __post_init__(self):
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        self.byte_tokens = {}
        for i, (t, tt) in enumerate(zip(self.tokens, self.token_types)):
            if tt == TokenType.BYTE and len(t) == 6 and t.startswith("<0x"):
                self.byte_tokens[int(t[3:5], 16)] = i
        self.special_tokens = {
            t: i
            for i, (t, tt) in enumerate(zip(self.tokens, self.token_types))
            if tt in (TokenType.CONTROL, TokenType.USER_DEFINED)
        }

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # ------------------------------------------------------------------

    def _encode_fragment(self, text: str) -> list[int]:
        """Greedy bigram-merge tokenization of raw text (no specials)."""
        if not text:
            return []
        # initial symbols: utf-8 characters
        symbols: list[str] = list(text)
        n = len(symbols)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n

        def pair_entry(i):
            j = nxt[i]
            if j >= n:
                return None
            merged = symbols[i] + symbols[j]
            tid = self.token_to_id.get(merged)
            if tid is None:
                return None
            # max-heap by score; tie-break on left position (earliest first)
            return (-self.scores[tid], i, merged)

        heap = []
        for i in range(n - 1):
            e = pair_entry(i)
            if e:
                heapq.heappush(heap, e)

        while heap:
            negscore, i, merged = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j >= n or not alive[j] or symbols[i] + symbols[j] != merged:
                continue
            symbols[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < n:
                prev[nxt[i]] = i
            e = pair_entry(i)
            if e:
                heapq.heappush(heap, e)
            if prev[i] >= 0:
                e = pair_entry(prev[i])
                if e:
                    heapq.heappush(heap, e)

        out: list[int] = []
        i = 0
        while i < n:  # walk the linked list of surviving symbols
            sym = symbols[i]
            tid = self.token_to_id.get(sym)
            if tid is not None:
                out.append(tid)
            else:
                # byte fallback (src/llama-vocab.cpp resegment/unknown path)
                for b in sym.encode("utf-8"):
                    out.append(self.byte_tokens.get(b, self.unk_id))
            i = nxt[i]
        return out

    def encode(self, text: str, add_bos: bool | None = None, add_eos: bool | None = None, parse_special: bool = True) -> list[int]:
        add_bos = self.add_bos if add_bos is None else add_bos
        add_eos = self.add_eos if add_eos is None else add_eos

        # split out special tokens first (llama.cpp tokenizer_st_partition)
        fragments: list[tuple[bool, str]] = [(False, text)]
        if parse_special and self.special_tokens:
            for sp, sid in sorted(self.special_tokens.items(), key=lambda kv: -len(kv[0])):
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
        first_raw = True
        for is_tok, frag in fragments:
            if is_tok:
                ids.append(self.special_tokens[frag])
                continue
            raw = frag.replace(" ", SPM_SPACE)
            if first_raw and self.add_space_prefix:
                raw = SPM_SPACE + raw
            first_raw = False
            ids.extend(self._encode_fragment(raw))
        if add_eos and self.eos_id >= 0:
            ids.append(self.eos_id)
        return ids

    # ------------------------------------------------------------------

    def decode(self, ids, skip_special: bool = False) -> str:
        buf = bytearray()
        for tid in ids:
            tt = self.token_types[tid] if 0 <= tid < len(self.tokens) else TokenType.UNKNOWN
            if tt == TokenType.BYTE:
                buf.append(int(self.tokens[tid][3:5], 16))
            elif tt == TokenType.CONTROL:
                if not skip_special:
                    buf.extend(self.tokens[tid].encode("utf-8"))
            else:
                buf.extend(self.tokens[tid].replace(SPM_SPACE, " ").encode("utf-8"))
        text = buf.decode("utf-8", errors="replace")
        # llama.cpp strips the leading space added by add_space_prefix on decode
        if self.add_space_prefix and text.startswith(" "):
            text = text[1:]
        return text

    def piece(self, tid: int) -> str:
        """Raw text a single token contributes (for grammar matching)."""
        tt = self.token_types[tid]
        if tt == TokenType.BYTE:
            try:
                return bytes([int(self.tokens[tid][3:5], 16)]).decode("utf-8")
            except UnicodeDecodeError:
                return ""
        if tt in (TokenType.CONTROL, TokenType.UNKNOWN):
            return ""
        return self.tokens[tid].replace(SPM_SPACE, " ")

    # ------------------------------------------------------------------

    @staticmethod
    def from_gguf_metadata(md: dict) -> "SPMTokenizer":
        tokens = list(md[Keys.Tokenizer.LIST])
        scores = [float(s) for s in md.get(Keys.Tokenizer.SCORES, [0.0] * len(tokens))]
        ttypes = [int(t) for t in md.get(Keys.Tokenizer.TOKEN_TYPE, [1] * len(tokens))]
        return SPMTokenizer(
            tokens=tokens,
            scores=scores,
            token_types=ttypes,
            bos_id=int(md.get(Keys.Tokenizer.BOS_ID, 1)),
            eos_id=int(md.get(Keys.Tokenizer.EOS_ID, 2)),
            unk_id=int(md.get(Keys.Tokenizer.UNK_ID, 0)),
            pad_id=int(md.get(Keys.Tokenizer.PAD_ID, -1)),
            add_bos=bool(md.get(Keys.Tokenizer.ADD_BOS, True)),
            add_eos=bool(md.get(Keys.Tokenizer.ADD_EOS, False)),
            add_space_prefix=bool(md.get(Keys.Tokenizer.ADD_SPACE_PREFIX, True)),
        )

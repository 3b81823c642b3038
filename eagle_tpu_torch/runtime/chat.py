"""Interactive multi-turn chat with the cache kept across turns (port of
eagle_tpu/runtime/chat.py: `ChatSession`) — llama-cli's conversation mode
(examples/main/main.cpp's interactive loop; the incremental formatting is
common_chat_format_single, common/chat.cpp:289).

A turn runs as in the reference:
- the first turn renders the whole conversation with the chat template and
  feeds it;
- every later turn feeds only the template's diff for the new user message
  (`format_single`) at the cache's current position (`Generator._extend`),
  so the shared history is never computed again;
- the last sampled token of a turn (usually the template's closing EOS) is
  pending: sampled, not fed. The next turn's feed starts with it, which
  lines the cache's text up with what `format_single` assumes was rendered.

The reply decodes in `Generator._decode_chunk`s (graphed steps on the card).
A chunk that runs past EOS keeps only the rows up to it: the rest are
dropped by tag (`KVCache.rollback`). When a feed or a chunk would overflow
the cache, `_ensure_room` shifts the context in place (`Generator.
shift_context`), so the step graphs keep replaying. A sampled turn draws
from the generator's `CounterRNG`, seeded per turn by the reference's mix
of the seed and the cache position. A stateful sampler (penalties, DRY,
mirostat) runs on the generator's `SamplerState`, reset at each turn."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..server.chat_templates import apply_template, format_single
from .generate import Generator, pad_bucket
from .sampling import SamplerConfig, draw


@dataclasses.dataclass
class ChatSession:
    gen: Generator
    tokenizer: Any
    template: str | None = None  # an explicit family name; None: detect
    jinja_src: str | None = None  # the GGUF's tokenizer.chat_template
    use_jinja: bool = False
    system: str | None = None

    def __post_init__(self):
        self.messages: list[dict] = []
        if self.system:
            self.messages.append({"role": "system", "content": self.system})
        self.pos = 0  # tokens in the cache
        self.pending: int | None = None  # the last sampled token, not yet fed
        self.fed: list[int] = []  # every token id fed, in order
        self.keep = 0  # the context shift's header: the first turn's prompt

    def _ensure_room(self, needed: int) -> None:
        """Shift the context when the next feed or chunk would overflow the
        cache: main.cpp's conversation-mode eviction (keep the header, drop
        half of the rest, re-rope the survivors; main.cpp:452-460)."""
        s = self.gen.max_seq
        if needed + 1 >= s // 2:
            raise ValueError(f"turn of {needed} tokens cannot fit a {s} cache")
        while self.pos + needed + 1 >= s:
            keep = min(self.keep, s // 4)
            # never discard more rows than are occupied past the header
            n_discard = min((s - keep) // 2, self.pos - keep)
            if n_discard <= 0:
                raise ValueError(f"cannot free room for {needed} tokens: header keep={keep} "
                                 f"fills the {s} cache")
            self.gen.shift_context(keep, n_discard)
            self.pos -= n_discard
            del self.fed[keep:keep + n_discard]

    def _feed(self, ids: list[int]) -> torch.Tensor:
        """Extend the cache with `ids` at self.pos; returns the last row's
        logits [B, V]."""
        self._ensure_room(len(ids))
        n = len(ids)
        t = pad_bucket(n)
        padded = np.zeros((self.gen.batch, t), np.int32)
        padded[0, :n] = ids
        logits, _ = self.gen._extend(torch.from_numpy(padded).to(self.gen.device), self.pos,
                                     n, t, kv_limit=self.gen.kv_read_bucket(self.pos + t))
        self.fed += list(ids)
        self.pos += n
        return logits

    def turn_tokens(self, text: str) -> list[int]:
        """The token ids this user turn feeds (pending + the template diff)."""
        new_msg = {"role": "user", "content": text}
        if self.pos == 0:
            rendered = apply_template(self.messages + [new_msg], template=self.template,
                                      jinja_src=self.jinja_src, add_assistant=True,
                                      use_jinja=self.use_jinja)
            return self.tokenizer.encode(rendered)
        suffix = format_single(self.messages, new_msg, template=self.template,
                               jinja_src=self.jinja_src, add_assistant=True,
                               use_jinja=self.use_jinja)
        head = [self.pending] if self.pending is not None else []
        return head + self.tokenizer.encode(suffix, add_bos=False)

    def ask(
        self,
        text: str,
        max_new_tokens: int = 256,
        sampler: SamplerConfig | None = None,
        seed: int = 0,
        on_token: Callable[[int], None] | None = None,
        chunk: int = 32,
    ) -> str:
        """One user turn: feed the incremental prompt, decode the reply up
        to EOS, record both in the message history."""
        scfg = sampler or SamplerConfig(greedy=True)
        gen = self.gen
        ids = self.turn_tokens(text)
        self.pending = None
        self.messages.append({"role": "user", "content": text})
        first_turn = self.pos == 0
        logits = self._feed(ids)
        if first_turn:
            self.keep = self.pos  # the header survives context shifts
        self.last_prompt_len = self.pos  # the context before this decode
        self.last_out: list[int] = []  # every token sampled this turn

        gen.rng.reset(seed ^ (self.pos * 0x9E3779B1 & 0x7FFFFFFF))
        # a stateful sampler starts afresh each turn, the turn's prompt not
        # counted (the reference's `ask`, unlike its `generate`)
        first = draw(logits, scfg, gen.rng, gen.sampler_state(scfg))
        out = [int(first[0])]
        eos = self.tokenizer.eos_id
        content: list[int] = []
        done = out[0] == eos
        if not done:
            if on_token:
                on_token(out[0])
            content.append(out[0])
        tok = first
        while not done and len(out) < max_new_tokens:
            if self.pos + chunk + 1 >= gen.max_seq:
                self._ensure_room(chunk)
            steps = min(chunk, max_new_tokens - len(out))
            toks = gen._decode_chunk(tok, self.pos, scfg, steps,
                                     kv_limit=gen.kv_read_bucket(self.pos + steps))
            chunk_toks = toks[0].tolist()
            fed_in_chunk = steps  # `tok`, then the chunk's samples but its last
            for j, tk in enumerate(chunk_toks):
                out.append(int(tk))
                if tk == eos:
                    # the rows after EOS were fed ahead: only slots below
                    # pos + j + 1 hold the conversation
                    fed_in_chunk = j + 1
                    done = True
                    break
                if on_token:
                    on_token(int(tk))
                content.append(int(tk))
            self.pos += fed_in_chunk
            if done and fed_in_chunk < steps:  # drop the rows fed past EOS, by tag
                gen.kv.rollback(torch.full((gen.batch,), self.pos, dtype=torch.int32,
                                           device=gen.device))
            self.fed += [int(tok[0])] + chunk_toks[:fed_in_chunk - 1]
            tok = toks[:, -1]
        self.pending = out[-1]
        self.last_out = out
        reply = self.tokenizer.decode(content, skip_special=True)
        self.messages.append({"role": "assistant", "content": reply})
        return reply

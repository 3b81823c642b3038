"""Autoregressive generation, non-speculative (port of
eagle_tpu/runtime/generate.py: `pad_bucket`, `Generator` with `kv_read_bucket`,
`_prefill`, `_extend`, `_decode_chunk`, `generate` with `context_shift_keep`,
Self-Extend group attention (`grp_attn_n`), prompt-cache sessions and the
stateful samplers, and `generate_constrained`).

The reference runs each decode chunk as one compiled `lax.scan`. Here the
scan's carry (the token, its position and the chunk's tokens) lives in
static device buffers, and one step is an in-place body over them: on the
card it is one CUDA graph per attention-read bucket (`runtime/graphs.py`),
replayed once a step with no host sync inside the chunk; on the CPU, or
with `cuda_graphs=False`, the same body runs eagerly. The prompt, and a
feed at an offset on the live cache (`_extend`, what a chat turn runs),
run eagerly. Prompt lengths are bucketed to powers of two, as in the
reference, so the two take the same shapes.

A sampled step draws its Gumbel noise from the engine's `CounterRNG`
(seeded by `generate(..., seed=)`, the reference's `PRNGKey(seed)`), whose
counter the step advances on the device, so a replayed step draws anew and
a graphed run gives the eager run's tokens. The step's graph key holds the
sampler config its body bakes in. A stateful sampler (penalties, DRY,
mirostat) keeps its `SamplerState` in static tensors of the generator,
reset in place for each sequence and read and written by the step body
(the reference's scan carry); they are among the graph's inputs. As the
reference, `generate` counts the prompt into the penalties' window before
the first draw. A context shift (`kvcache.context_shift`) and a
Self-Extend step (`kvcache.self_extend_shift`) rewrite the cache in place,
so the step graphs replay across them. The step's cache slot and rope
position are separate carries: they differ under Self-Extend, where
positions are compressed and every token keeps its own slot.

`generate_constrained` walks a GBNF grammar (`runtime/grammar.py`) on the
host: each token's logits come to the host, where the grammar's mask and
the draw (the argmax, or numpy's `choice` over f64 probabilities as the
reference's) pick it; the forward of one token is a graphed step per read
bucket whose logits land in a static buffer.

The cache may be int8 (`kv_dtype=torch.int8`). A session file
(`runtime/state_io.py`, the reference's format) seeds the cache with the
longest cached prefix of the prompt, and only the rest is fed."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..models.config import ModelConfig
from ..models.llama import llama_forward
from ..ops.rope import rope_inv_freq
from .graphs import StepGraphs
from .kvcache import KVCache, causal_mask_from_tags, context_shift, self_extend_shift
from .sampling import (
    CounterRNG,
    SamplerConfig,
    SamplerState,
    draw,
    refuse_dropped_state,
    transform_logits,
)


def pad_bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class Generator:
    params: Any
    cfg: ModelConfig
    max_seq: int = 2048
    batch: int = 1
    kv_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    eos_id: int = 2
    device: Any = "cuda"
    cuda_graphs: bool = True  # replay each decode step as a CUDA graph on the card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # one spill slot: a feed's rows past the cache write there, tag -1
        self.kv = KVCache.create(
            self.cfg.n_layers, self.batch, self.max_seq, self.cfg.n_kv_heads,
            self.cfg.head_dim, dtype=self.kv_dtype, device=self.device, spill=1,
        )
        # the scan's carry: the token to decode, its rope position, its cache
        # slot, and the decoded token history (the step at slot s writes s)
        b, dev = self.batch, self.device
        self._tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        self._slot = torch.zeros((b,), dtype=torch.int32, device=dev)
        self._hist = torch.zeros((b, self.max_seq), dtype=torch.int32, device=dev)
        self.rng = CounterRNG(device=dev)
        self.sstate: SamplerState | None = None  # made at the first stateful sampler
        self._logits: torch.Tensor | None = None  # a constrained step's logits [B, V]
        self.graphs = StepGraphs(self.cuda_graphs and dev.type == "cuda")
        self.session_prefix_reused = 0  # the last generate's session prefix

    def kv_read_bucket(self, slot_end: int) -> int:
        """Attention-read bound for a chunk whose highest written cache slot
        is < slot_end: power-of-two buckets from 128."""
        return min(self.max_seq, pad_bucket(slot_end, 128))

    def _prefill(self, tokens: torch.Tensor, n_valid: torch.Tensor, t: int):
        """tokens [B, t] padded; n_valid [B] actual lengths. Returns
        (last_logits [B, V], hidden [B, D], kv); the cache fills in place."""
        b = tokens.shape[0]
        positions = torch.arange(t, dtype=torch.int32, device=self.device).repeat(b, 1)
        valid = positions < n_valid[:, None]
        kv = self.kv.with_tags(positions, positions, valid=valid)
        mask = causal_mask_from_tags(kv.slot_pos, positions)
        out = llama_forward(
            self.params, self.cfg, tokens, positions, kv, positions, mask,
            compute_dtype=self.compute_dtype, kv_limit=min(self.max_seq, max(t, 128)),
            causal_tags_prefill=True,  # the prefill flash kernel
        )
        last = (n_valid - 1).long()
        b_idx = torch.arange(b, device=self.device)
        return out.logits[b_idx, last], out.hidden[b_idx, last], out.kv

    def _extend(self, tokens: torch.Tensor, start: int, n_valid: int, t: int, kv_limit: int):
        """Prefill at an offset: feed `tokens` [B, t] (the first `n_valid` of
        each row real) at positions start..start+t-1 on top of the live
        cache (a chat turn's feed). Returns (last_logits [B, V], kv); the
        cache fills in place and keeps its data pointers. Rows past the
        cache, whose writes the reference's scatter drops, write the spill
        slot with tag -1."""
        if start < 0 or not 0 < n_valid <= t:
            raise ValueError(f"a feed of {n_valid} rows padded to {t} at {start}")
        b, s = tokens.shape[0], self.max_seq
        offs = torch.arange(t, dtype=torch.int32, device=self.device).repeat(b, 1)
        positions = start + offs
        slots = torch.where(positions < s, positions, s)
        kv = self.kv.with_tags(slots, positions, valid=(offs < n_valid) & (positions < s))
        mask = causal_mask_from_tags(kv.slot_pos, positions)
        out = llama_forward(
            self.params, self.cfg, tokens, positions, kv, slots, mask,
            compute_dtype=self.compute_dtype, kv_limit=kv_limit,
            causal_tags_prefill=True,  # the prefill flash kernel
        )
        return out.logits[:, n_valid - 1], out.kv

    def _shift_freq(self) -> torch.Tensor:
        """The rope frequencies a shift re-rotates the cached keys with: the
        forward's own, Llama-3.1's factors included (the reference's shift
        leaves them out, generate.py:332 and :365, so its shifted keys
        differ from a recompute on such a file), without mscale (the keys
        carry theirs from the forward)."""
        return rope_inv_freq(self.cfg, self.params.get("rope_factors"), device=self.device)

    def shift_context(self, n_keep: int, n_discard: int) -> None:
        """`kvcache.context_shift` on this engine's cache, with the
        forward's rope frequencies (`_shift_freq`)."""
        context_shift(self.kv, self._shift_freq(), n_keep, n_discard)

    def self_extend(self, n_past: int, ga_i: int, ga_n: int, ga_w: int) -> tuple[int, int]:
        """`kvcache.self_extend_shift` on this engine's cache (the
        frequencies of `_shift_freq`); returns (n_past, ga_i) after it."""
        return self_extend_shift(self.kv, self._shift_freq(), n_past, ga_i, ga_n, ga_w)

    def sampler_state(self, scfg: SamplerConfig) -> SamplerState | None:
        """The generator's `SamplerState`, reset for a new sequence under
        `scfg` (made once, at the first stateful config: its tensors stay
        put), or None for a stateless config."""
        if not scfg.stateful:
            return None
        if self.sstate is None:
            self.sstate = SamplerState(self.batch, self.cfg.vocab_size, device=self.device)
        return self.sstate.reset(scfg.mirostat_tau)

    def _forward_tok(self, kv_limit: int | None) -> torch.Tensor:
        """The token in `_tok` at position `_pos` and cache slot `_slot`
        through the model; returns its logits [B, V]."""
        p, sl = self._pos[:, None], self._slot[:, None]
        self.kv.with_tags(sl, p)
        mask = causal_mask_from_tags(self.kv.slot_pos, p)
        fo = llama_forward(
            self.params, self.cfg, self._tok[:, None], p, self.kv, sl, mask,
            compute_dtype=self.compute_dtype, kv_limit=kv_limit,
        )
        return fo.logits[:, 0]

    def _step(self, scfg: SamplerConfig, kv_limit: int | None) -> None:
        """One decode step in place: the token in `_tok` at position `_pos`
        and cache slot `_slot` goes through the model, its successor
        (drawn with the generator's `SamplerState` for a stateful config)
        lands in `_tok` and in the history at `_slot`, and both advance."""
        sl = self._slot[:, None]
        nxt = draw(self._forward_tok(kv_limit), scfg, self.rng,
                   self.sstate if scfg.stateful else None)
        self._hist.scatter_(1, sl.long(), nxt[:, None])
        self._tok.copy_(nxt)
        self._pos.add_(1)
        self._slot.add_(1)

    def _decode_chunk(self, first_token: torch.Tensor, start_pos: int,
                      scfg: SamplerConfig, n_steps: int,
                      kv_limit: int | None = None, start_slot: int | None = None
                      ) -> torch.Tensor:
        """Decode `n_steps` tokens after `first_token` [B] at positions
        start_pos.. and cache slots start_slot.. (by default the positions),
        one step body (or its graph's replay) each. A stateful `scfg` draws
        with the generator's `SamplerState` as it stands (`sampler_state`
        resets it). Returns tokens [B, n_steps] on the device."""
        slot = start_pos if start_slot is None else start_slot
        if not 0 <= slot <= self.max_seq - n_steps:
            raise ValueError(f"steps at {slot}..{slot + n_steps} leave the "
                             f"cache's {self.max_seq} slots")
        self._tok.copy_(first_token)
        self._pos.fill_(start_pos)
        self._slot.fill_(slot)
        static = (*self.kv.tensors(), self._tok, self._pos, self._slot, self._hist,
                  self.rng.seed, self.rng.counter,
                  *(self.sstate.tensors() if scfg.stateful else ()))
        for _ in range(n_steps):
            self.graphs.run(("step", kv_limit, scfg), lambda: self._step(scfg, kv_limit),
                            static)
        return self._hist[:, slot:slot + n_steps].clone()

    def _prompt(self, prompt: np.ndarray, session_path) -> torch.Tensor:
        """The prompt's last logits [B, V], the cache filled: with a session
        file, its longest prefix shared with the prompt (at most n - 1
        tokens: the last one is fed for its logits, as main.cpp) goes into
        the cache and the rest is fed at an offset; else the whole prompt."""
        n = len(prompt)
        n_matched = 0
        if session_path:
            from .state_io import insert_session_kv, load_prompt_session, session_prefix_len

            loaded = load_prompt_session(session_path, self.kv)
            if loaded is not None:
                sess_tokens, arrs = loaded
                n_matched = min(session_prefix_len(sess_tokens, prompt), n - 1)
                if n_matched > 0:
                    insert_session_kv(self.kv, arrs, n_matched)
        self.session_prefix_reused = n_matched
        part = prompt[n_matched:]
        t = pad_bucket(len(part))
        padded = np.zeros((self.batch, t), np.int32)
        padded[0, :len(part)] = part
        tokens = torch.from_numpy(padded).to(self.device)
        if n_matched:
            return self._extend(tokens, n_matched, len(part), t, self.kv_read_bucket(n))[0]
        n_valid = torch.tensor([n] * self.batch, dtype=torch.int32, device=self.device)
        return self._prefill(tokens, n_valid, t)[0]

    def generate(
        self,
        prompt_tokens,
        max_new_tokens: int = 128,
        sampler: SamplerConfig | None = None,
        seed: int = 0,
        chunk: int = 32,
        stop_at_eos: bool = True,
        context_shift_keep: int | None = None,
        grp_attn_n: int = 1,
        grp_attn_w: int = 512,
        on_token=None,
        session_path=None,
        session_cache_all: bool = False,
    ) -> list[int]:
        """Single-sequence generation; returns the generated token ids. The
        first token is drawn from the prompt's logits, then one per step;
        `seed` starts the draws' stream. `context_shift_keep`: past
        max_seq, evict half of the context after the first
        `context_shift_keep` tokens (llama.cpp's --keep) instead of
        stopping. `grp_attn_n` > 1: Self-Extend group attention with
        window `grp_attn_w` (main.cpp's --grp-attn-n / --grp-attn-w).
        `session_path`: a prompt-cache session file, read before and
        written after (not after a shift or under Self-Extend, where slots
        are no longer token ordinals); `session_cache_all` caches the
        continuation too."""
        scfg = sampler or SamplerConfig(greedy=True)
        prompt = np.asarray(prompt_tokens, dtype=np.int32)
        n = len(prompt)
        if n < 1:  # the last prompt row and the first decode slot would be -1
            raise ValueError("generate needs a prompt of at least one token")
        # a reused Generator must not leak stale rows into the mask
        self.kv.rollback(torch.zeros((self.batch,), dtype=torch.int32, device=self.device))
        logits = self._prompt(prompt, session_path)
        self.rng.reset(seed)
        sstate = self.sampler_state(scfg)
        if sstate is not None:  # the prompt's tokens enter the penalties' window
            sstate.count(0, prompt)
        first = draw(logits, scfg, self.rng, sstate)
        out = [int(first[0])]
        shifted = False  # a context shift or Self-Extend: slots no longer token ordinals

        def finish():
            if session_path and not shifted:
                from .state_io import save_prompt_session

                # the last sampled token was never fed: no KV row of its own
                end = n + len(out) - 1 if session_cache_all else n
                toks = list(prompt) + out if session_cache_all else list(prompt)
                save_prompt_session(session_path, toks[:end], self.kv, end)
            return out

        if on_token:
            on_token(out[0])
        if stop_at_eos and out[-1] == self.eos_id:
            return finish()
        pos = slot = n
        ga_i = 0
        tok = first
        while len(out) < max_new_tokens:
            if grp_attn_n > 1:
                while pos >= ga_i + grp_attn_w:
                    shifted = True
                    pos, ga_i = self.self_extend(pos, ga_i, grp_attn_n, grp_attn_w)
                if slot + chunk + 1 >= self.max_seq:
                    break
                steps = min(chunk, max_new_tokens - len(out), ga_i + grp_attn_w - pos)
            elif context_shift_keep is not None and pos + chunk + 1 >= self.max_seq:
                n_discard = (self.max_seq - context_shift_keep) // 2
                self.shift_context(context_shift_keep, n_discard)
                shifted = True
                pos -= n_discard
                slot = pos
                steps = min(chunk, max_new_tokens - len(out))
            elif pos + chunk + 1 >= self.max_seq:
                break
            else:
                steps = min(chunk, max_new_tokens - len(out))
            toks = self._decode_chunk(tok, pos, scfg, steps, start_slot=slot,
                                      kv_limit=self.kv_read_bucket(slot + steps))
            for tk in toks[0].tolist():
                out.append(int(tk))
                if on_token:
                    on_token(int(tk))
                if stop_at_eos and tk == self.eos_id:
                    return finish()
            pos += steps
            slot += steps
            tok = toks[:, -1]
        return finish()

    def _logits_step(self, kv_limit: int) -> None:
        """A constrained step in place: the token in `_tok` through the
        model at `_pos` / `_slot`, its logits into `_logits`; both advance."""
        self._logits.copy_(self._forward_tok(kv_limit))
        self._pos.add_(1)
        self._slot.add_(1)

    def _constrained_step(self, tok: int, pos: int) -> torch.Tensor:
        """`tok` through the model at position (and slot) `pos`: on the card
        the replay of the step's graph for its read bucket. Returns the
        logits [B, V] (a static buffer)."""
        if self._logits is None:
            self._logits = torch.zeros((self.batch, self.cfg.vocab_size), dtype=torch.float32,
                                       device=self.device)
        self._tok.fill_(tok)
        self._pos.fill_(pos)
        self._slot.fill_(pos)
        lim = self.kv_read_bucket(pos + 1)
        static = (*self.kv.tensors(), self._tok, self._pos, self._slot, self._logits)
        self.graphs.run(("logits", lim), lambda: self._logits_step(lim), static)
        return self._logits

    def generate_constrained(self, prompt_tokens, grammar, tokenizer,
                             max_new_tokens: int = 128, sampler: SamplerConfig | None = None,
                             seed: int = 0) -> list[int]:
        """Grammar-constrained generation (GBNF), token by token with the
        grammar's mask on the host, as the reference's grammar sampler
        stage: the token is the argmax of the masked transformed logits, or
        for a sampled config a draw from numpy's `default_rng(seed)` over
        their f64 probabilities. EOS is allowed while the grammar awaits its
        trigger or can end. `grammar` advances as the tokens are accepted.
        A stateful `sampler` is refused: the reference transforms the logits
        here without the sampler's state."""
        from .grammar import TokenTrie

        scfg = sampler or SamplerConfig(greedy=True)
        refuse_dropped_state(scfg, "grammar-constrained generation")
        prompt = np.asarray(prompt_tokens, dtype=np.int32)
        n = len(prompt)
        if n < 1:
            raise ValueError("generate_constrained needs a prompt of at least one token")
        self.kv.rollback(torch.zeros((self.batch,), dtype=torch.int32, device=self.device))
        logits = self._prompt(prompt, None)
        pieces = [tokenizer.piece(i) for i in range(self.cfg.vocab_size)]
        trie = TokenTrie(pieces)
        rng = np.random.default_rng(seed)
        eos = tokenizer.eos_id
        out: list[int] = []
        pos = n
        for _ in range(max_new_tokens):
            l = transform_logits(logits[0], scfg).cpu().numpy().astype(np.float64)
            mask = grammar.token_mask(trie)
            if (grammar.awaiting_trigger or grammar.can_end) and eos >= 0:
                mask[eos] = True
            l[~mask] = -np.inf
            if scfg.is_greedy:
                tok = int(l.argmax())
            else:
                p = np.exp(l - l.max())
                p /= p.sum()
                tok = int(rng.choice(len(p), p=p))
            out.append(tok)
            if tok == eos:
                break
            grammar.accept_token(tok, pieces[tok])
            if pos + 1 >= self.max_seq:
                break
            logits = self._constrained_step(tok, pos)
            pos += 1
        return out

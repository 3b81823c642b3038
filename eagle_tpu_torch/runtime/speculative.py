"""EAGLE chain speculative decoding (port of
eagle_tpu/runtime/speculative.py: `EagleChainEngine` with `fresh_state`,
`fresh_paged_state`, `set_row_sampler`, `_prefill`, `_prefill_chunk` with
`feat_every`, both branches of `_cycle` with its freeze of inactive rows,
`_multi_cycle`, `generate` with `seed` and `cycles_per_dispatch`, and
grammar-constrained speculation: `_cycle_propose`, `_cycle_commit`,
`generate_constrained`).

A cycle: K draft steps (feature autoregression) -> one verify forward over
[last token + K drafts] -> acceptance -> KV rollback by tag invalidation ->
feature handoff. With a greedy sampler (`fast_greedy`) the drafts are
argmaxes and acceptance is the exact-match prefix, so the output equals
plain greedy decoding. Otherwise the drafts are drawn from the draft's
transformed distribution q (kept in a static [B, K, V] buffer), the verify
gives p over [B, K+1, V] under the same per-row chain, and
`speculative_accept` takes min(1, p/q) with a residual resample: the output
is distributed as plain sampling. Draws come from the state's `CounterRNG`,
seeded by `generate(..., seed=)`.

Indexing (EAGLE's shifted sequence): target token x_i lives at target
position i; draft pair (x_i, f_{i-1}) lives at draft position i-1, f_j being
the target hidden state at position j (post- or pre-final-norm per
`feature_source`).

Unlike the functional reference, the engine keeps one `SpecState` for its
life: `fresh_state` resets it in place, the prefill and every cycle write it
in place (each forward writes its cache's K/V rows, rollback rewrites the
tags), and a dispatch of C cycles writes its tokens into static [C, ...]
buffers. So C chained cycles are one in-place body: on the card one CUDA
graph per (C, attention-read bucket) (`runtime/graphs.py`), the reference's
compiled `lax.scan`; on the CPU, or with `cuda_graphs=False`, the same body
runs eagerly. The prompt runs eagerly.

The continuous batcher (`runtime/scheduler.py`) drives the same state: one
row per slot, each prompt admitted by `_prefill_chunk` on the row's views,
and one masked cycle (`_multi_cycle(1, active=...)`) over every row per
step. A masked cycle keeps the inactive rows' tags, last token, feature and
n_past as they were (their K/V data slots may change), with `active` in a
static buffer that the host writes when it changes (a copy from the host
waits for the card, so replays of an unchanged batch queue up). The
cycle's graph is keyed also on `fast_greedy` (every row's sampler greedy,
per dispatch, as the reference's `_cycle_jit`) and on whether it is
masked. The caches carry 2 (K + 1) spill slots (`runtime/kvcache.py`): a
row's cycle writes up to K past its n_past, and a freed row keeps the
n_past of its last cycle.

The caches may be int8 (`kv_dtype=torch.int8`). `fresh_paged_state` makes
both caches page pools (`runtime/paged_kv.py`) for the paged batcher
(`runtime/paged_batcher.py`), which owns their allocators: the chunk, the
cycle and the rollback run unchanged over them (the forward does the page
indirection), and the graphs' static inputs include the page tables,
which the batcher rewrites in place.

Grammar-constrained speculation splits a cycle in two. The proposal (K
argmax drafts, the verify forward, the target's argmax, its top
min(256, V) candidates per verify row and the features) writes the engine's
caches in place and static buffers, and advances nothing: one graph per
read bucket on the card. The host reads the drafts, argmaxes and
candidates in one read, walks them through the grammar, and the commit
(small in-place ops) rolls the tags back to what it kept and sets the last
token, feature and n_past. The first token comes from the prompt's last
logits row, kept by `_prefill`, as the plain constrained generator's. Where
no candidate is legal, the vetoed row's logits (kept in a static buffer)
give the masked argmax, where the reference takes the lowest legal token
id and leaves the plain generator's text.

The engine samples without a `SamplerState`, as the reference's cycles
(which drop the state): a stateful sampler is refused here and in
`set_row_sampler` (`sampling.refuse_dropped_state`)."""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.config import ModelConfig
from ..models.eagle import eagle_forward
from ..models.llama import llama_forward
from .generate import pad_bucket
from .graphs import StepGraphs
from .kvcache import KVCache, causal_mask_from_tags
from .paged_kv import PagedKVCache
from .sampling import (
    BatchedSamplerParams,
    CounterRNG,
    SamplerConfig,
    draw,
    refuse_dropped_state,
    sample_batched,
    speculative_accept,
    top_k,
    transformed_probs_batched,
)


@dataclasses.dataclass
class SpecState:
    tgt_kv: KVCache | PagedKVCache
    dft_kv: KVCache | PagedKVCache
    last_token: torch.Tensor  # [B] sampled but not yet decoded by the target
    feature: torch.Tensor  # [B, D] target feature at position n_past-1
    n_past: torch.Tensor  # [B] committed target tokens (m)
    rng: CounterRNG  # the draws' (seed, counter): the reference's `key`


class CycleOutput(NamedTuple):
    state: SpecState
    tokens: torch.Tensor  # [C, B, out_width] output tokens (accepted drafts + correction)
    n_out: torch.Tensor  # [C, B] how many of `tokens` are real output (n_acc + 1)
    n_accepted: torch.Tensor  # [C, B] accepted draft tokens in each cycle


class Proposal(NamedTuple):
    """The static buffers of one uncommitted proposal (B = 1)."""

    ids: torch.Tensor  # [B, K + (K+1) + (K+1) C] int32: drafts, t_true, cand_ids
    feats: torch.Tensor  # [B, K+1, D] features for the next draft step
    logits: torch.Tensor  # [B, K+1, V] the verify rows' logits (read where no candidate is legal)


class EagleChainEngine:
    """Single-sequence (B=1-oriented, but batch-shaped) chain speculation."""

    def __init__(
        self,
        target_params: dict[str, Any],
        draft_params: dict[str, Any],
        target_cfg: ModelConfig,
        draft_cfg: ModelConfig | None = None,
        *,
        n_draft: int = 5,
        max_seq: int = 2048,
        batch: int = 1,
        kv_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        feature_source: str = "post_norm",  # "post_norm" (fork) | "pre_norm" (official)
        sampler: SamplerConfig | None = None,
        eos_id: int = 2,
        device="cuda",
        cuda_graphs: bool = True,  # replay each dispatch as a CUDA graph on the card
    ):
        if feature_source not in ("post_norm", "pre_norm"):
            raise ValueError(f"feature_source {feature_source!r}")
        self.device = resolve_device(device)
        self.tp, self.dp = target_params, draft_params
        self.tcfg = target_cfg
        self.dcfg = draft_cfg or dataclasses.replace(target_cfg, n_layers=1, is_eagle=True)
        self.K = n_draft  # draft window: generate()'s overflow margin and n_drafted per cycle
        self.out_width = n_draft + 1  # columns of a cycle's output row (drafts + bonus)
        self.max_seq = max_seq
        self.batch = batch
        self.kv_dtype = kv_dtype
        self.compute_dtype = compute_dtype
        self.feature_source = feature_source
        self.scfg = sampler or SamplerConfig(greedy=True)
        refuse_dropped_state(self.scfg, "a speculative engine")
        #: per-row sampler parameters (every row the engine's sampler until
        #: `set_row_sampler`), written in place: the cycle's graphs hold them
        self.bsampler = BatchedSamplerParams.create(batch, self.scfg, n_draft=n_draft,
                                                    device=self.device)
        #: host-side greediness per row: all greedy takes the `fast_greedy`
        #: cycle, any sampled row the stochastic one
        self._row_greedy = [self.scfg.is_greedy] * batch
        self._q: torch.Tensor | None = None  # the drafts' q [B, K, V], made at first use
        self._active = torch.ones((batch,), dtype=torch.bool, device=self.device)
        self._active_host = [True] * batch  # what `_active` holds: written only on a change
        self.cycles_per_dispatch = 1  # generate()'s default C
        self.eos_id = eos_id
        self.state = self._new_state()  # static for the engine's life
        self._outs: dict[int, CycleOutput] = {}  # static output buffers per C
        self.graphs = StepGraphs(cuda_graphs and self.device.type == "cuda")
        self.cycles_run = 0  # cycles computed, overshoot included
        self.prompt_logits: torch.Tensor | None = None  # `_prefill`'s last row [B, V]
        self._prop: Proposal | None = None  # made at the first constrained proposal

    @property
    def fast_greedy(self) -> bool:
        return all(self._row_greedy)

    def set_row_sampler(self, i: int, cfg: SamplerConfig, spec_k: int | None = None) -> None:
        """Row i's sampler (and its cap on accepted drafts per cycle), in
        place; keeps the all-greedy flag that picks the cycle's branch."""
        refuse_dropped_state(cfg, "a batched row of a speculative engine")
        self.bsampler.set_row(i, cfg, spec_k=spec_k)
        self._row_greedy[i] = cfg.is_greedy

    def kv_read_bucket(self, slot_end: int) -> int:
        """Attention-read bound covering cache slots < slot_end."""
        return min(self.max_seq, pad_bucket(max(slot_end, 1), 128))

    def _pick_feature(self, post: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
        return post if self.feature_source == "post_norm" else pre

    def _dense_caches(self) -> tuple[KVCache, KVCache]:
        b, dev, spill = self.batch, self.device, 2 * (self.K + 1)
        return (KVCache.create(self.tcfg.n_layers, b, self.max_seq, self.tcfg.n_kv_heads,
                               self.tcfg.head_dim, self.kv_dtype, device=dev, spill=spill),
                KVCache.create(1, b, self.max_seq, self.dcfg.n_kv_heads,
                               self.dcfg.head_dim, self.kv_dtype, device=dev, spill=spill))

    def _new_state(self) -> SpecState:
        b, dev = self.batch, self.device
        tgt, dft = self._dense_caches()
        return SpecState(
            tgt_kv=tgt,
            dft_kv=dft,
            last_token=torch.zeros((b,), dtype=torch.int32, device=dev),
            feature=torch.zeros((b, self.tcfg.n_embd), dtype=torch.float32, device=dev),
            n_past=torch.zeros((b,), dtype=torch.int32, device=dev),
            rng=CounterRNG(device=dev),
        )

    def fresh_state(self) -> SpecState:
        """The engine's state, reset in place to a new one's: empty tags,
        zeros (unmapped page tables for a paged state), and the stream of
        seed 0."""
        st = self.state
        st.tgt_kv.reset()
        st.dft_kv.reset()
        for t in (st.last_token, st.feature, st.n_past):
            t.zero_()
        st.rng.reset(0)
        return st

    def fresh_dense_state(self) -> SpecState:
        """`fresh_state` on dense caches: a paged state's pools are replaced
        by dense caches first (a dense batcher over an engine that served a
        paged one)."""
        if self.paged:
            self.state.tgt_kv, self.state.dft_kv = self._dense_caches()
        return self.fresh_state()

    @property
    def paged(self) -> bool:
        return isinstance(self.state.tgt_kv, PagedKVCache)

    def fresh_paged_state(self, n_pages: int, page_size: int = 64,
                          dft_n_pages: int | None = None) -> SpecState:
        """The engine's state replaced by a paged one: the target and draft
        caches become page pools of `n_pages` (`dft_n_pages`) pages shared
        by every row, each row addressing max_seq positions (rounded up to
        a page) with the dense caches' spill as tag columns. For a
        `PagedBatcher`, which owns the allocators."""
        b, dev, spill = self.batch, self.device, 2 * (self.K + 1)
        mp = -(-self.max_seq // page_size)
        st = self.state
        st.tgt_kv = PagedKVCache.create(self.tcfg.n_layers, b, n_pages, mp, page_size,
                                        self.tcfg.n_kv_heads, self.tcfg.head_dim,
                                        self.kv_dtype, device=dev, spill=spill)
        st.dft_kv = PagedKVCache.create(1, b, dft_n_pages or n_pages, mp, page_size,
                                        self.dcfg.n_kv_heads, self.dcfg.head_dim,
                                        self.kv_dtype, device=dev, spill=spill)
        return self.fresh_state()

    def _prefill(self, state: SpecState, tokens: torch.Tensor, n_valid: torch.Tensor,
                 t: int) -> SpecState:
        """Target prefill over the padded prompt + draft prefill over the
        shifted (token, feature) pairs; picks the first output token, all in
        `state` in place. The prompt runs through the decode/verify
        attention at T = t (no causal_tags_prefill), as in the reference."""
        b = tokens.shape[0]
        positions = torch.arange(t, dtype=torch.int32, device=self.device).repeat(b, 1)
        valid = positions < n_valid[:, None]
        lim = min(self.max_seq, max(t, 128))
        tgt_kv = state.tgt_kv.with_tags(positions, positions, valid=valid)
        mask = causal_mask_from_tags(tgt_kv.slot_pos, positions)
        tout = llama_forward(
            self.tp, self.tcfg, tokens, positions, tgt_kv, positions, mask,
            compute_dtype=self.compute_dtype, kv_limit=lim, slots_contiguous=True,
        )
        feats = self._pick_feature(tout.hidden, tout.hidden_pre)

        # draft pairs: (x_i, f_{i-1}) for i = 1..n-1 at draft positions 0..n-2
        d_tokens = torch.roll(tokens, -1, dims=1)
        d_valid = positions < (n_valid[:, None] - 1)
        dft_kv = state.dft_kv.with_tags(positions, positions, valid=d_valid)
        d_mask = causal_mask_from_tags(dft_kv.slot_pos, positions)
        eagle_forward(
            self.dp, self.tp, self.dcfg, d_tokens, feats, positions, dft_kv,
            positions, d_mask, compute_dtype=self.compute_dtype,
            return_logits=False, kv_limit=lim, slots_contiguous=True,
        )
        b_idx = torch.arange(b, device=self.device)
        last = (n_valid - 1).long()
        self.prompt_logits = tout.logits[b_idx, last]
        state.last_token.copy_(draw(self.prompt_logits, self.scfg, state.rng))
        state.feature.copy_(feats[b_idx, last])
        state.n_past.copy_(n_valid)
        return state

    def _prefill_chunk(self, slot: int, tokens: torch.Tensor, start: int, n_valid: int,
                       feat_every: int = 0) -> torch.Tensor | None:
        """One prompt chunk of row `slot`: `tokens` [ct] at absolute
        positions start..start+ct of a prompt of `n_valid` tokens, on the
        row's views of the engine's state (the reference's
        `_prefill_chunk` on the batcher's B = 1 slice). With `feat_every`
        > 0 (dividing ct) it returns the features at every in-chunk stride
        boundary [ct // feat_every, D] on the device: row m is the feature
        of position start + (m+1)*feat_every - 1 (rows past n_valid are
        garbage). The first chunk clears the row's tags. Draft pairs
        are shifted one back, the chunk-boundary feature coming from the
        row's `feature`; on the final chunk the row's first output token is
        drawn with its own sampler. Rows at positions outside [0, max_seq)
        (the draft's pair at -1, padding past the cache) write to the last
        spill slot, as the reference's scatter leaves every tag they would
        touch as it was."""
        st, ct, s = self.state, tokens.shape[0], self.max_seq
        tkv, dkv = st.tgt_kv.row(slot), st.dft_kv.row(slot)
        if start == 0:
            tkv.slot_pos.fill_(-1)
            dkv.slot_pos.fill_(-1)
        spill_slot = tkv.slot_pos.shape[1] - 1
        lim = self.kv_read_bucket(start + ct)
        positions = start + torch.arange(ct, dtype=torch.int32, device=self.device)[None, :]
        w = torch.where(positions < s, positions, spill_slot)
        tkv.with_tags(w, positions, valid=positions < n_valid)
        mask = causal_mask_from_tags(tkv.slot_pos, positions)
        tout = llama_forward(
            self.tp, self.tcfg, tokens[None, :], positions, tkv, w, mask,
            compute_dtype=self.compute_dtype, kv_limit=lim, slots_contiguous=True,
        )
        feats = self._pick_feature(tout.hidden, tout.hidden_pre)

        # draft pair for token x_i uses f_{i-1}: the boundary feature for i = start
        d_feats = torch.cat([st.feature[slot:slot + 1, None], feats[:, :-1]], dim=1)
        d_pos = positions - 1
        d_w = torch.where((d_pos >= 0) & (d_pos < s), d_pos, spill_slot)
        dkv.with_tags(d_w, d_pos, valid=(d_pos >= 0) & (d_pos < n_valid - 1))
        d_mask = causal_mask_from_tags(dkv.slot_pos, d_pos)
        eagle_forward(
            self.dp, self.tp, self.dcfg, tokens[None, :], d_feats, d_pos, dkv, d_w, d_mask,
            compute_dtype=self.compute_dtype, return_logits=False, kv_limit=lim,
        )

        done = min(n_valid, start + ct)  # tokens processed so far
        last = min(max(done - start - 1, 0), ct - 1)
        gumbel = st.rng.gumbel((1, self.tcfg.vocab_size))
        if done >= n_valid:
            st.last_token[slot:slot + 1].copy_(
                sample_batched(tout.logits[:, last], self.bsampler.row(slot), gumbel))
        st.feature[slot].copy_(feats[0, last])
        st.n_past[slot] = done
        if feat_every:
            assert ct % feat_every == 0, (ct, feat_every)
            return feats[0, feat_every - 1::feat_every].clone()
        return None

    def _cycle(self, state: SpecState, out: CycleOutput, ci: int,
               kv_limit: int | None = None, active: torch.Tensor | None = None) -> None:
        """One speculative cycle: with every row greedy, the reference's
        `fast_greedy` branch (argmax drafts, exact-match prefix acceptance,
        each row's `spec_k` cap); otherwise drafts drawn from q and
        stochastic acceptance against p (`speculative_accept`). Advances
        `state` in place and writes row `ci` of `out`'s buffers. With
        `active` [B] bool, the other rows' tags and scalars come out as they
        went in (their K/V data slots may be written)."""
        b, K = self.batch, self.K
        b_idx = torch.arange(b, device=self.device)
        m = state.n_past  # [B]; overwritten last
        if active is not None:  # the inactive rows' state, restored at the end
            frozen = [t.clone() for t in (state.tgt_kv.slot_pos, state.dft_kv.slot_pos,
                                          state.last_token, state.feature, state.n_past)]
        fast_greedy, bs = self.fast_greedy, self.bsampler
        if not fast_greedy:  # the cycle's noise in two draws: K drafts + the correction
            greedy_rows = bs.greedy | (bs.temperature <= 0)
            gumbel = state.rng.gumbel((K + 1, b, self.tcfg.vocab_size))
            uniform = state.rng.uniform((b, K))

        # ---- 1. draft K tokens (feature autoregression) ----
        tok, feat, dkv = state.last_token, state.feature, state.dft_kv
        drafts = []
        for k in range(K):
            pos = (m - 1 + k)[:, None]  # draft position of this pair
            dkv.with_tags(pos, pos)
            mask = causal_mask_from_tags(dkv.slot_pos, pos)
            dout = eagle_forward(
                self.dp, self.tp, self.dcfg, tok[:, None], feat[:, None], pos,
                dkv, pos, mask, compute_dtype=self.compute_dtype, kv_limit=kv_limit,
            )
            if fast_greedy:
                tok = torch.argmax(dout.logits[:, 0], dim=-1).to(torch.int32)
            else:  # a draw from q; greedy rows take its argmax
                q = transformed_probs_batched(dout.logits[:, 0], bs)  # [B, V]
                self._q[:, k].copy_(q)
                drawn = torch.argmax(gumbel[k] + torch.log(q + 1e-30), dim=-1)
                tok = torch.where(greedy_rows, torch.argmax(q, dim=-1), drawn).to(torch.int32)
            feat = self._pick_feature(dout.feature, dout.feature_pre)[:, 0]
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)  # [B, K]; drafts[:, k] = candidate for x_{m+1+k}

        # ---- 2. verify: one target forward over [x_m, d_1..d_K] ----
        v_tokens = torch.cat([state.last_token[:, None], drafts], dim=1)
        v_pos = m[:, None] + torch.arange(K + 1, dtype=torch.int32, device=self.device)[None, :]
        tgt_kv = state.tgt_kv.with_tags(v_pos, v_pos)
        mask = causal_mask_from_tags(tgt_kv.slot_pos, v_pos)
        tout = llama_forward(
            self.tp, self.tcfg, v_tokens, v_pos, tgt_kv, v_pos, mask,
            compute_dtype=self.compute_dtype, kv_limit=kv_limit, slots_contiguous=True,
        )

        # ---- 3. acceptance ----
        if fast_greedy:  # exact-prefix match against the target's argmax
            t_true = torch.argmax(tout.logits, dim=-1).to(torch.int32)  # [B, K+1]
            match = drafts == t_true[:, :K]
            n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
            n_acc = torch.minimum(n_acc, bs.spec_k.to(n_acc.dtype)).to(torch.int32)
        else:  # min(1, p/q) with a residual resample, per-row chains on both sides
            p = transformed_probs_batched(tout.logits, bs)  # [B, K+1, V]
            t_true, n_acc = speculative_accept(drafts, self._q, p, bs.spec_k, greedy_rows,
                                               uniform, gumbel[K])
        new_m = m + n_acc + 1
        feats = self._pick_feature(tout.hidden, tout.hidden_pre)
        idx = n_acc.long()
        tgt_kv.rollback(keep_below=new_m)
        dkv.rollback(keep_below=new_m - 1)
        out.tokens[ci].copy_(t_true)
        out.n_out[ci].copy_(n_acc + 1)
        out.n_accepted[ci].copy_(n_acc)
        state.last_token.copy_(t_true[b_idx, idx])
        state.feature.copy_(feats[b_idx, idx])
        state.n_past.copy_(new_m)
        if active is not None:
            for t, old in zip((state.tgt_kv.slot_pos, state.dft_kv.slot_pos, state.last_token,
                               state.feature, state.n_past), frozen):
                keep = active.view(-1, *([1] * (t.dim() - 1)))
                t.copy_(torch.where(keep, t, old))

    def _multi_cycle(self, n_cycles: int, kv_limit: int | None = None,
                     active=None) -> CycleOutput:
        """`n_cycles` chained speculative cycles on the engine's state in ONE
        dispatch (one graph replay on the card), the reference's scanned
        `_multi_cycle`. Returns the state and the per-cycle outputs [C, B,
        ...]; they are static buffers, overwritten by the next dispatch of
        the same C. `kv_limit` must bound the LAST cycle's reads. `active`
        [B] bool (the batcher's) masks the cycles: it is copied into a
        static buffer. The subclasses' `_cycle` (the tree engines') is what
        runs here, unmasked."""
        out = self._outs.get(n_cycles)
        if out is None:
            b, dev = self.batch, self.device
            out = CycleOutput(
                state=self.state,
                tokens=torch.zeros((n_cycles, b, self.out_width), dtype=torch.int32, device=dev),
                n_out=torch.zeros((n_cycles, b), dtype=torch.int32, device=dev),
                n_accepted=torch.zeros((n_cycles, b), dtype=torch.int32, device=dev),
            )
            self._outs[n_cycles] = out
        st, fast = self.state, self.fast_greedy
        if not fast and self._q is None:
            self._q = torch.zeros((self.batch, self.K, self.tcfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
        mask = {}
        if active is not None:
            rows = [bool(a) for a in active]
            if rows != self._active_host:
                self._active.copy_(torch.tensor(rows))
                self._active_host = rows
            mask = {"active": self._active}

        def body():
            for ci in range(n_cycles):
                self._cycle(st, out, ci, kv_limit=kv_limit, **mask)

        static = (*st.tgt_kv.tensors(), *st.dft_kv.tensors(), st.last_token, st.feature,
                  st.n_past, st.rng.seed,
                  st.rng.counter, out.tokens, out.n_out, out.n_accepted, self._active,
                  *self.bsampler.tensors(),
                  *(() if self._q is None else (self._q,)))
        self.graphs.run(("cycles", n_cycles, kv_limit, fast, bool(mask)), body, static)
        self.cycles_run += n_cycles
        return out

    def generate(self, prompt_tokens, max_new_tokens: int = 128, seed: int = 0,
                 stop_at_eos: bool = True, on_token=None,
                 cycles_per_dispatch: int | None = None) -> tuple[list[int], dict]:
        """Returns (tokens, stats). Output is identical to non-speculative
        greedy decoding, or distributed as non-speculative sampling under
        the same sampler (the draft only changes speed); `seed` starts the
        draws' stream.

        `cycles_per_dispatch` C > 1 chains C cycles in one dispatch
        (`_multi_cycle`), as in the reference: stop conditions (eos,
        max_new) are checked between dispatches, and the cycles after a stop
        are computed and discarded, left out of the stats. Near `max_seq`
        the dispatches wind down to single cycles. The reference's C = 1
        branch is the same loop with one cycle. Without
        `cycles_per_dispatch`, C is the engine's `cycles_per_dispatch`. It
        runs on the dense state: an engine whose state is a page pool serves
        its `PagedBatcher` only."""
        if self.paged:
            raise ValueError("this engine's state is a page pool, driven by its PagedBatcher: "
                             "generate through the batcher, or on an engine of its own")
        state = self.fresh_state()
        state.rng.reset(seed)
        prompt = np.asarray(prompt_tokens, dtype=np.int32)
        n = len(prompt)
        if n < 1:  # the last prompt row and the first draft slot would be -1
            raise ValueError("generate needs a prompt of at least one token")
        t = pad_bucket(n)
        padded = np.zeros((self.batch, t), np.int32)
        padded[0, :n] = prompt
        state = self._prefill(
            state, torch.from_numpy(padded).to(self.device),
            torch.tensor([n] * self.batch, dtype=torch.int32, device=self.device), t,
        )
        out = [int(state.last_token[0])]
        if on_token:
            on_token(out[0])
        n_cycles = n_drafted = n_accepted = 0
        C = max(1, cycles_per_dispatch or self.cycles_per_dispatch)
        n_past = n  # state.n_past[0], followed on the host: no read of its own
        while len(out) < max_new_tokens and not (stop_at_eos and out[-1] == self.eos_id):
            if n_past + self.K + 2 >= self.max_seq:
                break
            # full C only if the LAST chained cycle stays in range; otherwise
            # wind down to single cycles
            c = C if n_past + C * (self.K + 2) < self.max_seq else 1
            res = self._multi_cycle(c, kv_limit=self.kv_read_bucket(n_past + c * (self.K + 2)))
            w = self.out_width
            rows = torch.cat([res.tokens[:, 0], res.n_out[:, :1], res.n_accepted[:, :1]],
                             dim=1).tolist()  # [c, w + 2]: one read of the dispatch
            n_past += sum(row[w] for row in rows)  # each cycle: m + n_out
            for row in rows:
                toks, k, acc = row[:w], row[w], row[w + 1]
                n_cycles += 1
                n_drafted += self.K
                n_accepted += acc
                done = False
                for tk in toks[:k]:
                    out.append(tk)
                    if on_token:
                        on_token(tk)
                    if (stop_at_eos and tk == self.eos_id) or len(out) >= max_new_tokens:
                        done = True
                        break
                if done:
                    break
        stats = {
            "n_cycles": n_cycles,
            "n_drafted": n_drafted,
            "n_accepted": n_accepted,
            "accept_rate": n_accepted / max(1, n_drafted),
            "mean_accept_len": (n_accepted + n_cycles) / max(1, n_cycles),
        }
        return out, stats

    # ------------------------------------------------------------------
    # grammar-constrained speculation: the cycle splits into a proposal
    # (drafts, verify, candidates; nothing committed) and a commit of what
    # the host's grammar walk kept

    def _cycle_propose(self, kv_limit: int | None, n_cand: int) -> None:
        """K argmax drafts from the draft positions m-1 on, the K+1-row
        verify forward, the target's argmax, its top `n_cand` candidates
        per verify row (lower index first on ties, as jax.lax.top_k) and
        the features, into the proposal's static buffers. The caches' K/V
        rows and tags are written; n_past, the last token and the feature
        stay as they were."""
        st, K, prop = self.state, self.K, self._prop
        m = st.n_past
        tok, feat, dkv = st.last_token, st.feature, st.dft_kv
        drafts = []
        for k in range(K):
            pos = (m - 1 + k)[:, None]
            dkv.with_tags(pos, pos)
            mask = causal_mask_from_tags(dkv.slot_pos, pos)
            dout = eagle_forward(
                self.dp, self.tp, self.dcfg, tok[:, None], feat[:, None], pos,
                dkv, pos, mask, compute_dtype=self.compute_dtype, kv_limit=kv_limit,
            )
            tok = torch.argmax(dout.logits[:, 0], dim=-1).to(torch.int32)
            feat = self._pick_feature(dout.feature, dout.feature_pre)[:, 0]
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)
        v_tokens = torch.cat([st.last_token[:, None], drafts], dim=1)
        v_pos = m[:, None] + torch.arange(K + 1, dtype=torch.int32, device=self.device)[None, :]
        tgt_kv = st.tgt_kv.with_tags(v_pos, v_pos)
        mask = causal_mask_from_tags(tgt_kv.slot_pos, v_pos)
        tout = llama_forward(
            self.tp, self.tcfg, v_tokens, v_pos, tgt_kv, v_pos, mask,
            compute_dtype=self.compute_dtype, kv_limit=kv_limit, slots_contiguous=True,
        )
        b = self.batch
        prop.ids[:, :K].copy_(drafts)
        prop.ids[:, K:2 * K + 1].copy_(torch.argmax(tout.logits, dim=-1))
        prop.ids[:, 2 * K + 1:].copy_(top_k(tout.logits, n_cand)[1].view(b, -1))
        prop.feats.copy_(self._pick_feature(tout.hidden, tout.hidden_pre))
        prop.logits.copy_(tout.logits)

    def _propose(self, kv_limit: int, n_cand: int) -> None:
        """One proposal (`_cycle_propose`): on the card the replay of its
        graph for (`kv_limit`, `n_cand`)."""
        st, prop = self.state, self._prop
        static = (*st.tgt_kv.tensors(), *st.dft_kv.tensors(), st.last_token, st.feature,
                  st.n_past, prop.ids, prop.feats, prop.logits)
        self.graphs.run(("propose", kv_limit, n_cand),
                        lambda: self._cycle_propose(kv_limit, n_cand), static)

    def _cycle_commit(self, m: int, n_final: int, final_token: int) -> None:
        """Commit `n_final` output tokens of the proposal made at n_past
        `m`, the last of them `final_token` (the grammar's pick where it
        vetoed the target's): the target tags roll back to m + n_final, the
        draft's to m + n_final - 1."""
        st = self.state
        new_m = torch.full((self.batch,), m + n_final, dtype=torch.int32, device=self.device)
        st.tgt_kv.rollback(keep_below=new_m)
        st.dft_kv.rollback(keep_below=new_m - 1)
        st.last_token.fill_(final_token)
        st.feature.copy_(self._prop.feats[:, n_final - 1])
        st.n_past.copy_(new_m)

    def generate_constrained(self, prompt_tokens, grammar, tokenizer,
                             max_new_tokens: int = 128, seed: int = 0,
                             stop_at_eos: bool = True) -> tuple[list[int], dict]:
        """Grammar-constrained speculative decoding: every output token is
        checked against (and advances) the grammar; a vetoed position ends
        the cycle's acceptance and takes the best grammar-legal candidate
        of the target's top min(256, V), or where none is legal the masked
        argmax of the row's logits (EOS where nothing is legal). The first
        token is the masked argmax of the prompt's last logits. Greedy,
        whatever the sampler; `grammar` advances. Returns (tokens, stats).

        So the tokens are the plain constrained generator's. The reference
        takes the lowest legal token id where no candidate is legal, which
        departs from them (ROADMAP queue 3); elsewhere the two agree."""
        from .grammar import TokenTrie

        if self.batch != 1:
            raise ValueError(f"constrained generation is single-sequence: this engine has "
                             f"batch {self.batch}, it needs batch 1")
        if self.paged:
            raise ValueError("this engine's state is a page pool, driven by its PagedBatcher")
        prompt = np.asarray(prompt_tokens, dtype=np.int32)
        n = len(prompt)
        if n < 1:
            raise ValueError("generate_constrained needs a prompt of at least one token")
        K, V = self.K, self.tcfg.vocab_size
        n_cand = min(256, V)
        if self._prop is None:
            self._prop = Proposal(
                ids=torch.zeros((1, K + (K + 1) * (1 + n_cand)), dtype=torch.int32,
                                device=self.device),
                feats=torch.zeros((1, K + 1, self.tcfg.n_embd), dtype=torch.float32,
                                  device=self.device),
                logits=torch.zeros((1, K + 1, V), dtype=torch.float32, device=self.device))
        pieces = [tokenizer.piece(i) for i in range(V)]
        trie = TokenTrie(pieces)
        eos = tokenizer.eos_id

        def legal():
            gmask = grammar.token_mask(trie)
            if eos >= 0:
                gmask[eos] = bool(grammar.can_end)
            return gmask

        def masked_argmax(row: torch.Tensor, gmask) -> int:
            masked = np.where(gmask, row.float().cpu().numpy(), -np.inf)
            return int(np.argmax(masked)) if np.isfinite(masked).any() else eos

        state = self.fresh_state()
        state.rng.reset(seed)
        t = pad_bucket(n)
        padded = np.zeros((1, t), np.int32)
        padded[0, :n] = prompt
        self._prefill(state, torch.from_numpy(padded).to(self.device),
                      torch.tensor([n], dtype=torch.int32, device=self.device), t)
        first = masked_argmax(self.prompt_logits[0], legal())
        state.last_token.fill_(first)
        out = [first]
        if first != eos:
            grammar.accept_token(first, pieces[first])

        prop = self._prop
        n_cycles = n_accepted = 0
        n_past = n
        while len(out) < max_new_tokens and not (stop_at_eos and out[-1] == eos):
            if n_past + K + 2 >= self.max_seq:
                break
            self._propose(self.kv_read_bucket(n_past + K + 2), n_cand)
            ids = prop.ids[0].tolist()  # one read: drafts, t_true, candidates
            drafts, t_true = ids[:K], ids[K:2 * K + 1]
            cands = ids[2 * K + 1:]
            n_dev = 1  # the device's acceptance: the longest exact-match prefix
            for p in range(K):
                if drafts[p] != t_true[p]:
                    break
                n_dev += 1
            kept: list[int] = []
            for p in range(n_dev):  # the grammar's walk over the proposed tokens
                tok = t_true[p]
                gmask = legal()
                if gmask[tok]:
                    kept.append(tok)
                    if tok == eos:
                        break
                    grammar.accept_token(tok, pieces[tok])
                    continue
                repl = next((c for c in cands[p * n_cand:(p + 1) * n_cand] if gmask[c]), None)
                if repl is None:  # no candidate is legal: the masked argmax of the whole row
                    repl = masked_argmax(prop.logits[0, p], gmask)
                kept.append(repl)
                if repl != eos:
                    grammar.accept_token(repl, pieces[repl])
                break
            self._cycle_commit(n_past, len(kept), kept[-1])
            n_past += len(kept)
            out.extend(kept)
            n_cycles += 1
            n_accepted += len(kept) - 1
        stats = {"constrained": True, "n_cycles": n_cycles, "n_accepted": n_accepted,
                 "mean_accept_len": (n_accepted + n_cycles) / max(1, n_cycles)}
        return out[:max_new_tokens], stats

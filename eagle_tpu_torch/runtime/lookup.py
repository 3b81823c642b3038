"""Prompt-lookup / n-gram speculative decoding, no draft model (port of
eagle_tpu/runtime/lookup.py: `NgramCache`, `prompt_lookup_draft`,
`LookupEngine`).

Drafts are proposed on the host from n-gram matches against the context
generated so far (the latest earlier occurrence of the trailing bigram,
then the n-gram table, which learns across calls, as the reference's), and
verified by the target in one forward of K + 1 rows; the greedy acceptance
(the longest prefix of drafts equal to the target's argmax) and the
rollback by tag come after it. So the tokens are plain greedy decoding's;
the drafts change only the speed.

As the chain engine's cycle, a verify is an in-place body over static
tensors: the cache, an input row of [last token, K drafts, n_past] that the
host writes in one copy, and an output row of [K + 1 argmaxes, n_acc] that
it reads in one. On the card it is one CUDA graph per attention-read
bucket (`runtime/graphs.py`); on the CPU, or with `cuda_graphs=False`, the
same body runs eagerly. The prompt runs eagerly through the decode / verify
attention at T = its bucket, as `EagleChainEngine._prefill`."""

from __future__ import annotations

from collections import defaultdict
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..models.config import ModelConfig
from ..models.llama import llama_forward
from .generate import pad_bucket
from .graphs import StepGraphs
from .kvcache import KVCache, causal_mask_from_tags


class NgramCache:
    """Token-sequence n-gram statistics (common/ngram-cache.h analogue)."""

    def __init__(self, n_min: int = 2, n_max: int = 3):
        self.n_min, self.n_max = n_min, n_max
        self.table: dict[tuple, dict[int, int]] = defaultdict(lambda: defaultdict(int))

    def update(self, tokens: list[int]):
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(tokens) - n):
                key = tuple(tokens[i : i + n])
                self.table[key][tokens[i + n]] += 1

    def draft(self, context: list[int], k: int) -> list[int]:
        out: list[int] = []
        ctx = list(context)
        for _ in range(k):
            best = None
            for n in range(self.n_max, self.n_min - 1, -1):
                key = tuple(ctx[-n:])
                cand = self.table.get(key)
                if cand:
                    best = max(cand.items(), key=lambda kv: kv[1])[0]
                    break
            if best is None:
                break
            out.append(best)
            ctx.append(best)
        return out


def prompt_lookup_draft(context: list[int], k: int, ngram: int = 2) -> list[int]:
    """Prompt-lookup: find the latest earlier occurrence of the trailing
    `ngram` and copy what followed it."""
    if len(context) <= ngram:
        return []
    tail = tuple(context[-ngram:])
    for start in range(len(context) - ngram - 1, -1, -1):
        if tuple(context[start : start + ngram]) == tail:
            cont = context[start + ngram : start + ngram + k]
            if cont:
                return list(cont)
    return []


def model_free_prefill(params, cfg: ModelConfig, kv: KVCache, prompt: np.ndarray,
                       compute_dtype, device) -> int:
    """The prompt through the target into `kv` (in place, tags from 0) at
    T = its bucket with the decode / verify attention, as
    `EagleChainEngine._prefill`; returns the argmax of its last row. Rows
    past the cache (padding of a bucket longer than max_seq) write its
    spill slot with tag -1, where the reference's scatter drops them."""
    n, s = len(prompt), kv.max_seq
    t = pad_bucket(n)
    padded = np.zeros((1, t), np.int32)
    padded[0, :n] = prompt
    kv.rollback(torch.zeros((1,), dtype=torch.int32, device=device))
    positions = torch.arange(t, dtype=torch.int32, device=device)[None, :]
    slots = torch.where(positions < s, positions, s)
    kv.with_tags(slots, positions, valid=(positions < n) & (positions < s))
    mask = causal_mask_from_tags(kv.slot_pos, positions)
    out = llama_forward(params, cfg, torch.from_numpy(padded).to(device), positions, kv, slots,
                        mask, compute_dtype=compute_dtype, kv_limit=min(s, max(t, 128)),
                        slots_contiguous=True)
    return int(torch.argmax(out.logits[0, n - 1]))


class LookupEngine:
    """Target-only speculative decoding with host-proposed drafts."""

    def __init__(
        self,
        params: dict[str, Any],
        cfg: ModelConfig,
        *,
        n_draft: int = 8,
        max_seq: int = 2048,
        kv_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        eos_id: int = 2,
        use_ngram_cache: bool = True,
        device="cuda",
        cuda_graphs: bool = True,  # replay each verify as a CUDA graph on the card
    ):
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.K = n_draft
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.compute_dtype = compute_dtype
        self.kv_dtype = kv_dtype
        self.ngram = NgramCache() if use_ngram_cache else None
        self.kv = KVCache.create(cfg.n_layers, 1, max_seq, cfg.n_kv_heads, cfg.head_dim,
                                 dtype=kv_dtype, device=self.device, spill=1)
        k1, dev = n_draft + 1, self.device
        self._in = torch.zeros((k1 + 1,), dtype=torch.int32, device=dev)  # [x_m, drafts, m]
        self._out = torch.zeros((k1 + 1,), dtype=torch.int32, device=dev)  # [t_true, n_acc]
        self._offs = torch.arange(k1, dtype=torch.int32, device=dev)
        self.graphs = StepGraphs(cuda_graphs and dev.type == "cuda")

    def kv_read_bucket(self, slot_end: int) -> int:
        """Attention-read bound covering cache slots < slot_end."""
        return min(self.max_seq, pad_bucket(slot_end, 128))

    def _verify(self, kv_limit: int) -> None:
        """The verify in place: [x_m, d_1..d_K] at positions m..m+K through
        the target, the greedy acceptance, the rollback to m + n_acc + 1;
        the target's argmaxes and n_acc into the output row."""
        k1 = self.K + 1
        v_tokens = self._in[None, :k1]
        v_pos = self._in[k1] + self._offs[None, :]
        kv = self.kv.with_tags(v_pos, v_pos)
        mask = causal_mask_from_tags(kv.slot_pos, v_pos)
        out = llama_forward(self.params, self.cfg, v_tokens, v_pos, kv, v_pos, mask,
                            compute_dtype=self.compute_dtype, kv_limit=kv_limit,
                            slots_contiguous=True)
        t_true = torch.argmax(out.logits, dim=-1).to(torch.int32)  # [1, K+1]
        match = v_tokens[:, 1:] == t_true[:, :-1]
        n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        kv.rollback(keep_below=self._in[k1:] + n_acc + 1)
        self._out[:k1].copy_(t_true[0])
        self._out[k1:].copy_(n_acc)

    def _cycle(self, last: int, drafts: list[int], m: int) -> list[int]:
        """One verify of `drafts` after `last` at n_past `m`: the input row in
        one copy, the body (a graph replay on the card), the output row in
        one read. Returns [t_true (K + 1), n_acc]."""
        self._in.copy_(torch.tensor([last, *drafts, m], dtype=torch.int32))
        self._replay(self.kv_read_bucket(m + self.K + 1))
        return self._out.tolist()

    def _replay(self, lim: int) -> None:
        """The verify body on the input row as it stands, reading slots <
        `lim`: a graph replay on the card (the first call of a bucket runs
        it eagerly, then captures it)."""
        static = (*self.kv.tensors(), self._in, self._out, self._offs)
        self.graphs.run(("verify", lim), lambda: self._verify(lim), static)

    def generate(self, prompt_tokens, max_new_tokens: int = 128, stop_at_eos: bool = True,
                 on_token=None) -> tuple[list[int], dict]:
        """Greedy generation with host-proposed drafts; returns (tokens, stats)
        with the reference's counts. `on_token` is called with each output
        token as it is known (the other engines' callback)."""
        prompt = [int(x) for x in prompt_tokens]
        n = len(prompt)
        if n < 1:
            raise ValueError("generate needs a prompt of at least one token")
        first = model_free_prefill(self.params, self.cfg, self.kv, np.asarray(prompt, np.int32),
                                   self.compute_dtype, self.device)
        if self.ngram:
            self.ngram.update(prompt)
        context = prompt + [first]
        out = [first]
        if on_token:
            on_token(first)
        m = n
        stats = {"n_cycles": 0, "n_drafted": 0, "n_accepted": 0}
        while len(out) < max_new_tokens and not (stop_at_eos and out[-1] == self.eos_id):
            if m + self.K + 2 >= self.max_seq:
                break
            drafts = prompt_lookup_draft(context, self.K)
            if self.ngram and len(drafts) < self.K:
                drafts += self.ngram.draft(context + drafts, self.K - len(drafts))
            drafts = (drafts + [0] * self.K)[: self.K]
            res = self._cycle(context[-1], drafts, m)
            na = res[self.K + 1]
            stats["n_cycles"] += 1
            stats["n_drafted"] += self.K
            stats["n_accepted"] += na
            for tk in res[: na + 1]:
                out.append(tk)
                context.append(tk)
                if on_token:
                    on_token(tk)
                if self.ngram:
                    self.ngram.update(context[-5:])
                if (stop_at_eos and tk == self.eos_id) or len(out) >= max_new_tokens:
                    break
            m = m + na + 1
        stats["accept_rate"] = stats["n_accepted"] / max(1, stats["n_drafted"])
        stats["mean_accept_len"] = (stats["n_accepted"] + stats["n_cycles"]) / max(
            1, stats["n_cycles"]
        )
        return out, stats

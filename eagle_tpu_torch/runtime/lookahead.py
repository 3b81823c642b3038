"""Lookahead decoding: model-free speculation through Jacobi-iteration
n-grams (port of eagle_tpu/runtime/lookahead.py: `_Layout`,
`LookaheadEngine` with `_step` and `generate`).

A step feeds one batch of T = 1 + G(N-1) + (W-1) + (N-2)W rows: the input
token, G verification n-grams from the pool, and the W x (N-1) lookahead
window, under the lookahead visibility mask (the committed prefix, plus the
static window pattern among the step's own rows). The greedy verification
walk accepts the longest gram that the target's argmaxes confirm, the
accepted rows' K/V move into committed slots (`tree._compact_kv`) and the
window's tags are wiped. The n-gram pool and the Jacobi window stay on the
host, as in the reference: O(W N) integer work between steps.

The step is one in-place body over static tensors: the cache (the step's
rows live in its last T slots), an input row that the host writes in one
copy (the input token, the grams, the window, which grams are live,
n_past), and an output row it reads in one (the N candidates, how many are
real, the deepest level's W argmaxes). The accepted count stays on the
device until the replay has ended. On the card the body is one CUDA graph
(`runtime/graphs.py`); on the CPU, or with `cuda_graphs=False`, it runs
eagerly. The attention reads the whole cache (its mask spans it, window
included). The prompt runs eagerly through the decode / verify attention
at T = its bucket (`lookup.model_free_prefill`).

Decoding is greedy, so the output is plain greedy decoding's tokens; the
pool only changes the speed."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..models.config import ModelConfig
from ..models.llama import llama_forward
from .graphs import StepGraphs
from .kvcache import KVCache
from .lookup import model_free_prefill
from .tree import _compact_kv


class _Layout:
    """Static row layout of one lookahead step's batch.

    Row order (lookahead.cpp:208-258): input token, then G x (N-1)
    verification rows (gram g, token j at row 1 + g(N-1) + j), then level-0
    columns 1..W-1, then levels 1..N-2 x columns 0..W-1."""

    def __init__(self, W: int, N: int, G: int):
        if N < 3 or W < 2 or G < 1:
            raise ValueError(
                f"lookahead needs N >= 3, W >= 2, G >= 1 (got W={W}, N={N}, G={G})"
            )
        self.W, self.N, self.G = W, N, G
        self.v_rows = 1 + G * (N - 1)
        self.T = self.v_rows + (W - 1) + (N - 2) * W

        pos_off = np.zeros(self.T, np.int32)
        vis = np.eye(self.T, dtype=bool)
        vis[:, 0] = True  # the input token is visible to every row
        for g in range(G):
            for j in range(N - 1):
                r = 1 + g * (N - 1) + j
                pos_off[r] = j + 1
                for j2 in range(j):
                    vis[r, 1 + g * (N - 1) + j2] = True
        self.a0 = lambda i: self.v_rows + (i - 1)  # level-0 column i (1..W-1)
        self.aj = lambda j, i: self.v_rows + (W - 1) + (j - 1) * W + i
        for i in range(1, W):
            r = self.a0(i)
            pos_off[r] = i
            for i2 in range(1, i):
                vis[r, self.a0(i2)] = True
        for j in range(1, N - 1):
            for i in range(W):
                r = self.aj(j, i)
                pos_off[r] = j + i
                for i2 in range(1, i + 1):
                    vis[r, self.a0(i2)] = True
                for j2 in range(1, j):
                    vis[r, self.aj(j2, i)] = True
        self.pos_off = pos_off
        self.visible = vis
        self.gram_row0 = 1  # rows of gram g start at 1 + g*(N-1)
        self.lastlvl_rows = np.asarray(
            [self.aj(N - 2, i) for i in range(W)], np.int32
        )
        # verification row of gram g, token index j (0-based within the gram)
        self.gram_rows = np.asarray(
            [[1 + g * (N - 1) + j for j in range(N - 1)] for g in range(G)],
            np.int32,
        )

    def token_source(self) -> np.ndarray:
        """[T] index of each row's token in the step's input row [cur, grams
        (G x (N-1), row-major), window (N-1 x W, row-major), ...]: the
        reference's scatter of the input token, the grams, level 0's
        columns 1..W-1 and levels 1..N-2 into the token row, as one gather."""
        W, N, G = self.W, self.N, self.G
        src = np.zeros(self.T, np.int64)
        src[self.gram_rows.reshape(-1)] = 1 + np.arange(G * (N - 1))
        win = 1 + G * (N - 1)
        for i in range(1, W):
            src[self.a0(i)] = win + i
        for j in range(1, N - 1):
            for i in range(W):
                src[self.aj(j, i)] = win + j * W + i
        return src


class LookaheadEngine:
    """Single-sequence lookahead decoding (W window, N gram size, G pool).

    Defaults follow lookahead.cpp:47-49 scaled for the batch row budget."""

    def __init__(
        self,
        params: dict[str, Any],
        cfg: ModelConfig,
        *,
        W: int = 8,
        N: int = 4,
        G: int = 8,
        max_seq: int = 2048,
        kv_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        eos_id: int = 2,
        device="cuda",
        cuda_graphs: bool = True,  # replay each step as a CUDA graph on the card
    ):
        self.device = dev = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.lay = lay = _Layout(W, N, G)
        if max_seq <= lay.T:
            raise ValueError(f"max_seq {max_seq} leaves no room beside the step's {lay.T} rows")
        self.max_seq = max_seq
        self.compute_dtype = compute_dtype
        self.eos_id = eos_id
        self.kv_dtype = kv_dtype
        self.kv = KVCache.create(cfg.n_layers, 1, max_seq, cfg.n_kv_heads, cfg.head_dim,
                                 dtype=kv_dtype, device=dev, spill=1)
        T, base = lay.T, max_seq - lay.T

        def const(a, dtype=torch.int32):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        self._vis = const(lay.visible, torch.bool)
        self._pos_off = const(lay.pos_off)[None, :]
        self._gram_rows = const(lay.gram_rows, torch.int64)
        self._lastlvl_rows = const(lay.lastlvl_rows, torch.int64)
        self._tok_src = const(lay.token_source(), torch.int64)
        # row r's liveness is ok_src[r] of [True, g_active...]: a gram row
        # takes its gram's, every other row is live
        ok_src = np.zeros(T, np.int64)
        ok_src[lay.gram_rows.reshape(-1)] = 1 + np.repeat(np.arange(G), N - 1)
        self._ok_src = const(ok_src, torch.int64)
        self._slots = (base + torch.arange(T, dtype=torch.int32, device=dev))[None, :]
        self._committed = torch.arange(max_seq, dtype=torch.int32, device=dev) < base
        self._cols = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
        # input row: [cur, grams G x (N-1), window (N-1) x W, g_active G, n_past]
        self._n_in = 1 + G * (N - 1) + (N - 1) * W + G + 1
        self._in = torch.zeros((self._n_in,), dtype=torch.int32, device=dev)
        # output row: [N candidates, n_out, W deepest-level argmaxes]
        self._out = torch.zeros((N + 1 + W,), dtype=torch.int32, device=dev)
        self.graphs = StepGraphs(cuda_graphs and dev.type == "cuda")

    def _consts(self) -> tuple[torch.Tensor, ...]:
        return (self._vis, self._pos_off, self._gram_rows, self._lastlvl_rows, self._tok_src,
                self._ok_src, self._slots, self._committed, self._cols)

    # ------------------------------------------------------------------

    def _step(self) -> None:
        """One lookahead step in place on the engine's cache, from the input
        row to the output row."""
        lay, kv = self.lay, self.kv
        W, N, G, T = lay.W, lay.N, lay.G, lay.T
        base, s = self.max_seq - T, self.max_seq
        n_gram = G * (N - 1)
        inp = self._in
        cur = inp[:1]
        grams = inp[1:1 + n_gram].view(G, N - 1)
        win_end = 1 + n_gram + (N - 1) * W
        g_active = inp[win_end:win_end + G] != 0
        n_past = inp[win_end + G:]

        # ---- the step's token row, positions and tags ----
        toks = inp[self._tok_src][None, :]  # [1, T]
        positions = n_past[:, None] + self._pos_off
        # rows of inactive grams get invalid tags: they write K/V into the
        # window's slots, are invisible, and the window is wiped afterwards
        row_ok = torch.cat([torch.ones_like(g_active[:1]), g_active])[self._ok_src]  # [T]
        kv.with_tags(self._slots, positions, valid=row_ok[None, :])

        # ---- lookahead mask: committed prefix, then the static window ----
        tags = kv.slot_pos[:, :s]
        committed = (tags >= 0) & self._committed[None, :]
        mask = committed[:, None, :] & (tags[:, None, :] <= positions[:, :, None])  # [1, T, S]
        mask[:, :, base:] = (self._vis & row_ok[None, :])[None]

        out = llama_forward(self.params, self.cfg, toks, positions, kv, self._slots, mask,
                            compute_dtype=self.compute_dtype, kv_limit=s,
                            slots_contiguous=True)
        logits = out.logits[0]  # [T, V]

        # ---- greedy verification walk (lookahead.cpp:265-311) ----
        id1 = torch.argmax(logits[0], dim=-1).to(torch.int32)
        ids = [id1]
        src_rows = [torch.zeros_like(self._gram_rows[0, 0])]
        active = g_active & (grams[:, 0] == id1)
        n_acc = torch.zeros((), dtype=torch.int32, device=self.device)
        for v in range(1, N):
            any_hit = active.any()
            # the first live match; gathers, not a tensor index (which would
            # read it on the host, and no capture takes a host read)
            g_star = torch.argmax(active.to(torch.int32)).view(1)
            row = self._gram_rows[:, v - 1].gather(0, g_star)  # [1]
            idv = torch.argmax(logits.index_select(0, row)[0], dim=-1).to(torch.int32)
            ids.append(torch.where(any_hit, idv, 0))
            src_rows.append(torch.where(any_hit, row[0], 0))
            n_acc = n_acc + any_hit.to(torch.int32)
            if v < N - 1:
                active = active & (grams[:, v] == idv)
            else:
                active = torch.zeros_like(active)

        # ---- compact the accepted rows into committed slots, wipe the window ----
        src = base + torch.stack(src_rows)[None, :]  # [1, N]
        dst = n_past[:, None] + self._cols
        _compact_kv(kv, src, dst, self._cols <= n_acc)
        kv.slot_pos[:, base:s] = -1

        lastlvl = torch.argmax(logits[self._lastlvl_rows], dim=-1).to(torch.int32)
        self._out[:N].copy_(torch.stack(ids))
        self._out[N].copy_(n_acc + 1)
        self._out[N + 1:].copy_(lastlvl)

    def _run_step(self, cur: int, tokens_j: np.ndarray, grams: np.ndarray,
                  g_active: np.ndarray, n_past: int) -> np.ndarray:
        """One step: the input row in one copy, the body (a graph replay on
        the card), the output row in one read."""
        row = np.concatenate([[cur], grams.reshape(-1), tokens_j.reshape(-1),
                              g_active.astype(np.int32), [n_past]]).astype(np.int32)
        self._in.copy_(torch.from_numpy(row))
        self._replay()
        return self._out.cpu().numpy()

    def _replay(self) -> None:
        """The step body on the input row as it stands: a graph replay on
        the card (the first call runs it eagerly, then captures it)."""
        static = (*self.kv.tensors(), self._in, self._out, *self._consts())
        self.graphs.run(("step",), self._step, static)

    # ------------------------------------------------------------------

    def generate(
        self,
        prompt_tokens,
        max_new_tokens: int = 128,
        stop_at_eos: bool = True,
        on_token=None,
        seed: int = 0,  # accepted for engine-API parity; greedy decode ignores it
    ) -> tuple[list[int], dict]:
        """Greedy lookahead generation; returns (tokens, stats)."""
        lay = self.lay
        W, N, G = lay.W, lay.N, lay.G
        prompt = np.asarray(prompt_tokens, np.int32)
        n = len(prompt)
        if n < 1:
            raise ValueError("generate needs a prompt of at least one token")
        cur = model_free_prefill(self.params, self.cfg, self.kv, prompt, self.compute_dtype,
                                 self.device)
        out = [cur]
        if on_token:
            on_token(cur)

        # host state: Jacobi window + n-gram pool (lookahead.cpp:125-152)
        rng = np.random.default_rng(0)
        tokens_j = np.empty((N - 1, W), np.int32)
        for j in range(N - 1):
            # the window starts from prompt tokens (the reference's other
            # documented choice beside 100+i): they converge faster on
            # repetitive text
            tokens_j[j] = prompt[rng.integers(0, n, size=W)]
        pool_cnt = np.zeros(self.cfg.vocab_size, np.int32)
        pool_head = np.zeros(self.cfg.vocab_size, np.int32)
        pool = np.zeros((self.cfg.vocab_size, G, N - 1), np.int32)

        n_past = n
        n_predict = 1
        n_accept = 0
        n_steps = 0
        while n_predict < max_new_tokens and not (stop_at_eos and out[-1] == self.eos_id):
            if n_past + N + 1 >= self.max_seq - lay.T:
                break
            # active verification grams for `cur` from the pool
            g_cur = int(pool_cnt[cur])
            g_active = np.zeros(G, bool)
            g_active[:g_cur] = True

            res = self._run_step(cur, tokens_j, pool[cur], g_active, n_past)
            toks, k, lastlvl = res[:N], int(res[N]), res[N + 1:]
            n_steps += 1
            n_accept += k - 1

            # per accepted token: emit + Jacobi shift + pool update
            # (lookahead.cpp:350-430)
            for v in range(k):
                tok = int(toks[v])
                out.append(tok)
                n_predict += 1
                n_past += 1
                if on_token:
                    on_token(tok)
                if (stop_at_eos and tok == self.eos_id) or n_predict >= max_new_tokens:
                    break
                tokens_j_prev = tokens_j[0].copy()
                tokens_j[:-1] = tokens_j[1:]
                tokens_j[-1] = lastlvl if v == 0 else tokens_j[0]
                if v == 0:
                    for f in range(W):
                        ft = int(tokens_j_prev[f])
                        ngram = tokens_j[:, f]
                        existing = pool[ft, : pool_cnt[ft]]
                        if (existing == ngram).all(axis=1).any():
                            continue
                        head = pool_head[ft]
                        pool[ft, head] = ngram
                        pool_cnt[ft] = min(G, pool_cnt[ft] + 1)
                        pool_head[ft] = (head + 1) % G
            cur = out[-1]

        stats = {
            "n_steps": n_steps,
            "n_predict": n_predict,
            "n_accept": n_accept,
            "tokens_per_step": n_predict / max(1, n_steps),
        }
        return out, stats

"""EAGLE-2 dynamic draft trees (port of eagle_tpu/runtime/tree2.py:
`_window_tree_mask` and `EagleTree2Engine` with its `_tree2_cycle`).

Each level expands only the globally most probable nodes (beam search over
cumulative draft log-probs), then the verify pass reranks ALL drafted
candidates and submits the top N in one tree-mask forward. Beam width M,
depth D and verify budget N are static; the topology lives in data
(parent pointers and ancestor bitmaps built on the device).

Candidate table (W = 1 + D*M entries): id 0 is the root (the cycle's input
token), ids 1+(d-1)*M .. d*M the M beam nodes of depth d. Draft slot of
candidate g = (m-1) + g; verify slot of selected row j = m + j. Level-D
nodes are drafted but never forwarded through the draft head.

The reference's `approx_max_k` (exact on the CPU) and `top_k` both become
`sampling.top_k`: exact, lower index first on ties. The rerank stays closed
under ancestors through that order: once the scores fall below about -16
to -32, the 1e-6-per-depth nudge rounds away and a child confidently
drafted ties its parent, which must then come first.

The cycle is an in-place body over the engine's one `SpecState`; C > 1
cycles per dispatch run through the base `_multi_cycle` (the reference's
`_tree2_multi`)."""

from __future__ import annotations

import numpy as np
import torch

from ..models.eagle import eagle_forward
from ..models.llama import llama_forward
from .kvcache import causal_mask_from_tags
from .sampling import draw, top_k
from .speculative import CycleOutput, EagleChainEngine, SpecState
from .tree import _compact_kv, _emit


def _window_tree_mask(
    slot_pos: torch.Tensor,  # [B, S] cache tags
    q_pos: torch.Tensor,  # [B, T] query rope positions
    base: torch.Tensor,  # [B] slot of window element 0
    vis: torch.Tensor,  # [B, T, W] within-window visibility (ancestor bitmaps)
) -> torch.Tensor:
    """Committed slots (tagged, strictly below the window) OR window slots
    the per-row bitmap allows: `tree._tree_mask` with the ancestor matrix
    as data."""
    b, s = slot_pos.shape
    t, w = vis.shape[1], vis.shape[2]
    s_iota = torch.arange(s, dtype=torch.int32, device=slot_pos.device)[None, :]
    committed = (slot_pos >= 0) & (s_iota < base[:, None])  # [B, S]
    causal = committed[:, None, :] & (slot_pos[:, None, :] <= q_pos[:, :, None])
    rel = s_iota - base[:, None]  # [B, S]
    in_win = (rel >= 0) & (rel < w)
    rel_c = rel.clamp(0, w - 1).long()
    win = vis.gather(2, rel_c[:, None, :].expand(b, t, s)) & in_win[:, None, :]
    return causal | win


class EagleTree2Engine(EagleChainEngine):
    """EAGLE-2 beam-expanded, reranked tree speculation.

    beam:     nodes expanded per level (M)
    depth:    draft tree depth (D levels below the root)
    n_verify: candidate rows in the verify forward (N, root included;
              N <= 1 + D*beam)

    `K` is the draft window W = 1 + D*M, as in the reference (generate()'s
    overflow margin and `n_drafted` per cycle); a cycle's output row is
    D + 1 wide."""

    def __init__(self, *args, beam: int = 8, depth: int = 6, n_verify: int = 32, **kwargs):
        kwargs.setdefault("n_draft", 0)
        super().__init__(*args, **kwargs)
        self.M, self.D = int(beam), int(depth)
        self.W = 1 + self.D * self.M
        self.N = min(int(n_verify), self.W)
        if self.M < 1 or self.D < 1 or self.N < 2:
            raise ValueError(f"beam {beam}, depth {depth}, n_verify {n_verify}")
        self.K = self.W
        self.out_width = self.D + 1
        depth_t = np.asarray([0] + [d + 1 for d in range(self.D) for _ in range(self.M)], np.int32)
        self._depth_t = torch.from_numpy(depth_t).to(self.device)
        # the rerank's tie-break, 1e-6 per depth, rounded to f32 as the reference's
        nudge = np.float32(1e-6) * depth_t.astype(np.float32)
        self._nudge = torch.from_numpy(nudge).to(self.device)

    def _cycle(self, state: SpecState, out: CycleOutput, ci: int,
               kv_limit: int | None = None) -> None:
        """One EAGLE-2 cycle (the reference's `_tree2_cycle`):
        advances `state` in place and writes row `ci` of `out`'s buffers."""
        b, M, D, W, N = self.batch, self.M, self.D, self.W, self.N
        dev = self.device
        b_idx = torch.arange(b, device=dev)
        m = state.n_past  # [B]; overwritten last
        db = m - 1  # [B] draft slot of the root pair
        w_iota = torch.arange(W, device=dev)

        cand_tok = torch.zeros((b, W), dtype=torch.int32, device=dev)
        cand_tok[:, 0] = state.last_token
        cand_par = torch.full((b, W), -1, dtype=torch.int64, device=dev)
        cand_score = torch.full((b, W), float("-inf"), dtype=torch.float32, device=dev)
        cand_score[:, 0] = 0.0
        anc = torch.zeros((b, W, W), dtype=torch.bool, device=dev)  # ancestor-or-self rows
        anc[:, 0, 0] = True

        # ---- level 0: forward the root pair, seed the beam ----
        dkv = state.dft_kv.with_tags(db[:, None], db[:, None])
        mask0 = causal_mask_from_tags(dkv.slot_pos, db[:, None])
        dout = eagle_forward(
            self.dp, self.tp, self.dcfg, state.last_token[:, None], state.feature[:, None],
            db[:, None], dkv, db[:, None], mask0, compute_dtype=self.compute_dtype,
            kv_limit=kv_limit, slots_contiguous=True,
        )
        root_feat = self._pick_feature(dout.feature, dout.feature_pre)[:, 0]
        bscore, btok = top_k(torch.log_softmax(dout.logits[:, 0].float(), dim=-1), M)
        bpar = torch.zeros((b, M), dtype=torch.int64, device=dev)  # level 1's parent: the root
        bfeat = root_feat[:, None].expand(b, M, root_feat.shape[-1])

        # ---- levels 1..D: record the beam; forward and expand while d < D ----
        for d in range(1, D + 1):
            lo, hi = 1 + (d - 1) * M, 1 + d * M
            cand_tok[:, lo:hi] = btok.to(torch.int32)
            cand_par[:, lo:hi] = bpar
            cand_score[:, lo:hi] = bscore
            # a child's bitmap = its parent's (already in the table) + itself
            rows = anc.gather(1, bpar[:, :, None].expand(b, M, W))  # [B, M, W]
            rows = rows | (w_iota[None, None, :] == w_iota[lo:hi][None, :, None])
            anc[:, lo:hi] = rows
            if d == D:
                break  # the last level is drafted, not expanded

            pos = (db + d)[:, None].expand(b, M)  # rope position of every level-d node
            slots = db[:, None] + w_iota[lo:hi][None, :]
            dkv.with_tags(slots, pos)
            mask = _window_tree_mask(dkv.slot_pos, pos, db, rows)
            dout = eagle_forward(
                self.dp, self.tp, self.dcfg, btok, bfeat, pos, dkv, slots, mask,
                compute_dtype=self.compute_dtype, kv_limit=kv_limit, slots_contiguous=True,
            )
            feat = self._pick_feature(dout.feature, dout.feature_pre)
            cvals, cidx = top_k(torch.log_softmax(dout.logits.float(), dim=-1), M)  # [B, M, M]
            flat_scores = (bscore[:, :, None] + cvals).reshape(b, M * M)
            bscore, flat = top_k(flat_scores, M)  # the global best M
            prow = flat // M  # beam row of each chosen child's parent
            btok = cidx.reshape(b, M * M).gather(1, flat)
            bpar = lo + prow
            bfeat = feat.gather(1, prow[:, :, None].expand(b, M, feat.shape[-1]))

        # ---- rerank: top-N candidates by cumulative score, in level order ----
        _, sidx = top_k(cand_score - self._nudge[None, :], N)
        sel = torch.sort(sidx, dim=1).values  # row 0 is always the root

        # ---- one tree-mask verify forward over the selected rows ----
        vt = cand_tok.gather(1, sel)  # [B, N]
        v_pos = m[:, None] + self._depth_t[sel]
        v_slots = m[:, None] + torch.arange(N, dtype=torch.int32, device=dev)[None, :]
        rows = anc.gather(1, sel[:, :, None].expand(b, N, W))
        vis = rows.gather(2, sel[:, None, :].expand(b, N, N))  # anc[sel_q, sel_k]
        tgt_kv = state.tgt_kv.with_tags(v_slots, v_pos)
        mask = _window_tree_mask(tgt_kv.slot_pos, v_pos, m, vis)
        tout = llama_forward(
            self.tp, self.tcfg, vt, v_pos, tgt_kv, v_slots, mask,
            compute_dtype=self.compute_dtype, kv_limit=kv_limit, slots_contiguous=True,
        )
        # the target's decision per node: its argmax, or one draw of the
        # sampler chain, then the exact-match walk below. Sample-then-match
        # keeps the output distributed as plain sampling: the expansion is a
        # deterministic top-k, so a node proposes a fixed candidate set C,
        # and no distribution-preserving scheme accepts with more than
        # P(x in C), which the draw and the match reach.
        t_true = draw(tout.logits, self.scfg, state.rng)  # [B, N]

        # ---- acceptance walk over the dynamic topology ----
        sel_par = cand_par.gather(1, sel)  # [B, N] parents' candidate ids
        cur = torch.zeros((b,), dtype=torch.int64, device=dev)  # verify row, from the root
        alive = torch.ones((b,), dtype=torch.bool, device=dev)
        n_acc = torch.zeros((b,), dtype=torch.int32, device=dev)
        path = [cur]
        for _ in range(D):
            want = t_true[b_idx, cur]
            hit = (sel_par == sel[b_idx, cur][:, None]) & (vt == want[:, None])  # [B, N]
            any_hit = hit.any(dim=1) & alive
            cur = torch.where(any_hit, hit.to(torch.int32).argmax(dim=1), cur)
            n_acc = n_acc + any_hit.to(torch.int32)
            alive = any_hit
            path.append(cur)
        path = torch.stack(path, dim=1)  # [B, D + 1] verify rows

        new_m = m + n_acc + 1
        bonus = t_true[b_idx, cur]
        new_feature = self._pick_feature(tout.hidden, tout.hidden_pre)[b_idx, cur]

        # ---- compact the accepted rows into contiguous slots ----
        depth_iota = torch.arange(D + 1, dtype=torch.int32, device=dev)[None, :]
        keep = depth_iota <= n_acc[:, None]
        _compact_kv(tgt_kv, m[:, None] + path, m[:, None] + depth_iota, keep)
        _compact_kv(dkv, db[:, None] + sel.gather(1, path), db[:, None] + depth_iota, keep)
        tgt_kv.rollback(keep_below=new_m)
        dkv.rollback(keep_below=new_m - 1)

        out.tokens[ci].copy_(_emit(vt, path, n_acc, bonus))
        out.n_out[ci].copy_(n_acc + 1)
        out.n_accepted[ci].copy_(n_acc)
        state.last_token.copy_(bonus)
        state.feature.copy_(new_feature)
        state.n_past.copy_(new_m)

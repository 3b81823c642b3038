"""EAGLE tree speculation (port of eagle_tpu/runtime/tree.py:
`TreeSpec`, `_tree_mask`, `_compact_kv` and `EagleTreeEngine` with its
`_tree_cycle`).

A cycle drafts a static token tree level by level with the EAGLE head (one
draft forward over all nodes of a level, each attending to the committed
prefix and its own ancestors), verifies root and every node in ONE target
forward under the same ancestor mask, walks the tree greedily to the
longest path whose tokens the target predicts, copies the accepted path's
K/V rows into contiguous slots and rolls the rest back by tag rewrite.

As in the chain engine, a cycle is an in-place body over the engine's one
`SpecState`, and `generate(..., cycles_per_dispatch=C)` chains C of them in
one dispatch (one CUDA graph per (C, read bucket) on the card). The
reference's engine does not override `_multi_cycle`, so at C > 1 it scans
the CHAIN cycle with K = n_nodes drafts; here `_multi_cycle` chains this
tree cycle, so a run at any C gives the C = 1 run's tokens and stats."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.eagle import eagle_forward
from ..models.llama import llama_forward
from .kvcache import KVCache
from .sampling import draw, top_k
from .speculative import CycleOutput, EagleChainEngine, SpecState


class TreeSpec:
    """Static tree topology. Node 0 is the root (the cycle's input token);
    speculative nodes are numbered level by level, so each level is a
    contiguous range of ids."""

    def __init__(self, branching: tuple[int, ...] = (4, 2, 2)):
        self.branching = tuple(branching)
        parents = [-1]  # root
        depth = [0]
        level_nodes: list[list[int]] = [[0]]
        for d, b in enumerate(self.branching):
            new_level = []
            for p in level_nodes[d]:
                for _ in range(b):
                    new_level.append(len(parents))
                    parents.append(p)
                    depth.append(d + 1)
            level_nodes.append(new_level)
        self.parent = np.asarray(parents, np.int32)
        self.depth = np.asarray(depth, np.int32)
        self.n_nodes = len(parents)  # includes root
        self.levels = level_nodes  # node ids per level
        self.max_depth = len(self.branching)

        # ancestor[i, j] = node j is an ancestor of i, or i == j
        anc = np.eye(self.n_nodes, dtype=bool)
        for i in range(self.n_nodes):
            p = self.parent[i]
            while p >= 0:
                anc[i, p] = True
                p = self.parent[p]
        self.ancestor = anc

        self.children: list[list[int]] = [[] for _ in range(self.n_nodes)]
        for i in range(1, self.n_nodes):
            self.children[self.parent[i]].append(i)
        self.max_children = max((len(c) for c in self.children), default=0)
        self.child_mat = np.full((self.n_nodes, self.max_children), -1, np.int32)
        for i, cs in enumerate(self.children):
            self.child_mat[i, : len(cs)] = cs


def _tree_mask(
    slot_pos: torch.Tensor,  # [B, S] tags
    q_pos: torch.Tensor,  # [B, T] query rope positions
    base: torch.Tensor,  # [B] first node slot (slot of node 0)
    node_ids: torch.Tensor,  # [T] node id of each query row
    ancestor: torch.Tensor,  # [N, N] bool
    n_nodes: int,
) -> torch.Tensor:
    """Visibility [B, T, S]: committed slots by position tag (strictly
    before the node window) OR ancestor nodes inside the window."""
    b, s = slot_pos.shape
    t = node_ids.shape[0]
    s_iota = torch.arange(s, dtype=torch.int32, device=slot_pos.device)[None, :]
    committed = (slot_pos >= 0) & (s_iota < base[:, None])  # [B, S]
    causal = committed[:, None, :] & (slot_pos[:, None, :] <= q_pos[:, :, None])
    rel = s_iota - base[:, None]  # [B, S] node index of each slot (if in the window)
    in_win = (rel >= 0) & (rel < n_nodes)
    rel_c = rel.clamp(0, n_nodes - 1).long()
    anc_rows = ancestor[node_ids.long()]  # [T, N]: which nodes each query may see
    tree_part = anc_rows[None].expand(b, t, n_nodes).gather(
        2, rel_c[:, None, :].expand(b, t, s)) & in_win[:, None, :]
    return causal | tree_part


def _compact_kv(kv: KVCache, src: torch.Tensor, dst: torch.Tensor,
                keep: torch.Tensor) -> KVCache:
    """In place: copy K/V rows src -> dst per batch row where keep, and move
    their position tags. src/dst/keep: [B, P]; each row's dst is a run of P
    distinct slots (accepted depth d lands at base + d). All P source rows
    are read before the run is written, and a row with keep False writes
    back its dst slot's current content, so an in-window permutation is
    safe; a dropped row's tag write goes to its own src slot (no-op). An
    int8 cache's scale planes move with their rows."""
    b, p = src.shape
    src, dst = src.long(), dst.long()
    for buf in (kv.k, kv.v, kv.k_scale, kv.v_scale):  # [L, B, H, S(, D)]
        if buf is None:
            continue
        tail = (None,) * (buf.dim() - 4)
        shape = (buf.shape[0], b, buf.shape[2], p) + tuple(buf.shape[4:])
        rows = buf.gather(3, src[(None, slice(None), None, slice(None)) + tail].expand(shape))
        at = dst[(None, slice(None), None, slice(None)) + tail].expand(shape)
        k = keep[(None, slice(None), None, slice(None)) + tail]
        buf.scatter_(3, at, torch.where(k, rows, buf.gather(3, at)))
    tags = kv.slot_pos.gather(1, src)
    kv.slot_pos.scatter_(1, torch.where(keep, dst, src), tags)
    return kv


def _emit(tokens: torch.Tensor, path: torch.Tensor, n_acc: torch.Tensor,
          bonus: torch.Tensor) -> torch.Tensor:
    """A cycle's output row [B, depth + 1]: the accepted path's tokens
    (`tokens` [B, ·] gathered at `path[:, 1:]`) for columns < n_acc, the
    bonus token at n_acc, zeros beyond."""
    col = torch.arange(path.shape[1], device=path.device)[None, :]
    accepted = F.pad(tokens.gather(1, path[:, 1:]), (0, 1))
    return torch.where(col < n_acc[:, None], accepted,
                       torch.where(col == n_acc[:, None], bonus[:, None], 0))


class EagleTreeEngine(EagleChainEngine):
    """Tree-drafting variant; shares prefill, state, dispatch and
    `generate` with the chain engine. `K` is the slot window (n_nodes), as
    in the reference: generate()'s overflow margin and `n_drafted` per
    cycle; a cycle's output row is max_depth + 1 wide."""

    def __init__(self, *args, tree: TreeSpec | None = None, **kwargs):
        kwargs.setdefault("n_draft", 0)
        super().__init__(*args, **kwargs)
        self.tree = tree or TreeSpec()
        self.K = self.tree.n_nodes
        self.out_width = self.tree.max_depth + 1
        dev = self.device
        self._anc = torch.from_numpy(self.tree.ancestor).to(dev)
        self._depth = torch.from_numpy(self.tree.depth).to(dev)
        self._child_mat = torch.from_numpy(self.tree.child_mat).long().to(dev)
        self._ids = torch.arange(self.tree.n_nodes, dtype=torch.int32, device=dev)

    def _cycle(self, state: SpecState, out: CycleOutput, ci: int,
               kv_limit: int | None = None) -> None:
        """One tree cycle (the reference's `_tree_cycle`): advances
        `state` in place and writes row `ci` of `out`'s buffers."""
        tree, b, dev = self.tree, self.batch, self.device
        n = tree.n_nodes
        b_idx = torch.arange(b, device=dev)
        m = state.n_past  # [B]; overwritten last

        node_tokens = torch.zeros((b, n), dtype=torch.int32, device=dev)
        node_tokens[:, 0] = state.last_token
        node_feats = torch.zeros((b, n, self.tcfg.n_embd), dtype=torch.float32, device=dev)
        node_feats[:, 0] = state.feature
        dkv = state.dft_kv
        d_base = (m - 1)[:, None]  # draft slot of node 0

        # ---- 1. level-by-level tree drafting ----
        for d, level in enumerate(tree.levels[:-1]):
            lo, hi = level[0], level[-1] + 1
            ids = self._ids[lo:hi]
            pos = (d_base + d).expand(b, hi - lo)  # one rope position per level
            slots = d_base + ids[None, :]  # a slot per node
            dkv.with_tags(slots, pos)
            mask = _tree_mask(dkv.slot_pos, pos, d_base[:, 0], ids, self._anc, n)
            dout = eagle_forward(
                self.dp, self.tp, self.dcfg, node_tokens[:, lo:hi], node_feats[:, lo:hi], pos,
                dkv, slots, mask, compute_dtype=self.compute_dtype, kv_limit=kv_limit,
                slots_contiguous=True,
            )
            bfac = tree.branching[d]
            _, top = top_k(torch.log_softmax(dout.logits.float(), dim=-1), bfac)  # [B, L, bfac]
            nxt = tree.levels[d + 1]
            node_tokens[:, nxt[0]:nxt[-1] + 1] = top.reshape(b, -1).to(torch.int32)
            # a child's feature is its parent's draft output feature
            feat = self._pick_feature(dout.feature, dout.feature_pre)
            node_feats[:, nxt[0]:nxt[-1] + 1] = feat[:, :, None].expand(
                b, hi - lo, bfac, feat.shape[-1]).reshape(b, -1, feat.shape[-1])

        # ---- 2. one tree-attention verify forward ----
        v_base = m[:, None]  # target slot of node 0
        v_pos = v_base + self._depth[None, :]  # [B, N]
        v_slots = v_base + self._ids[None, :]
        tgt_kv = state.tgt_kv.with_tags(v_slots, v_pos)
        mask = _tree_mask(tgt_kv.slot_pos, v_pos, m, self._ids, self._anc, n)
        tout = llama_forward(
            self.tp, self.tcfg, node_tokens, v_pos, tgt_kv, v_slots, mask,
            compute_dtype=self.compute_dtype, kv_limit=kv_limit, slots_contiguous=True,
        )
        # the target's decision per node: its argmax, or one draw of the
        # sampler chain, then the exact-match walk below. Sample-then-match
        # keeps the output distributed as plain sampling: the expansion is a
        # deterministic top-k, so a node proposes a fixed candidate set C,
        # and no distribution-preserving scheme accepts with more than
        # P(x in C), which the draw and the match reach.
        t_argmax = draw(tout.logits, self.scfg, state.rng)  # [B, N]

        # ---- 3. path acceptance walk (static depth loop) ----
        cur = torch.zeros((b,), dtype=torch.int64, device=dev)
        alive = torch.ones((b,), dtype=torch.bool, device=dev)
        n_acc = torch.zeros((b,), dtype=torch.int32, device=dev)
        path = [cur]  # accepted node at each depth (clamped at the last one)
        for _ in range(tree.max_depth):
            want = t_argmax[b_idx, cur]  # the target's token after `cur`
            kids = self._child_mat[cur]  # [B, C]
            kid_toks = torch.where(kids >= 0, node_tokens.gather(1, kids.clamp(min=0)), -1)
            hit = kid_toks == want[:, None]
            any_hit = hit.any(dim=1) & alive
            first = hit.to(torch.int32).argmax(dim=1, keepdim=True)
            cur = torch.where(any_hit, kids.gather(1, first)[:, 0], cur)
            n_acc = n_acc + any_hit.to(torch.int32)
            alive = any_hit
            path.append(cur)
        path = torch.stack(path, dim=1)  # [B, depth + 1] node ids

        new_m = m + n_acc + 1
        bonus = t_argmax[b_idx, cur]
        new_feature = self._pick_feature(tout.hidden, tout.hidden_pre)[b_idx, cur]

        # ---- 4. compact the accepted path's K/V into contiguous slots ----
        depth_iota = torch.arange(tree.max_depth + 1, dtype=torch.int32, device=dev)[None, :]
        keep = depth_iota <= n_acc[:, None]
        _compact_kv(tgt_kv, v_base + path, v_base + depth_iota, keep)
        _compact_kv(dkv, d_base + path, d_base + depth_iota, keep)
        tgt_kv.rollback(keep_below=new_m)
        dkv.rollback(keep_below=new_m - 1)

        out.tokens[ci].copy_(_emit(node_tokens, path, n_acc, bonus))
        out.n_out[ci].copy_(n_acc + 1)
        out.n_accepted[ci].copy_(n_acc)
        state.last_token.copy_(bonus)
        state.feature.copy_(new_feature)
        state.n_past.copy_(new_m)

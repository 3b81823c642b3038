"""EAGLE tree speculation in the port (eagle_tpu_torch/runtime/tree.py and
tree2.py, greedy) against the reference (eagle_tpu/runtime/tree.py and
tree2.py, `backend="xla"`, f32) on the CPU, on the tiny synthetic models
(`tiny_cfgs`, weights carried across by `convert.params_from_numpy`):

- `TreeSpec` field by field; `_tree_mask`, `_window_tree_mask` and
  `_compact_kv` (in-window permutations, dropped rows) on random inputs;
- `sampling.top_k` against `jax.lax.top_k` and `approx_max_k` on inputs
  with ties (lower index first);
- both engines' tokens and stats identical to the reference's at the
  reference tests' configurations, and tokens identical to the port's
  greedy `Generator`;
- an oracle draft (its logits boosted at the target's greedy continuation)
  accepts the full depth every cycle, and the EAGLE-2 rerank stays closed
  under ancestors when its scores tie;
- chained cycles (`cycles_per_dispatch`): EAGLE-2 at C = 3 equals C = 1
  and the reference's C = 3; the static tree at C = 2 equals its C = 1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models.synth import synth_eagle_params, synth_llama_params
from eagle_tpu.runtime import tree as jtree
from eagle_tpu.runtime import tree2 as jtree2
from eagle_tpu.runtime.kvcache import KVCache as JaxKV
from eagle_tpu_torch.convert import params_from_numpy
from eagle_tpu_torch.runtime import tree, tree2
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.kvcache import KVCache
from eagle_tpu_torch.runtime.sampling import top_k
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    background_cpu, oracle, tiny_cfgs, tree_to_numpy,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

MAX_NEW = 24
TREES = [(3,), (2, 2), (4, 2, 2)]
BEAMS = [(2, 2, 4), (4, 3, 8), (3, 4, 13)]  # (beam, depth, n_verify), as tests/test_tree2.py


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_cfgs()
    jt = synth_llama_params(jcfg, seed=0, on_device=True, packed=True, coded=True)
    jd = synth_eagle_params(dataclasses.replace(jcfg, n_layers=1, is_eagle=True), packed=True)
    tt = params_from_numpy(tree_to_numpy(jt), "cpu")
    td = params_from_numpy(tree_to_numpy(jd), "cpu")
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, size=11).tolist()
    gen = Generator(tt, tcfg, max_seq=128, kv_dtype=torch.float32, compute_dtype=torch.float32,
                    eos_id=-1, device="cpu")
    greedy = gen.generate(prompt, max_new_tokens=MAX_NEW + 8, stop_at_eos=False)
    return dict(jcfg=jcfg, tcfg=tcfg, jt=jt, jd=jd, tt=tt, td=td, prompt=prompt, greedy=greedy)


def _engine(s, kind, arg):
    cls, kw = ((tree.EagleTreeEngine, dict(tree=tree.TreeSpec(arg))) if kind == "tree" else
               (tree2.EagleTree2Engine, dict(zip(("beam", "depth", "n_verify"), arg))))
    return cls(s["tt"], s["td"], s["tcfg"], max_seq=128, kv_dtype=torch.float32,
               compute_dtype=torch.float32, eos_id=-1, device="cpu", **kw)


def _reference(s, kind, arg):
    """The reference's engine for (kind, arg), made once per module: its
    compiled programs (the prefill among them) serve every test of it."""
    cache = s.setdefault("reference_engines", {})
    if (kind, arg) not in cache:
        cls, kw = ((jtree.EagleTreeEngine, dict(tree=jtree.TreeSpec(arg))) if kind == "tree" else
                   (jtree2.EagleTree2Engine, dict(zip(("beam", "depth", "n_verify"), arg))))
        cache[(kind, arg)] = cls(s["jt"], s["jd"], s["jcfg"], max_seq=128, kv_dtype=jnp.float32,
                                 compute_dtype=jnp.float32, backend="xla", eos_id=-1, **kw)
    return cache[(kind, arg)]


def _seq(s):
    return torch.tensor(list(s["prompt"]) + s["greedy"], dtype=torch.int64)


# ---- structure and helpers


@pytest.mark.parametrize("branching", TREES + [(3, 2), (2, 2, 1)])
def test_tree_spec_matches_reference(branching):
    got, want = tree.TreeSpec(branching), jtree.TreeSpec(branching)
    for f in ("branching", "n_nodes", "levels", "max_depth", "children", "max_children"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("parent", "depth", "ancestor", "child_mat"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def _tags(rng, b, s, n_tagged):
    tags = np.full((b, s), -1, np.int32)
    for i in range(b):
        tags[i, : n_tagged[i]] = np.arange(n_tagged[i])
        holes = rng.choice(n_tagged[i], size=3, replace=False)
        tags[i, holes] = -1
    return tags


@pytest.mark.parametrize("branching", TREES)
def test_tree_mask_matches_reference(branching):
    rng = np.random.default_rng(1)
    spec = jtree.TreeSpec(branching)
    b, s, n = 2, 64, spec.n_nodes
    base = rng.integers(5, s - n, size=b).astype(np.int32)
    tags = _tags(rng, b, s, base + n // 2)
    # the verify forward's rows (every node) and the widest drafted level's
    for ids in (np.arange(n, dtype=np.int32), np.asarray(spec.levels[-2], np.int32)):
        q_pos = (base[:, None] + spec.depth[ids][None, :]).astype(np.int32)
        want = jtree._tree_mask(jnp.asarray(tags), jnp.asarray(q_pos), jnp.asarray(base),
                                jnp.asarray(ids), jnp.asarray(spec.ancestor), n)
        got = tree._tree_mask(torch.from_numpy(tags), torch.from_numpy(q_pos),
                              torch.from_numpy(base), torch.from_numpy(ids),
                              torch.from_numpy(spec.ancestor), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w,t", [(5, 4), (13, 8), (49, 32)])
def test_window_tree_mask_matches_reference(w, t):
    rng = np.random.default_rng(w)
    b, s = 2, 96
    base = rng.integers(3, s - w, size=b).astype(np.int32)
    tags = _tags(rng, b, s, base + w // 2)
    vis = rng.random((b, t, w)) < 0.4
    q_pos = (base[:, None] + rng.integers(0, 6, size=(b, t))).astype(np.int32)
    want = jtree2._window_tree_mask(jnp.asarray(tags), jnp.asarray(q_pos), jnp.asarray(base),
                                    jnp.asarray(vis))
    got = tree2._window_tree_mask(torch.from_numpy(tags), torch.from_numpy(q_pos),
                                  torch.from_numpy(base), torch.from_numpy(vis))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["path", "permutation", "dropped"])
def test_compact_kv_matches_reference(case):
    """Moves rows within the window: a tree path (src >= dst), an in-window
    permutation (a dst slot is another row's src), and rows with keep
    False (their dst keeps its content, their tag write is a no-op)."""
    rng = np.random.default_rng(3)
    l, b, h, s, d, p = 2, 2, 2, 32, 8, 4
    k = rng.standard_normal((l, b, h, s, d)).astype(np.float32)
    v = rng.standard_normal((l, b, h, s, d)).astype(np.float32)
    tags = rng.integers(-1, 40, size=(b, s)).astype(np.int32)
    base = np.array([[5], [9]], np.int32)
    dst = base + np.arange(p, dtype=np.int32)[None]
    if case == "path":
        src = base + np.array([[0, 2, 5, 6], [0, 1, 3, 7]], np.int32)
        keep = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    elif case == "permutation":
        src = base + np.array([[3, 2, 1, 0], [1, 0, 3, 2]], np.int32)
        keep = np.ones((b, p), bool)
    else:
        src = base + np.array([[0, 4, 4, 4], [0, 2, 2, 2]], np.int32)
        keep = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], bool)
    ref = jtree._compact_kv(JaxKV(jnp.asarray(k), jnp.asarray(v), jnp.asarray(tags)),
                            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(keep))
    kv = KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                 torch.from_numpy(tags.copy()))
    got = tree._compact_kv(kv, torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(keep))
    assert got is kv  # in place
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(getattr(kv, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("shape,k", [((2, 17), 5), ((3, 4, 512), 8), ((2, 49), 32)])
def test_top_k_matches_jax_on_ties(shape, k):
    """Values descending, the lower index first among equal values: as
    jax.lax.top_k, and as approx_max_k, which is exact on the CPU."""
    rng = np.random.default_rng(k)
    x = rng.integers(-6, 3, size=shape).astype(np.float32) * np.float32(0.5)  # many ties
    x[..., 1] = -np.inf
    x[..., -1] = x[..., 0]
    got_v, got_i = top_k(torch.from_numpy(x), k)
    for vals, idx in (jax.lax.top_k(jnp.asarray(x), k),
                      jax.lax.approx_max_k(jnp.asarray(x), k, recall_target=0.95)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(vals))
    assert got_i.dtype == torch.int64


def test_rerank_closed_under_ancestors_on_ties(setup, monkeypatch):
    """With an oracle draft the scores of rejected branches fall to ~-1e4,
    where the rerank's 1e-6-per-depth nudge rounds away: a child drafted
    with log-prob 0 ties its parent, and the lower index (the parent) must
    win the tie. In every cycle each verify row sees all of its ancestors
    among the selected rows (its visible window rows number its depth + 1),
    and such ties occur."""
    eng = _engine(setup, "tree2", (4, 3, 8))
    monkeypatch.setattr(tree2, "eagle_forward", oracle(tree2.eagle_forward, _seq(setup)))
    reranks, verifies = [], []
    real_top_k, real_mask = tree2.top_k, tree2._window_tree_mask

    def top_k_spy(x, k):
        vals, idx = real_top_k(x, k)
        if x.shape[-1] == eng.W:  # the rerank (the expansions are over 512 and M * M)
            reranks.append(vals)
        return vals, idx

    def mask_spy(slot_pos, q_pos, base, vis):
        if vis.shape[1:] == (eng.N, eng.N):  # the verify forward's
            verifies.append((vis.sum(dim=-1), q_pos - base[:, None] + 1))
        return real_mask(slot_pos, q_pos, base, vis)

    monkeypatch.setattr(tree2, "top_k", top_k_spy)
    monkeypatch.setattr(tree2, "_window_tree_mask", mask_spy)
    toks, stats = eng.generate(setup["prompt"], max_new_tokens=MAX_NEW, stop_at_eos=False)
    assert toks == setup["greedy"][:MAX_NEW]
    assert stats["mean_accept_len"] == eng.D + 1
    assert len(verifies) == len(reranks) == stats["n_cycles"]
    for seen, depth_plus_one in verifies:
        assert torch.equal(seen, depth_plus_one)
    assert sum(int((v[:, 1:] == v[:, :-1]).sum()) for v in reranks) > 0  # ties occurred


# ---- engines against the reference


@pytest.mark.parametrize("kind,arg", [("tree", a) for a in TREES] + [("tree2", a) for a in BEAMS])
def test_engine_matches_reference_and_greedy(setup, kind, arg):
    got, stats = _engine(setup, kind, arg).generate(setup["prompt"], max_new_tokens=MAX_NEW,
                                                    stop_at_eos=False)
    want, ref_stats = _reference(setup, kind, arg).generate(setup["prompt"],
                                                            max_new_tokens=MAX_NEW,
                                                            stop_at_eos=False)
    assert got == want == setup["greedy"][:MAX_NEW]
    assert stats == ref_stats
    assert stats["n_cycles"] > 0


@pytest.mark.parametrize("kind,arg", [("tree", (4, 2, 2)), ("tree2", (3, 4, 13))])
def test_oracle_draft_accepts_full_depth(setup, kind, arg, monkeypatch):
    mod = tree if kind == "tree" else tree2
    monkeypatch.setattr(mod, "eagle_forward", oracle(mod.eagle_forward, _seq(setup)))
    eng = _engine(setup, kind, arg)
    toks, stats = eng.generate(setup["prompt"], max_new_tokens=MAX_NEW, stop_at_eos=False)
    depth = eng.out_width - 1
    assert toks == setup["greedy"][:MAX_NEW]
    assert stats["mean_accept_len"] == depth + 1
    assert stats["n_accepted"] == depth * stats["n_cycles"]


def test_tree2_multi_cycle_matches_single_and_reference(setup):
    arg = (4, 3, 8)
    base, st1 = _engine(setup, "tree2", arg).generate(setup["prompt"], max_new_tokens=MAX_NEW,
                                                      stop_at_eos=False)
    eng = _engine(setup, "tree2", arg)
    got, st3 = eng.generate(setup["prompt"], max_new_tokens=MAX_NEW, stop_at_eos=False,
                            cycles_per_dispatch=3)
    want, ref3 = _reference(setup, "tree2", arg).generate(
        setup["prompt"], max_new_tokens=MAX_NEW, stop_at_eos=False, cycles_per_dispatch=3)
    assert got == base == want
    assert st3 == st1 == ref3
    assert eng.cycles_run >= st3["n_cycles"] and eng.cycles_run % 3 == 0


@pytest.mark.parametrize("with_oracle", [False, True], ids=["random", "oracle"])
def test_tree_multi_cycle_chains_tree_cycles(setup, with_oracle, monkeypatch):
    """The port's static tree at C = 2 gives its C = 1 tokens and stats. The
    reference's EagleTreeEngine does not override `_multi_cycle`, so at C > 1
    it scans the CHAIN cycle with K = n_nodes drafts (n_drafted 7 per cycle
    and no acceptance on these models at (2, 2)); the port does not copy
    that fault."""
    if with_oracle:
        monkeypatch.setattr(tree, "eagle_forward", oracle(tree.eagle_forward, _seq(setup)))
    runs = [_engine(setup, "tree", (2, 2)).generate(setup["prompt"], max_new_tokens=MAX_NEW,
                                                    stop_at_eos=False, cycles_per_dispatch=c)
            for c in (1, 2)]
    assert runs[0] == runs[1]
    assert runs[0][0] == setup["greedy"][:MAX_NEW]
    if with_oracle:
        assert runs[1][1]["mean_accept_len"] == 3

"""Prompt-lookup / n-gram speculation in the port
(eagle_tpu_torch/runtime/lookup.py) against the reference
(eagle_tpu/runtime/lookup.py, `backend="xla"`, f32) on the CPU:

- the lookup cases of tests/test_speculative.py on the port: lookup
  decoding equals plain greedy decoding on a repetitive prompt,
  `prompt_lookup_draft` and `NgramCache` on the reference's inputs;
- `prompt_lookup_draft` and `NgramCache.draft` equal to the reference's on
  seeded sequences;
- `LookupEngine` tokens and stats (`n_cycles`, `n_drafted`, `n_accepted`,
  `accept_rate`, `mean_accept_len`) identical to the reference's engine on
  a tiny GGUF pair's target, at K = 4 and 8, with and without the n-gram
  cache, over two calls (the cache learns across calls);
- an oracle: the engine's `NgramCache` fed the greedy continuation first
  drafts the greedy tokens, so every cycle accepts all K drafts;
- with capture stubbed (a replay reruns the body), the verify is captured
  once per attention-read bucket and replayed, with the eager tokens."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models.loader import load_llama_params as jax_load
from eagle_tpu.runtime import lookup as jlookup
from eagle_tpu_torch.models.loader import load_llama_params
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.lookup import LookupEngine, NgramCache, prompt_lookup_draft
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT,
    background_cpu,
    stub_capture,
    tiny_engine_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

MAX_SEQ = 256
N_NEW = 40


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    """The tiny GGUF pair's target, loaded by both packages; a repetitive
    prompt (so that lookup drafts) and the port's greedy tokens."""
    path = tiny_engine_pair(tmp_path_factory.mktemp("lookup"), ENGINE_PROMPT)[0]
    params, cfg, _ = load_llama_params(path, device="cpu")
    jparams, jcfg, _ = jax_load(path)
    base = np.random.default_rng(3).integers(3, cfg.vocab_size, size=6).tolist()
    prompt = base * 3
    gen = Generator(params, cfg, max_seq=MAX_SEQ, **_f32())
    greedy = gen.generate(prompt, max_new_tokens=N_NEW, stop_at_eos=False)
    return dict(params=params, cfg=cfg, jparams=jparams, jcfg=jcfg, prompt=prompt,
                greedy=greedy)


def _f32():
    return dict(kv_dtype=torch.float32, compute_dtype=torch.float32, eos_id=-1, device="cpu")


def _port(t, k, **kw):
    return LookupEngine(t["params"], t["cfg"], n_draft=k, max_seq=MAX_SEQ, **_f32(), **kw)


# ---- the reference's cases (tests/test_speculative.py:99-130), on the port ---


def test_lookup_decoding_equals_plain(target):
    got, stats = _port(target, 4).generate(target["prompt"], max_new_tokens=15,
                                           stop_at_eos=False)
    assert got == target["greedy"][:15], (got, stats)


def test_prompt_lookup_draft_matches():
    ctx = [1, 2, 3, 9, 1, 2]
    assert prompt_lookup_draft(ctx, 2) == [3, 9]
    assert prompt_lookup_draft([5, 6, 7], 2) == []


def test_ngram_cache():
    c = NgramCache(2, 3)
    c.update([1, 2, 3, 1, 2, 3, 1, 2])
    assert c.draft([1, 2], 1) == [3]
    assert c.draft([9, 9], 1) == []


# ---- the host drafters against the reference's ------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_drafters_match_reference(seed):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 6, size=60).tolist()  # a small alphabet: many repeats
    for n in (10, 31, 60):
        for k in (1, 4, 8):
            for ngram in (1, 2, 3):
                assert prompt_lookup_draft(seq[:n], k, ngram) == jlookup.prompt_lookup_draft(
                    seq[:n], k, ngram)
    got, want = NgramCache(2, 4), jlookup.NgramCache(2, 4)
    got.update(seq[:40])
    want.update(seq[:40])
    for tail in (seq[35:42], seq[:3], [5, 5, 5]):
        assert got.draft(tail, 6) == want.draft(tail, 6)


# ---- LookupEngine against the reference's ------------------------------------

ENGINES = {"k4": dict(k=4), "k8": dict(k=8), "k4_no_ngram": dict(k=4, use_ngram_cache=False)}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_matches_reference(target, case):
    kw = dict(ENGINES[case])
    k = kw.pop("k")
    ref = jlookup.LookupEngine(target["jparams"], target["jcfg"], n_draft=k, max_seq=MAX_SEQ,
                               kv_dtype=jnp.float32, compute_dtype=jnp.float32, backend="xla",
                               eos_id=-1, **kw)
    eng = _port(target, k, **kw)
    for call in range(2):  # the n-gram cache learns across calls, in both packages
        want, want_stats = ref.generate(target["prompt"], max_new_tokens=N_NEW,
                                        stop_at_eos=False)
        got, stats = eng.generate(target["prompt"], max_new_tokens=N_NEW, stop_at_eos=False)
        assert got == want and stats == want_stats, call
        assert got == target["greedy"]
    assert set(stats) == {"n_cycles", "n_drafted", "n_accepted", "accept_rate",
                          "mean_accept_len"}


def test_oracle_cache_accepts_every_draft(target):
    """The engine's n-gram cache fed the prompt and the greedy continuation
    drafts the greedy tokens: each cycle accepts its K drafts (the upper
    bound the card's oracle run reports)."""
    eng = _port(target, 4)
    eng.ngram.update(target["prompt"] + target["greedy"])
    got, stats = eng.generate(target["prompt"], max_new_tokens=N_NEW, stop_at_eos=False)
    assert got == target["greedy"]
    assert stats["n_accepted"] >= stats["n_drafted"] - eng.K  # all but the last cycle's
    assert stats["mean_accept_len"] > eng.K


def test_verify_graph_replays(target, monkeypatch):
    eng = _port(target, 4)
    stub_capture(monkeypatch, eng)
    got, stats = eng.generate(target["prompt"], max_new_tokens=N_NEW, stop_at_eos=False)
    assert got == target["greedy"]
    g = eng.graphs
    assert g.captures == g.eager == 1  # one read bucket: every cycle reads < 128 slots
    assert g.replays == stats["n_cycles"] - 1

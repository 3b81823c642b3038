"""Lookahead decoding in the port (eagle_tpu_torch/runtime/lookahead.py)
against the reference (eagle_tpu/runtime/lookahead.py, `backend="xla"`,
f32) on the CPU:

- every case of tests/test_lookahead.py on the port: the layout's rows,
  positions and visibility; tokens identical to plain greedy decoding
  (seeds 0 and 3); n-gram acceptance on repetitive text;
- `_Layout` field by field against the reference's, and the step's token
  row (one gather) against the reference's scatters;
- `Engine(EngineConfig(lookahead=(W, N, G)))` on a tiny GGUF pair: tokens
  and stats identical to the reference's `Engine`'s lookahead engine and
  to the port's greedy `Generator`, at (4, 4, 3), the defaults (8, 4, 8)
  and (3, 3, 2);
- with capture stubbed (a replay reruns the body), the step is captured
  once and replayed for every later step, with the eager run's tokens; a
  second `generate` replays the same graph;
- the engine refuses a layout the reference refuses, and a cache with no
  room beside the step's rows.

The reference's cases run on the port's synthetic model (`tiny_cfgs`, Q4_K
packed, coded, `models/synth.py`), which loops on a few tokens; the GGUF
pair's (Q8_0, an SPM vocabulary) output varies, so the verification walk
accepts some grams and rejects others there."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.api import Engine as JaxEngine
from eagle_tpu.api import EngineConfig as JaxEngineConfig
from eagle_tpu.runtime import lookahead as jla
from eagle_tpu_torch.api import Engine, EngineConfig
from eagle_tpu_torch.models.synth import synth_llama_params
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.lookahead import LookaheadEngine, _Layout
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT,
    background_cpu,
    stub_capture,
    tiny_cfgs,
    tiny_engine_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

LAYOUTS = [(4, 4, 3), (8, 4, 8), (3, 3, 2), (2, 5, 1)]
N_NEW = 48


# ---- the reference's cases (tests/test_lookahead.py), on the port ------------


def test_layout_mask_shape_and_visibility():
    lay = _Layout(W=4, N=4, G=3)
    assert lay.T == 1 + 3 * 3 + 3 + 2 * 4
    vis = lay.visible
    assert vis[:, 0].all()
    r_g1_t1 = 1 + 1 * 3 + 1
    assert vis[r_g1_t1, 1 + 1 * 3 + 0] and not vis[r_g1_t1, 1 + 0 * 3 + 0]
    r = lay.aj(2, 2)
    assert vis[r, lay.a0(1)] and vis[r, lay.a0(2)]
    assert vis[r, lay.aj(1, 2)]
    assert not vis[r, lay.a0(3)] and not vis[r, lay.aj(1, 1)]
    assert lay.pos_off[0] == 0
    assert lay.pos_off[lay.a0(3)] == 3
    assert lay.pos_off[lay.aj(2, 1)] == 3


@pytest.fixture(scope="module")
def synth():
    """The port's tiny synthetic model per seed (Q4_K packed, coded)."""
    _, cfg = tiny_cfgs()
    cache = {}

    def get(seed):
        if seed not in cache:
            cache[seed] = synth_llama_params(cfg, seed=seed, packed=True, coded=True,
                                             device="cpu")
        return cache[seed], cfg

    return get


def _f32(**kw):
    return dict(kv_dtype=torch.float32, compute_dtype=torch.float32, eos_id=-1, device="cpu",
                **kw)


@pytest.mark.parametrize("seed", [0, 3])
def test_lookahead_matches_plain_greedy(synth, seed):
    params, cfg = synth(seed)
    prompt = np.asarray([5, 9, 5, 9, 5, 9, 11, 5, 9], np.int32)
    gen = Generator(params, cfg, max_seq=256, **_f32())
    ref = gen.generate(prompt, max_new_tokens=40, stop_at_eos=False, chunk=16)
    la = LookaheadEngine(params, cfg, W=4, N=4, G=4, max_seq=256, **_f32())
    out, stats = la.generate(prompt, max_new_tokens=40, stop_at_eos=False)
    assert out[: len(ref)] == list(ref), (out, list(ref), stats)
    assert stats["n_steps"] > 0


def test_lookahead_accepts_on_repetitive_text(synth):
    params, cfg = synth(1)
    la = LookaheadEngine(params, cfg, W=4, N=4, G=4, max_seq=512, **_f32())
    out, stats = la.generate(np.asarray([7, 7, 7, 7], np.int32), max_new_tokens=120,
                             stop_at_eos=False)
    assert len(out) >= 120
    assert stats["n_accept"] > 0, stats
    assert stats["tokens_per_step"] > 1.0


# ---- the layout and the token row against the reference's -----------------


@pytest.mark.parametrize("wng", LAYOUTS, ids=[str(x) for x in LAYOUTS])
def test_layout_matches_reference(wng):
    got, want = _Layout(*wng), jla._Layout(*wng)
    for f in ("W", "N", "G", "v_rows", "T", "gram_row0"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("pos_off", "visible", "lastlvl_rows", "gram_rows"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for j in range(1, wng[1] - 1):
        for i in range(wng[0]):
            assert got.aj(j, i) == want.aj(j, i)
    assert [got.a0(i) for i in range(1, wng[0])] == [want.a0(i) for i in range(1, wng[0])]


@pytest.mark.parametrize("wng", LAYOUTS, ids=[str(x) for x in LAYOUTS])
def test_token_row_matches_reference_scatter(wng):
    """The step's one gather from [cur, grams, window] gives the token row
    the reference's scatters build."""
    W, N, G = wng
    lay = _Layout(*wng)
    rng = np.random.default_rng(sum(wng))
    cur = int(rng.integers(0, 99))
    grams = rng.integers(100, 199, size=(G, N - 1))
    window = rng.integers(200, 299, size=(N - 1, W))
    want = np.zeros(lay.T, np.int64)
    want[0] = cur
    want[lay.gram_rows.reshape(-1)] = grams.reshape(-1)
    want[[lay.a0(i) for i in range(1, W)]] = window[0, 1:]
    for j in range(1, N - 1):
        want[[lay.aj(j, i) for i in range(W)]] = window[j]
    row = np.concatenate([[cur], grams.reshape(-1), window.reshape(-1)])
    np.testing.assert_array_equal(row[lay.token_source()], want)


@pytest.mark.parametrize("wng", [(3, 2, 1), (1, 4, 1), (4, 4, 0)])
def test_layout_refuses_what_the_reference_refuses(wng):
    with pytest.raises(ValueError, match="lookahead needs"):
        _Layout(*wng)
    with pytest.raises(ValueError, match="lookahead needs"):
        jla._Layout(*wng)


def test_engine_refuses_a_cache_without_room(synth):
    params, cfg = synth(0)
    with pytest.raises(ValueError, match="no room"):
        LookaheadEngine(params, cfg, W=8, N=4, G=8, max_seq=48, **_f32())


# ---- the engines against the reference's, through Engine -------------------


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tiny_engine_pair(tmp_path_factory.mktemp("lookahead"), ENGINE_PROMPT)


@pytest.fixture(scope="module")
def plain(pair):
    """The port's greedy tokens of the prompt (the reference for every
    lookahead run), and the prompt's ids."""
    eng = Engine(EngineConfig(model_path=pair[0], max_seq=256, compute_dtype=torch.float32,
                              kv_dtype=torch.float32, device="cpu"))
    ids = eng.tokenizer.encode(ENGINE_PROMPT)
    return ids, eng.engine.generate(ids, max_new_tokens=N_NEW, stop_at_eos=False)


def _port(pair, wng) -> Engine:
    return Engine(EngineConfig(model_path=pair[0], max_seq=256, compute_dtype=torch.float32,
                               kv_dtype=torch.float32, device="cpu", lookahead=wng))


@pytest.mark.parametrize("wng", LAYOUTS[:3], ids=[str(x) for x in LAYOUTS[:3]])
def test_engine_lookahead_matches_reference(pair, plain, wng):
    ids, greedy = plain
    ref = JaxEngine(JaxEngineConfig(model_path=str(pair[0]), max_seq=256, backend="xla",
                                    compute_dtype=jnp.float32, kv_dtype=jnp.float32,
                                    lookahead=wng))
    want, want_stats = ref.engine.generate(ids, max_new_tokens=N_NEW, stop_at_eos=False)
    eng = _port(pair, wng)
    assert isinstance(eng.engine, LookaheadEngine)
    got, stats = eng.engine.generate(ids, max_new_tokens=N_NEW, stop_at_eos=False)
    assert got == list(want) and stats == want_stats
    assert got[:len(greedy)] == greedy
    assert 0 < stats["n_accept"] < N_NEW - stats["n_steps"]  # some grams accepted, not all


def test_step_graph_replays(pair, plain, monkeypatch):
    """With capture stubbed, the first step runs eagerly and is captured,
    every later step replays it (the body reads only static tensors), and
    the tokens are the eager run's; a second `generate` captures nothing."""
    ids, greedy = plain
    eng = _port(pair, (4, 4, 3)).engine
    stub_capture(monkeypatch, eng)
    got, stats = eng.generate(ids, max_new_tokens=N_NEW, stop_at_eos=False)
    assert got[:len(greedy)] == greedy
    g = eng.graphs
    assert (g.eager, g.captures, g.replays) == (1, 1, stats["n_steps"] - 1)
    again, _ = eng.generate(ids, max_new_tokens=N_NEW, stop_at_eos=False)
    assert again == got and g.captures == 1 and g.replays == 2 * stats["n_steps"] - 1

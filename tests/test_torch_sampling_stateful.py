"""The port's stateful samplers (eagle_tpu_torch/runtime/sampling.py:
`SamplerState`, `apply_penalties`, the penalties in `transform_logits`,
`dry_penalty`, `_mirostat_v1`, `_mirostat_v2`, `sample_stateful`) against
the reference (eagle_tpu/runtime/sampling.py) on the CPU, and the
generation that carries them (`Generator.generate`, `ChatSession.ask`)
against the reference's on a tiny GGUF:

- `apply_penalties`, `dry_penalty` (breakers, longer matches penalised
  harder, a batch of windows) and both mirostats at rtol 1e-6, mirostat
  v1's truncation k equal to the number of logits the reference keeps, its
  descending sort checked on tied logits, mu at rtol 1e-6;
- `sample_stateful` token for token over several steps under the
  reference's own draws (`key` on the chain's branch, `mkey` on
  mirostat's, XTC's uniform from `tkey`), the state (counts, mu, recent)
  equal after each step, for every branch;
- `observe` and the prompt count with repeated tokens (one count per
  occurrence, as `.at[...].add`);
- the cases of tests/test_sampling.py from `test_penalties_repeat` on;
- greedy generation with the repeat, frequency and presence penalties and
  with DRY, in `Generator.generate` and in a two-turn `ChatSession`, gives
  the reference's tokens; mirostat runs repeat from their seed; a step's
  graph takes the state's tensors among its inputs, so a new state
  recaptures (capture stubbed)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eagle_tpu.runtime.sampling as ref
import eagle_tpu_torch.runtime.sampling as port
from eagle_tpu.api import Engine as JaxEngine
from eagle_tpu.api import EngineConfig as JaxEngineConfig
from eagle_tpu_torch.runtime import graphs
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT,
    background_cpu,
    tiny_engine_pair,
    tiny_port_engine,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

V = 128
# the reference's functions compiled whole: faster here than op by op
ref_dry = jax.jit(ref.dry_penalty, static_argnums=2)
ref_sample_stateful = jax.jit(ref.sample_stateful, static_argnums=2)


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def jcfg(cfg: port.SamplerConfig) -> ref.SamplerConfig:
    return ref.SamplerConfig(**dataclasses.asdict(cfg))


def logits_with_ties(seed: int, rows: int = 4, v: int = V) -> np.ndarray:
    """Random logits, a tie at the maximum and at the 5th value of each row."""
    rng = np.random.default_rng(seed)
    l = (rng.standard_normal((rows, v)) * 2).astype(np.float32)
    for r in range(rows):
        order = np.argsort(-l[r])
        l[r, order[1]] = l[r, order[0]]
        l[r, order[5]] = l[r, order[4]]
    return l


def counts_of(seed: int, rows: int = 4, v: int = V) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (rows, v)).astype(np.float32)
    c[rng.random((rows, v)) < 0.6] = 0
    return c


# ---- apply_penalties ---------------------------------------------------------

PENALTIES = [dict(penalty_repeat=1.3), dict(penalty_repeat=0.8), dict(penalty_freq=0.4),
             dict(penalty_present=0.7), dict(penalty_repeat=1.1, penalty_freq=0.2,
                                             penalty_present=0.3)]


@pytest.mark.parametrize("kw", PENALTIES, ids=[str(k) for k in PENALTIES])
def test_apply_penalties_matches_reference(kw):
    cfg = port.SamplerConfig(**kw)
    l, c = logits_with_ties(0), counts_of(1)
    close(port.apply_penalties(torch.from_numpy(l), torch.from_numpy(c), cfg),
          jax.vmap(lambda a, b: ref.apply_penalties(a, b, jcfg(cfg)))(jnp.asarray(l),
                                                                      jnp.asarray(c)))
    # inside the chain: after the logit bias, before the greedy return
    g = dataclasses.replace(cfg, greedy=True, logit_bias=((3, 2.0),))
    close(port.transform_logits(torch.from_numpy(l), g, penalty_counts=torch.from_numpy(c)),
          jax.vmap(lambda a, b: ref.transform_logits(a, jcfg(g), b))(jnp.asarray(l),
                                                                     jnp.asarray(c)))


def test_penalties_repeat():
    """tests/test_sampling.py: a positive seen logit divided, a negative one
    multiplied, an unseen one untouched."""
    out = port.apply_penalties(torch.tensor([2.0, -2.0, 1.0]), torch.tensor([1.0, 1.0, 0.0]),
                               port.SamplerConfig(penalty_repeat=2.0))
    assert out.tolist() == pytest.approx([1.0, -4.0, 1.0])


# ---- dry_penalty -------------------------------------------------------------

A, B, C, D, X, BRK = 3, 4, 5, 6, 9, 7
DRY = {  # (recent, multiplier, base, allowed, breakers): tests/test_sampling.py's windows
    "extends_a_match": ([-1, -1, A, B, C, X, A, B], 2.0, 1.75, 2, ()),
    "longer_matches_harder": ([A, B, C, D, X, A, B, C], 1.0, 2.0, 2, ()),
    "breakers": ([A, B, C, X, A, BRK, A, B], 1.0, 2.0, 2, (BRK,)),
    "nothing_through_a_breaker": ([-1, -1, -1, X, A, BRK, A, B], 1.0, 2.0, 2, (BRK,)),
    "empty_window": ([-1] * 8, 1.0, 2.0, 1, ()),
    "long_loop": ([A, B, A, B, A, B, A, B, A, B, A], 0.8, 1.75, 1, (X,)),
}


@pytest.mark.parametrize("name", list(DRY))
def test_dry_penalty_matches_reference(name):
    recent, mult, base, allowed, brk = DRY[name]
    cfg = port.SamplerConfig(dry_multiplier=mult, dry_base=base, dry_allowed_length=allowed,
                             dry_sequence_breakers=brk)
    l = logits_with_ties(2, rows=1, v=16)[0]
    got = port.dry_penalty(torch.from_numpy(l), torch.tensor(recent, dtype=torch.int32), cfg)
    want = ref_dry(jnp.asarray(l), jnp.asarray(recent, jnp.int32), jcfg(cfg))
    close(got, want)
    zeros = port.dry_penalty(torch.zeros(16), torch.tensor(recent, dtype=torch.int32), cfg)
    if name == "extends_a_match":  # C extends "A B" (length 2): 2 * 1.75^0
        assert zeros[C] == pytest.approx(-2.0) and zeros[X] == 0 and zeros[7] == 0
    elif name == "longer_matches_harder":  # D extends "A B C" (length 3): 1 * 2^1
        assert zeros[D] == pytest.approx(-2.0)
    elif name == "breakers":  # "A B" at 0-1: C loses 1 * 2^0
        assert zeros[C] == pytest.approx(-1.0)
    elif name in ("nothing_through_a_breaker", "empty_window"):
        assert (zeros == 0).all()


def test_dry_penalty_batch_of_windows_matches_reference():
    """[B, W] windows of a few tokens (many repeats), -1 padding and a
    breaker, against the reference vmapped over the rows."""
    rng = np.random.default_rng(3)
    recent = rng.integers(0, 6, (5, 24)).astype(np.int32)
    recent[1, :9] = -1
    recent[3, :] = -1
    cfg = port.SamplerConfig(dry_multiplier=0.8, dry_base=1.75, dry_allowed_length=2,
                             dry_sequence_breakers=(4,))
    l = logits_with_ties(4, rows=5, v=32)
    got = port.dry_penalty(torch.from_numpy(l), torch.from_numpy(recent), cfg)
    want = jax.jit(jax.vmap(lambda a, r: ref.dry_penalty(a, r, jcfg(cfg))))(
        jnp.asarray(l), jnp.asarray(recent))
    close(got, want)
    assert (got != torch.from_numpy(l)).any()  # some candidate was penalised


# ---- mirostat ----------------------------------------------------------------


@pytest.fixture
def captured_categorical(monkeypatch):
    """jax.random.categorical recording the logits it draws from (the
    reference's truncated logits)."""
    seen = []
    real = jax.random.categorical

    def categorical(key, logits, axis=-1, **kw):
        seen.append(np.asarray(logits))
        return real(key, logits, axis=axis, **kw)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    return seen


@pytest.mark.parametrize("mu", [2.0, 6.0, 10.0])
@pytest.mark.parametrize("ties", [False, True])
def test_mirostat_v1_matches_reference(captured_categorical, mu, ties):
    """k: the count of logits the reference keeps (no ties) or, with ties at
    the k-th value, the same kept set; tokens under the reference's noise,
    mu at rtol 1e-6."""
    cfg = port.SamplerConfig(mirostat=1, mirostat_tau=4.0, mirostat_eta=0.3, temperature=0.9)
    rng = np.random.default_rng(int(mu * 10) + ties)
    l = logits_with_ties(7, rows=4) if ties else (rng.standard_normal((4, V)) * 3).astype(
        np.float32)
    mus = np.asarray([mu, mu + 0.5, mu - 0.5, mu * 1.5], np.float32)
    key = jax.random.PRNGKey(int(mu))
    tok_r, mu_r = ref._mirostat_v1(jnp.asarray(l), key, jcfg(cfg), jnp.asarray(mus))
    kept_r = captured_categorical[-1] > ref._NEG_INF / 2
    k = port._mirostat_v1_k(torch.from_numpy(l), torch.from_numpy(mus))
    if not ties:
        assert k.tolist() == kept_r.sum(-1).tolist()
    kth = torch.sort(torch.from_numpy(l), dim=-1, descending=True).values.gather(
        -1, (k - 1).clamp(0, V - 1)[:, None])
    assert ((torch.from_numpy(l) >= kth).numpy() == kept_r).all()
    g = np.asarray(jax.random.gumbel(key, l.shape, jnp.float32))
    tok, mu_new = port._mirostat_v1(torch.from_numpy(l), torch.from_numpy(g.copy()), cfg,
                                    torch.from_numpy(mus))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_r))
    close(mu_new, mu_r)


@pytest.mark.parametrize("mu", [1.0, 4.0, 9.0])
def test_mirostat_v2_matches_reference(mu):
    cfg = port.SamplerConfig(mirostat=2, mirostat_tau=3.0, mirostat_eta=0.5, temperature=1.2)
    l = logits_with_ties(int(mu), rows=4)
    mus = np.asarray([mu, mu * 2, mu / 2, 0.1], np.float32)  # 0.1: only the argmax stays
    key = jax.random.PRNGKey(int(mu) + 1)
    tok_r, mu_r = ref._mirostat_v2(jnp.asarray(l), key, jcfg(cfg), jnp.asarray(mus))
    g = np.array(jax.random.gumbel(key, l.shape, jnp.float32))
    tok, mu_new = port._mirostat_v2(torch.from_numpy(l), torch.from_numpy(g), cfg,
                                    torch.from_numpy(mus))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_r))
    close(mu_new, mu_r)
    assert int(tok[3]) == int(np.argmax(l[3]))


# ---- sample_stateful ---------------------------------------------------------

STATEFUL = {
    "greedy_repeat": port.SamplerConfig(greedy=True, penalty_repeat=1.5),
    "sampled_freq_present_xtc": port.SamplerConfig(
        temperature=0.9, top_k=20, top_p=0.9, min_p=0.0, penalty_freq=0.3,
        penalty_present=0.4, xtc_probability=0.7, xtc_threshold=0.02),
    "sampled_xtc_dry": port.SamplerConfig(
        temperature=1.1, top_k=0, top_p=1.0, min_p=0.0, dry_multiplier=1.5,
        dry_allowed_length=1, dry_sequence_breakers=(5,), xtc_probability=0.6,
        xtc_threshold=0.01),
    "greedy_dry": port.SamplerConfig(temperature=0.0, dry_multiplier=3.0, dry_base=2.0,
                                     dry_allowed_length=1),
    "mirostat_v1_penalties": port.SamplerConfig(mirostat=1, mirostat_tau=4.0,
                                                penalty_repeat=1.2, temperature=0.8),
    "mirostat_v2_bias_dry": port.SamplerConfig(mirostat=2, mirostat_tau=3.0, mirostat_eta=0.4,
                                               logit_bias=((2, 1.5),), dry_multiplier=0.5),
}


def _noise(cfg, key, shape):
    """The reference's draws inside `sample_stateful`: the split into (key,
    tkey, mkey); Gumbel noise from `mkey` on the mirostat branch, from
    `key` on the chain's; XTC's uniform from a split of `tkey`, one per row
    without penalties and one for all rows under the penalties' vmap."""
    k, tkey, mkey = jax.random.split(key, 3)
    g = np.array(jax.random.gumbel(mkey if cfg.mirostat in (1, 2) else k, shape, jnp.float32))
    _, sub = jax.random.split(tkey)
    if cfg.needs_penalties:
        u = np.broadcast_to(np.asarray(jax.random.uniform(sub, (1,))), (shape[0], 1)).copy()
    else:
        u = np.array(jax.random.uniform(sub, (shape[0], 1)))
    return torch.from_numpy(g), torch.from_numpy(u)


@pytest.mark.parametrize("name", list(STATEFUL))
def test_sample_stateful_matches_reference(name):
    """Six steps on a batch of 3 from a state with repeats in its window:
    the tokens equal, and the state after each step (counts and recent
    equal, mu at rtol 1e-6)."""
    cfg = STATEFUL[name]
    b, rng = 3, np.random.default_rng(11)
    recent = rng.integers(0, 8, (b, 64)).astype(np.int32)
    recent[0, :40] = -1
    counts = counts_of(12, rows=b)
    rstate = dataclasses.replace(ref.SamplerState.create(b, V, tau=cfg.mirostat_tau),
                                 counts=jnp.asarray(counts), recent=jnp.asarray(recent))
    pstate = port.SamplerState(b, V, tau=cfg.mirostat_tau)
    pstate.counts.copy_(torch.from_numpy(counts))
    pstate.recent.copy_(torch.from_numpy(recent))
    close(pstate.mu, rstate.mu)
    for step in range(6):
        l = logits_with_ties(20 + step, rows=b)
        l[:, :8] += 2.0  # the window's tokens are likely draws
        key = jax.random.PRNGKey(100 + step)
        tok_r, rstate = ref_sample_stateful(jnp.asarray(l), key, jcfg(cfg), rstate)
        g, u = _noise(cfg, key, l.shape)
        tok = port.sample_stateful(torch.from_numpy(l), cfg, pstate, g, u)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_r), err_msg=f"step {step}")
        np.testing.assert_array_equal(pstate.counts.numpy(), np.asarray(rstate.counts))
        np.testing.assert_array_equal(pstate.recent.numpy(), np.asarray(rstate.recent))
        close(pstate.mu, rstate.mu)


def test_observe_and_prompt_count_with_repeats():
    """`observe` adds one per row and shifts the window through a copy;
    `count` adds once per occurrence, as the reference's `.at[0, prompt]
    .add(1.0)` in `Generator.generate`."""
    prompt = [5, 9, 5, 5, 1, 9]
    st = port.SamplerState(2, 16, tau=2.5, window=4)
    assert st.mu.tolist() == [5.0, 5.0] and (st.recent == -1).all()
    st.count(0, np.asarray(prompt, np.int32))
    r = ref.SamplerState.create(2, 16, tau=2.5, window=4)
    r = dataclasses.replace(r, counts=r.counts.at[0, jnp.asarray(prompt)].add(1.0))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(r.counts))
    assert st.counts[0, 5] == 3 and st.counts[1].sum() == 0
    for toks in ([3, 4], [3, 3], [7, 4], [2, 2], [1, 0]):
        st.observe(torch.tensor(toks, dtype=torch.int32))
        r = r.observe(jnp.asarray(toks, jnp.int32))
        np.testing.assert_array_equal(st.counts.numpy(), np.asarray(r.counts))
        np.testing.assert_array_equal(st.recent.numpy(), np.asarray(r.recent))
    ptrs = [t.data_ptr() for t in st.tensors()]
    st.reset(1.0)
    assert [t.data_ptr() for t in st.tensors()] == ptrs and st.counts.sum() == 0
    assert st.mu.tolist() == [2.0, 2.0] and (st.recent == -1).all()


# ---- tests/test_sampling.py's stateful cases on the port ------------------------


def _run_steps(cfg, logits, steps, state, seed=0):
    rng = port.CounterRNG(seed)
    return [int(port.draw(logits, cfg, rng, state)[0]) for _ in range(steps)]


def test_sample_stateful_penalties_suppress_repeats():
    cfg = port.SamplerConfig(greedy=True, penalty_repeat=2.0)
    l = torch.tensor([[2.0, 1.9, 0.0, -1.0]])
    assert _run_steps(cfg, l, 2, port.SamplerState(1, 4)) == [0, 1]  # 2.0 -> 1.0: 1.9 wins


def test_mirostat_v2_adapts_mu():
    cfg = port.SamplerConfig(temperature=1.0, mirostat=2, mirostat_tau=3.0, mirostat_eta=0.5)
    st = port.SamplerState(1, 16, tau=3.0)
    l = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 16)).astype(np.float32))
    mu0 = float(st.mu[0])
    toks = _run_steps(cfg, l, 5, st)
    assert all(0 <= t < 16 for t in toks) and float(st.mu[0]) != mu0


def test_dry_in_stateful_chain_reduces_loops():
    cfg = port.SamplerConfig(greedy=True, dry_multiplier=10.0, dry_base=2.0, dry_allowed_length=1)
    l = torch.zeros((1, 8))
    l[0, 2], l[0, 3] = 5.0, 4.0  # greedy alone would loop "2 2 2 ..."
    assert 3 in _run_steps(cfg, l, 6, port.SamplerState(1, 8, window=16))


def test_mirostat_v1_adapts_and_samples():
    cfg = port.SamplerConfig(mirostat=1, mirostat_tau=4.0, temperature=1.0)
    st = port.SamplerState(2, 128)
    l = torch.from_numpy((np.random.default_rng(0).standard_normal((2, 128)) * 3).astype(
        np.float32))
    rng, mus = port.CounterRNG(0), []
    for _ in range(8):
        tok = port.draw(l, cfg, rng, st)
        mus.append(float(st.mu[0]))
        assert ((0 <= tok) & (tok < 128)).all()
    assert mus[0] != mus[-1]


def test_draw_counts_are_the_configs_alone():
    """A stateful draw advances the counter by the same count on every call
    of one config: mirostat and a sampled chain one Gumbel draw (plus XTC's
    uniform when on), a greedy chain none."""
    for cfg, n in ((STATEFUL["greedy_repeat"], 0), (STATEFUL["sampled_freq_present_xtc"], 2),
                   (STATEFUL["mirostat_v1_penalties"], 1), (STATEFUL["greedy_dry"], 0)):
        rng, st = port.CounterRNG(3), port.SamplerState(2, V)
        for i in range(3):
            port.draw(torch.from_numpy(logits_with_ties(i, rows=2)), cfg, rng, st)
            assert int(rng.counter) == n * (i + 1)


# ---- stateful generation against the reference ----------------------------------

MAX_SEQ = 128
GREEDY = {
    "repeat": port.SamplerConfig(greedy=True, penalty_repeat=1.3),
    "freq_present": port.SamplerConfig(temperature=0.0, penalty_freq=0.5, penalty_present=0.3),
    "dry": port.SamplerConfig(greedy=True, dry_multiplier=0.8, dry_base=1.75,
                              dry_allowed_length=1, dry_sequence_breakers=(5,)),
}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tiny_engine_pair(tmp_path_factory.mktemp("stateful"), ENGINE_PROMPT)


@pytest.fixture(scope="module")
def ref_engine(pair):
    return JaxEngine(JaxEngineConfig(model_path=str(pair[0]), max_seq=MAX_SEQ, backend="xla",
                                     compute_dtype=jnp.float32, kv_dtype=jnp.float32))


@pytest.fixture(scope="module")
def port_engine(pair):
    return tiny_port_engine(pair, "plain")


@pytest.mark.parametrize("name", list(GREEDY))
def test_stateful_generate_matches_reference(ref_engine, port_engine, name):
    """`Generator.generate` (the prompt counted into the window first) and
    a two-turn `ChatSession` (a fresh state per turn, the prompt not
    counted): the reference's tokens."""
    cfg = GREEDY[name]
    ids = port_engine.tokenizer.encode(ENGINE_PROMPT)
    want = ref_engine.engine.generate(ids, max_new_tokens=20, sampler=jcfg(cfg),
                                      stop_at_eos=False)
    got = port_engine.engine.generate(ids, max_new_tokens=20, sampler=cfg, stop_at_eos=False)
    assert got == [int(t) for t in want]
    plain = port_engine.engine.generate(ids, max_new_tokens=20, stop_at_eos=False)
    assert got != plain  # the sampler changed the greedy text
    rs, ps = ref_engine.chat_session(template="vicuna"), port_engine.chat_session(
        template="vicuna")
    for text in ("the quick brown fox", "a lazy dog"):
        assert ps.ask(text, max_new_tokens=14, sampler=cfg) == rs.ask(
            text, max_new_tokens=14, sampler=jcfg(cfg))
        assert ps.last_out == [int(t) for t in rs.last_out] and ps.fed == rs.fed


@pytest.mark.parametrize("mirostat", [1, 2])
def test_mirostat_generation_repeats_from_its_seed(port_engine, mirostat):
    cfg = port.SamplerConfig(mirostat=mirostat, mirostat_tau=8.0, temperature=1.0)
    gen = port_engine.engine
    ids = port_engine.tokenizer.encode(ENGINE_PROMPT)
    a = gen.generate(ids, max_new_tokens=16, sampler=cfg, seed=4, stop_at_eos=False)
    assert gen.generate(ids, max_new_tokens=16, sampler=cfg, seed=4, stop_at_eos=False) == a
    assert gen.generate(ids, max_new_tokens=16, sampler=cfg, seed=5, stop_at_eos=False) != a
    s = port_engine.chat_session(template="vicuna")
    s.ask("the fox", max_new_tokens=8, sampler=cfg, seed=2)
    assert s.gen.sstate.mu[0] != 16.0  # mu moved from 2 tau


class _ReplayGraph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def test_new_state_recaptures(port_engine, monkeypatch):
    """The step graph holds the state's tensors: a state made anew (other
    addresses) recaptures instead of replaying a graph on stale ones, and
    a reset in place replays. The tokens stay the eager run's."""
    monkeypatch.setattr(graphs.StepGraphs, "_warm_up", lambda self, body: body())
    monkeypatch.setattr(graphs.StepGraphs, "_capture", lambda self, body: _ReplayGraph(body))
    monkeypatch.delenv("EAGLE_TPU_FUSED_FFN", raising=False)
    gen = port_engine.engine
    cfg = GREEDY["repeat"]
    ids = port_engine.tokenizer.encode(ENGINE_PROMPT)
    eager = gen.generate(ids, max_new_tokens=12, sampler=cfg, stop_at_eos=False)
    monkeypatch.setattr(gen, "graphs", graphs.StepGraphs(enabled=True))
    assert gen.generate(ids, max_new_tokens=12, sampler=cfg, stop_at_eos=False) == eager
    first = gen.graphs.captures
    assert first == 1
    assert gen.generate(ids, max_new_tokens=12, sampler=cfg, stop_at_eos=False) == eager
    assert gen.graphs.captures == first and gen.graphs.replays > 0
    old = gen.sstate  # kept: the new state lies elsewhere
    monkeypatch.setattr(gen, "sstate", None)  # the next run makes a new state
    assert gen.generate(ids, max_new_tokens=12, sampler=cfg, stop_at_eos=False) == eager
    assert gen.graphs.captures == first + 1
    assert old.counts.data_ptr() != gen.sstate.counts.data_ptr()

"""Grammar-constrained decoding in the port (`Generator.generate_constrained`,
`EagleChainEngine.generate_constrained` with its proposal and commit,
`Engine.generate_text(grammar=, json_schema=)`, the CLI's `--grammar`,
`--json-schema` and `--repeat-penalty`) against the reference on the CPU,
both packages on one tiny GGUF pair (`tiny_engine_pair`: Q8_0, an SPM
vocabulary of 512 pieces whose byte tokens spell JSON's punctuation), f32,
max_seq 128, the chain drafting K = 3. The reference runs each scenario
once per module.

- the plain constrained generator, greedy and sampled at one seed (numpy's
  `default_rng(seed).choice`, as the reference), gives the reference's
  tokens on a word grammar, a GBNF of three items and a JSON schema;
- the chain's constrained tokens equal the plain generator's
  (tests/test_spec_grammar.py), with the random draft and with an oracle
  draft (its logits boosted at the constrained continuation, in both
  packages) that gets drafts accepted; so do the reference chain's tokens
  and stats (`n_cycles`, `n_accepted`, `mean_accept_len`), but under a
  grammar where the reference falls back to the lowest legal token id (no
  legal candidate in the target's top 256), which the test shows is where
  the two part; the first token is the reference's (the masked argmax of
  the prompt's last logits);
- the JSON-schema path: `json.loads` of the text where it ends;
- `Engine.generate_text` with a grammar and a schema on the plain, chain
  and tree engines, and the CLI with `--grammar` (chain), `--json-schema`
  and `--repeat-penalty` (plain), give the reference's text;
- the refusals where the reference drops the sampler's state: an engine
  with a draft and a stateful sampler (also through the CLI),
  `set_row_sampler`, a stateful sampler with a grammar; constrained
  speculation on a batch of 2 raises ValueError naming batch 1."""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eagle_tpu.api as jax_api
import eagle_tpu.runtime.speculative as jax_spec
import eagle_tpu_torch.api as port_api
import eagle_tpu_torch.runtime.speculative as port_spec
from eagle_tpu.runtime.grammar import Grammar as JaxGrammar
from eagle_tpu.runtime.json_schema import json_schema_to_gbnf as jax_schema_to_gbnf
from eagle_tpu.runtime.sampling import SamplerConfig as JaxSamplerConfig
from eagle_tpu.tools import cli as jax_cli
from eagle_tpu_torch.runtime.grammar import Grammar, TokenTrie
from eagle_tpu_torch.runtime.json_schema import json_schema_to_gbnf
from eagle_tpu_torch.runtime.sampling import DroppedSamplerState, SamplerConfig
from eagle_tpu_torch.tools import cli
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT,
    background_cpu,
    oracle,
    tiny_engine_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

MAX_SEQ = 128
K = 3
PROMPT = "the quick brown fox"
GRAMMARS = {
    "words": "root ::= [a-z ]+",
    "items": 'root ::= item item item\nitem ::= ("the" | "fox" | "dog" | "lazy") " "',
}
SCHEMA = {"type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "boolean"}},
          "required": ["a", "b"]}
SAMPLED = SamplerConfig(temperature=0.9, top_k=40, top_p=0.95, min_p=0.05)
#: grammars under which the reference's chain meets a vetoed row with no
#: legal token among the target's top 256 (half of V = 512) and falls back
#: to the lowest legal token id (ROADMAP queue 3): the port keeps the plain
#: generator's tokens there
N_NEW = 16
FALLS_BACK = {"items"}


def jcfg(cfg: SamplerConfig) -> JaxSamplerConfig:
    return JaxSamplerConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tiny_engine_pair(tmp_path_factory.mktemp("constrained"), ENGINE_PROMPT)


def _jax_engine(pair, draft: bool, **kw):
    return jax_api.Engine(jax_api.EngineConfig(
        model_path=str(pair[0]), draft_path=str(pair[1]) if draft else None, n_draft=K,
        max_seq=MAX_SEQ, backend="xla", compute_dtype=jnp.float32, kv_dtype=jnp.float32, **kw))


def _port_engine(pair, draft: bool, **kw):
    return port_api.Engine(port_api.EngineConfig(
        model_path=pair[0], draft_path=pair[1] if draft else None, n_draft=K, max_seq=MAX_SEQ,
        compute_dtype=torch.float32, kv_dtype=torch.float32, device="cpu", **kw))


@pytest.fixture(scope="module")
def engines(pair):
    """(reference plain, reference chain, port plain, port chain) and a
    cache of the reference's runs."""
    return (_jax_engine(pair, False), _jax_engine(pair, True), _port_engine(pair, False),
            _port_engine(pair, True), {})


def once(engines, key, fn):
    runs = engines[4]
    if key not in runs:
        runs[key] = fn()
    return runs[key]


def _gbnf(name):
    return json_schema_to_gbnf(SCHEMA) if name == "schema" else GRAMMARS[name]


def _ref_plain(engines, name, sampled, n=N_NEW):
    def run():
        eng = engines[0]
        g = JaxGrammar(jax_schema_to_gbnf(SCHEMA) if name == "schema" else GRAMMARS[name])
        ids = eng.tokenizer.encode(PROMPT)
        return [int(t) for t in eng.engine.generate_constrained(
            ids, g, eng.tokenizer, max_new_tokens=n,
            sampler=jcfg(SAMPLED) if sampled else None, seed=7)]

    return once(engines, ("plain", name, sampled, n), run)


PLAIN = [("words", False), ("items", False), ("schema", False), ("schema", True)]


@pytest.mark.parametrize("name,sampled", PLAIN,
                         ids=[f"{n}-{'sampled' if s else 'greedy'}" for n, s in PLAIN])
def test_plain_constrained_matches_reference(engines, name, sampled):
    port = engines[2]
    ids = port.tokenizer.encode(PROMPT)
    g = Grammar(_gbnf(name))
    got = port.engine.generate_constrained(ids, g, port.tokenizer, max_new_tokens=N_NEW,
                                           sampler=SAMPLED if sampled else None, seed=7)
    assert got == _ref_plain(engines, name, sampled)
    text = "".join(port.tokenizer.piece(t) for t in got if t != port.tokenizer.eos_id)
    if got[-1] == port.tokenizer.eos_id or name == "items":  # the grammar ran to its end
        assert Grammar(_gbnf(name)).accepts_text(text, partial=False), text
    else:
        assert Grammar(_gbnf(name)).accepts_text(text), text


def _jax_oracle(real, seq, boost: float = 1e4):
    """`oracle` on the reference's side (jnp ops inside its jitted cycle)."""
    seq_j = jnp.asarray(seq, jnp.int32)

    def forward(*args, **kw):
        out = real(*args, **kw)
        if out.logits is None:
            return out
        want = seq_j[jnp.clip(args[5] + 2, 0, len(seq) - 1)]
        return out._replace(logits=out.logits + boost * jax.nn.one_hot(
            want, out.logits.shape[-1], dtype=out.logits.dtype))

    return forward


def _ref_chain(engines, pair, name, with_oracle, n=N_NEW):
    def run():
        eng = engines[1] if not with_oracle else _jax_engine(pair, True)
        ids = eng.tokenizer.encode(PROMPT)
        g = JaxGrammar(jax_schema_to_gbnf(SCHEMA) if name == "schema" else GRAMMARS[name])
        if with_oracle:
            seq = ids + _ref_plain(engines, name, False, n)
            real = jax_spec.eagle_forward
            jax_spec.eagle_forward = _jax_oracle(real, seq)
            try:
                out, stats = eng.engine.generate_constrained(ids, g, eng.tokenizer,
                                                             max_new_tokens=n, seed=3)
            finally:
                jax_spec.eagle_forward = real
        else:
            out, stats = eng.engine.generate_constrained(ids, g, eng.tokenizer,
                                                         max_new_tokens=n, seed=3)
        return [int(t) for t in out], stats

    return once(engines, ("chain", name, with_oracle, n), run)


CHAIN = [("words", False), ("words", True), ("items", False), ("schema", False)]


@pytest.mark.parametrize("name,with_oracle", CHAIN,
                         ids=[f"{n}-{'oracle' if o else 'draft'}" for n, o in CHAIN])
def test_chain_constrained_matches_reference(engines, pair, monkeypatch, name, with_oracle):
    port = engines[3]
    assert type(port.engine) is port_spec.EagleChainEngine
    ids = port.tokenizer.encode(PROMPT)
    want, want_stats = _ref_chain(engines, pair, name, with_oracle)
    if with_oracle:
        seq = torch.tensor(ids + _ref_plain(engines, name, False))
        monkeypatch.setattr(port_spec, "eagle_forward", oracle(port_spec.eagle_forward, seq))
    got, stats = port.engine.generate_constrained(ids, Grammar(_gbnf(name)), port.tokenizer,
                                                  max_new_tokens=N_NEW, seed=3)
    # speculation does not change the text: the plain constrained generator's
    assert got == _ref_plain(engines, name, False)
    if name in FALLS_BACK:
        _assert_reference_falls_back(port.tokenizer, _gbnf(name), got, want)
    else:
        assert got == want and stats == want_stats
    if with_oracle and name == "words":
        assert stats["n_accepted"] > 0 and stats["mean_accept_len"] > 1.5


def _assert_reference_falls_back(tok, gbnf, got, want):
    """Where the reference's chain leaves the port's (and the plain
    generator's) tokens, it took the lowest legal token id: no candidate of
    the target's top 256 was legal there, and the port took the masked
    argmax of the row instead."""
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    g = Grammar(gbnf)
    pieces = [tok.piece(t) for t in range(tok.vocab_size)]
    for t in got[:i]:
        g.accept_token(t, pieces[t])
    gmask = g.token_mask(TokenTrie(pieces))
    gmask[tok.eos_id] = bool(g.can_end)
    assert want[i] == int(np.nonzero(gmask)[0][0]) != got[i] and gmask[got[i]]


def test_chain_first_token_is_the_masked_prompt_argmax(engines):
    """The first token comes from the prefill's last logits row, as the
    reference's recomputed one: the masked argmax under the grammar."""
    port = engines[3]
    ids = port.tokenizer.encode(PROMPT)
    g = Grammar(GRAMMARS["items"])
    out, _ = port.engine.generate_constrained(ids, g, port.tokenizer, max_new_tokens=1)
    row = port.engine.prompt_logits[0].numpy()
    pieces = [port.tokenizer.piece(i) for i in range(len(row))]
    mask = Grammar(GRAMMARS["items"]).token_mask(TokenTrie(pieces))
    mask[port.tokenizer.eos_id] = False
    assert out == [int(np.argmax(np.where(mask, row, -np.inf)))]
    assert out[0] == _ref_chain(engines, None, "items", False)[0][0]


def test_schema_output_parses(engines):
    """The JSON schema's text, the same from the chain and the plain
    generator, reads with `json.loads` and holds the schema's keys."""
    text, stats = engines[3].generate_text(PROMPT, max_new_tokens=48, json_schema=SCHEMA)
    assert stats["constrained"] and stats["n_cycles"] >= 1
    assert text == engines[2].generate_text(PROMPT, max_new_tokens=48, json_schema=SCHEMA)[0]
    obj = json.loads(text)
    assert isinstance(obj["a"], int) and isinstance(obj["b"], bool)


@pytest.mark.parametrize("kind", ["plain", "chain", "tree"])
@pytest.mark.parametrize("what", ["words", "schema_text"])
def test_generate_text_matches_reference(engines, pair, kind, what):
    """`Engine.generate_text`: a chain engine speculates under the grammar
    (its stats the reference chain's), a tree engine and no draft take the
    plain constrained generator (stats `{"constrained": True}`); the text
    is the reference's (`generate_text` decodes the reference's tokens of
    the same run, the EOS left out)."""
    kw = dict(grammar=GRAMMARS["words"]) if what == "words" else dict(
        json_schema=json.dumps(SCHEMA))
    if kind == "tree":
        port = _port_engine(pair, True, tree_branching=(2,))
        assert type(port.engine) is not port_spec.EagleChainEngine
    else:
        port = engines[2] if kind == "plain" else engines[3]
    text, stats = port.generate_text(PROMPT, max_new_tokens=N_NEW, **kw)
    name = "words" if what == "words" else "schema"
    toks = _ref_plain(engines, name, False)
    tok = engines[0].tokenizer
    assert text == tok.decode([t for t in toks if t != tok.eos_id], skip_special=True)
    if kind == "chain" and name not in FALLS_BACK:
        assert stats == _ref_chain(engines, pair, name, False)[1]
    elif kind == "chain":
        assert stats["constrained"] and stats["n_cycles"] >= 1
    else:
        assert stats == {"constrained": True}


@pytest.fixture
def f32_configs(monkeypatch):
    """Both CLIs' engines at f32 (their default compute is bf16)."""
    monkeypatch.setattr(jax_api, "EngineConfig", functools.partial(
        jax_api.EngineConfig, compute_dtype=jnp.float32, kv_dtype=jnp.float32))
    monkeypatch.setattr(port_api, "EngineConfig", functools.partial(
        port_api.EngineConfig, compute_dtype=torch.float32, kv_dtype=torch.float32))


CLI_RUNS = {
    "grammar_chain": ["--draft", "DRAFT", "--grammar", GRAMMARS["items"]],
    "json_schema": ["--json-schema", json.dumps(SCHEMA)],
    "repeat_penalty": ["--repeat-penalty", "1.3", "--temp", "0", "-n", "20"],
}


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_matches_reference_cli(pair, engines, f32_configs, capsys, name):
    flags = [str(pair[1]) if f == "DRAFT" else f for f in CLI_RUNS[name]]
    base = ["-m", str(pair[0]), "-p", PROMPT, "--ctx", str(MAX_SEQ), "-n", "16"]

    def ref_text():
        assert jax_cli.main(base + ["--backend", "xla"] + flags) == 0
        return capsys.readouterr().out

    want = once(engines, ("cli", name), ref_text)
    capsys.readouterr()
    assert cli.main(base + ["--device", "cpu"] + flags) == 0
    out, err = capsys.readouterr()
    assert out == want and out.strip()
    if name == "grammar_chain":
        assert Grammar(GRAMMARS["items"]).accepts_text(out.rstrip("\n"))
    if name == "repeat_penalty":  # the penalty changed the greedy text
        assert cli.main(base + ["--device", "cpu", "--temp", "0", "-n", "20"]) == 0
        assert capsys.readouterr().out != out


# ---- refusals where the reference drops the sampler's state ------------------------

STATEFUL = SamplerConfig(greedy=True, penalty_repeat=1.2)


def _refusal(name, pair, engines):
    if name == "engine_with_draft":
        _port_engine(pair, True, sampler=SamplerConfig(mirostat=2))
    elif name == "tree_engine":
        _port_engine(pair, True, tree_branching=(2,), sampler=STATEFUL)
    elif name == "chain_engine":
        port_spec.EagleChainEngine(engines[3].params, engines[3].draft_params,
                                   engines[3].model_cfg, engines[3].draft_cfg, max_seq=32,
                                   sampler=SamplerConfig(dry_multiplier=0.5), device="cpu")
    elif name == "set_row_sampler":
        engines[3].engine.set_row_sampler(0, SamplerConfig(penalty_freq=0.2))
    elif name == "grammar_plain":
        engines[2].generate_text(PROMPT, max_new_tokens=4, grammar=GRAMMARS["words"],
                                 sampler=STATEFUL)
    elif name == "grammar_chain":
        engines[3].generate_text(PROMPT, max_new_tokens=4, json_schema=SCHEMA,
                                 sampler=SamplerConfig(mirostat=1))
    elif name == "generate_constrained":
        port = engines[2]
        port.engine.generate_constrained([1, 5], Grammar(GRAMMARS["words"]), port.tokenizer,
                                         sampler=SamplerConfig(penalty_present=0.5))
    elif name == "cli_draft":
        cli.main(["-m", str(pair[0]), "--draft", str(pair[1]), "-p", "a", "--device", "cpu",
                  "--repeat-penalty", "1.1"])
    elif name == "cli_grammar":
        cli.main(["-m", str(pair[0]), "-p", "a", "--device", "cpu", "--repeat-penalty", "1.1",
                  "--grammar", GRAMMARS["words"]])


REFUSALS = ["engine_with_draft", "tree_engine", "chain_engine", "set_row_sampler",
            "grammar_plain", "grammar_chain", "generate_constrained", "cli_draft",
            "cli_grammar"]


@pytest.mark.parametrize("name", REFUSALS)
def test_dropped_state_is_refused(pair, engines, name):
    with pytest.raises(DroppedSamplerState, match="drops the sampler's state"):
        _refusal(name, pair, engines)
    assert engines[3].engine.bsampler.penalty_freq[0] == 0.0  # the row kept its sampler


def test_constrained_speculation_needs_batch_one(pair):
    eng = _port_engine(pair, True, batch=2)
    with pytest.raises(ValueError, match="batch 1"):
        eng.generate_text(PROMPT, max_new_tokens=4, grammar=GRAMMARS["words"])

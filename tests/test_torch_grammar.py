"""The port's grammar engine and JSON-schema converter
(eagle_tpu_torch/runtime/grammar.py and json_schema.py, copies of the
reference's) against the reference on the CPU:

- every case of tests/test_grammar.py and tests/test_json_schema.py runs
  on the port's modules (the reference's test bodies, with the reference's
  modules swapped for the port's), but the 32,000-piece speed test and the
  end-to-end generation test (held against the reference in
  tests/test_torch_constrained.py);
- `json_schema_to_gbnf` gives the reference's text for every schema of
  tests/test_json_schema.py and the tool schemas;
- the parser's rules, `accepts_text` on a set of texts (whole and
  partial), `token_mask` over a vocabulary of 800 pieces after each prefix,
  and the lazy triggers (words and tokens) give the reference's answers on
  every grammar of those files. The vocabularies stay small: no 32k mask
  in these tests."""

from __future__ import annotations

import importlib
import json
import sys
import types

import numpy as np
import pytest

import eagle_tpu.runtime.grammar as ref_grammar
import eagle_tpu.runtime.json_schema as ref_schema
import eagle_tpu_torch.runtime.grammar as port_grammar
import eagle_tpu_torch.runtime.json_schema as port_schema

GRAMMAR_CASES = importlib.import_module("test_grammar")
SCHEMA_CASES = importlib.import_module("test_json_schema")
SKIP = {"test_token_mask_speed_32k_vocab", "test_constrained_generation_obeys_grammar"}


def _cases(mod):
    return sorted(n for n, f in vars(mod).items()
                  if n.startswith("test_") and callable(f) and n not in SKIP)


def run_on_port(fn, monkeypatch, names: dict):
    """Run a reference test body with its module-level names and its
    in-body imports bound to the port's modules."""
    monkeypatch.setitem(sys.modules, "eagle_tpu.runtime.grammar", port_grammar)
    monkeypatch.setitem(sys.modules, "eagle_tpu.runtime.json_schema", port_schema)
    glb = dict(fn.__globals__)
    glb.update(names)
    types.FunctionType(fn.__code__, glb, fn.__name__, fn.__defaults__, fn.__closure__)()


@pytest.mark.parametrize("name", _cases(GRAMMAR_CASES))
def test_grammar_case_on_port(name, monkeypatch):
    run_on_port(getattr(GRAMMAR_CASES, name), monkeypatch,
                {"Grammar": port_grammar.Grammar,
                 "GrammarParseError": port_grammar.GrammarParseError})


@pytest.mark.parametrize("name", _cases(SCHEMA_CASES))
def test_json_schema_case_on_port(name, monkeypatch):
    run_on_port(getattr(SCHEMA_CASES, name), monkeypatch,
                {"Grammar": port_grammar.Grammar,
                 "json_schema_to_gbnf": port_schema.json_schema_to_gbnf})


def test_cases_are_all_run():
    """The reference's files hold the cases run here, and nothing was left
    out but the two named ones."""
    assert len(_cases(GRAMMAR_CASES)) >= 14 and len(_cases(SCHEMA_CASES)) >= 8
    assert SKIP <= set(vars(GRAMMAR_CASES))


TOOL_SCHEMA = {"type": "object", "properties": {"name": {"const": "add"},
                                                "arguments": {"type": "object", "properties": {
                                                    "a": {"type": "integer"}},
                                                    "required": ["a"]}},
               "required": ["name", "arguments"]}
SCHEMAS = {
    "enum": {"enum": ["red", "green", "blue"]}, "const": {"const": 42},
    "integer": {"type": "integer"}, "number": {"type": "number"},
    "string": {"type": "string"}, "boolean": {"type": "boolean"}, "null": {"type": "null"},
    "object": {"type": "object", "properties": {"name": {"type": "string"},
                                                "age": {"type": "integer"}},
               "required": ["name", "age"]},
    "optional_props": {"type": "object", "properties": {"a": {"type": "integer"},
                                                        "b": {"type": "string"}},
                       "required": ["a"]},
    "array": {"type": "array", "items": {"type": "integer"}},
    "anyof": {"anyOf": [{"type": "integer"}, {"type": "boolean"}]},
    "oneof": {"oneOf": [{"type": "string"}, {"type": "null"}]},
    "refs": {"type": "object", "properties": {"a": {"$ref": "#/$defs/num"}}, "required": ["a"],
             "$defs": {"num": {"type": "integer"}}},
    "tool_call": TOOL_SCHEMA,
    "empty": {},
}


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_json_schema_to_gbnf_matches_reference(name):
    schema = SCHEMAS[name]
    got = port_schema.json_schema_to_gbnf(schema)
    assert got == ref_schema.json_schema_to_gbnf(schema)
    assert got == port_schema.json_schema_to_gbnf(json.dumps(schema))  # a JSON text too


JSON_GBNF = (
    'root ::= object\n'
    'object ::= "{" ws ( string ":" ws value ("," ws string ":" ws value)* )? "}"\n'
    'value ::= object | array | string | number | "true" | "false" | "null"\n'
    'array ::= "[" ws ( value ("," ws value)* )? "]" ws\n'
    'string ::= "\\"" [^"\\\\]* "\\"" ws\n'
    'number ::= "-"? [0-9]+ ("." [0-9]+)? ws\n'
    'ws ::= [ \\t\\n]*\n')
GRAMMARS = {  # (GBNF, texts to test, a prefix to accept before the mask)
    "alternates": ('root ::= "yes" | "no"', ["yes", "no", "y", "maybe", "yess", ""], "y"),
    "class_star": ("root ::= [a-z]*", ["", "abcxyz", "ABC", "a1"], "ab"),
    "plus_question": ('root ::= [0-9]+ "."? [0-9]*', ["42", "3.14", "7.", ".5", "1..2"], "3"),
    "recursion": ('root ::= expr\nexpr ::= term ("+" term)*\nterm ::= [0-9]+',
                  ["1+2+33", "1++2", "7", "+"], "1+"),
    "negated": ('root ::= "\\"" [^"]* "\\""', ['"hello"', '"he"llo"', '"'], '"h'),
    "bounded": ("root ::= [a]{2,4}", ["a", "aa", "aaaa", "aaaaa"], "a"),
    "escapes": ('root ::= "\\n" [\\t ]', ["\n\t", "\n ", "\n\n"], "\n"),
    "json": (JSON_GBNF, ['{"a": 1, "b": [true, null]}', '{"nested": {"x": -2.5}}', '{"a": }',
                         "[1,2]", '{"k'], '{"a'),
    "items": ('root ::= item item item\nitem ::= ("aa" | "bb" | "cc") " "',
              ["aa bb cc ", "aa bb", "aa dd ", "cc cc cc cc "], "aa "),
    **{f"schema_{k}": (ref_schema.json_schema_to_gbnf(SCHEMAS[k]),
                       ['{"name": "bob", "age": 5}', '{"a": 3}', '"red"', "42", "-2e10", "[1, 2]",
                        "true", "null", '{"name": "add", "arguments": {"a": 1}}', '"x"'], '{"')
       for k in ("object", "refs", "enum", "number", "array", "anyof", "tool_call")},
}


def vocab(n: int = 800, seed: int = 0) -> list[str]:
    """tests/test_grammar.py's fake vocabulary, the grammars' characters
    added: JSON's punctuation, letters, digits and a few words."""
    rng = np.random.default_rng(seed)
    pieces = ['{', '}', '[', ']', '"', ':', ',', ' ', 'true', 'false', 'null', '":', '",', '{"',
              '"}', "yes", "no", "y", "aa", "bb", "cc", " ", "\n", "\t", "+", ".", "", "add",
              "name", "arguments", "\\", "\\n"]
    alphabet = list('abcdefghijklmnopqrstuvwxyz0123456789 .-_"{}[]:,+\\')
    while len(pieces) < n:
        pieces.append("".join(rng.choice(alphabet) for _ in range(int(rng.integers(1, 6)))))
    return pieces


@pytest.mark.parametrize("name", list(GRAMMARS))
def test_grammar_answers_match_reference(name):
    src, texts, prefix = GRAMMARS[name]
    got, want = port_grammar.Grammar(src), ref_grammar.Grammar(src)
    assert got.rule_names == want.rule_names
    assert repr(got.rules_by_id) == repr(want.rules_by_id)
    for t in texts:
        for partial in (True, False):
            assert got.accepts_text(t, partial=partial) == want.accepts_text(t, partial=partial), \
                (t, partial)
    pieces = vocab()
    pt, rt = port_grammar.TokenTrie(pieces), ref_grammar.TokenTrie(pieces)
    np.testing.assert_array_equal(got.token_mask(pt), want.token_mask(rt))
    assert got.allowed_mask(pieces[:200]) == want.allowed_mask(pieces[:200])
    try:
        want.accept_text(prefix)
    except ValueError:
        with pytest.raises(ValueError):
            got.accept_text(prefix)
        return
    got.accept_text(prefix)
    assert got.can_end == want.can_end
    np.testing.assert_array_equal(got.token_mask(pt), want.token_mask(rt))


@pytest.mark.parametrize("trigger", ["word", "token"])
def test_lazy_triggers_match_reference(trigger):
    """A lazy grammar, before and after its trigger (a word inside a piece,
    or a token id), masks as the reference's."""
    src = 'root ::= "{" [a-z]* "}"'
    kw = dict(trigger_words=["{"]) if trigger == "word" else dict(trigger_tokens=[2])
    pieces = ["Hello", " world", "{", "ab", "}", "zz9", "x{a", ""]
    got = port_grammar.Grammar(src, lazy=True, **kw)
    want = ref_grammar.Grammar(src, lazy=True, **kw)
    pt, rt = port_grammar.TokenTrie(pieces), ref_grammar.TokenTrie(pieces)
    for tid in (0, 1, 2, 3, 4):
        assert got.awaiting_trigger == want.awaiting_trigger
        np.testing.assert_array_equal(got.token_mask(pt), want.token_mask(rt))
        got.accept_token(tid, pieces[tid])
        want.accept_token(tid, pieces[tid])
    assert got.can_end == want.can_end and not got.awaiting_trigger


def test_parse_errors_match_reference():
    for src in ('start ::= "x"', 'root ::= "unterminated', "root ::= [a-", "root ::= ( x"):
        with pytest.raises(Exception) as want:
            ref_grammar.Grammar(src)
        with pytest.raises(Exception) as got:
            port_grammar.Grammar(src)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)

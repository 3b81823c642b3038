"""The port's tool-call parsing and tool grammars
(eagle_tpu_torch/server/tool_calls.py, a copy of the reference's) against
the reference on the CPU:

- every case of tests/test_tool_calls.py runs on the port's modules (the
  reference's test bodies, the reference's modules swapped for the
  port's);
- `detect_format`, `parse` (content, reasoning, every tool call's name,
  arguments and id) and `as_openai` give the reference's answers on every
  input of that file, with and without reasoning extraction;
- `build_tool_grammar`'s GBNF text and triggers equal the reference's for
  every format, required or lazy, and the grammars accept the same texts."""

from __future__ import annotations

import dataclasses
import importlib
import sys
import types

import pytest

import eagle_tpu.server.tool_calls as ref
import eagle_tpu_torch.runtime.grammar as port_grammar
import eagle_tpu_torch.runtime.json_schema as port_schema
import eagle_tpu_torch.server.tool_calls as port

CASES = importlib.import_module("test_tool_calls")


def _cases():
    return sorted(n for n, f in vars(CASES).items() if n.startswith("test_") and callable(f))


@pytest.mark.parametrize("name", _cases())
def test_tool_call_case_on_port(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "eagle_tpu.runtime.grammar", port_grammar)
    monkeypatch.setitem(sys.modules, "eagle_tpu.runtime.json_schema", port_schema)
    monkeypatch.setitem(sys.modules, "eagle_tpu.server.tool_calls", port)
    fn = getattr(CASES, name)
    glb = dict(fn.__globals__)
    glb.update(ChatMsg=port.ChatMsg, build_tool_grammar=port.build_tool_grammar,
               detect_format=port.detect_format, parse=port.parse)
    types.FunctionType(fn.__code__, glb, fn.__name__, fn.__defaults__, fn.__closure__)()


TEMPLATES = ["...<｜tool▁calls▁begin｜>...", "...<|END_THINKING|><|START_ACTION|>...",
             "...>>>all...", "... functools[...", "...<tool_call>...",
             "<|start_header_id|>x<function=f>",
             "<|start_header_id|>ipython<|end_header_id|><|python_tag|>",
             "<|start_header_id|>ipython<|end_header_id|>", "...[TOOL_CALLS]...",
             "{{ messages }}", ""]


@pytest.mark.parametrize("has_tools", [True, False])
def test_detect_format_matches_reference(has_tools):
    for src in TEMPLATES:
        assert port.detect_format(src, has_tools=has_tools) == ref.detect_format(
            src, has_tools=has_tools), src


DS = ("<think>I'm\nthinking</think><｜tool▁calls▁begin｜><｜tool▁call▁begin｜>function"
      "<｜tool▁sep｜>special_function\n```json\n{\"arg1\": 1}\n```<｜tool▁call▁end｜>"
      "<｜tool▁calls▁end｜>")
OUTPUTS = [  # (text, format): the inputs of tests/test_tool_calls.py and a few more
    ("Hello there", "content_only"),
    ('<tool_call>\n{"name": "special_function", "arguments": {"arg1": 1}}\n</tool_call>',
     "hermes_2_pro"),
    ("I'll call it now.\n<tool_call>\n{\"name\": \"f\", \"arguments\": {}}\n</tool_call>\n"
     "<tool_call>\n{\"name\": \"g\", \"arguments\": {\"x\": \"y\"}}\n</tool_call>",
     "hermes_2_pro"),
    ("<tool_call>\n{not json", "hermes_2_pro"),
    ('{"name": "special_function", "parameters": {"arg1": 1}}', "llama_3_x"),
    ('<|python_tag|>brave_search.call(query="Who?")', "llama_3_x_builtin"),
    ('[TOOL_CALLS][{"name": "special_function", "arguments": {"arg1": 1}, "id": "123456789"}]',
     "mistral_nemo"),
    (' functools[{"name": "special_function", "arguments": {"arg1": 1}}]', "firefunction_v2"),
    (DS, "deepseek_r1"),
    ("<think>hmm</think>The answer is 4.", "deepseek_r1"),
    ('all\nHello, world!\n>>>special_function\n{"arg1": 1}', "functionary_v3_2"),
    ("all\njust text", "functionary_v3_2"),
    ('<function=special_function>{"arg1": 1}</function>', "functionary_v3_1"),
    ("<|python_tag|>print(1)", "functionary_v3_1"),
    ('<|START_THINKING|>deep thought<|END_THINKING|><|START_ACTION|>[{"tool_call_id": "0", '
     '"tool_name": "special_function", "parameters": {"arg1": 1}}]<|END_ACTION|>',
     "command_r7b"),
    ("<|START_RESPONSE|>42<|END_RESPONSE|>", "command_r7b"),
    ('{"tool_calls": [{"name": "f", "arguments": {"a": 1}, "id": "9"}]}', "generic"),
    ('{"tool_call": {"name": "g", "arguments": {"q": 1}}}', "generic"),
    ('{"response": "hi"}', "generic"),
    ('{"tool_call": {"name": "add", "arguments": {"a": 5}}', "generic"),  # unclosed
]


def _plain(msg):
    return dataclasses.asdict(msg) | {"openai": [tc.as_openai() for tc in msg.tool_calls]}


@pytest.mark.parametrize("text,fmt", OUTPUTS, ids=[f"{i}-{o[1]}" for i, o in enumerate(OUTPUTS)])
@pytest.mark.parametrize("extract", [True, False])
def test_parse_matches_reference(text, fmt, extract):
    assert _plain(port.parse(text, fmt, extract_reasoning=extract)) == _plain(
        ref.parse(text, fmt, extract_reasoning=extract))


TOOLS = [{"type": "function", "function": {
    "name": "special_function", "description": "I'm special",
    "parameters": {"type": "object", "properties": {"arg1": {"type": "integer"}},
                   "required": ["arg1"]}}},
    {"type": "function", "function": {"name": "add", "parameters": {
        "type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "number"}},
        "required": ["a"]}}}]
FORMATS = ["hermes_2_pro", "mistral_nemo", "llama_3_x", "generic"]
CALLS = ['<tool_call> {"name": "add", "arguments": {"a": 1}} </tool_call> ',
         '[TOOL_CALLS] [ {"name": "special_function", "arguments": {"arg1": 1}} ]',
         '{"name": "add", "parameters": {"a": 2, "b": 1.5}}',
         '{ "tool_call": {"name": "add", "arguments": {"a": 3}} }',
         '{"tool_call": {"name": "nope", "arguments": {}}}']


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("required", [True, False])
def test_build_tool_grammar_matches_reference(fmt, required):
    got, got_trig = port.build_tool_grammar(TOOLS, fmt, required=required)
    want, want_trig = ref.build_tool_grammar(TOOLS, fmt, required=required)
    assert got.gbnf_source == want.gbnf_source and got_trig == want_trig
    assert got.awaiting_trigger == want.awaiting_trigger == (not required)
    if required:
        for text in CALLS:
            assert got.accepts_text(text) == want.accepts_text(text), text

"""Tool-call (function-calling) output parsing + constrained-grammar setup.

The port's own copy of eagle_tpu/server/tool_calls.py,
unchanged but for this note: pure Python, kept here because the port
imports nothing of the JAX package.

Python re-implementation of the reference's `common/chat.cpp` (format
detection at common/chat.cpp:1436-1496, per-format parsers at :713-1390):
given a model's raw completion text and the chat format implied by its
template, extract `content` / `reasoning_content` / `tool_calls` the way the
reference's `common_chat_parse` does, and optionally build a lazy
trigger-grammar from the tool JSON schemas so generation is constrained to
well-formed calls (chat.cpp builds GBNF the same way via json-schema →
grammar; we reuse runtime/json_schema.py + runtime/grammar.py).

Formats (COMMON_CHAT_FORMAT_*, chat.cpp:432-449): content_only, generic,
mistral_nemo, llama_3_x (+ builtin tools), deepseek_r1, firefunction_v2,
functionary_v3_2, functionary_v3_1_llama_3_1, hermes_2_pro, command_r7b.
"""

from __future__ import annotations

import dataclasses
import json
import re


@dataclasses.dataclass
class ToolCall:
    name: str
    arguments: str  # JSON-encoded argument object (string, like the reference)
    id: str = ""

    def as_openai(self) -> dict:
        return {
            "id": self.id or f"call_{abs(hash((self.name, self.arguments))) % 10**8}",
            "type": "function",
            "function": {"name": self.name, "arguments": self.arguments},
        }


@dataclasses.dataclass
class ChatMsg:
    role: str = "assistant"
    content: str = ""
    reasoning_content: str = ""
    tool_calls: list[ToolCall] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# format detection (common_chat_templates_apply_jinja, chat.cpp:1436-1496)
# ---------------------------------------------------------------------------

FORMATS = (
    "content_only", "generic", "mistral_nemo", "llama_3_x",
    "llama_3_x_builtin", "deepseek_r1", "firefunction_v2",
    "functionary_v3_2", "functionary_v3_1", "hermes_2_pro", "command_r7b",
)


def detect_format(template_source: str, has_tools: bool = True) -> str:
    """Map a chat template's source text to a tool-call format, mirroring the
    marker checks in common_chat_templates_apply_jinja (chat.cpp:1438-1496)."""
    src = template_source or ""
    if "<｜tool▁calls▁begin｜>" in src:
        return "deepseek_r1"
    if "<|END_THINKING|><|START_ACTION|>" in src:
        return "command_r7b"
    if ">>>all" in src:
        return "functionary_v3_2"
    if " functools[" in src:
        return "firefunction_v2"
    if not has_tools:
        return "content_only"
    if "<tool_call>" in src:
        return "hermes_2_pro"
    if "<|start_header_id|>" in src and "<function=" in src:
        return "functionary_v3_1"
    if "<|start_header_id|>ipython<|end_header_id|>" in src:
        return "llama_3_x_builtin" if "<|python_tag|>" in src else "llama_3_x"
    if "[TOOL_CALLS]" in src:
        return "mistral_nemo"
    return "generic"


# ---------------------------------------------------------------------------
# shared helpers (chat.cpp:458-600)
# ---------------------------------------------------------------------------

_DECODER = json.JSONDecoder()


def _parse_json_at(s: str, pos: int):
    """Parse one JSON value starting at `pos` (ignoring leading whitespace);
    returns (value, end_index) or (None, pos) — the sax-probing parse_json
    (chat.cpp:458) equivalent."""
    m = re.compile(r"\s*").match(s, pos)
    start = m.end()
    try:
        val, end = _DECODER.raw_decode(s, start)
        return val, end
    except json.JSONDecodeError:
        return None, pos


def _dump_args(arguments) -> str:
    # the reference stores the arguments as a JSON string; a string-valued
    # `arguments` passes through as-is (chat.cpp:531)
    if isinstance(arguments, str):
        return arguments
    return json.dumps(arguments, ensure_ascii=False)


def parse_json_tool_calls(
    text: str, function_regex: str, close_regex: str,
) -> ChatMsg:
    """parse_json_tool_calls (chat.cpp:505-541): repeatedly find the function
    prefix (group 1 = name), parse the JSON arguments that follow, then match
    the close pattern; non-matching text accumulates as content."""
    msg = ChatMsg()
    fn_re = re.compile(function_regex)
    close_re = re.compile(close_regex)
    it = 0
    content = []
    while True:
        m = fn_re.search(text, it)
        if not m:
            content.append(text[it:])
            break
        content.append(text[it:m.start()])
        name = m.group(1)
        args, end = _parse_json_at(text, m.end())
        if args is None:
            raise ValueError(f"Failed to parse json tool call arguments: {text!r}")
        cm = close_re.search(text, end)
        if not cm:
            raise ValueError(f"Malformed input, missing closing pattern: {text!r}")
        it = cm.end()
        msg.tool_calls.append(ToolCall(name, _dump_args(args)))
    msg.content = "".join(content)
    if msg.tool_calls and msg.content.strip():
        msg.content = ""  # chat.cpp:536 drops stray content next to calls
    elif msg.tool_calls:
        msg.content = ""
    return msg


def parse_prefixed_json_tool_call_array(text: str, prefix: str, rstrip_prefix: int = 0) -> ChatMsg:
    """parse_prefixed_json_tool_call_array (chat.cpp:543-575): content up to
    `prefix`, then a JSON array of {name, arguments[, id]}."""
    msg = ChatMsg()
    idx = text.find(prefix)
    if idx < 0:
        msg.content = text
        return msg
    msg.content = text[:idx]
    arr, _ = _parse_json_at(text, idx + len(prefix) - rstrip_prefix)
    if arr is None:
        raise ValueError(f"Failed to parse tool call array: {text!r}")
    for tc in arr:
        msg.tool_calls.append(
            ToolCall(tc["name"], _dump_args(tc["arguments"]), tc.get("id", ""))
        )
    return msg


# ---------------------------------------------------------------------------
# per-format parsers
# ---------------------------------------------------------------------------


def _parse_generic(text: str) -> ChatMsg:
    data, _ = _parse_json_at(text, 0)
    msg = ChatMsg()
    if data is None or not isinstance(data, dict):
        msg.content = text
        return msg
    if "tool_calls" in data:
        for tc in data["tool_calls"]:
            msg.tool_calls.append(
                ToolCall(tc["name"], _dump_args(tc["arguments"]), tc.get("id", ""))
            )
    elif "tool_call" in data:
        tc = data["tool_call"]
        msg.tool_calls.append(ToolCall(tc["name"], _dump_args(tc["arguments"])))
    elif "response" in data:
        resp = data["response"]
        msg.content = resp if isinstance(resp, str) else json.dumps(resp, ensure_ascii=False)
    else:
        msg.content = text
    return msg


_LLAMA3_FN = (
    r"\{[\s\n\r]*(?:\"type\"[\s\n\r]*:[\s\n\r]*\"function\"[\s\n\r]*,[\s\n\r]*|[\s\n\r]*)"
    r"\"name\"[\s\n\r]*:[\s\n\r]*\"([^\"]+)\"[\s\n\r]*,[\s\n\r]*\"parameters\": "
)
_LLAMA3_BUILTIN = re.compile(r"<\|python_tag\|>([^.(]+)\.call\((.*)\)", re.S)


def _parse_llama_3_x(text: str, builtin: bool) -> ChatMsg:
    if builtin:
        m = _LLAMA3_BUILTIN.fullmatch(text)
        if m:
            name, raw = m.group(1), m.group(2)
            arg_name, _, arg_val = raw.partition("=")
            msg = ChatMsg(content=text[:m.start()])
            msg.tool_calls.append(
                ToolCall(name, json.dumps({arg_name: json.loads(arg_val)}, ensure_ascii=False))
            )
            return msg
    return parse_json_tool_calls(text, _LLAMA3_FN, r"\}")


_DS_REASONING = re.compile(r"((?:<think>)?([\s\S\r\n]*?)</think>)?([\s\S\r\n]*)", re.S)
_DS_TOOLCALLS = re.compile(
    r"[\s\r\n]*(?:<｜tool▁calls▁begin｜>|<｜tool_calls_begin｜>|"
    r"<｜tool calls begin｜>|<｜tool\\_calls\\_begin｜>)([\s\S\r\n]*?)<｜tool▁calls▁end｜>"
)


def _parse_deepseek_r1(text: str, extract_reasoning: bool) -> ChatMsg:
    msg = ChatMsg()
    m = _DS_REASONING.fullmatch(text)
    if not m:
        msg.content = text
        return msg
    if m.group(1) is not None:
        if extract_reasoning:
            msg.reasoning_content = (m.group(2) or "").strip()
        else:
            msg.content = m.group(1)
    rest = m.group(3) or ""
    tm = _DS_TOOLCALLS.search(rest)
    if tm:
        inner = parse_json_tool_calls(
            tm.group(1),
            r"<｜tool▁call▁begin｜>function<｜tool▁sep｜>([^\n]+)\n```json\n",
            r"```[\s\r\n]*<｜tool▁call▁end｜>",
        )
        msg.tool_calls = inner.tool_calls
    else:
        msg.content += rest.lstrip(" \r\n")
    return msg


def _parse_functionary_v3_2(text: str) -> ChatMsg:
    # (chat.cpp:1193): ">>>all\ncontent>>>fn\n{args}>>>fn2\n{args}" or direct
    # "fn\n{args}..." — function prefix is "(?:>>>)?(\w+)\n"
    fn_re = r"(?:>>>)?(\w+)\n"
    content = ""
    t = text
    if t.startswith("all\n"):
        t = t[4:]
        m = re.search(fn_re, t)
        if m is None:
            return ChatMsg(content=t)
        content, t = t[:m.start()], t[m.start():]
    try:
        # close pattern: end-of-string or lookahead ">>>"
        msg = parse_json_tool_calls(t, fn_re, r"$|(?=>>>)")
        msg.content = content + msg.content
        return msg
    except ValueError:
        return ChatMsg(content=text)


_FUNC31_PYTHON = re.compile(r"<\|python_tag\|>([\s\S\n]*)$")


def _parse_functionary_v3_1(text: str) -> ChatMsg:
    m = _FUNC31_PYTHON.search(text)
    if m:
        msg = ChatMsg(content=text[:m.start()])
        msg.tool_calls.append(
            ToolCall("python", json.dumps({"code": m.group(1)}, ensure_ascii=False))
        )
        return msg
    return parse_json_tool_calls(text, r"<function=(\w+)>", r"</function>")


def _parse_hermes_2_pro(text: str) -> ChatMsg:
    start = re.compile(r"[\n\s]*<tool_call>")
    middle = re.compile(r"[\n\s]*</tool_call>[\n\s]*<tool_call>")
    end_pat = re.compile(r"[\n\s]*</tool_call>[\n\s]*$")
    msg = ChatMsg()
    m = start.search(text)
    if not m:
        msg.content = text
        return msg
    msg.content = text[:m.start()]
    it = m.end()
    try:
        while it < len(text):
            call, it = _parse_json_at(text, it)
            if call is None:
                raise ValueError("Failed to parse json tool call")
            msg.tool_calls.append(ToolCall(call["name"], _dump_args(call["arguments"])))
            mm = middle.match(text, it)
            if mm:
                it = mm.end()
                continue
            me = end_pat.match(text, it)
            if not me:
                raise ValueError("Malformed input, missing </tool_call>")
            break
        return msg
    except (ValueError, KeyError):
        return ChatMsg(content=text)


_R7B_THOUGHT = re.compile(r"(<\|START_THINKING\|>([\s\S\n\r]*?)<\|END_THINKING\|>)([\s\S\n\r]*)")
_R7B_ACTION = re.compile(r"<\|START_ACTION\|>([\s\S\n\r]*?)<\|END_ACTION\|>")
_R7B_RESPONSE = re.compile(r"(?:<\|START_RESPONSE\|>)?([\s\S\n\r]*?)<\|END_RESPONSE\|>")


def _parse_command_r7b(text: str, extract_reasoning: bool) -> ChatMsg:
    msg = ChatMsg()
    rest = text
    m = _R7B_THOUGHT.fullmatch(rest)
    if m:
        if extract_reasoning:
            msg.reasoning_content = m.group(2)
        elif m.group(2):
            msg.content = m.group(1)
        rest = m.group(3)
    m = _R7B_ACTION.fullmatch(rest)
    if m:
        for action in json.loads(m.group(1)):
            msg.tool_calls.append(
                ToolCall(action["tool_name"], _dump_args(action["parameters"]),
                         action.get("tool_call_id", ""))
            )
        return msg
    m = _R7B_RESPONSE.fullmatch(rest)
    msg.content += m.group(1) if m else rest
    return msg


def parse(text: str, fmt: str, extract_reasoning: bool = False) -> ChatMsg:
    """common_chat_parse (chat.cpp:1570-1607)."""
    if fmt == "content_only":
        return ChatMsg(content=text)
    if fmt == "generic":
        return _parse_generic(text)
    if fmt == "mistral_nemo":
        return parse_prefixed_json_tool_call_array(text, "[TOOL_CALLS]")
    if fmt == "firefunction_v2":
        return parse_prefixed_json_tool_call_array(text, " functools[", rstrip_prefix=1)
    if fmt in ("llama_3_x", "llama_3_x_builtin"):
        return _parse_llama_3_x(text, builtin=fmt.endswith("builtin"))
    if fmt == "deepseek_r1":
        return _parse_deepseek_r1(text, extract_reasoning)
    if fmt == "functionary_v3_2":
        return _parse_functionary_v3_2(text)
    if fmt == "functionary_v3_1":
        return _parse_functionary_v3_1(text)
    if fmt == "hermes_2_pro":
        return _parse_hermes_2_pro(text)
    if fmt == "command_r7b":
        return _parse_command_r7b(text, extract_reasoning)
    raise ValueError(f"unknown chat format: {fmt}")


# ---------------------------------------------------------------------------
# tool grammar construction (constrained tool-call generation)
# ---------------------------------------------------------------------------


def build_tool_grammar(tools: list[dict], fmt: str, *, required: bool = False,
                       parallel: bool = False):
    """Build a (lazy) GBNF Grammar constraining output to well-formed tool
    calls, as common_chat_params_init_* do via json-schema → grammar
    (e.g. hermes: chat.cpp:1356-1378). Returns (Grammar, trigger_words);
    lazy unless `required` (tool_choice=required ⇒ grammar active at once)."""
    from ..runtime.grammar import Grammar
    from ..runtime.json_schema import json_schema_to_gbnf

    call_schemas = []
    for tool in tools:
        fn = tool.get("function", tool)
        name = fn["name"]
        params = fn.get("parameters") or {"type": "object"}
        # llama3-style calls carry "parameters"; hermes/nemo carry "arguments"
        args_key = "parameters" if fmt.startswith("llama_3") else "arguments"
        call_schemas.append({
            "type": "object",
            "properties": {"name": {"const": name}, args_key: params},
            "required": ["name", args_key],
        })
    # one converter over the anyOf keeps rule names collision-free; its root
    # becomes the `toolcall` rule we wrap with the format's framing tokens
    inner = json_schema_to_gbnf({"anyOf": call_schemas})
    inner = inner.replace("root ::=", "toolcall ::=", 1)
    if fmt == "hermes_2_pro":
        body = '"<tool_call>" ws toolcall ws "</tool_call>" ws'
        triggers = ["<tool_call>"]
    elif fmt == "mistral_nemo":
        body = '"[TOOL_CALLS]" ws "[" ws toolcall ws ("," ws toolcall ws)* "]"'
        triggers = ["[TOOL_CALLS]"]
    elif fmt.startswith("llama_3"):  # bare JSON object call
        body = "toolcall"
        triggers = ['{"']
    else:  # generic: {"tool_call": {...}} wrapper (chat.cpp:668-695)
        body = '"{" ws "\\"tool_call\\"" ws ":" ws toolcall ws "}"'
        triggers = ['{"']
    if parallel and fmt == "hermes_2_pro":
        body = f"({body})+"
    src = f"root ::= {body}\n" + inner
    g = Grammar(src, lazy=not required, trigger_words=None if required else triggers)
    g.gbnf_source = src  # callers pass the text to engines that re-parse it
    return g, triggers

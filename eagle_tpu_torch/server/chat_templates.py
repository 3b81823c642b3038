"""Chat template application (port of eagle_tpu/server/chat_templates.py:
every family of `TEMPLATES`, `detect_template`, `apply_template` and
`format_single`).

The GGUF usually embeds the Jinja source at `tokenizer.chat_template`; the
family is detected by substring and applied by a native renderer. The
template literals are wire-format data and match the reference's byte for
byte (tests/test_torch_chat_templates.py). The chat session
(`runtime/chat.py`) and the server's chat endpoint use them. Executing the
embedded Jinja source (`render_jinja`, `use_jinja`, `--jinja`) is not
ported: jinja2 is not among the card host's packages, so it raises
NotImplementedError saying so."""

from __future__ import annotations

from typing import Callable

Msg = dict  # {"role": ..., "content": ...}
JINJA_REFUSED = ("executing the GGUF's jinja chat template (--jinja) is not ported: jinja2 is "
                 "not among the card host's packages; the built-in families are")


def _trim(s: str) -> str:
    return s.strip()


# ---------------------------------------------------------------------------
# family renderers (llm_chat_apply_template branches, in source order)


def _chatml(messages: list[Msg], add_assistant: bool = True) -> str:
    out = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages]
    if add_assistant:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _mistral_v7(messages: list[Msg], add_assistant: bool = True) -> str:
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"[SYSTEM_PROMPT] {m['content']}[/SYSTEM_PROMPT]")
        elif m["role"] == "user":
            out.append(f"[INST] {m['content']}[/INST]")
        else:
            out.append(f" {m['content']}</s>")
    return "".join(out)


def _mistral(leading: str, trailing: str, trim_assistant: bool) -> Callable:
    """Official mistral v1/v3/v3-tekken renderers differ only in spacing and
    assistant trimming (llama-chat.cpp:206-231)."""

    def render(messages: list[Msg], add_assistant: bool = True) -> str:
        out = []
        inside = False
        for m in messages:
            if not inside:
                out.append(f"{leading}[INST]{trailing}")
                inside = True
            if m["role"] == "system":
                out.append(f"{m['content']}\n\n")
            elif m["role"] == "user":
                out.append(f"{m['content']}{leading}[/INST]")
            else:
                content = _trim(m["content"]) if trim_assistant else m["content"]
                out.append(f"{trailing}{content}</s>")
                inside = False
        return "".join(out)

    return render


def _llama2_family(support_system: bool, bos_inside: bool, strip: bool) -> Callable:
    """llama2 and its -sys / -sys-bos / -sys-strip variants
    (llama-chat.cpp:233-270)."""

    def render(messages: list[Msg], add_assistant: bool = True) -> str:
        out = ["[INST] "]
        inside = True
        for m in messages:
            content = _trim(m["content"]) if strip else m["content"]
            if not inside:
                inside = True
                out.append("<s>[INST] " if bos_inside else "[INST] ")
            if m["role"] == "system":
                if support_system:
                    out.append(f"<<SYS>>\n{content}\n<</SYS>>\n\n")
                else:
                    # no system support: included in the first message plain
                    out.append(f"{content}\n")
            elif m["role"] == "user":
                out.append(f"{content} [/INST]")
            else:
                out.append(f"{content}</s>")
                inside = False
        return "".join(out)

    return render


def _phi3(messages: list[Msg], add_assistant: bool = True) -> str:
    out = [f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in messages]
    if add_assistant:
        out.append("<|assistant|>\n")
    return "".join(out)


def _phi4(messages: list[Msg], add_assistant: bool = True) -> str:
    out = [f"<|im_start|>{m['role']}<|im_sep|>{m['content']}<|im_end|>" for m in messages]
    if add_assistant:
        out.append("<|im_start|>assistant<|im_sep|>")
    return "".join(out)


def _falcon3(messages: list[Msg], add_assistant: bool = True) -> str:
    out = [f"<|{m['role']}|>\n{m['content']}\n" for m in messages]
    if add_assistant:
        out.append("<|assistant|>\n")
    return "".join(out)


def _zephyr(messages: list[Msg], add_assistant: bool = True) -> str:
    out = [f"<|{m['role']}|>\n{m['content']}<|endoftext|>\n" for m in messages]
    if add_assistant:
        out.append("<|assistant|>\n")
    return "".join(out)


def _monarch(messages: list[Msg], add_assistant: bool = True) -> str:
    # the <s> is included inside history, skipped for the first message
    out = [
        f"{'' if i == 0 else '<s>'}{m['role']}\n{m['content']}</s>\n"
        for i, m in enumerate(messages)
    ]
    if add_assistant:
        out.append("<s>assistant\n")
    return "".join(out)


def _gemma(messages: list[Msg], add_assistant: bool = True) -> str:
    # no system role: merged into the next non-model turn (llama-chat.cpp:314)
    out = []
    system_prompt = ""
    for m in messages:
        if m["role"] == "system":
            system_prompt = _trim(m["content"])
            continue
        role = "model" if m["role"] == "assistant" else m["role"]
        out.append(f"<start_of_turn>{role}\n")
        if system_prompt and role != "model":
            out.append(f"{system_prompt}\n\n")
            system_prompt = ""
        out.append(f"{_trim(m['content'])}<end_of_turn>\n")
    if add_assistant:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _orion(messages: list[Msg], add_assistant: bool = True) -> str:
    out = []
    system_prompt = ""
    for m in messages:
        if m["role"] == "system":
            system_prompt = m["content"]
        elif m["role"] == "user":
            out.append("Human: ")
            if system_prompt:
                out.append(f"{system_prompt}\n\n")
                system_prompt = ""
            out.append(f"{m['content']}\n\nAssistant: </s>")
        else:
            out.append(f"{m['content']}</s>")
    return "".join(out)


def _openchat(messages: list[Msg], add_assistant: bool = True) -> str:
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"{m['content']}<|end_of_turn|>")
        else:
            role = m["role"][:1].upper() + m["role"][1:]
            out.append(f"GPT4 Correct {role}: {m['content']}<|end_of_turn|>")
    if add_assistant:
        out.append("GPT4 Correct Assistant:")
    return "".join(out)


def _vicuna_family(orca: bool) -> Callable:
    def render(messages: list[Msg], add_assistant: bool = True) -> str:
        out = []
        for m in messages:
            if m["role"] == "system":
                out.append(f"SYSTEM: {m['content']}\n" if orca else f"{m['content']}\n\n")
            elif m["role"] == "user":
                out.append(f"USER: {m['content']}\n")
            elif m["role"] == "assistant":
                out.append(f"ASSISTANT: {m['content']}</s>\n")
        if add_assistant:
            out.append("ASSISTANT:")
        return "".join(out)

    return render


def _deepseek(messages: list[Msg], add_assistant: bool = True) -> str:
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(m["content"])
        elif m["role"] == "user":
            out.append(f"### Instruction:\n{m['content']}\n")
        elif m["role"] == "assistant":
            out.append(f"### Response:\n{m['content']}\n<|EOT|>\n")
    if add_assistant:
        out.append("### Response:\n")
    return "".join(out)


def _command_r(messages: list[Msg], add_assistant: bool = True) -> str:
    roles = {"system": "<|SYSTEM_TOKEN|>", "user": "<|USER_TOKEN|>",
             "assistant": "<|CHATBOT_TOKEN|>"}
    out = [
        f"<|START_OF_TURN_TOKEN|>{roles[m['role']]}{_trim(m['content'])}<|END_OF_TURN_TOKEN|>"
        for m in messages if m["role"] in roles
    ]
    if add_assistant:
        out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
    return "".join(out)


def _llama3(messages: list[Msg], add_assistant: bool = True) -> str:
    # BOS (<|begin_of_text|>) comes from the tokenizer's add_bos, not the
    # template (reference renders without it)
    out = [
        f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{_trim(m['content'])}<|eot_id|>"
        for m in messages
    ]
    if add_assistant:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _chatglm3(messages: list[Msg], add_assistant: bool = True) -> str:
    out = ["[gMASK]sop"]
    out += [f"<|{m['role']}|>\n {m['content']}" for m in messages]
    if add_assistant:
        out.append("<|assistant|>")
    return "".join(out)


def _chatglm4(messages: list[Msg], add_assistant: bool = True) -> str:
    out = ["[gMASK]<sop>"]
    out += [f"<|{m['role']}|>\n{m['content']}" for m in messages]
    if add_assistant:
        out.append("<|assistant|>")
    return "".join(out)


def _glmedge(messages: list[Msg], add_assistant: bool = True) -> str:
    out = [f"<|{m['role']}|>\n{m['content']}" for m in messages]
    if add_assistant:
        out.append("<|assistant|>")
    return "".join(out)


def _minicpm(messages: list[Msg], add_assistant: bool = True) -> str:
    out = []
    for m in messages:
        if m["role"] == "user":
            out.append(f"<用户>{_trim(m['content'])}<AI>")
        else:
            out.append(_trim(m["content"]))
    return "".join(out)


def _deepseek2(messages: list[Msg], add_assistant: bool = True) -> str:
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"{m['content']}\n\n")
        elif m["role"] == "user":
            out.append(f"User: {m['content']}\n\n")
        elif m["role"] == "assistant":
            out.append(f"Assistant: {m['content']}<｜end▁of▁sentence｜>")
    if add_assistant:
        out.append("Assistant:")
    return "".join(out)


def _deepseek3(messages: list[Msg], add_assistant: bool = True) -> str:
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"{m['content']}\n\n")
        elif m["role"] == "user":
            out.append(f"<｜User｜>{m['content']}")
        else:
            out.append(f"<｜Assistant｜>{m['content']}<｜end▁of▁sentence｜>")
    if add_assistant:
        out.append("<｜Assistant｜>")
    return "".join(out)


def _exaone3(messages: list[Msg], add_assistant: bool = True) -> str:
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"[|system|]{_trim(m['content'])}[|endofturn|]\n")
        elif m["role"] == "user":
            out.append(f"[|user|]{_trim(m['content'])}\n")
        elif m["role"] == "assistant":
            out.append(f"[|assistant|]{_trim(m['content'])}[|endofturn|]\n")
    if add_assistant:
        out.append("[|assistant|]")
    return "".join(out)


def _rwkv_world(messages: list[Msg], add_assistant: bool = True) -> str:
    # requires the model to have "\n\n" as EOT token
    out = []
    for m in messages:
        if m["role"] == "user":
            out.append(f"User: {m['content']}\n\nAssistant:")
        else:
            out.append(f"{m['content']}\n\n")
    return "".join(out)


def _granite(messages: list[Msg], add_assistant: bool = True) -> str:
    out = []
    for m in messages:
        out.append(f"<|start_of_role|>{m['role']}<|end_of_role|>")
        if m["role"] == "assistant_tool_call":
            out.append("<|tool_call|>")
        out.append(f"{m['content']}<|end_of_text|>\n")
    if add_assistant:
        out.append("<|start_of_role|>assistant<|end_of_role|>\n")
    return "".join(out)


def _gigachat(messages: list[Msg], add_assistant: bool = True) -> str:
    out = []
    rest = messages
    if messages and messages[0]["role"] == "system":
        out.append(f"<s>{messages[0]['content']}<|message_sep|>")
        rest = messages[1:]
    else:
        out.append("<s>")
    for m in rest:
        if m["role"] == "user":
            out.append(f"user<|role_sep|>{m['content']}<|message_sep|>"
                       "available functions<|role_sep|>[]<|message_sep|>")
        elif m["role"] == "assistant":
            out.append(f"assistant<|role_sep|>{m['content']}<|message_sep|>")
    if add_assistant:
        out.append("assistant<|role_sep|>")
    return "".join(out)


def _megrez(messages: list[Msg], add_assistant: bool = True) -> str:
    out = [f"<|role_start|>{m['role']}<|role_end|>{m['content']}<|turn_end|>"
           for m in messages]
    if add_assistant:
        out.append("<|role_start|>assistant<|role_end|>")
    return "".join(out)


#: built-in family names — mirrors LLM_CHAT_TEMPLATES (llama-chat.cpp:27-62)
TEMPLATES: dict[str, Callable] = {
    "chatml": _chatml,
    "llama2": _llama2_family(False, False, False),
    "llama2-sys": _llama2_family(True, False, False),
    "llama2-sys-bos": _llama2_family(True, True, False),
    "llama2-sys-strip": _llama2_family(True, False, True),
    "mistral-v1": _mistral(" ", " ", False),
    "mistral-v3": _mistral("", " ", True),
    "mistral-v3-tekken": _mistral("", "", False),
    "mistral-v7": _mistral_v7,
    "phi3": _phi3,
    "phi4": _phi4,
    "falcon3": _falcon3,
    "zephyr": _zephyr,
    "monarch": _monarch,
    "gemma": _gemma,
    "orion": _orion,
    "openchat": _openchat,
    "vicuna": _vicuna_family(False),
    "vicuna-orca": _vicuna_family(True),
    "deepseek": _deepseek,
    "deepseek2": _deepseek2,
    "deepseek3": _deepseek3,
    "command-r": _command_r,
    "llama3": _llama3,
    "chatglm3": _chatglm3,
    "chatglm4": _chatglm4,
    "glmedge": _glmedge,
    "minicpm": _minicpm,
    "exaone3": _exaone3,
    "rwkv-world": _rwkv_world,
    "granite": _granite,
    "gigachat": _gigachat,
    "megrez": _megrez,
    # "mistral" is not a built-in name in the reference: detection routes it
    # through the startswith("mistral") branch to the llama2 renderer ("for
    # old pre-v1 templates", test-chat-template.cpp:365,391)
    "mistral": _llama2_family(False, False, False),
}


def detect_template(jinja_src: str | None) -> str:
    """Family name from the embedded jinja source — the ordered substring
    heuristics of llm_chat_detect_template (llama-chat.cpp:69-172).  An exact
    built-in name passes through (llm_chat_template_from_str).  Unknown
    sources fall back to chatml (the reference errors instead)."""
    if not jinja_src:
        return "chatml"
    if jinja_src in TEMPLATES:
        return jinja_src
    has = lambda needle: needle in jinja_src  # noqa: E731
    if has("<|im_start|>"):
        return "phi4" if has("<|im_sep|>") else "chatml"
    if jinja_src.startswith("mistral") or has("[INST]"):
        if has("[SYSTEM_PROMPT]"):
            return "mistral-v7"
        if has("' [INST] ' + system_message") or has("[AVAILABLE_TOOLS]"):
            if has(" [INST]"):
                return "mistral-v1"
            if has('"[INST]"'):
                return "mistral-v3-tekken"
            return "mistral-v3"
        if has("content.strip()"):
            return "llama2-sys-strip"
        if has("bos_token + '[INST]"):
            return "llama2-sys-bos"
        if has("<<SYS>>"):
            return "llama2-sys"
        return "llama2"
    if has("<|assistant|>") and has("<|end|>"):
        return "phi3"
    if has("<|assistant|>") and has("<|user|>"):
        return "falcon3" if has("</s>") else "glmedge"
    if has("<|user|>") and has("<|endoftext|>"):
        return "zephyr"
    if has("bos_token + message['role']"):
        return "monarch"
    if has("<start_of_turn>"):
        return "gemma"
    if has("'\\n\\nAssistant: ' + eos_token"):
        return "orion"
    if has("GPT4 Correct "):
        return "openchat"
    if has("USER: ") and has("ASSISTANT: "):
        return "vicuna-orca" if has("SYSTEM: ") else "vicuna"
    if has("### Instruction:") and has("<|EOT|>"):
        return "deepseek"
    if has("<|START_OF_TURN_TOKEN|>") and has("<|USER_TOKEN|>"):
        return "command-r"
    if has("<|start_header_id|>") and has("<|end_header_id|>"):
        return "llama3"
    if has("[gMASK]sop"):
        return "chatglm3"
    if has("[gMASK]<sop>"):
        return "chatglm4"
    if has("<用户>"):
        return "minicpm"
    if has("'Assistant: ' + message['content'] + eos_token"):
        return "deepseek2"
    if has("<｜Assistant｜>") and has("<｜User｜>") and has("<｜end▁of▁sentence｜>"):
        return "deepseek3"
    if has("[|system|]") and has("[|assistant|]") and has("[|endofturn|]"):
        return "exaone3"
    if has("rwkv-world"):
        return "rwkv-world"
    if has("<|start_of_role|>"):
        return "granite"
    if has("message['role'] + additional_special_tokens[0] + message['content'] + additional_special_tokens[1]"):
        return "gigachat"
    if has("<|role_start|>"):
        return "megrez"
    return "chatml"


def render_jinja(jinja_src: str, messages: list[Msg], add_assistant: bool = True,
                 bos_token: str = "", eos_token: str = "", tools: list | None = None) -> str:
    """Executing the model's own template is not ported."""
    raise NotImplementedError(JINJA_REFUSED)


def format_single(
    past: list[Msg], new_msg: Msg, template: str | None = None,
    jinja_src: str | None = None, add_assistant: bool = True,
    use_jinja: bool = False,
) -> str:
    """Format ONE new message as the incremental suffix for interactive chat —
    common_chat_format_single (common/chat.cpp:289-317): render with and
    without the new message and take the diff, preserving a trailing newline
    of the past rendering when the assistant prompt is appended."""
    fmt_past = ""
    if past:
        fmt_past = apply_template(past, template=template, jinja_src=jinja_src,
                                  add_assistant=False, use_jinja=use_jinja)
    out = ""
    if add_assistant and fmt_past.endswith("\n"):
        out = "\n"
    fmt_new = apply_template(past + [new_msg], template=template,
                             jinja_src=jinja_src, add_assistant=add_assistant,
                             use_jinja=use_jinja)
    return out + fmt_new[len(fmt_past):]


def apply_template(
    messages: list[Msg], template: str | None = None, jinja_src: str | None = None,
    add_assistant: bool = True, use_jinja: bool = False,
    bos_token: str = "", eos_token: str = "", tools: list | None = None,
) -> str:
    """The detected (or named) native family's rendering. `use_jinja` with a
    source raises (`render_jinja`), where the reference falls back to the
    family when its jinja fails."""
    if use_jinja and jinja_src:
        return render_jinja(jinja_src, messages, add_assistant, bos_token=bos_token,
                            eos_token=eos_token, tools=tools)
    family = template or detect_template(jinja_src)
    fn = TEMPLATES.get(family, _chatml)
    return fn(messages, add_assistant)

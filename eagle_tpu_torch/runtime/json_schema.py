"""JSON schema -> GBNF grammar conversion.

The port's own copy of eagle_tpu/runtime/json_schema.py,
unchanged but for this note: pure Python, kept here because the port
imports nothing of the JAX package.

Counterpart of common/json-schema-to-grammar.cpp: supports object/array/
string/number/integer/boolean/null, enum, const, properties+required,
items, anyOf/oneOf, and $ref to #/definitions or #/$defs. Output feeds
runtime/grammar.Grammar for constrained generation."""

from __future__ import annotations

import json
from typing import Any

_PRIMITIVES = {
    "boolean": '("true" | "false")',
    "null": '"null"',
    "number": '"-"? ([0-9] | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)?',
    "integer": '"-"? ([0-9] | [1-9] [0-9]*)',
    "string": r'"\"" ([^"\\\x7F\x00-\x1F] | "\\" (["\\bfnrt] | "u" [0-9a-fA-F]{4}))* "\""',
}

_SPACE = 'ws ::= [ \\t\\n]{0,20}\n'


def _lit(value: Any) -> str:
    """Literal JSON value as a quoted GBNF string."""
    s = json.dumps(value)
    out = s.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{out}"'


class _Converter:
    def __init__(self, schema: dict):
        self.schema = schema
        self.rules: dict[str, str] = {}
        self.counter = 0

    def _add_rule(self, name: str, body: str) -> str:
        base = name or "rule"
        if base in self.rules and self.rules[base] != body:
            self.counter += 1
            base = f"{base}{self.counter}"
        self.rules[base] = body
        return base

    def _resolve_ref(self, ref: str) -> dict:
        node: Any = self.schema
        assert ref.startswith("#/"), f"only local $refs supported: {ref}"
        for part in ref[2:].split("/"):
            node = node[part]
        return node

    def visit(self, schema: dict, name: str) -> str:
        if "$ref" in schema:
            return self.visit(self._resolve_ref(schema["$ref"]), schema["$ref"].split("/")[-1])
        if "const" in schema:
            return self._add_rule(name, _lit(schema["const"]))
        if "enum" in schema:
            return self._add_rule(name, " | ".join(_lit(v) for v in schema["enum"]))
        for comb in ("anyOf", "oneOf"):
            if comb in schema:
                alts = [self.visit(s, f"{name}-{i}") for i, s in enumerate(schema[comb])]
                return self._add_rule(name, " | ".join(alts))

        t = schema.get("type")
        if isinstance(t, list):
            alts = [self.visit({**schema, "type": ti}, f"{name}-{ti}") for ti in t]
            return self._add_rule(name, " | ".join(alts))

        if t == "object" and "properties" in schema:
            required = set(schema.get("required", schema["properties"].keys()))
            parts = []
            first = True
            for prop, sub in schema["properties"].items():
                sub_rule = self.visit(sub, f"{name}-{prop}")
                piece = f'{_lit(prop)} ws ":" ws {sub_rule}'
                sep = "" if first else '"," ws '
                if prop in required:
                    parts.append(f"{sep}{piece} ws")
                else:
                    parts.append(f"({sep}{piece} ws)?")
                first = False
            body = '"{" ws ' + " ".join(parts) + '"}"'
            return self._add_rule(name, body)
        if t == "object":
            # free-form object
            return self._add_rule(name, '"{" ws ( jstring ws ":" ws value ("," ws jstring ws ":" ws value)* )? "}"')
        if t == "array":
            item = self.visit(schema.get("items", {}), f"{name}-item") if "items" in schema else "value"
            min_i = schema.get("minItems", 0)
            body_core = f'{item} ws ("," ws {item} ws)*' if min_i > 0 else f'({item} ws ("," ws {item} ws)*)?'
            return self._add_rule(name, f'"[" ws {body_core} "]"')
        if t in _PRIMITIVES:
            return self._add_rule(name, _PRIMITIVES[t])
        # untyped -> any JSON value
        self._ensure_value_rules()
        return "value"

    def _ensure_value_rules(self):
        self.rules.setdefault("jstring", _PRIMITIVES["string"])
        self.rules.setdefault("jnumber", _PRIMITIVES["number"])
        self.rules.setdefault(
            "value",
            'jobject | jarray | jstring | jnumber | "true" | "false" | "null"',
        )
        self.rules.setdefault(
            "jobject",
            '"{" ws ( jstring ws ":" ws value ("," ws jstring ws ":" ws value)* )? "}"',
        )
        self.rules.setdefault(
            "jarray", '"[" ws ( value ws ("," ws value ws)* )? "]"'
        )

    def convert(self) -> str:
        root = self.visit(self.schema, "root")
        if "value" in " ".join(self.rules.values()) or any(
            "jstring" in b for b in self.rules.values()
        ):
            self._ensure_value_rules()
        lines = []
        if root != "root":
            lines.append(f"root ::= {root}")
        for rname, body in self.rules.items():
            lines.append(f"{rname} ::= {body}")
        # bounded whitespace like the reference's SPACE_RULE
        # (json-schema-to-grammar.cpp:267): an unbounded ws rule lets greedy
        # constrained decoding emit whitespace forever and never close the
        # object
        lines.append('ws ::= (" " | "\\n" (" " | "\\t")?)?')
        return "\n".join(lines) + "\n"


def json_schema_to_gbnf(schema: dict | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    return _Converter(schema).convert()

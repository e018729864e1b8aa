"""JSON schema -> regex construction (subset).

The port's copy of ``scratchpad_tpu/constrained/json_schema.py``.

Replaces outlines' build_regex_from_schema for the schema shapes used in
structured-output serving: typed scalars, enums/consts, fixed-property
objects, arrays, nested combinations. Unsupported constructs fall back to a
generic JSON value regex (still valid JSON guidance).
"""

from __future__ import annotations

import json
import re

WS = r"[ \n\t]{0,8}"
STRING_INNER = r'(?:[^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})'
STRING = f'"{STRING_INNER}*"'
INTEGER = r"(?:-?(?:0|[1-9]\d*))"
NUMBER = r"(?:-?(?:0|[1-9]\d*)(?:\.\d+)?(?:[eE][+-]?\d+)?)"
BOOLEAN = r"(?:true|false)"
NULL = r"null"

# depth-limited generic JSON value (regex cannot express true recursion)
def _generic_value(depth: int = 3) -> str:
    if depth == 0:
        return f"(?:{STRING}|{NUMBER}|{BOOLEAN}|{NULL})"
    inner = _generic_value(depth - 1)
    arr = f"\\[{WS}(?:{inner}(?:{WS},{WS}{inner}){{0,9}})?{WS}\\]"
    obj = (
        f"\\{{{WS}(?:{STRING}{WS}:{WS}{inner}"
        f"(?:{WS},{WS}{STRING}{WS}:{WS}{inner}){{0,9}})?{WS}\\}}"
    )
    return f"(?:{STRING}|{NUMBER}|{BOOLEAN}|{NULL}|{arr}|{obj})"


def _escape_literal(value) -> str:
    lit = json.dumps(value)
    return re.escape(lit).replace(re.escape(" "), " ")


def schema_to_regex(schema) -> str:
    """Compile a parsed JSON-schema dict (or True) to a regex."""
    if schema is True or schema == {}:
        return _generic_value()
    return _node(schema)


def _node(s: dict) -> str:
    if "const" in s:
        return _escape_literal(s["const"])
    if "enum" in s:
        return "(?:" + "|".join(_escape_literal(v) for v in s["enum"]) + ")"
    for comb in ("anyOf", "oneOf"):
        if comb in s:
            return "(?:" + "|".join(_node(x) for x in s[comb]) + ")"
    t = s.get("type")
    if isinstance(t, list):
        return "(?:" + "|".join(_node({**s, "type": x}) for x in t) + ")"
    if t == "string":
        if "pattern" in s:
            # embed the user pattern (assumed anchored-free)
            return f'"{s["pattern"]}"'
        lo = s.get("minLength")
        hi = s.get("maxLength")
        if lo is not None or hi is not None:
            return f'"{STRING_INNER}{{{lo or 0},{hi if hi is not None else ""}}}"'.replace(
                ",}", ",}"
            )
        return STRING
    if t == "integer":
        return INTEGER
    if t == "number":
        return NUMBER
    if t == "boolean":
        return BOOLEAN
    if t == "null":
        return NULL
    if t == "array":
        item = _node(s["items"]) if isinstance(s.get("items"), dict) else _generic_value()
        lo = s.get("minItems", 0)
        hi = s.get("maxItems")
        if hi is not None:
            if lo == 0:
                body = f"(?:{item}(?:{WS},{WS}{item}){{0,{max(hi - 1, 0)}}})?"
            else:
                body = f"{item}(?:{WS},{WS}{item}){{{lo - 1},{hi - 1}}}"
        elif lo > 0:
            body = f"{item}(?:{WS},{WS}{item}){{{lo - 1},}}"
        else:
            body = f"(?:{item}(?:{WS},{WS}{item})*)?"
        return f"\\[{WS}{body}{WS}\\]"
    if t == "object" or "properties" in s:
        props = s.get("properties", {})
        required = set(s.get("required", list(props)))
        if not props:
            return _generic_value()
        parts = []
        # fixed property order (objects emit properties in schema order;
        # optional ones may be skipped)
        first = True
        out = f"\\{{{WS}"
        opt_stack = []
        for name, sub in props.items():
            pat = f'"{re.escape(name)}"{WS}:{WS}{_node(sub)}'
            sep = "" if first else f"{WS},{WS}"
            if name in required:
                out += f"{sep}{pat}"
                first = False
            else:
                out += f"(?:{sep}{pat})?"
                if first:
                    # an optional first property complicates separators;
                    # keep it simple: treat as required when it leads
                    first = False
        out += f"{WS}\\}}"
        return out
    return _generic_value()

"""Tool/function-call extraction from model output.

A copy of ``scratchpad_tpu/server/openai_api/function_call_parser.py`` for the PyTorch port
(standard library only; it imports nothing of the JAX package).

Re-implements the reference FunctionCallParser's per-family detectors
(reference: scratchpad/server/openai_api/function_call_parser.py:315-607):
Qwen2.5 (<tool_call> tags), Mistral ([TOOL_CALLS]), Llama-3.2 (raw JSON
object), DeepSeek-V3-style fenced JSON. Format auto-detected from the text.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ToolCallItem:
    name: str
    arguments: str  # JSON-encoded string (OpenAI wire format)
    call_id: str = field(default_factory=lambda: f"call_{uuid.uuid4().hex[:24]}")

    def to_openai(self, index: int) -> dict:
        return {
            "id": self.call_id,
            "index": index,
            "type": "function",
            "function": {"name": self.name, "arguments": self.arguments},
        }


@dataclass
class ParseResult:
    normal_text: str
    calls: list[ToolCallItem]


def _mk(obj: dict) -> Optional[ToolCallItem]:
    name = obj.get("name")
    if not name:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if not isinstance(args, str):
        args = json.dumps(args)
    return ToolCallItem(name=name, arguments=args)


class BaseDetector:
    def detect(self, text: str) -> Optional[ParseResult]:
        raise NotImplementedError


class Qwen25Detector(BaseDetector):
    """<tool_call>\n{...}\n</tool_call> (reference: :315 Qwen25Detector)."""

    _re = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)

    def detect(self, text):
        calls = []
        for m in self._re.finditer(text):
            try:
                item = _mk(json.loads(m.group(1)))
                if item:
                    calls.append(item)
            except json.JSONDecodeError:
                continue
        if not calls:
            return None
        return ParseResult(self._re.sub("", text).strip(), calls)


class MistralDetector(BaseDetector):
    """[TOOL_CALLS] [{...}, ...] (reference: :390 MistralDetector)."""

    _re = re.compile(r"\[TOOL_CALLS\]\s*(\[.*\])", re.DOTALL)

    def detect(self, text):
        m = self._re.search(text)
        if not m:
            return None
        try:
            objs = json.loads(m.group(1))
        except json.JSONDecodeError:
            return None
        calls = [c for c in (_mk(o) for o in objs) if c]
        if not calls:
            return None
        return ParseResult(text[: m.start()].strip(), calls)


class Llama32Detector(BaseDetector):
    """Raw JSON object(s): {"name": ..., "parameters": {...}}
    (reference: :470 Llama32Detector); also handles ';'-joined objects."""

    def detect(self, text):
        stripped = text.strip()
        if not stripped.startswith("{"):
            return None
        calls = []
        for part in stripped.split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                obj = json.loads(part)
            except json.JSONDecodeError:
                continue
            item = _mk(obj) if isinstance(obj, dict) else None
            if item:
                calls.append(item)
        if not calls:
            return None
        return ParseResult("", calls)


class FencedJsonDetector(BaseDetector):
    """```json {...} ``` tool blocks (DeepSeek-V3-style)."""

    _re = re.compile(r"```json\s*(\{.*?\})\s*```", re.DOTALL)

    def detect(self, text):
        calls = []
        for m in self._re.finditer(text):
            try:
                item = _mk(json.loads(m.group(1)))
                if item:
                    calls.append(item)
            except json.JSONDecodeError:
                continue
        if not calls:
            return None
        return ParseResult(self._re.sub("", text).strip(), calls)


_DETECTORS = [
    Qwen25Detector(),
    MistralDetector(),
    Llama32Detector(),
    FencedJsonDetector(),
]


def _value_span(s: str, start: int) -> tuple[int, bool]:
    """Chars of s[start:] that belong to one JSON value; (length, complete).

    Walks string/escape/depth state so a partial container value can be
    streamed verbatim while it is still arriving (the role
    partial_json_parser plays in the reference,
    reference: function_call_parser.py:47 _partial_json_loads)."""
    i = start
    n = len(s)
    while i < n and s[i] in " \t\r\n":
        i += 1
    if i >= n:
        return i - start, False
    c0 = s[i]
    if c0 in "{[":
        depth = 0
        in_str = esc = False
        j = i
        while j < n:
            c = s[j]
            if in_str:
                if esc:
                    esc = False
                elif c == "\\":
                    esc = True
                elif c == '"':
                    in_str = False
            elif c == '"':
                in_str = True
            elif c in "{[":
                depth += 1
            elif c in "}]":
                depth -= 1
                if depth == 0:
                    return j + 1 - start, True
            j += 1
        return n - start, False
    if c0 == '"':
        esc = False
        j = i + 1
        while j < n:
            c = s[j]
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                return j + 1 - start, True
            j += 1
        return n - start, False
    # number / true / false / null: ends at a delimiter
    j = i
    while j < n and s[j] not in ",}] \t\r\n":
        j += 1
    return j - start, j < n


_NAME_RE = re.compile(r'"name"\s*:\s*"((?:[^"\\]|\\.)*)"')
_ARGS_RE = re.compile(r'"(?:arguments|parameters)"\s*:')


class _ObjStream:
    """Incremental parse of ONE JSON tool-call object: surfaces the name
    as soon as its string closes and streams the arguments value verbatim
    while it arrives (StreamingParseResult semantics,
    reference: function_call_parser.py:141 parse_streaming_increment)."""

    def __init__(self):
        self.buf = ""
        self.done = False
        self._depth = 0
        self._in_str = False
        self._esc = False
        self._started = False
        self.name: Optional[str] = None

    def push(self, c: str) -> bool:
        """Feed one char; True when the object just completed."""
        self.buf += c
        if self._in_str:
            if self._esc:
                self._esc = False
            elif c == "\\":
                self._esc = True
            elif c == '"':
                self._in_str = False
            return False
        if c == '"':
            self._in_str = True
        elif c in "{[":
            self._depth += 1
            self._started = True
        elif c in "}]":
            self._depth -= 1
            if self._started and self._depth == 0:
                self.done = True
        if self.name is None:
            m = _NAME_RE.search(self.buf)
            if m:
                self.name = json.loads(f'"{m.group(1)}"')
        return self.done

    def args_progress(self) -> tuple[Optional[str], bool]:
        """(streamable argument text so far, value complete?).

        Container values stream raw (fragment concatenation equals the
        final arguments string); string/scalar values are withheld until
        complete, then returned decoded."""
        m = _ARGS_RE.search(self.buf)
        if not m:
            if self.done:
                return "{}", True  # no-arg call: OpenAI wire default
            return None, False
        start = m.end()
        length, complete = _value_span(self.buf, start)
        val = self.buf[start:][:length]
        stripped = val.lstrip()
        if stripped[:1] in ("{", "["):
            return val.lstrip(), complete
        if not complete:
            return "", False
        try:
            decoded = json.loads(stripped)
        except json.JSONDecodeError:
            return stripped, True
        if isinstance(decoded, str):
            return decoded, True  # args double-encoded as a JSON string
        return json.dumps(decoded), True


@dataclass
class StreamResult:
    """One streaming increment: visible text + OpenAI tool_calls deltas."""

    normal_text: str = ""
    deltas: list = field(default_factory=list)  # ChatCompletion delta dicts


_MARKERS = {
    "<tool_call>": ("qwen", "</tool_call>"),
    "[TOOL_CALLS]": ("mistral", None),
    "```json": ("fenced", "```"),
}


class StreamingToolParser:
    """Incremental tool-call extraction over streamed text.

    The streaming counterpart of FunctionCallParser: normal text flows
    through with the minimum hold-back (a suffix that could begin a tool
    marker), and once a marker commits, `tool_calls` deltas are emitted —
    first chunk carries id+name, later chunks carry argument fragments
    whose concatenation is the final arguments string
    (reference contract: function_call_parser.py:66 StreamingParseResult,
    :141 parse_streaming_increment)."""

    def __init__(self, tools: Optional[list[dict]] = None):
        self.allowed = {
            t["function"]["name"]
            for t in (tools or [])
            if t.get("type") == "function" and "function" in t
        }
        self.buf = ""
        self.state = "normal"
        self.fmt: Optional[str] = None
        self.obj: Optional[_ObjStream] = None
        self.index = -1
        self._emitted_any_text = False
        self._name_sent = False
        self._args_sent = 0
        self._args_done = False
        self._call_id = None
        self._raw_call = ""  # raw text of the in-progress call (for flush)
        self._expect: Optional[str] = None
        self.saw_tool_call = False

    # ------------------------------------------------------------- helpers

    def _holdback_len(self) -> int:
        """Longest buffer suffix that is a prefix of some marker."""
        best = 0
        for m in _MARKERS:
            for k in range(min(len(m) - 1, len(self.buf)), 0, -1):
                if self.buf.endswith(m[:k]):
                    best = max(best, k)
                    break
        # a leading '{' before any visible text may open a raw-JSON call
        if not self._emitted_any_text and self.buf.strip() == "":
            best = max(best, len(self.buf))
        return best

    def _start_call(self, fmt: str, raw_prefix: str):
        self.fmt = fmt
        self.obj = _ObjStream()
        self.index += 1
        self._name_sent = False
        self._args_sent = 0
        self._args_done = False
        self._call_id = f"call_{uuid.uuid4().hex[:24]}"
        self._raw_call = raw_prefix
        self.state = "in_call"

    def _emit_ready(self, out: StreamResult):
        """Emit name/argument deltas now derivable from the object."""
        if self.obj is None:
            return
        if not self._name_sent:
            if self.obj.name is None:
                return
            if self.allowed and self.obj.name not in self.allowed:
                # unknown tool: surface the raw text instead of a call
                out.normal_text += self._raw_call
                self.state = "skip_call"
                return
            out.deltas.append(
                {
                    "index": self.index,
                    "id": self._call_id,
                    "type": "function",
                    "function": {"name": self.obj.name, "arguments": ""},
                }
            )
            self._name_sent = True
            self.saw_tool_call = True
        if self._args_done:
            return
        args, complete = self.obj.args_progress()
        if args is None:
            return
        frag = args[self._args_sent :]
        if frag:
            out.deltas.append(
                {
                    "index": self.index,
                    "function": {"arguments": frag},
                }
            )
            self._args_sent = len(args)
        if complete:
            self._args_done = True

    # --------------------------------------------------------------- feed

    def feed(self, text: str) -> StreamResult:
        out = StreamResult()
        for c in text:
            self._feed_char(c, out)
        # in normal state, release everything but the marker hold-back
        if self.state == "normal" and self.buf:
            hold = self._holdback_len()
            release = self.buf[: len(self.buf) - hold]
            if release:
                out.normal_text += release
                self._emitted_any_text = True
                self.buf = self.buf[len(release) :]
        return out

    def _feed_char(self, c: str, out: StreamResult):
        if self.state == "normal":
            self.buf += c
            # full marker anywhere in the pending buffer?
            for m, (fmt, _eot) in _MARKERS.items():
                i = self.buf.find(m)
                if i >= 0:
                    pre = self.buf[:i]
                    if pre:
                        out.normal_text += pre
                        self._emitted_any_text = True
                    self.buf = ""
                    if fmt == "mistral":
                        self.state = "mistral_pre"
                        self._raw_call = m
                    else:
                        self._start_call(fmt, m)
                    return
            # llama-style: raw JSON object before any visible text
            if not self._emitted_any_text and self.buf.lstrip().startswith("{"):
                lead = self.buf[: len(self.buf) - len(self.buf.lstrip())]
                self.buf = ""
                self._start_call("llama", lead)
                self._push_call_char("{", out)
            return
        if self.state == "mistral_pre":
            self._raw_call += c
            if c == "[":
                self._start_call("mistral", self._raw_call)
            elif c not in " \t\r\n":
                # not the expected array: replay as normal text
                out.normal_text += self._raw_call
                self._emitted_any_text = True
                self.state = "normal"
            return
        if self.state == "in_call":
            self._push_call_char(c, out)
            return
        if self.state == "between_calls":
            self._raw_call += c
            if c in " \t\r\n":
                return
            if self.fmt == "mistral":
                if c == ",":
                    self._start_call("mistral", self._raw_call)
                    return
                if c == "]":
                    self.state = "normal"
                    return
            if self.fmt == "llama" and c in ";,":
                self._start_call("llama", self._raw_call)
                return
            if self.fmt == "llama" and c == "{":
                self._start_call("llama", self._raw_call)
                self._push_call_char("{", out)
                return
            self.state = "normal"
            self._feed_char(c, out)
            return
        if self.state == "await_eot":
            self._expect_buf += c
            want = self._expect
            stripped = self._expect_buf.lstrip()
            if want.startswith(stripped) or stripped.startswith(want):
                if stripped.startswith(want):
                    rest = stripped[len(want) :]
                    self.state = "normal"
                    for r in rest:
                        self._feed_char(r, out)
                return
            # eot never arrived; pass the residue through as text
            out.normal_text += self._expect_buf
            self._emitted_any_text = True
            self.state = "normal"
            return
        if self.state == "skip_call":
            # emit the remainder of an unknown-tool call verbatim
            out.normal_text += c
            if self.obj is not None and self.obj.push(c):
                self.state = "normal"
                self.obj = None
            return

    def _push_call_char(self, c: str, out: StreamResult):
        self._raw_call += c
        done = self.obj.push(c)
        self._emit_ready(out)
        if self.state == "skip_call":
            return
        if done:
            if not self._name_sent:
                # object finished without a usable name: surface raw text
                out.normal_text += self._raw_call
                self._emitted_any_text = True
                self.state = "normal"
                self.obj = None
                return
            eot = _MARKERS.get(
                {"qwen": "<tool_call>", "fenced": "```json"}.get(self.fmt, ""),
                (None, None),
            )[1]
            if eot:
                self.state = "await_eot"
                self._expect = eot
                self._expect_buf = ""
            else:
                self.state = "between_calls"
                self._raw_call = ""
            self.obj = None

    def finish(self) -> StreamResult:
        """Flush at end-of-stream: pending hold-back becomes normal text;
        an incomplete call that never produced a delta is surfaced raw."""
        out = StreamResult()
        if self.state == "normal":
            out.normal_text = self.buf
        elif self.state in ("in_call", "mistral_pre", "skip_call"):
            if not self._name_sent or self.state != "in_call":
                out.normal_text = self._raw_call
        elif self.state == "await_eot":
            pass  # call completed; trailing eot residue is dropped
        self.buf = ""
        return out


class FunctionCallParser:
    """Auto-detecting parser (reference: FunctionCallParser :560)."""

    def __init__(self, tools: Optional[list[dict]] = None):
        self.allowed = {
            t["function"]["name"]
            for t in (tools or [])
            if t.get("type") == "function" and "function" in t
        }

    def parse(self, text: str) -> ParseResult:
        for det in _DETECTORS:
            res = det.detect(text)
            if res is None:
                continue
            if self.allowed:
                res.calls = [c for c in res.calls if c.name in self.allowed]
                if not res.calls:
                    continue
            return res
        return ParseResult(text, [])

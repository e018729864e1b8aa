"""OpenAI-compatible API schema, on dataclasses.

Counterpart of ``scratchpad_tpu/server/openai_api/protocol.py`` (pydantic
models) with the same classes, fields, defaults and response keys, on the
standard library only. ``parse(cls, body)`` validates a JSON body as
pydantic's lax mode does for these fields: a missing required field, an
unknown shape or a value that cannot be coerced raises ``ValidationError``
(the server answers 400); ints, floats and bools take the same coercions
(``16.0`` and ``"16"`` for an int, ``"true"`` for a bool); unknown keys are
ignored. ``dump(obj)`` gives the JSON-ready dict, None fields included.
"""

from __future__ import annotations

import dataclasses
import time
import typing
import uuid
from typing import Any, Dict, List, Optional, Union


class ValidationError(ValueError):
    pass


def _id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def _now() -> int:
    return int(time.time())


_TRUE = {"1", "true", "t", "yes", "y", "on"}
_FALSE = {"0", "false", "f", "no", "n", "off"}


def _coerce(tp, v, path: str):
    origin = typing.get_origin(tp)
    if tp is Any:
        return v
    if origin is Union:
        args = typing.get_args(tp)
        if v is None and type(None) in args:
            return None
        errors = []
        for a in args:
            if a is type(None):
                continue
            try:
                return _coerce(a, v, path)
            except ValidationError as e:
                errors.append(str(e))
        raise ValidationError("; ".join(errors) or f"{path}: invalid value")
    if origin in (list, List):
        if not isinstance(v, list):
            raise ValidationError(f"{path}: expected a list")
        (item,) = typing.get_args(tp)
        return [_coerce(item, x, f"{path}[{i}]") for i, x in enumerate(v)]
    if origin in (dict, Dict):
        if not isinstance(v, dict):
            raise ValidationError(f"{path}: expected an object")
        _, val = typing.get_args(tp)
        return {str(k): _coerce(val, x, f"{path}.{k}") for k, x in v.items()}
    if dataclasses.is_dataclass(tp):
        return parse(tp, v, path)
    if tp is bool:
        if isinstance(v, bool):
            return v
        if isinstance(v, (int, float)) and v in (0, 1):
            return bool(v)
        if isinstance(v, str) and v.lower() in _TRUE | _FALSE:
            return v.lower() in _TRUE
        raise ValidationError(f"{path}: expected a boolean")
    if tp is int:
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, int):
            return v
        if isinstance(v, float) and v.is_integer():
            return int(v)
        if isinstance(v, str):
            try:
                return int(v.strip())
            except ValueError:
                pass
        raise ValidationError(f"{path}: expected an integer")
    if tp is float:
        if isinstance(v, (int, float)):
            return float(v)
        if isinstance(v, str):
            try:
                return float(v.strip())
            except ValueError:
                pass
        raise ValidationError(f"{path}: expected a number")
    if tp is str:
        if isinstance(v, str):
            return v
        raise ValidationError(f"{path}: expected a string")
    raise TypeError(f"unsupported field type {tp!r}")


def parse(cls, body, path: str = "body"):
    """``cls`` built from the JSON object ``body``, validated (see the
    module's docstring)."""
    if not isinstance(body, dict):
        raise ValidationError(f"{path}: expected an object")
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in body:
            kw[f.name] = _coerce(hints[f.name], body[f.name], f"{path}.{f.name}")
        elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
            raise ValidationError(f"{path}.{f.name}: field required")
    return cls(**kw)


def dump(obj) -> dict:
    return dataclasses.asdict(obj)


@dataclasses.dataclass
class UsageInfo:
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    prompt_tokens_details: Optional[Dict[str, int]] = None  # {"cached_tokens": n}


@dataclasses.dataclass
class CompletionRequest:
    model: str
    prompt: Union[str, List[str], List[int], List[List[int]]]
    best_of: Optional[int] = None
    echo: bool = False
    frequency_penalty: float = 0.0
    logit_bias: Optional[Dict[str, float]] = None
    # a pickled per-request logit processor and its params: served only
    # under --enable-custom-logit-processor (http_server.sampling_params)
    custom_logit_processor: Optional[str] = None
    custom_params: Optional[Dict[str, float]] = None
    logprobs: Optional[int] = None
    max_tokens: int = 16
    n: int = 1
    presence_penalty: float = 0.0
    seed: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    stream: bool = False
    suffix: Optional[str] = None
    temperature: float = 1.0
    top_p: float = 1.0
    user: Optional[str] = None
    # extensions
    top_k: int = -1
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    min_tokens: int = 0
    ignore_eos: bool = False
    skip_special_tokens: bool = True
    regex: Optional[str] = None
    ebnf: Optional[str] = None
    json_schema: Optional[str] = None


@dataclasses.dataclass
class CompletionChoice:
    index: int
    text: str
    logprobs: Optional[Any] = None
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class CompletionResponse:
    id: str = dataclasses.field(default_factory=lambda: _id("cmpl"))
    object: str = "text_completion"
    created: int = dataclasses.field(default_factory=_now)
    model: str = ""
    choices: List[CompletionChoice] = dataclasses.field(default_factory=list)
    usage: Optional[UsageInfo] = None


@dataclasses.dataclass
class ChatMessage:
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None
    tool_call_id: Optional[str] = None
    reasoning_content: Optional[str] = None


@dataclasses.dataclass
class ResponseFormat:
    # text | json_object | json_schema | structural_tag
    type: str = "text"
    json_schema: Optional[Dict[str, Any]] = None
    structures: Optional[List[Dict[str, Any]]] = None
    triggers: Optional[List[str]] = None


@dataclasses.dataclass
class ChatCompletionRequest:
    model: str
    messages: List[ChatMessage]
    frequency_penalty: float = 0.0
    logit_bias: Optional[Dict[str, float]] = None
    custom_logit_processor: Optional[str] = None
    custom_params: Optional[Dict[str, float]] = None
    logprobs: bool = False
    top_logprobs: Optional[int] = None
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    n: int = 1
    presence_penalty: float = 0.0
    response_format: Optional[ResponseFormat] = None
    seed: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    stream: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    user: Optional[str] = None
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Optional[Union[str, Dict[str, Any]]] = None
    # extensions
    top_k: int = -1
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    min_tokens: int = 0
    ignore_eos: bool = False
    skip_special_tokens: bool = True
    regex: Optional[str] = None
    ebnf: Optional[str] = None
    json_schema: Optional[str] = None


@dataclasses.dataclass
class ChatCompletionChoice:
    index: int
    message: ChatMessage
    logprobs: Optional[Any] = None
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class ChatCompletionResponse:
    id: str = dataclasses.field(default_factory=lambda: _id("chatcmpl"))
    object: str = "chat.completion"
    created: int = dataclasses.field(default_factory=_now)
    model: str = ""
    choices: List[ChatCompletionChoice] = dataclasses.field(default_factory=list)
    usage: Optional[UsageInfo] = None


@dataclasses.dataclass
class DeltaMessage:
    role: Optional[str] = None
    content: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None
    reasoning_content: Optional[str] = None


@dataclasses.dataclass
class ChatCompletionStreamChoice:
    index: int
    delta: DeltaMessage
    logprobs: Optional[Any] = None
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class ChatCompletionStreamResponse:
    id: str = dataclasses.field(default_factory=lambda: _id("chatcmpl"))
    object: str = "chat.completion.chunk"
    created: int = dataclasses.field(default_factory=_now)
    model: str = ""
    choices: List[ChatCompletionStreamChoice] = dataclasses.field(default_factory=list)
    usage: Optional[UsageInfo] = None


@dataclasses.dataclass
class ModelCard:
    id: str
    object: str = "model"
    created: int = dataclasses.field(default_factory=_now)
    owned_by: str = "scratchpad-tpu"


@dataclasses.dataclass
class ModelList:
    object: str = "list"
    data: List[ModelCard] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EmbeddingRequest:
    model: str
    input: Union[str, List[str], List[int], List[List[int]]]
    encoding_format: str = "float"
    user: Optional[str] = None


@dataclasses.dataclass
class ErrorResponse:
    message: str
    object: str = "error"
    type: str = "invalid_request_error"
    code: int = 400

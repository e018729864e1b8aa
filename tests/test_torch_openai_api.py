"""The port's OpenAI API modules against the JAX package's, on the same inputs.

``protocol`` (dataclasses and a hand-written validator, against pydantic):
the same bodies are accepted or refused on both sides, and accepted ones
dump to the same dict. ``conversation``, ``reasoning_parser`` and
``function_call_parser`` are copies: every template, the split and the
streaming parsers give the same output on fixed cases and on strings that
hypothesis makes from the tags' pieces.
"""

import dataclasses

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from scratchpad_tpu.server.openai_api import conversation as jconv
from scratchpad_tpu.server.openai_api import function_call_parser as jfc
from scratchpad_tpu.server.openai_api import protocol as jproto
from scratchpad_tpu.server.openai_api import reasoning_parser as jrp
from scratchpad_tpu_torch.server.openai_api import conversation as conv
from scratchpad_tpu_torch.server.openai_api import function_call_parser as fc
from scratchpad_tpu_torch.server.openai_api import protocol as proto
from scratchpad_tpu_torch.server.openai_api import reasoning_parser as rp
import torch_threads  # noqa: F401  (one torch thread a test process)

REQUESTS = ("CompletionRequest", "ChatCompletionRequest", "EmbeddingRequest")
RANDOM = dict(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])


def _outcome_jax(name, body):
    try:
        return "ok", getattr(jproto, name)(**body).model_dump()
    except Exception:  # noqa: BLE001 - any refusal is a 400 on the JAX server
        return "refused", None


def _outcome_port(name, body):
    try:
        return "ok", proto.dump(proto.parse(getattr(proto, name), body))
    except proto.ValidationError:
        return "refused", None


def _same(name, body):
    j, p = _outcome_jax(name, body), _outcome_port(name, body)
    assert j[0] == p[0], (name, body, j, p)
    assert j[1] == p[1], (name, body)


GOOD = [
    ("CompletionRequest", {"model": "m", "prompt": "hi"}),
    ("CompletionRequest", {"model": "m", "prompt": [1, 2, 3], "max_tokens": 4, "logprobs": 1,
                           "echo": True, "n": 2, "logit_bias": {"5": 3}, "stop": ["a", "b"]}),
    ("CompletionRequest", {"model": "m", "prompt": [[1, 2], [3]], "temperature": 0,
                           "max_tokens": 16.0, "stream": "true", "ignore_eos": 1}),
    ("CompletionRequest", {"model": "m", "prompt": ["a", "b"], "top_k": "5", "unknown": 1}),
    ("ChatCompletionRequest", {"model": "m", "messages": [{"role": "user", "content": "x"}]}),
    ("ChatCompletionRequest", {"model": "m", "messages": [
        {"role": "system", "content": "s"},
        {"role": "user", "content": [{"type": "text", "text": "t"}]},
        {"role": "assistant", "content": None, "tool_calls": [{"id": "c"}]}],
        "tools": [{"type": "function", "function": {"name": "f"}}], "tool_choice": "auto",
        "response_format": {"type": "text"}, "max_completion_tokens": 3, "stream": False}),
    ("EmbeddingRequest", {"model": "m", "input": "text"}),
    ("EmbeddingRequest", {"model": "m", "input": [[1, 2], [3, 4]]}),
]
BAD = [
    ("CompletionRequest", {"prompt": "no model"}),
    ("CompletionRequest", {"model": "m"}),
    ("CompletionRequest", {"model": "m", "prompt": {"a": 1}}),
    ("CompletionRequest", {"model": "m", "prompt": "x", "max_tokens": "many"}),
    ("CompletionRequest", {"model": "m", "prompt": "x", "max_tokens": 1.5}),
    ("CompletionRequest", {"model": "m", "prompt": "x", "temperature": "hot"}),
    ("CompletionRequest", {"model": "m", "prompt": "x", "stream": "perhaps"}),
    ("CompletionRequest", {"model": "m", "prompt": "x", "stop": 3}),
    ("CompletionRequest", {"model": 5, "prompt": "x"}),
    ("ChatCompletionRequest", {"model": "m", "messages": "hello"}),
    ("ChatCompletionRequest", {"model": "m", "messages": [{"content": "no role"}]}),
    ("ChatCompletionRequest", {"model": "m", "messages": [], "n": "two"}),
    ("EmbeddingRequest", {"model": "m", "input": [1.5]}),
    ("EmbeddingRequest", {"model": "m"}),
]


@pytest.mark.parametrize("name,body", GOOD + BAD, ids=lambda x: x if isinstance(x, str) else "")
def test_protocol_accepts_and_refuses_as_pydantic(name, body):
    _same(name, body)


def test_protocol_responses_dump_the_same_keys():
    usage = dict(prompt_tokens=3, completion_tokens=2, total_tokens=5,
                 prompt_tokens_details={"cached_tokens": 1})
    pairs = [
        (jproto.CompletionResponse(model="m", choices=[jproto.CompletionChoice(index=0, text="t")],
                                   usage=jproto.UsageInfo(**usage)),
         proto.CompletionResponse(model="m", choices=[proto.CompletionChoice(index=0, text="t")],
                                  usage=proto.UsageInfo(**usage))),
        (jproto.ChatCompletionStreamResponse(choices=[jproto.ChatCompletionStreamChoice(
            index=0, delta=jproto.DeltaMessage(content="c"))]),
         proto.ChatCompletionStreamResponse(choices=[proto.ChatCompletionStreamChoice(
             index=0, delta=proto.DeltaMessage(content="c"))])),
        (jproto.ChatCompletionResponse(choices=[jproto.ChatCompletionChoice(
            index=0, message=jproto.ChatMessage(role="assistant", content="x"))]),
         proto.ChatCompletionResponse(choices=[proto.ChatCompletionChoice(
             index=0, message=proto.ChatMessage(role="assistant", content="x"))])),
        (jproto.ModelList(data=[jproto.ModelCard(id="m")]), proto.ModelList(data=[proto.ModelCard(id="m")])),
        (jproto.ErrorResponse(message="e", code=401), proto.ErrorResponse(message="e", code=401)),
    ]
    for j, p in pairs:
        a, b = j.model_dump(), proto.dump(p)
        for d in (a, b):
            d.pop("id", None)
            d.pop("created", None)
            for card in d.get("data", []):
                card.pop("created")
        assert a == b


_scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-3, 300), st.floats(-2, 2, allow_nan=False),
    st.text(alphabet="abcxyz", max_size=4),
    st.sampled_from(["true", "false", "7", "0.5", "yes", "off"]),
)
_values = st.one_of(
    _scalars,
    st.lists(_scalars, max_size=3),
    st.lists(st.lists(st.integers(0, 9), max_size=3), max_size=2),
    st.dictionaries(st.sampled_from(["1", "2", "role", "content", "type", "text"]), _scalars,
                    max_size=2),
    st.lists(st.fixed_dictionaries({"role": st.sampled_from(["user", "system", 3])},
                                   optional={"content": _scalars}), max_size=2),
)


@settings(**RANDOM)
@given(name=st.sampled_from(REQUESTS), data=st.data())
def test_protocol_random_bodies_match_pydantic(name, data):
    fields = [f.name for f in dataclasses.fields(getattr(proto, name)) if f.name != "response_format"]
    keys = data.draw(st.lists(st.sampled_from(fields), max_size=5, unique=True))
    body = {k: data.draw(_values) for k in keys}
    for k in ("model", "prompt", "messages", "input"):  # mostly well-formed
        if k in fields and k not in body and data.draw(st.booleans()):
            body[k] = {"model": "m", "prompt": "p", "input": [1, 2],
                       "messages": [{"role": "user", "content": "c"}]}[k]
    _same(name, body)


MESSAGES = [
    [{"role": "user", "content": "hello"}],
    [{"role": "system", "content": "be brief"}, {"role": "user", "content": "q1"},
     {"role": "assistant", "content": "a1"}, {"role": "user", "content": "q2"}],
    [{"role": "assistant", "content": None}, {"role": "tool", "content": "{}"}],
]


@pytest.mark.parametrize("name", sorted(jconv.TEMPLATES))
def test_conversation_templates_render_as_jax(name):
    assert sorted(conv.TEMPLATES) == sorted(jconv.TEMPLATES)
    for msgs in MESSAGES:
        assert conv.TEMPLATES[name].render(msgs) == jconv.TEMPLATES[name].render(msgs)
    assert conv.TEMPLATES[name].stop == jconv.TEMPLATES[name].stop


@pytest.mark.parametrize(
    "model", ["Llama-3.2-1B", "Qwen2-VL-2B", "mllama-vision", "phi-3-mini", "gpt_oss", "other", None]
)
def test_conversation_inference_matches_jax(model):
    assert conv.get_template(None, model).name == jconv.get_template(None, model).name


TOOLS = [{"type": "function", "function": {"name": n}} for n in ("get_weather", "lookup")]
PIECES = [
    "<think>", "</think>", "<tool_call>", "</tool_call>", "[TOOL_CALLS]", "```json", "```",
    '{"name": "get_weather", "arguments": {"city": "Paris"}}', '{"name": "lookup"', ', "arguments"',
    ': {"q": "a b"}}', '[{"name": "lookup", "arguments": {}}]', "Sure.", " ", "\n", '"', "{", "}",
    "plan: ", "<", "/", "think", "tool", "_call>",
]
FIXED = [
    "<think>weigh it</think>The answer.",
    "reasoning only</think>visible",
    'Let me check. <tool_call>{"name": "get_weather", "arguments": {"city": "Paris"}}</tool_call>',
    '[TOOL_CALLS][{"name": "lookup", "arguments": {"q": 1}}]',
    '```json\n{"name": "lookup", "arguments": {}}\n```',
    '{"name": "get_weather", "arguments": {"city": "Rome"}}',
    "<think>a</think><think>b</think>c",
    "plain text, no calls",
]


def _calls(res):
    return [(c.name, c.arguments) for c in res.calls], res.normal_text


def _stream(mod, text, cuts):
    parser = mod.StreamingToolParser(TOOLS)
    out, last = [], 0
    for c in sorted(set(cuts)) + [len(text)]:
        r = parser.feed(text[last:c])
        out.append((r.normal_text, [_strip_ids(d) for d in r.deltas]))
        last = c
    r = parser.finish()
    out.append((r.normal_text, [_strip_ids(d) for d in r.deltas]))
    return out, parser.saw_tool_call


def _strip_ids(delta):
    return {k: v for k, v in delta.items() if k != "id"}


def _reason_stream(mod, text, cuts, force):
    p = mod.StreamingReasoningParser(force_reasoning=force, stream_reasoning=True)
    out, last = [], 0
    for c in sorted(set(cuts)) + [len(text)]:
        out.append(p.feed(text[last:c]))
        last = c
    out.append(p.finish())
    return out


def _check_text(text, cuts):
    assert rp.split_reasoning(text) == jrp.split_reasoning(text)
    assert _calls(fc.FunctionCallParser(TOOLS).parse(text)) == _calls(
        jfc.FunctionCallParser(TOOLS).parse(text)
    )
    assert _stream(fc, text, cuts) == _stream(jfc, text, cuts)
    for force in (False, True):
        assert _reason_stream(rp, text, cuts, force) == _reason_stream(jrp, text, cuts, force)


@pytest.mark.parametrize("text", FIXED)
def test_parsers_match_jax_on_fixed_cases(text):
    _check_text(text, list(range(0, len(text), 3)))
    _check_text(text, [])


@settings(**RANDOM)
@given(parts=st.lists(st.sampled_from(PIECES), max_size=10), data=st.data())
def test_parsers_match_jax_on_random_strings(parts, data):
    text = "".join(parts)
    cuts = data.draw(st.lists(st.integers(0, max(len(text), 1)), max_size=6))
    _check_text(text, cuts)

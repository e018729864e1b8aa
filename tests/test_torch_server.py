"""The port's HTTP server against the JAX package's, on the same weights.

Two pairs of servers start once for the module, each on a free port, each
side on its own engine (tiny-debug, f32, page 4): the JAX ``ServerApp``
(aiohttp) on a JAX engine and the port's ``ServerApp`` (asyncio streams) on
the port's engine, with the JAX weights handed over through
``params_from_jax``. Requests go to both over HTTP with ``urllib``.

- Pair A, random weights and the char-level tokenizer of
  ``tests/test_server_chat.py``: completions (greedy ids and logprobs,
  ``n``, parallel requests, streaming, echo, ``logit_bias``), chat with the
  fallback template, embeddings, files and batches, bad bodies, the
  refusals, a ``regex`` and a ``response_format`` grammar, custom logit
  processors behind ``enable_custom_logit_processor``, ``/metrics`` and
  ``/system_info``.
- Pair B, scripted weights: every layer's output projections are zero, so
  the last token alone picks the next, and the head walks a chain from the
  fallback template's last token through ids that decode to ``SCRIPT``, a
  reasoning span and a tool call, then to EOS. Its chat answers stream
  reasoning and tool-call deltas on both sides. It also asks for an API key.

Greedy prompts are fixed, and the port's top-2 logit margin must exceed
``MARGIN`` at every compared step, so a near tie fails loudly instead of
flaking.
"""

import asyncio
import concurrent.futures
import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu.server.http_server import ServerApp as JaxServerApp
from scratchpad_tpu.server.metrics import LatencyStats as JaxLatencyStats
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from scratchpad_tpu_torch.server.http_server import ServerApp, ServerThread
from scratchpad_tpu_torch.server.metrics import LatencyStats
from scratchpad_tpu_torch.server.openai_api.conversation import get_template
from scratchpad_tpu_torch.tools import analyze_trace
from torch_margins import top2_margin
import torch_threads  # noqa: F401  (one torch thread a test process)

ARGS = dict(preset="tiny-debug", random_weights=True, dtype="float32", page_size=4,
            max_total_tokens=2048, host="127.0.0.1", served_model_name="tiny")
MARGIN = 1e-3
LP_TOL = 1e-4
API_KEY = "sk-test"
SCRIPT = '<think>check the sky</think>Sure. <tool_call>{"name": "get_weather", ' \
         '"arguments": {"city": "Paris"}}</tool_call>'
BAND = 300  # token BAND + j decodes to SCRIPT[j]
TOOLS = [{"type": "function", "function": {"name": "get_weather"}}]


class CharTokenizer:
    """The char-level tokenizer of tests/test_server_chat.py: id = ord(char)
    + 1, eos = 0."""

    eos_token_id = 0
    chat_template = None

    def encode(self, text):
        return [ord(c) + 1 for c in text]

    def decode(self, ids, **kw):
        return "".join(chr(i - 1) for i in ids if 0 < i <= 256)


class ScriptTokenizer(CharTokenizer):
    """CharTokenizer whose ids ``BAND + j`` decode to ``SCRIPT[j]``."""

    def decode(self, ids, **kw):
        return "".join(
            chr(i - 1) if 0 < i <= 256 else SCRIPT[i - BAND] if 0 <= i - BAND < len(SCRIPT) else ""
            for i in ids
        )


def scripted(params: dict) -> dict:
    """Pair B's weights: no layer adds to the residual stream, and the head
    maps '\\n' (the fallback template's last token) to BAND, BAND + j to
    BAND + j + 1, and the script's last id to EOS."""
    p = jax.tree.map(np.array, params)
    p["layers"]["wo"][:] = 0.0
    p["layers"]["down"][:] = 0.0
    src = [ord("\n") + 1] + [BAND + j for j in range(len(SCRIPT))]
    dst = [BAND + j for j in range(len(SCRIPT))] + [0]
    for s, d in zip(src, dst):
        e = p["embed"][s]
        h = e / np.sqrt(np.mean(e * e) + 1e-6) * p["final_norm"]
        p["lm_head"][d] = 60.0 * h / np.linalg.norm(h)
    return p


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _JaxServer:
    def __init__(self, engine, args):
        from aiohttp import web

        self.loop = asyncio.new_event_loop()
        self.app = JaxServerApp(engine, args)
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            runner = web.AppRunner(self.app.app)
            self.loop.run_until_complete(runner.setup())
            self.loop.run_until_complete(web.TCPSite(runner, args.host, args.port).start())
            started.set()
            self.loop.run_forever()

        threading.Thread(target=run, daemon=True).start()
        assert started.wait(60), "the JAX server did not start"

    def stop(self):
        self.app.runner.shutdown()
        self.loop.call_soon_threadsafe(self.loop.stop)


def _pair(tokenizer, transform=None, **extra):
    """(JAX engine, port engine) on the same weights."""
    jeng = JaxEngine(JaxServerArgs(port=_free_port(), **ARGS, **extra), tokenizer=tokenizer)
    eng = Engine(ServerArgs(device="cpu", port=_free_port(), **ARGS, **extra), tokenizer=tokenizer)
    runner = jeng.scheduler.runner
    params = jax.tree.map(np.asarray, runner.params)
    if transform is not None:
        params = transform(params)
        runner.params = jax.tree.map(jnp.asarray, params)
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return jeng, eng


def _serve(jeng, eng):
    j = _JaxServer(jeng, jeng.args)
    p = ServerThread(ServerApp(eng, eng.args))
    return j, p, f"http://127.0.0.1:{jeng.args.port}", f"http://127.0.0.1:{eng.args.port}"


PROMPTS = [np.random.default_rng(s).integers(1, 500, n).tolist() for s, n in ((11, 9), (12, 23), (13, 40))]
TEXT = "The quick brown fox"
CHAT = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hello there"}]
PARALLEL = [np.random.default_rng(100 + i).integers(1, 500, 6 + 5 * i).tolist() for i in range(8)]


@pytest.fixture(scope="module")
def servers():
    a = _pair(CharTokenizer())
    b = _pair(ScriptTokenizer(), scripted, api_key=API_KEY, reasoning_parser="qwen3")
    # engine-level checks that need idle engines: the margins of every
    # greedy prompt, and top-logprobs (the HTTP servers return none)
    eng = a[1]
    chat = CharTokenizer().encode(get_template(None, "tiny").render(CHAT))
    bias = logit_bias(eng, PROMPTS[0])
    for prompt, n, lb in [(p, 8, None) for p in PROMPTS + PARALLEL] + [
        (CharTokenizer().encode(TEXT), 10, None), (chat, 6, None), (PROMPTS[0], 8, bias),
    ]:
        out = eng.generate(input_ids=prompt, sampling_params=SamplingParams(
            temperature=0.0, max_new_tokens=n, ignore_eos=True,
            logit_bias=None if lb is None else {int(k): v for k, v in lb.items()}))
        assert top2_margin(eng, prompt, out.output_ids, lb) > MARGIN, f"near tie on {prompt}"
    jeng = a[0]
    tops = [
        e.generate(input_ids=PROMPTS[1], return_logprob=True, sampling_params=S(
            temperature=0.0, max_new_tokens=4, ignore_eos=True, top_logprobs=5))
        for e, S in ((jeng, JaxSamplingParams), (eng, SamplingParams))
    ]
    # the servers start alike: empty caches, and /metrics counts their
    # traffic alone
    jeng.flush_cache()
    eng.flush_cache()
    jeng.latency, eng.latency = JaxLatencyStats(), LatencyStats()
    ja, pa, ja_url, pa_url = _serve(*a)
    jb, pb, jb_url, pb_url = _serve(*b)
    yield dict(a=(ja_url, pa_url), b=(jb_url, pb_url), tops=tops, port_app=pa.app,
               bias=bias, args=(ja.app.args, pa.app.args))
    for s in (ja, pa, jb, pb):
        s.stop()


def request(url, path, body=None, method=None, headers=None, raw=None, timeout=120):
    """(status, parsed JSON or bytes) of one request."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(
        url + path, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, payload = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, payload = e.code, e.read()
    try:
        return status, json.loads(payload)
    except ValueError:
        return status, payload


def events(url, path, body, headers=None):
    """The JSON events of a streamed answer, up to ``[DONE]``."""
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    out, done = [], False
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if line == "data: [DONE]":
                done = True
            elif line.startswith("data: "):
                out.append(json.loads(line[6:]))
    assert done
    return out


def both(servers, path, body=None, pair="a", **kw):
    return [request(u, path, body, **kw) for u in servers[pair]]


def completion(**kw):
    return {**dict(model="tiny", max_tokens=8, temperature=0.0, ignore_eos=True, logprobs=1), **kw}


def ids_and_lps(choice):
    lp = choice["logprobs"]
    return [int(t) for t in lp["tokens"]], lp["token_logprobs"]


def assert_lps_close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert abs(x - y) <= LP_TOL, (a, b)


def assert_same_keys(a, b, path="$"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_same_keys(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and a and b and isinstance(a[0], dict):
        for x, y in zip(a, b):
            assert_same_keys(x, y, f"{path}[]")


# ---------------------------------------------------------------- completions


@pytest.mark.parametrize("prompt", PROMPTS, ids=["9", "23", "40"])
def test_greedy_completion_ids_and_logprobs_match(servers, prompt):
    (sj, j), (sp, p) = both(servers, "/v1/completions", completion(prompt=prompt))
    assert sj == sp == 200
    assert_same_keys(j, p)
    ji, jl = ids_and_lps(j["choices"][0])
    pi, pl = ids_and_lps(p["choices"][0])
    assert ji == pi and len(pi) == 8
    assert_lps_close(jl, pl)
    assert j["usage"] == p["usage"]


def test_n_2_gives_two_equal_greedy_choices(servers):
    (_, j), (_, p) = both(servers, "/v1/completions", completion(prompt=PROMPTS[1], n=2))
    assert len(j["choices"]) == len(p["choices"]) == 2
    for a, b in zip(j["choices"], p["choices"]):
        assert ids_and_lps(a)[0] == ids_and_lps(b)[0]
        assert_lps_close(ids_and_lps(a)[1], ids_and_lps(b)[1])
    assert ids_and_lps(p["choices"][0]) == ids_and_lps(p["choices"][1])


def test_eight_parallel_requests_match(servers):
    def run(url):
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            return list(ex.map(
                lambda pr: request(url, "/v1/completions", completion(prompt=pr)), PARALLEL))

    jr, pr = (run(u) for u in servers["a"])
    for (sj, j), (sp, p) in zip(jr, pr):
        assert sj == sp == 200
        assert ids_and_lps(j["choices"][0])[0] == ids_and_lps(p["choices"][0])[0]
        assert_lps_close(ids_and_lps(j["choices"][0])[1], ids_and_lps(p["choices"][0])[1])


def test_streamed_completion_joins_to_the_full_answer(servers):
    body = dict(model="tiny", prompt=TEXT, max_tokens=10, temperature=0.0, ignore_eos=True)
    texts = []
    for url in servers["a"]:
        evs = events(url, "/v1/completions", dict(body, stream=True))
        _, full = request(url, "/v1/completions", body)
        joined = "".join(e["choices"][0]["text"] for e in evs)
        assert joined == full["choices"][0]["text"]
        assert evs[-1]["choices"][0]["finish_reason"] == "length"
        assert evs[-1]["usage"]["completion_tokens"] == 10
        assert len({e["id"] for e in evs}) == 1
        texts.append((joined, evs[-1]["usage"]))
    assert texts[0] == texts[1]


def test_echo_logprobs_score_the_prompt(servers):
    body = completion(prompt=PROMPTS[2], echo=True, max_tokens=4)
    (_, j), (_, p) = both(servers, "/v1/completions", body)
    ji, jl = ids_and_lps(j["choices"][0])
    pi, pl = ids_and_lps(p["choices"][0])
    assert ji == pi and ji[: len(PROMPTS[2])] == PROMPTS[2]
    assert jl[0] is None and pl[0] is None and len(pl) == len(PROMPTS[2]) + 4
    assert_lps_close(jl, pl)


def logit_bias(eng, prompt):
    """A bias that bans the prompt's first greedy token and favours 17."""
    out = eng.generate(input_ids=prompt, sampling_params=SamplingParams(
        temperature=0.0, max_new_tokens=1, ignore_eos=True))
    return {str(out.output_ids[0]): -100.0, "17": 2.5}


def test_logit_bias_moves_both_sides_alike(servers):
    bias = servers["bias"]
    first = int(next(k for k, v in bias.items() if v < 0))
    (_, j), (_, p) = both(servers, "/v1/completions", completion(prompt=PROMPTS[0], logit_bias=bias))
    ji, jl = ids_and_lps(j["choices"][0])
    pi, pl = ids_and_lps(p["choices"][0])
    assert ji == pi and first not in pi
    assert_lps_close(jl, pl)


def test_top_logprobs_match_at_the_engine(servers):
    """logprobs=5's top ids and values, asked of the idle engines before the
    servers started (the HTTP servers return ``top_logprobs: null`` on both
    sides)."""
    j, p = servers["tops"]
    assert j.output_ids == p.output_ids
    assert len(p.output_top_logprobs) == 4
    for (jv, ji), (pv, pi) in zip(j.output_top_logprobs, p.output_top_logprobs):
        assert list(ji)[:5] == list(pi)[:5]
        np.testing.assert_allclose(np.asarray(pv)[:5], np.asarray(jv)[:5], atol=LP_TOL)


def test_embeddings_match(servers):
    body = dict(model="tiny", input=[PROMPTS[0], PROMPTS[2]])
    (sj, j), (sp, p) = both(servers, "/v1/embeddings", body)
    assert sj == sp == 200
    assert_same_keys(j, p)
    for a, b in zip(j["data"], p["data"]):
        assert np.abs(np.asarray(a["embedding"]) - np.asarray(b["embedding"])).max() <= 1e-5
    _, text = both(servers, "/v1/embeddings", dict(model="tiny", input="hello"))[1]
    assert abs(np.linalg.norm(text["data"][0]["embedding"]) - 1.0) < 1e-5


def test_chat_with_the_fallback_template(servers):
    body = dict(model="tiny", messages=CHAT, max_tokens=6, temperature=0.0, ignore_eos=True)
    (sj, j), (sp, p) = both(servers, "/v1/chat/completions", body)
    assert sj == sp == 200
    assert_same_keys(j, p)
    assert j["choices"][0]["message"] == p["choices"][0]["message"]
    assert j["usage"] == p["usage"] and p["usage"]["completion_tokens"] == 6
    for url in servers["a"]:
        evs = events(url, "/v1/chat/completions", dict(body, stream=True))
        assert evs[0]["choices"][0]["delta"]["role"] == "assistant"
        joined = "".join(e["choices"][0]["delta"].get("content") or "" for e in evs)
        assert joined == (p["choices"][0]["message"]["content"] or "")
        assert evs[-1]["choices"][0]["finish_reason"] == "length"


# --------------------------------------------------- scripted chat: reasoning, tools


def _chat_stream(url, body):
    evs = events(url, "/v1/chat/completions", body, headers={"Authorization": f"Bearer {API_KEY}"})
    reasoning = "".join(e["choices"][0]["delta"].get("reasoning_content") or "" for e in evs)
    content = "".join(e["choices"][0]["delta"].get("content") or "" for e in evs)
    calls = [d for e in evs for d in e["choices"][0]["delta"].get("tool_calls") or []]
    names = [c["function"]["name"] for c in calls if c["function"].get("name")]
    args = "".join(c["function"].get("arguments", "") for c in calls)
    return reasoning, content, names, args, evs[-1]["choices"][0]["finish_reason"]


def test_streamed_chat_reasoning_and_tool_calls_match(servers):
    body = dict(model="tiny", messages=[{"role": "user", "content": "weather?"}], max_tokens=200,
                temperature=0.0, stream=True, tools=TOOLS)
    j, p = (_chat_stream(u, body) for u in servers["b"])
    assert j == p
    reasoning, content, names, args, finish = p
    assert reasoning == "check the sky"
    assert names == ["get_weather"] and json.loads(args) == {"city": "Paris"}
    assert finish == "tool_calls" and content.strip() == "Sure."


def test_chat_tool_calls_and_api_key(servers):
    body = dict(model="tiny", messages=[{"role": "user", "content": "weather?"}], max_tokens=200,
                temperature=0.0, tools=TOOLS)
    auth = {"Authorization": f"Bearer {API_KEY}"}
    (sj, j), (sp, p) = both(servers, "/v1/chat/completions", body, pair="b", headers=auth)
    assert sj == sp == 200
    jm, pm = j["choices"][0]["message"], p["choices"][0]["message"]
    for m in (jm, pm):
        for c in m["tool_calls"]:
            c.pop("id")
    assert jm == pm and pm["reasoning_content"] == "check the sky"
    assert p["choices"][0]["finish_reason"] == j["choices"][0]["finish_reason"] == "tool_calls"
    for bad in ({}, {"Authorization": "Bearer wrong"}):
        (sj, j), (sp, p) = both(servers, "/v1/chat/completions", body, pair="b", headers=bad)
        assert sj == sp == 401 and j == p
    assert [s for s, _ in both(servers, "/health", pair="b")] == [200, 200]


# ------------------------------------------------------------ files and batches


def _multipart(fields: dict, filename: str, content: bytes):
    boundary = "sptpu-boundary-7f1c"
    parts = [
        f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
        for k, v in fields.items()
    ]
    parts.append(
        f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="{filename}"\r\n'
        f"Content-Type: application/octet-stream\r\n\r\n".encode() + content + b"\r\n"
    )
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _run_batch(url):
    lines = [
        {"custom_id": f"r{i}", "body": dict(model="tiny", prompt=pr, max_tokens=4, temperature=0.0,
                                             ignore_eos=True)}
        for i, pr in enumerate(PROMPTS[:2])
    ] + [{"custom_id": "bad", "body": {"prompt": [1]}}]
    raw, ctype = _multipart({"purpose": "batch"}, "in.jsonl",
                            "\n".join(json.dumps(x) for x in lines).encode())
    s, f = request(url, "/v1/files", raw=raw, headers={"Content-Type": ctype})
    assert s == 200 and f["bytes"] == len("\n".join(json.dumps(x) for x in lines))
    s, b = request(url, "/v1/batches", {"input_file_id": f["id"], "endpoint": "/v1/completions"})
    assert s == 200
    for _ in range(600):
        s, b = request(url, f"/v1/batches/{b['id']}")
        if b["status"] == "completed":
            break
        time.sleep(0.05)
    s, out = request(url, f"/v1/files/{b['output_file_id']}/content")
    rows = [json.loads(x) for x in out.decode().splitlines()]
    s2, deleted = request(url, f"/v1/files/{f['id']}", method="DELETE")
    s3, _ = request(url, f"/v1/files/{f['id']}")
    return b["request_counts"], rows, (s2, deleted["deleted"], s3), f


def test_files_and_batches_match(servers):
    (jc, jrows, jdel, jf), (pc, prows, pdel, pf) = (_run_batch(u) for u in servers["a"])
    assert jc == pc == {"total": 3, "completed": 2, "failed": 1}
    assert jdel == pdel == (200, True, 404)
    assert_same_keys(jf, pf)
    for a, b in zip(jrows, prows):
        assert a["custom_id"] == b["custom_id"]
        if a["response"] is None:
            assert b["response"] is None and b["error"]
            continue
        ja, pa = a["response"]["body"], b["response"]["body"]
        assert ja["choices"] == pa["choices"] and ja["usage"] == pa["usage"]


# ------------------------------------------------------------- bad bodies, refusals

BAD = [
    ("/v1/completions", b"{not json"),
    ("/v1/completions", b"[1, 2]"),
    ("/v1/completions", b'{"prompt": [1, 2]}'),
    ("/v1/completions", b'{"model": "m"}'),
    ("/v1/completions", b'{"model": "m", "prompt": {"a": 1}}'),
    ("/v1/completions", b'{"model": "m", "prompt": [1], "max_tokens": "many"}'),
    ("/v1/completions", b'{"model": "m", "prompt": "text, no tokenizer needed", "n": "two"}'),
    ("/v1/chat/completions", b'{"model": "m", "messages": "hi"}'),
    ("/v1/chat/completions", b'{"model": "m", "messages": [{"content": "x"}]}'),
    ("/v1/chat/completions", b'{"model": "m"}'),
    ("/v1/embeddings", b'{"model": "m"}'),
    ("/v1/embeddings", b'{"model": "m", "input": [1.5]}'),
    ("/memory_pool", b'{"max_total_tokens": -1}'),
    ("/v1/batches", b'{"input_file_id": "file-none"}'),
]


@pytest.mark.parametrize("path,raw", BAD, ids=[f"{p}-{i}" for i, (p, _) in enumerate(BAD)])
def test_bad_bodies_get_the_same_status(servers, path, raw):
    (sj, j), (sp, p) = both(servers, path, raw=raw)
    assert sj == sp and sj >= 400, (j, p)
    if isinstance(j, dict) and isinstance(p, dict):
        assert set(j) == set(p)


def test_routes_and_methods(servers):
    for path, method, status in (("/nowhere", "GET", 404), ("/v1/completions", "GET", 405),
                                 ("/health", "GET", 200), ("/v1/models", "GET", 200),
                                 ("/health_generate", "GET", 200), ("/", "GET", 200)):
        (sj, j), (sp, p) = both(servers, path, method=method)
        assert sj == sp == status, path
        if path in ("/health", "/v1/models", "/health_generate"):
            assert_same_keys(j, p)
    (sj, j), (sp, p) = both(servers, "/abort_request", {"rid": "none"})
    assert sj == sp == 200 and j == p
    (sj, j), (sp, p) = both(servers, "/flush_cache", {})
    assert sj == sp == 200 and j == p


@pytest.mark.parametrize(
    "path,body,status",
    [
        ("/v1/chat/completions", {"model": "m", "messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": "data:,"}}]}]}, 400),
    ],
    ids=["image"],
)
def test_unported_features_are_refused_over_http(servers, path, body, status):
    """An image, refused while the vision models were unported, answers 400
    from a text model (``tests/test_torch_mm_http.py`` serves images on
    vision models). ``/update_weights`` and ``/memory_pool``, once refused
    here, are served (``tests/test_torch_memory_extras.py``)."""
    s, p = request(servers["a"][1], path, body)
    assert s == status and "does not accept images" in (p.get("message") or ""), p


@pytest.mark.parametrize("route", ["completions", "chat"])
def test_custom_logit_processor_over_http(servers, route):
    """A ``BannedTokensProcessor`` of each package's own (base64, zlib,
    pickle), banning the ids of the free greedy answer: without
    ``--enable-custom-logit-processor`` both servers answer 400 with the
    JAX message; with it, 200 with equal texts (and, on completions, equal
    ids) that hold none of the banned ids."""
    from scratchpad_tpu.sampling.custom_logit_processor import BannedTokensProcessor as JaxBanned
    from scratchpad_tpu_torch.sampling.custom_logit_processor import BannedTokensProcessor

    if route == "completions":
        path, body = "/v1/completions", completion(prompt=PROMPTS[2], max_tokens=6)
        answer = lambda out: ids_and_lps(out["choices"][0])[0]
    else:
        path = "/v1/chat/completions"
        body = dict(model="tiny", messages=CHAT, max_tokens=6, temperature=0.0, ignore_eos=True)
        answer = lambda out: CharTokenizer().encode(out["choices"][0]["message"]["content"])
    (sj, j), (sp, p) = both(servers, path, body)
    assert sj == sp == 200 and answer(j) == answer(p)
    banned = answer(p)
    assert banned
    bodies = [dict(body, custom_logit_processor=cls(banned).to_str(), custom_params={"unused": 1.0})
              for cls in (JaxBanned, BannedTokensProcessor)]
    (sj, j), (sp, p) = (request(u, path, b) for u, b in zip(servers["a"], bodies))
    assert sj == sp == 400 and j["message"] == p["message"] == (
        "custom_logit_processor requires the server to run with --enable-custom-logit-processor")
    for args in servers["args"]:
        args.enable_custom_logit_processor = True
    try:
        (sj, j), (sp, p) = (request(u, path, b) for u, b in zip(servers["a"], bodies))
    finally:
        for args in servers["args"]:
            args.enable_custom_logit_processor = False
    assert sj == sp == 200, (j, p)
    assert j["choices"][0]["text" if route == "completions" else "message"] == \
        p["choices"][0]["text" if route == "completions" else "message"]
    assert answer(j) == answer(p) and not set(answer(p)) & set(banned), (answer(p), banned)


# a schema whose longest word fits max_tokens: four places of up to 8
# blanks beside 12 other characters
GRAMMAR_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}, "required": ["ok"]}


@pytest.mark.parametrize(
    "path,body",
    [
        ("/v1/chat/completions", {"model": "m", "messages": [{"role": "user", "content": "x"}],
                                  "max_tokens": 48, "temperature": 0.0, "response_format": {
                                      "type": "json_schema",
                                      "json_schema": {"name": "s", "schema": GRAMMAR_SCHEMA}}}),
        ("/v1/completions", {"model": "m", "prompt": [1], "max_tokens": 8, "temperature": 0.0,
                             "regex": "(yes|no)!"}),
    ],
    ids=["response_format", "regex"],
)
def test_grammars_are_served_over_http(servers, path, body):
    """A ``response_format`` and a ``regex`` answer 200 on both sides, with
    the same text, which matches the grammar."""
    import re

    (sj, j), (sp, p) = both(servers, path, body)
    assert sj == sp == 200, (j, p)
    if "messages" in body:
        texts = [r["choices"][0]["message"]["content"] for r in (j, p)]
        v = json.loads(texts[1])
        assert isinstance(v, dict) and set(v) == {"ok"} and isinstance(v["ok"], bool), texts[1]
    else:
        texts = [r["choices"][0]["text"] for r in (j, p)]
        assert re.fullmatch(r"(yes|no)!", texts[1]), texts[1]
    assert texts[0] == texts[1]


def test_profile_writes_a_trace_analyze_trace_reads(servers, tmp_path):
    url = servers["a"][1]
    s, p = request(url, "/start_profile", {"output_dir": str(tmp_path)})
    assert s == 200
    # the same request to both sides keeps /metrics' traffic equal
    both(servers, "/v1/completions", completion(prompt=PROMPTS[0], max_tokens=2))
    s, p = request(url, "/stop_profile", {})
    assert s == 200
    with open(p["trace"]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert analyze_trace.load_events(p["trace"]) == []  # no device on the CPU
    assert request(url, "/stop_profile", {})[0] == 400


def test_system_info_keys(servers):
    (sj, j), (sp, p) = both(servers, "/system_info")
    assert sj == sp == 200
    assert set(j) == set(p)
    assert p["model"] == j["model"] == "tiny"
    assert p["args"]["enable_overlap"] is None  # auto: off on the CPU


def _samples(text):
    out = {}
    for line in text.decode().splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_metrics_names_and_counts_match(servers):
    """Last in the module: both sides have served the same traffic."""
    (sj, j), (sp, p) = both(servers, "/metrics")
    assert sj == sp == 200
    js, ps = _samples(j), _samples(p)
    assert sorted(js) == sorted(ps)
    counted = [k for k in js if k.endswith("_count") or "num_finished_reqs_total" in k]
    assert len(counted) >= 5
    for k in counted:
        assert js[k] == ps[k], k
    assert ps["scratchpad_tpu:time_to_first_token_seconds_count"] > 0
    assert ps["scratchpad_tpu:inter_token_latency_seconds_count"] > 0


def test_concurrent_clients_and_disconnects_keep_the_runner_consistent(servers):
    """After /metrics (its traffic is the port's alone): more client threads
    than cores, a short switch interval, and every third client dropping its
    stream after the first event. The others get whole answers; afterwards
    no request is left in the runner or the scheduler, and a flush returns
    every page."""
    url, app = servers["a"][1], servers["port_app"]
    n_clients = (os.cpu_count() or 1) + 4

    def client(i):
        body = completion(prompt=PARALLEL[i % 8], max_tokens=64 if i % 3 == 0 else 12)
        if i % 3:
            s, out = request(url, "/v1/completions", body)
            return s == 200 and out["usage"]["completion_tokens"] == 12
        req = urllib.request.Request(url + "/v1/completions",
                                     data=json.dumps(dict(body, stream=True)).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.readline().startswith(b"data: ")  # then hang up

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(n_clients) as ex:
            results = list(ex.map(client, range(n_clients), timeout=120))
    finally:
        sys.setswitchinterval(switch)
    assert all(results)
    sched = app.engine.scheduler
    deadline = time.monotonic() + 30
    while (app.runner.states or sched.has_work()) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not app.runner.states and not sched.has_work()
    assert request(url, "/flush_cache", {})[0] == 200
    assert sched.allocator.available_pages == sched.allocator.num_pages - 1
    assert app.runner.thread.is_alive()

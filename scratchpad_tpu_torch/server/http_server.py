"""OpenAI-compatible HTTP server on asyncio streams.

Counterpart of ``scratchpad_tpu/server/http_server.py`` (aiohttp) on the
standard library: ``asyncio.start_server`` and a small HTTP/1.1 handler
that reads a request line, headers and a ``Content-Length`` body, answers
JSON with ``Content-Length`` and streams ``text/event-stream`` with chunked
encoding; connections are kept alive unless the client asks to close them. Every JAX route is here, with the same statuses and response
keys. Constrained decoding is served: ``regex``, ``ebnf`` and
``json_schema`` on completions and chat, and chat's ``response_format``
``json_object``, ``json_schema`` and ``structural_tag``. A custom logit
processor is decoded behind ``--enable-custom-logit-processor`` and
answers 400 without it, as the JAX server does. Chat takes ``image_url``,
``image``, ``video_url`` and ``video`` parts (a ``data:`` URL, raw base64
or a local path; a remote URL, a model without vision or a missing
decoding library answer 400), decoded off the event loop and encoded on
the scheduler thread. ``/update_weights`` and a ``/memory_pool`` resize
run on the scheduler thread of an idle engine (409 while requests run).
The handlers await the async runner's streams; the
engine itself runs on the runner's scheduler thread.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import re
import tempfile
import threading
import time
from typing import Awaitable, Callable, Optional
from urllib.parse import urlsplit

import torch

from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.sampling.custom_logit_processor import CustomLogitProcessor
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.async_runner import AsyncEngineRunner
from scratchpad_tpu_torch.server.engine import Engine, GenerationOutput
from scratchpad_tpu_torch.server.openai_api.protocol import (
    ChatCompletionChoice,
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatCompletionStreamChoice,
    ChatCompletionStreamResponse,
    ChatMessage,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    DeltaMessage,
    EmbeddingRequest,
    ErrorResponse,
    ModelCard,
    ModelList,
    UsageInfo,
    ValidationError,
    dump,
    parse,
)
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("http_server")

_REASONS = {
    200: "OK", 100: "Continue", 400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict", 500: "Internal Server Error",
    501: "Not Implemented",
}
MAX_BODY = 64 << 20


def _sampling_from(req, max_tokens: int, allow_custom_logit: bool = False) -> SamplingParams:
    """The request's sampling parameters, its grammar (regex, ebnf,
    json_schema) and its custom logit processor among them. A processor's
    payload is decoded only with ``allow_custom_logit`` (the server's
    ``enable_custom_logit_processor``): unpickling runs arbitrary code.
    Raises ``ValueError`` (400) for a processor without the flag, as the
    JAX server does (``http_server.py:52-59``), and for a payload that does
    not decode."""
    proc = None
    if getattr(req, "custom_logit_processor", None):
        if not allow_custom_logit:
            raise ValueError(
                "custom_logit_processor requires the server to run with "
                "--enable-custom-logit-processor"
            )
        try:
            proc = CustomLogitProcessor.from_str(req.custom_logit_processor)
        except Exception as e:  # base64, zlib or pickle: a payload that does not decode
            raise ValueError(f"custom_logit_processor does not decode: {e!r}") from e
        if not callable(proc):
            raise ValueError(f"custom_logit_processor decodes to a {type(proc).__name__}, not a callable")
    # OpenAI logit_bias keys are token-id strings
    bias = {int(k): float(v) for k, v in req.logit_bias.items()} if req.logit_bias else None
    return SamplingParams(
        custom_logit_processor=proc,
        custom_params=getattr(req, "custom_params", None),
        max_new_tokens=max_tokens,
        temperature=req.temperature,
        top_p=req.top_p,
        top_k=req.top_k,
        min_p=req.min_p,
        frequency_penalty=req.frequency_penalty,
        presence_penalty=req.presence_penalty,
        repetition_penalty=req.repetition_penalty,
        stop=req.stop,
        ignore_eos=req.ignore_eos,
        skip_special_tokens=req.skip_special_tokens,
        logit_bias=bias,
        regex=req.regex,
        ebnf=req.ebnf,
        json_schema=req.json_schema,
    )


def _response_format_grammar(sp: SamplingParams, fmt) -> None:
    """Chat's ``response_format`` as the grammar of ``sp``, as the JAX
    server maps it: ``json_object`` the generic JSON grammar,
    ``json_schema`` its ``schema``, ``structural_tag`` its structures and
    triggers."""
    if fmt is None or fmt.type == "text":
        return
    if fmt.type == "json_object":
        sp.json_schema = "true"
    elif fmt.type == "json_schema":
        sp.json_schema = json.dumps((fmt.json_schema or {}).get("schema", {}))
    elif fmt.type == "structural_tag":
        structures = [
            {"begin": s["begin"], "schema": s.get("schema"), "end": s["end"]}
            for s in (fmt.structures or [])
        ]
        sp.structural_tag = json.dumps({"structures": structures, "triggers": fmt.triggers or []})
    else:
        raise ValueError(f"unknown response_format type {fmt.type!r}")


def _usage(out: GenerationOutput) -> UsageInfo:
    return UsageInfo(
        prompt_tokens=out.prompt_tokens,
        completion_tokens=out.completion_tokens,
        total_tokens=out.prompt_tokens + out.completion_tokens,
        prompt_tokens_details={"cached_tokens": out.cached_tokens},
    )


# ------------------------------------------------------------------ HTTP


class Request:
    def __init__(self, method: str, target: str, headers: dict, body: bytes):
        self.method = method
        self.path = urlsplit(target).path
        self.headers = headers  # lower-cased names
        self.body = body
        self.match_info: dict[str, str] = {}
        self.stream: Optional[EventStream] = None  # set once the answer streams

    def json(self):
        return json.loads(self.body or b"null")


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "application/json", headers: Optional[dict] = None):
        self.body, self.status, self.content_type = body, status, content_type
        self.headers = headers or {}


def json_response(data, status: int = 200) -> Response:
    return Response(json.dumps(data).encode(), status)


def text_response(text: str, status: int = 200, content_type: str = "text/plain") -> Response:
    return Response(text.encode(), status, f"{content_type}; charset=utf-8")


class EventStream:
    """A ``text/event-stream`` response in chunked encoding; the handler
    returns it after writing its last event. A stream that fails before its
    end is cut by closing the connection."""

    def __init__(self, request: Request, writer: asyncio.StreamWriter):
        self.writer = writer
        self.started = self.closed = False
        request.stream = self

    async def prepare(self) -> None:
        self.writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\nTransfer-Encoding: chunked\r\n\r\n"
        )
        self.started = True
        await self.writer.drain()

    async def send(self, data: str) -> None:
        raw = data.encode()
        self.writer.write(b"%x\r\n%s\r\n" % (len(raw), raw))
        await self.writer.drain()

    async def close(self) -> None:
        self.writer.write(b"0\r\n\r\n")
        await self.writer.drain()
        self.closed = True


Handler = Callable[[Request, asyncio.StreamWriter], Awaitable]


class Router:
    def __init__(self):
        self.routes: list[tuple[str, re.Pattern, Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        rx = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
        self.routes.append((method, re.compile(f"^{rx}$"), handler))

    def add_get(self, path, handler):
        self.add("GET", path, handler)

    def add_post(self, path, handler):
        self.add("POST", path, handler)

    def add_delete(self, path, handler):
        self.add("DELETE", path, handler)

    def resolve(self, req: Request):
        """(handler, None), or (None, status 404 or 405)."""
        found = False
        for method, rx, handler in self.routes:
            m = rx.match(req.path)
            if m is None:
                continue
            found = True
            if method == req.method:
                req.match_info = m.groupdict()
                return handler, None
        return None, 405 if found else 404


async def _read_request(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
    """The next request on the connection, or None at its end."""
    line = await reader.readline()
    if not line.strip():
        return None
    try:
        method, target, _version = line.decode("latin-1").split()
    except ValueError:
        raise ValueError(f"malformed request line {line[:80]!r}")
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    if headers.get("expect", "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if "transfer-encoding" in headers:
        raise ValueError("send the body with a Content-Length")
    n = int(headers.get("content-length", "0") or 0)
    if n > MAX_BODY:
        raise ValueError(f"a {n}-byte body is over the {MAX_BODY}-byte limit")
    body = await reader.readexactly(n) if n else b""
    return Request(method.upper(), target, headers, body)


def _write_response(writer: asyncio.StreamWriter, resp: Response, keep_alive: bool) -> None:
    lines = [
        f"HTTP/1.1 {resp.status} {_REASONS.get(resp.status, 'Unknown')}",
        f"Content-Type: {resp.content_type}",
        f"Content-Length: {len(resp.body)}",
        f"Connection: {'keep-alive' if keep_alive else 'close'}",
    ] + [f"{k}: {v}" for k, v in resp.headers.items()]
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
    writer.write(resp.body)


# ------------------------------------------------------------------ app


class ServerApp:
    def __init__(self, engine: Engine, args: ServerArgs):
        self.engine = engine
        self.args = args
        self.runner = AsyncEngineRunner(engine)
        self.router = Router()
        self._metrics = None
        if args.enable_metrics:
            from scratchpad_tpu_torch.server.metrics import ServerMetrics

            self._metrics = ServerMetrics(engine)
        self._profiler = None
        self._profile_dir: Optional[str] = None
        self._add_routes()

    # ---------------------------------------------------------------- routes

    def _add_routes(self) -> None:
        r = self.router
        r.add_get("/", self.dashboard)
        r.add_get("/health", self.health)
        r.add_get("/health_generate", self.health_generate)
        r.add_get("/v1/models", self.list_models)
        r.add_get("/system_info", self.system_info)
        r.add_post("/v1/completions", self.completions)
        r.add_post("/v1/chat/completions", self.chat_completions)
        r.add_post("/flush_cache", self.flush_cache)
        r.add_post("/memory_pool", self.memory_pool)
        r.add_post("/abort_request", self.abort_request)
        r.add_post("/start_profile", self.start_profile)
        r.add_post("/stop_profile", self.stop_profile)
        r.add_post("/update_weights", self.update_weights)
        r.add_post("/v1/embeddings", self.embeddings)
        from scratchpad_tpu_torch.server.openai_api.files_batches import FilesAndBatches

        self.files_batches = FilesAndBatches(self)
        self.files_batches.add_routes(r)
        if self._metrics is not None:
            r.add_get("/metrics", self.metrics)

    async def handle_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                try:
                    req = await _read_request(reader, writer)
                except (ValueError, asyncio.IncompleteReadError) as e:
                    _write_response(writer, self._bad_request(str(e)), keep_alive=False)
                    await writer.drain()
                    return
                if req is None:
                    return
                keep_alive = req.headers.get("connection", "").lower() != "close"
                resp = await self._dispatch(req, writer)
                if isinstance(resp, EventStream):
                    if not (keep_alive and resp.closed):
                        return
                    continue
                _write_response(writer, resp, keep_alive)
                await writer.drain()
                if not keep_alive:
                    return
        except ConnectionError:
            pass
        finally:
            writer.close()

    async def _dispatch(self, req: Request, writer):
        handler, status = self.router.resolve(req)
        if handler is None:
            return json_response({"error": _REASONS[status]}, status)
        if self.args.api_key and req.path.startswith("/v1"):
            if req.headers.get("authorization", "") != f"Bearer {self.args.api_key}":
                return json_response(dump(ErrorResponse(message="invalid api key", code=401)), 401)
        try:
            return await handler(req, writer)
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception as e:  # a fault of the server: 500, with the message
            logger.exception("%s %s failed", req.method, req.path)
            if req.stream is not None and req.stream.started:
                return req.stream  # headers are out: the connection is cut
            return json_response(
                dump(ErrorResponse(message=str(e), type="internal_error", code=500)), 500
            )

    async def start(self, host: Optional[str] = None, port: Optional[int] = None):
        """Listen on ``host``:``port`` (default: the args'); returns the
        ``asyncio`` server."""
        return await asyncio.start_server(
            self.handle_connection, host or self.args.host, port or self.args.port
        )

    def shutdown(self) -> None:
        self.runner.shutdown()
        self.engine.shutdown()

    # ------------------------------------------------------------- handlers

    async def dashboard(self, request, writer) -> Response:
        from scratchpad_tpu_torch.server.metrics_ui import DASHBOARD_HTML

        return text_response(DASHBOARD_HTML, content_type="text/html")

    async def metrics(self, request, writer) -> Response:
        from scratchpad_tpu_torch.server.metrics import CONTENT_TYPE

        return Response(self._metrics.render(), 200, CONTENT_TYPE)

    async def health(self, request, writer) -> Response:
        return json_response({"status": "ok"})

    async def health_generate(self, request, writer) -> Response:
        out = await self.runner.generate_full(
            input_ids=[1, 2, 3],
            sampling_params=SamplingParams(max_new_tokens=1, temperature=0.0),
        )
        return json_response({"status": "ok", "tokens": out.completion_tokens})

    async def list_models(self, request, writer) -> Response:
        return json_response(dump(ModelList(data=[ModelCard(id=self.args.served_model_name)])))

    async def system_info(self, request, writer) -> Response:
        import scratchpad_tpu_torch

        sched = self.engine.scheduler
        return json_response(
            {
                "model": self.args.served_model_name,
                "version": scratchpad_tpu_torch.__version__,
                "num_running": sched.num_running(),
                "num_waiting": sched.num_queued(),
                "kv_pages_free": sched.allocator.available_pages,
                "kv_pages_total": sched.allocator.num_pages,
                "radix_evictable_pages": sched.tree_cache.evictable_pages,
                "generated_tokens": sched.num_generated_tokens,
                "retractions": sched.num_retractions,
                "spec_steps": sched.num_spec_steps,
                "spec_accepted_tokens": sched.num_spec_accepted,
                "host_kv_stored_pages": sched.host_tier.stored_pages if sched.host_tier else 0,
                "host_kv_restored_pages": sched.host_tier.restored_pages if sched.host_tier else 0,
                "args": {
                    k: v
                    for k, v in dataclasses.asdict(self.args).items()
                    if isinstance(v, (int, float, str, bool, type(None)))
                },
            }
        )

    async def flush_cache(self, request, writer) -> Response:
        def flush():
            if self.engine.scheduler.has_work():
                return False
            self.engine.flush_cache()
            return True

        if not await self.runner.call(flush):
            return json_response({"status": "busy"}, 409)
        return json_response({"status": "ok"})

    async def memory_pool(self, request, writer) -> Response:
        """Grow or shrink the KV pool at run time (JAX
        ``http_server.py:205-225``): 409 while requests run."""
        body = request.json()
        tokens = body.get("max_total_tokens") if isinstance(body, dict) else None
        if not isinstance(tokens, int) or tokens <= 0:
            return self._bad_request("max_total_tokens (positive int) required")

        def resize():
            if self.engine.scheduler.has_work():
                return 409, {"status": "busy"}
            try:
                return 200, {"status": "ok", "max_total_tokens": self.engine.resize_kv_pool(tokens)}
            except (RuntimeError, ValueError) as e:
                return 409, {"status": "error", "message": str(e)}

        status, out = await self.runner.call(resize)
        return json_response(out, status)

    async def abort_request(self, request, writer) -> Response:
        body = request.json()
        self.runner.abort(body.get("rid", ""))
        return json_response({"status": "ok"})

    async def update_weights(self, request, writer) -> Response:
        """Reload the weights from ``model_path`` in place (JAX
        ``http_server.py:227-240``): 409 while requests run, 500 with the
        message when the state does not fit the model."""
        body = request.json()
        path = body.get("model_path") if isinstance(body, dict) else None
        if not path:
            return self._bad_request("model_path required")

        def update():
            if self.engine.scheduler.has_work():
                return 409, {"status": "busy"}
            ok, msg = self.engine.update_weights(model_path=path)
            return (200 if ok else 500), {"status": "ok" if ok else "error", "message": msg}

        status, out = await self.runner.call(update)
        return json_response(out, status)

    async def start_profile(self, request, writer) -> Response:
        """Start ``torch.profiler`` (the card's kernels where there is one);
        ``/stop_profile`` writes a chrome trace that
        ``scratchpad_tpu_torch.tools.analyze_trace`` reads."""
        from torch.profiler import ProfilerActivity, profile

        body = request.json() if request.body else {}
        if self._profiler is not None:
            return self._bad_request("a profile is already running")
        out_dir = (body or {}).get("output_dir") or os.path.join(
            tempfile.gettempdir(), "sptpu_torch_profile"
        )
        acts = [ProfilerActivity.CPU]
        if self.engine.scheduler.runner.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.start()
        self._profile_dir = out_dir
        return json_response({"status": "ok", "output_dir": out_dir})

    async def stop_profile(self, request, writer) -> Response:
        if self._profiler is None:
            return self._bad_request("no profile is running")
        prof, self._profiler = self._profiler, None
        if self.engine.scheduler.runner.device.type == "cuda":
            torch.cuda.synchronize(self.engine.scheduler.runner.device)
        prof.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        trace = os.path.join(self._profile_dir, f"trace-{int(time.time() * 1000)}.json")
        prof.export_chrome_trace(trace)
        return json_response({"status": "ok", "output_dir": self._profile_dir, "trace": trace})

    async def embeddings(self, request, writer) -> Response:
        try:
            ereq = parse(EmbeddingRequest, request.json())
        except (ValueError, TypeError) as e:
            return self._bad_request(str(e))
        inputs = ereq.input
        if isinstance(inputs, str):
            items = [("prompt", inputs)]
        elif inputs and isinstance(inputs[0], int):
            items = [("ids", inputs)]
        elif inputs and isinstance(inputs[0], str):
            items = [("prompt", x) for x in inputs]
        else:
            items = [("ids", x) for x in inputs]
        if self.engine.tokenizer is None and any(k == "prompt" for k, _ in items):
            return self._bad_request("no tokenizer loaded; send token ids")
        embs = await asyncio.gather(
            *[
                self.runner.encode(
                    prompt=val if kind == "prompt" else None,
                    input_ids=val if kind == "ids" else None,
                )
                for kind, val in items
            ]
        )
        data = [
            {"object": "embedding", "index": i, "embedding": [float(x) for x in e]}
            for i, e in enumerate(embs)
        ]
        return json_response(
            {
                "object": "list",
                "data": data,
                "model": ereq.model,
                "usage": {"prompt_tokens": 0, "total_tokens": 0},
            }
        )

    # ----------------------------------------------------------- completions

    async def completions(self, request, writer):
        try:
            creq = parse(CompletionRequest, request.json())
        except (ValueError, TypeError) as e:
            return self._bad_request(str(e))
        prompts, idss = self._normalize_prompt(creq.prompt)
        if self.engine.tokenizer is None and any(p is not None for p in prompts):
            return self._bad_request("no tokenizer loaded; send token-id prompts")
        try:
            sp = _sampling_from(creq, creq.max_tokens, self.args.enable_custom_logit_processor)
        except ValueError as e:
            return self._bad_request(str(e))
        bad = self._grammar_refused(sp)
        if bad is not None:
            return bad
        if creq.stream:
            return await self._stream_completion(request, writer, creq, prompts, idss, sp)
        outs = await asyncio.gather(
            *[
                self.runner.generate_full(
                    prompt=p,
                    input_ids=i,
                    sampling_params=sp,
                    return_logprob=creq.logprobs is not None,
                )
                for p, i in zip(prompts, idss)
                for _ in range(creq.n)
            ]
        )
        # echo + logprobs: the prompt's logprobs from a teacher-forced pass
        prompt_lps = [None] * len(prompts)
        if creq.echo and creq.logprobs is not None:
            tok = self.engine.tokenizer
            all_ids = [i if i is not None else tok.encode(p) for p, i in zip(prompts, idss)]
            prompt_lps = await asyncio.gather(*[self.runner.score(ids) for ids in all_ids])
            idss = all_ids
        choices = []
        usage = UsageInfo()
        for idx, out in enumerate(outs):
            text = out.text
            pidx = idx // creq.n
            if creq.echo and prompts[pidx] is not None:
                text = prompts[pidx] + text
            lp = self._logprobs_block(out, creq.logprobs)
            if lp is not None and prompt_lps[pidx] is not None:
                # the first prompt token has no conditional logprob
                lp["token_logprobs"] = [None] + prompt_lps[pidx] + lp["token_logprobs"]
                lp["tokens"] = [str(t) for t in idss[pidx]] + lp["tokens"]
            choices.append(
                CompletionChoice(index=idx, text=text, finish_reason=out.finish_reason, logprobs=lp)
            )
            usage.prompt_tokens += out.prompt_tokens
            usage.completion_tokens += out.completion_tokens
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        return json_response(dump(CompletionResponse(model=creq.model, choices=choices, usage=usage)))

    async def _stream_completion(self, request, writer, creq, prompts, idss, sp):
        resp = EventStream(request, writer)
        cid = None
        async for kind, payload in self.runner.generate(
            prompt=prompts[0], input_ids=idss[0], sampling_params=sp, stream=True
        ):
            if not resp.started:
                await resp.prepare()
            if kind == "delta":
                chunk = CompletionResponse(
                    model=creq.model, choices=[CompletionChoice(index=0, text=payload)]
                )
                cid = cid or chunk.id
                chunk.id = cid
                await resp.send(f"data: {json.dumps(dump(chunk))}\n\n")
            elif kind == "done":
                out: GenerationOutput = payload
                chunk = CompletionResponse(
                    id=cid or "cmpl-x",
                    model=creq.model,
                    choices=[CompletionChoice(index=0, text="", finish_reason=out.finish_reason)],
                    usage=_usage(out),
                )
                await resp.send(f"data: {json.dumps(dump(chunk))}\n\n")
        if not resp.started:
            await resp.prepare()
        await resp.send("data: [DONE]\n\n")
        await resp.close()
        return resp

    def _normalize_prompt(self, prompt):
        if isinstance(prompt, str):
            return [prompt], [None]
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return [None], [prompt]
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], str):
            return list(prompt), [None] * len(prompt)
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], list):
            return [None] * len(prompt), list(prompt)
        return [prompt or ""], [None]

    def _logprobs_block(self, out: GenerationOutput, want: Optional[int]):
        if want is None:
            return None
        return {
            "token_logprobs": list(out.output_token_logprobs or []),
            "top_logprobs": None,
            "tokens": [str(t) for t in out.output_ids],
            "text_offset": [],
        }

    def _grammar_refused(self, sp: SamplingParams):
        """A 400 answer for a grammar that cannot be served (no tokenizer,
        or one that does not compile), else None; a good grammar is
        compiled here, into the backend's cache."""
        key = sp.grammar_key()
        if key is None:
            return None
        if self.engine.grammar_backend is None:
            return self._bad_request("constrained decoding needs a tokenizer (none is loaded)")
        try:
            self.engine.grammar_backend.get_grammar(*key)
        except (ValueError, KeyError, TypeError, RecursionError) as e:
            return self._bad_request(f"{key[0]} grammar does not compile: {e}")
        return None

    # ------------------------------------------------------ chat completions

    def _decode_preprocess_image(self, src):
        from scratchpad_tpu_torch.multimodal import decode_image

        return self.engine.preprocess_image(decode_image(src))

    def _decode_preprocess_video(self, src):
        import numpy as np

        from scratchpad_tpu_torch.multimodal.video import decode_video

        frames = decode_video(src, num_frames=self.args.video_frames)
        return np.stack([self.engine.preprocess_image(f) for f in frames])

    async def _extract_media(self, messages: list[ChatMessage]):
        """Text parts join into the message's content; an ``image_url`` or
        ``image`` part becomes ``mm_image_token`` in it and a ``video_url`` or
        ``video`` part ``mm_video_token`` (JAX ``http_server.py:460-520``).
        Returns (images [N, C, S, S] or None, video frames [T, C, S, S] or
        None), decoded and preprocessed in worker threads, all images of the
        request at once; a tiled model's one image is its ``(tiles, ar_id,
        n_tiles)`` tuple (``Engine.preprocess_image``). Raises ``ValueError`` (400): media for a model
        without vision, images and a video together, two videos, a remote
        URL, a payload that does not decode, a missing decoding library."""
        import numpy as np

        images, video = [], None
        for m in messages:
            if not isinstance(m.content, list):
                continue
            texts = []
            for part in m.content:
                ptype = part.get("type")
                if ptype == "text":
                    texts.append(part.get("text", ""))
                elif ptype in ("image_url", "image", "video_url", "video"):
                    url = part.get("image_url" if ptype.startswith("image") else "video_url")
                    src = (url.get("url") if isinstance(url, dict) else url) or part.get(ptype)
                    if ptype.startswith("image"):
                        images.append(src)
                        texts.append(self.args.mm_image_token)
                    elif video is not None:
                        raise ValueError("one video per request")
                    else:
                        video = src
                        texts.append(self.args.mm_video_token)
            m.content = "".join(texts)
        if not images and video is None:
            return None, None
        if not getattr(self.engine.scheduler.runner.model, "is_multimodal", False):
            raise ValueError(
                f"{self.engine.model_config.architecture} does not accept images or video"
            )
        if images and video is not None:
            raise ValueError("a request carries images or one video, not both")
        if video is not None:
            return None, await asyncio.to_thread(self._decode_preprocess_video, video)
        pixels = await asyncio.gather(
            *[asyncio.to_thread(self._decode_preprocess_image, src) for src in images]
        )
        if isinstance(pixels[0], tuple):
            # a tiled model's (tiles, aspect-ratio id, live tiles), one image
            # a request (JAX http_server.py:531-537)
            if len(pixels) > 1:
                raise ValueError("one tiled image per request (Mllama)")
            return pixels[0], None
        return np.stack(pixels), None

    def _apply_chat_template(self, messages: list[ChatMessage]) -> str:
        tok = self.engine.tokenizer
        dicts = []
        for m in messages:
            d = {"role": m.role, "content": m.content}
            if m.tool_calls:
                d["tool_calls"] = m.tool_calls
            dicts.append(d)
        if tok is not None and getattr(tok, "chat_template", None):
            return tok.apply_chat_template(dicts, tokenize=False, add_generation_prompt=True)
        from scratchpad_tpu_torch.server.openai_api.conversation import get_template

        return get_template(self.args.chat_template, self.args.served_model_name).render(dicts)

    async def chat_completions(self, request, writer):
        try:
            creq = parse(ChatCompletionRequest, request.json())
        except (ValueError, TypeError) as e:
            return self._bad_request(str(e))
        if self.engine.tokenizer is None:
            return self._bad_request("no tokenizer loaded; chat API unavailable")
        try:
            media = await self._extract_media(creq.messages)
        except (ValueError, TypeError) as e:
            return self._bad_request(str(e))
        prompt = self._apply_chat_template(creq.messages)
        try:
            sp = _sampling_from(creq, creq.max_completion_tokens or creq.max_tokens or 512,
                                self.args.enable_custom_logit_processor)
        except ValueError as e:
            return self._bad_request(str(e))
        try:
            _response_format_grammar(sp, creq.response_format)
        except (KeyError, TypeError, ValueError) as e:
            return self._bad_request(f"response_format: {e}")
        bad = self._grammar_refused(sp)
        if bad is not None:
            return bad
        try:
            if creq.stream:
                return await self._stream_chat(request, writer, creq, prompt, sp, media)
            outs = await asyncio.gather(*[
                self.runner.generate_full(prompt=prompt, sampling_params=sp, image_data=media[0],
                                          video_data=media[1])
                for _ in range(creq.n)
            ])
        except ValueError as e:  # the prompt's placeholders do not fit the media
            if request.stream is not None and request.stream.started:
                raise
            return self._bad_request(str(e))
        from scratchpad_tpu_torch.server.openai_api.function_call_parser import FunctionCallParser
        from scratchpad_tpu_torch.server.openai_api.reasoning_parser import split_reasoning

        choices = []
        usage = UsageInfo()
        for idx, out in enumerate(outs):
            reasoning, visible = split_reasoning(out.text)
            tool_calls = None
            finish = out.finish_reason
            if creq.tools:
                parsed = FunctionCallParser(creq.tools).parse(visible)
                if parsed.calls:
                    tool_calls = [c.to_openai(i) for i, c in enumerate(parsed.calls)]
                    visible = parsed.normal_text or None
                    finish = "tool_calls"
            choices.append(
                ChatCompletionChoice(
                    index=idx,
                    message=ChatMessage(
                        role="assistant",
                        content=visible,
                        tool_calls=tool_calls,
                        reasoning_content=reasoning,
                    ),
                    finish_reason=finish,
                )
            )
            usage.prompt_tokens += out.prompt_tokens
            usage.completion_tokens += out.completion_tokens
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        return json_response(
            dump(ChatCompletionResponse(model=creq.model, choices=choices, usage=usage))
        )

    async def _stream_chat(self, request, writer, creq, prompt, sp, media=(None, None)):
        resp = EventStream(request, writer)
        first = True
        cid = None
        # incremental tool-call extraction over the streamed text
        tool_parser = None
        if creq.tools:
            from scratchpad_tpu_torch.server.openai_api.function_call_parser import (
                StreamingToolParser,
            )

            tool_parser = StreamingToolParser(creq.tools)
        # <think> spans stream as reasoning_content ahead of the tool parser
        reasoning_parser = None
        if self.args.reasoning_parser:
            from scratchpad_tpu_torch.server.openai_api.reasoning_parser import (
                StreamingReasoningParser,
            )

            reasoning_parser = StreamingReasoningParser(
                force_reasoning=self.args.reasoning_parser == "deepseek-r1",
                stream_reasoning=self.args.stream_reasoning,
            )

        async def _send(delta: DeltaMessage, finish=None, usage=None):
            nonlocal first, cid
            if first:
                delta.role = "assistant"
                first = False
            chunk = ChatCompletionStreamResponse(
                model=creq.model,
                choices=[ChatCompletionStreamChoice(index=0, delta=delta, finish_reason=finish)],
                usage=usage,
            )
            cid = cid or chunk.id
            chunk.id = cid
            await resp.send(f"data: {json.dumps(dump(chunk))}\n\n")

        async def _send_increment(res):
            if res.normal_text:
                await _send(DeltaMessage(content=res.normal_text))
            for d in res.deltas:
                await _send(DeltaMessage(tool_calls=[d]))

        async def _send_content(text):
            if not text:
                return
            if tool_parser is not None:
                await _send_increment(tool_parser.feed(text))
            else:
                await _send(DeltaMessage(content=text))

        async for kind, payload in self.runner.generate(
            prompt=prompt, sampling_params=sp, stream=True, image_data=media[0], video_data=media[1]
        ):
            if not resp.started:
                await resp.prepare()
            if kind == "delta":
                if reasoning_parser is not None:
                    r, c = reasoning_parser.feed(payload)
                    if r:
                        await _send(DeltaMessage(reasoning_content=r))
                    await _send_content(c)
                else:
                    await _send_content(payload)
            elif kind == "done":
                out: GenerationOutput = payload
                finish = out.finish_reason
                if reasoning_parser is not None:
                    r, c = reasoning_parser.finish()
                    if r:
                        await _send(DeltaMessage(reasoning_content=r))
                    await _send_content(c)
                if tool_parser is not None:
                    await _send_increment(tool_parser.finish())
                    if tool_parser.saw_tool_call:
                        finish = "tool_calls"
                await _send(DeltaMessage(), finish=finish, usage=_usage(out))
        if not resp.started:
            await resp.prepare()
        await resp.send("data: [DONE]\n\n")
        await resp.close()
        return resp

    def _bad_request(self, msg: str) -> Response:
        return json_response(dump(ErrorResponse(message=msg)), 400)


class ServerThread:
    """A ``ServerApp`` served on its args' host and port from an event loop
    in a thread of its own (tests, ``chip_smoke.py``); the constructor
    returns once the socket listens, and ``stop()`` closes the socket, the
    runner's threads and the loop."""

    def __init__(self, app: ServerApp, timeout: float = 60.0):
        self.app = app
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, name="http", daemon=True)
        self.thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("the HTTP server did not start")
        if self._error is not None:
            raise self._error

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        try:
            self.server = self.loop.run_until_complete(self.app.start())
        except BaseException as e:  # a port in use: raised by the constructor
            self._error = e
            self._started.set()
            return
        self._started.set()
        self.loop.run_forever()
        self.server.close()
        tasks = asyncio.all_tasks(self.loop)  # open connections, batches
        for t in tasks:
            t.cancel()
        self.loop.run_until_complete(asyncio.gather(*tasks, return_exceptions=True))
        self.loop.run_until_complete(self.server.wait_closed())
        self.loop.close()

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.app.shutdown()


def launch_server(args: ServerArgs, engine: Optional[Engine] = None) -> None:
    """Blocking server entry: build the engine, listen on ``args.host``:
    ``args.port`` and serve until interrupted."""
    args = args.resolve()
    engine = engine or Engine(args)
    app = ServerApp(engine, args)

    async def serve():
        server = await app.start()
        logger.info("serving %s on %s:%d", args.served_model_name, args.host, args.port)
        async with server:
            await server.serve_forever()

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass
    finally:
        app.shutdown()

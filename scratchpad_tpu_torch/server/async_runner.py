"""Async pump around the synchronous Engine/Scheduler.

Counterpart of ``scratchpad_tpu/server/async_runner.py``: one background
thread steps the scheduler, and asyncio consumers receive per-request deltas
through a thread-safe handoff. That thread is the only one that launches
work on the card: it selects the engine's device first, and every runner
entry it reaches runs under ``torch.inference_mode()`` (thread-local, so each
entry sets it itself) and launches on torch's current stream of that device.
It is also the only thread that changes the scheduler: submits, aborts and
calls such as a cache flush reach it through queues it drains between steps
(the JAX runner aborts from the event loop's thread).
"""

from __future__ import annotations

import asyncio
import queue
import threading
import time
from typing import Any, Callable, Optional

import torch

from scratchpad_tpu_torch.core.req import Req
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine, GenerationOutput
from scratchpad_tpu_torch.tokenizer.detokenizer import IncrementalDetokenizer
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("async_runner")


def _settle(fut: asyncio.Future, res, err) -> None:
    if fut.done():  # the awaiting task was cancelled
        return
    if err is not None:
        fut.set_exception(err)
    else:
        fut.set_result(res)


class _ReqState:
    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self.q: asyncio.Queue = asyncio.Queue()

    def push(self, item) -> None:
        self.loop.call_soon_threadsafe(self.q.put_nowait, item)


class AsyncEngineRunner:
    """Owns the scheduler thread; exposes async generate streams."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.submit_q: "queue.Queue[tuple[Req, _ReqState]]" = queue.Queue()
        # callables the scheduler thread runs between steps (aborts, calls)
        self.control_q: "queue.Queue[Callable[[], None]]" = queue.Queue()
        self.states: dict[str, _ReqState] = {}
        self._states_lock = threading.Lock()  # the watchdog fails requests too
        self._stop = threading.Event()
        self._wake = threading.Event()
        self.last_step_at = time.monotonic()
        self.thread = threading.Thread(target=self._loop, name="scheduler", daemon=True)
        self.thread.start()
        # requests in flight but no step for watchdog_timeout seconds: fail
        # them instead of leaving the clients hanging
        self._watchdog = threading.Thread(target=self._watch, name="watchdog", daemon=True)
        self._watchdog.start()

    def _watch(self) -> None:
        timeout = self.engine.args.watchdog_timeout
        while not self._stop.wait(timeout / 4):
            if not self.states:
                self.last_step_at = time.monotonic()
                continue
            if time.monotonic() - self.last_step_at > timeout:
                logger.critical(
                    "watchdog: no scheduler progress in %.0fs with %d requests in flight; "
                    "failing them",
                    timeout,
                    len(self.states),
                )
                with self._states_lock:
                    rids = list(self.states)
                for rid in rids:
                    self.abort(rid)
                self._fail_all()
                self.last_step_at = time.monotonic()

    # ------------------------------------------------------------- scheduler

    def _loop(self) -> None:
        device = self.engine.scheduler.runner.device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        sched = self.engine.scheduler
        while not self._stop.is_set():
            self._drain_submits()
            if not sched.has_work():
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                events = sched.step()
            except Exception:
                logger.exception("scheduler step failed")
                self._fail_all()
                continue
            self.last_step_at = time.monotonic()
            for ev in events:
                self.engine._postprocess_event(ev)
                st = self.states.get(ev.req.rid)
                if st is not None:
                    self._publish(ev.req, st)

    def _publish(self, req: Req, st: _ReqState) -> None:
        """Push what ``req`` has new for its consumer: streamable text, an
        empty delta for token progress without text (TTFT and ITL stay
        measurable without a tokenizer), and its result once finished."""
        safe = IncrementalDetokenizer.stream_safe_len(req)
        ntok = len(req.output_ids)
        if safe > req.stream_sent_len:
            st.push(("delta", req.decoded_text[req.stream_sent_len : safe]))
            req.stream_sent_len = safe
        elif ntok > req.stream_sent_tokens and not req.finished():
            st.push(("delta", ""))
        req.stream_sent_tokens = ntok
        if not req.finished():
            return
        with self._states_lock:
            self.states.pop(req.rid, None)
        if req.is_embedding:
            st.push(("done", req.embedding))
            return
        if req.is_score:
            st.push(("done", req.prompt_logprobs))
            return
        out = self.engine._to_output(req)
        if len(req.decoded_text) > req.stream_sent_len:
            st.push(("delta", req.decoded_text[req.stream_sent_len :]))
            req.stream_sent_len = len(req.decoded_text)
        st.push(("done", out))

    def _drain_submits(self) -> None:
        """Add the submitted requests, then run the queued calls (an abort
        finds a request submitted before it)."""
        while True:
            try:
                req, st = self.submit_q.get_nowait()
            except queue.Empty:
                break
            with self._states_lock:
                self.states[req.rid] = st
            self.engine.scheduler.add_request(req)
        while True:
            try:
                fn = self.control_q.get_nowait()
            except queue.Empty:
                return
            fn()

    def _fail_all(self) -> None:
        with self._states_lock:
            failed, self.states = self.states, {}
        for st in failed.values():
            st.push(("error", "internal scheduler error"))

    def _control(self, fn: Callable[[], None]) -> None:
        self.control_q.put(fn)
        self._wake.set()

    def _submit(self, req: Req) -> _ReqState:
        st = _ReqState(asyncio.get_running_loop())
        self.submit_q.put((req, st))
        self._wake.set()
        return st

    # ---------------------------------------------------------------- public

    async def generate(
        self,
        prompt: Optional[str] = None,
        input_ids: Optional[list[int]] = None,
        sampling_params: Optional[SamplingParams] = None,
        rid: Optional[str] = None,
        return_logprob: bool = False,
        stream: bool = False,
    ):
        """Async generator yielding ("delta", str) items, then ("done",
        GenerationOutput) or ("error", message)."""
        req = self.engine._make_req(prompt, input_ids, sampling_params, return_logprob, rid=rid)
        req.stream = stream
        st = self._submit(req)
        try:
            while True:
                kind, payload = await st.q.get()
                yield kind, payload
                if kind in ("done", "error"):
                    return
        finally:
            if not req.finished():  # the consumer left: free its slot and pages
                self.abort(req.rid)
                with self._states_lock:
                    self.states.pop(req.rid, None)

    async def _one_shot(self, req: Req):
        st = self._submit(req)
        while True:
            kind, payload = await st.q.get()
            if kind == "error":
                raise RuntimeError(payload)
            if kind == "done":
                return payload

    async def score(self, input_ids: list[int]) -> list[float]:
        """Teacher-forced prompt logprobs through the scheduler thread (the
        echo + logprobs primitive)."""
        req = self.engine._make_req(None, input_ids, SamplingParams(max_new_tokens=0))
        req.is_score = True
        out = await self._one_shot(req)
        if out is None:
            raise RuntimeError(f"a {len(input_ids)}-token prompt does not fit the KV pool")
        return out

    async def encode(self, prompt: Optional[str] = None, input_ids: Optional[list[int]] = None):
        """An embedding through the scheduler thread."""
        req = self.engine._make_req(prompt, input_ids, SamplingParams(max_new_tokens=0))
        req.is_embedding = True
        return await self._one_shot(req)

    async def generate_full(self, **kw) -> GenerationOutput:
        async for kind, payload in self.generate(**kw):
            if kind == "error":
                raise RuntimeError(payload)
            if kind == "done":
                return payload
        raise RuntimeError("generation ended without result")

    def abort(self, rid: str) -> None:
        """Abort request ``rid`` on the scheduler thread, between steps."""
        self._control(lambda: self.engine.scheduler.abort_request(rid))

    async def call(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` run on the scheduler thread between steps; its result,
        or its exception raised here."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def run():
            try:
                res, err = fn(), None
            except Exception as e:  # noqa: BLE001 - handed to the awaiting task
                res, err = None, e
            loop.call_soon_threadsafe(_settle, fut, res, err)

        self._control(run)
        return await fut

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self.thread.join(timeout=5)
        self._watchdog.join(timeout=5)

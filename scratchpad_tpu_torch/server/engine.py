"""Synchronous/offline engine facade.

Counterpart of ``scratchpad_tpu/server/engine.py`` for one device and one
host: the engine owns the Scheduler in-process and pumps its step loop.
The port has ``generate``, ``generate_stream``, per-request toppings
(``register_topping``, then ``generate(..., topping=name)``), embeddings
(``encode``), teacher-forced scoring (``score``, ``perplexity``),
multi-turn sessions and constrained decoding (``SamplingParams``'s
``regex``, ``json_schema``, ``ebnf`` and ``structural_tag``, through the
grammar backend of ``constrained/`` once a tokenizer is loaded); images and
videos are refused, and so are ``update_weights`` and ``resize_kv_pool``
(not ported yet). The HTTP server
drives the same engine from its async runner's thread
(``server/async_runner.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import time
import uuid
from typing import Any, Iterator, Optional, Union

from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.core.req import FinishReason, Req
from scratchpad_tpu_torch.core.scheduler import Scheduler, StepEvent
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.metrics import LatencyStats
from scratchpad_tpu_torch.tokenizer import load_tokenizer
from scratchpad_tpu_torch.tokenizer.detokenizer import IncrementalDetokenizer
from scratchpad_tpu_torch.toppings import ToppingsManager
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("engine")


@dataclasses.dataclass
class GenerationOutput:
    rid: str
    text: str
    output_ids: list[int]
    finish_reason: str
    prompt_tokens: int
    completion_tokens: int
    cached_tokens: int
    output_token_logprobs: Optional[list[float]] = None
    output_top_logprobs: Optional[list] = None  # [(values, token_ids), ...]
    ttft: Optional[float] = None
    e2e_latency: Optional[float] = None


def _resolve_model_config(args: ServerArgs) -> ModelConfig:
    if args.preset:
        # preset = architecture shortcut; an explicit model_path still
        # supplies the weights
        ov = dict(dtype=args.dtype, quantization=args.quantization)
        if args.model_path:
            ov["model_path"] = args.model_path
        model_config = get_preset(args.preset, **ov)
    else:
        model_config = ModelConfig.from_pretrained(
            args.model_path, dtype=args.dtype, quantization=args.quantization
        )
    if args.context_length:
        model_config.max_position_embeddings = args.context_length
    return model_config


class Engine:
    def __init__(
        self,
        server_args: ServerArgs,
        mesh=None,
        model_config: Optional[ModelConfig] = None,
        tokenizer: Any = None,
        params: Optional[dict] = None,
    ):
        """``params``: the model's ``state_dict`` to serve (see
        ``ModelRunner``); None loads or draws the weights."""
        if mesh is not None:
            raise NotImplementedError("device meshes are not ported yet")
        self.args = server_args.resolve()
        if model_config is None:
            model_config = _resolve_model_config(self.args)
        elif self.args.context_length:
            model_config.max_position_embeddings = self.args.context_length
        self.model_config = model_config

        self.tokenizer = tokenizer
        if self.tokenizer is None and self.args.tokenizer_path:
            self.tokenizer = load_tokenizer(self.args.tokenizer_path)
        self.detokenizer = IncrementalDetokenizer(self.tokenizer)

        self.eos_token_ids: frozenset[int] = frozenset(self._find_eos_ids())
        self.scheduler = Scheduler(model_config, self.args, params=params)
        # TTFT/ITL/TPOT/E2E sample sink
        self.latency = LatencyStats()
        self.toppings_manager: Optional[ToppingsManager] = None
        # session id -> (token history, last use on the monotonic clock)
        self._sessions: collections.OrderedDict = collections.OrderedDict()
        # grammars need the tokenizer's strings of the vocabulary
        self.grammar_backend = None
        if self.tokenizer is not None:
            from scratchpad_tpu_torch.constrained import GrammarBackend

            self.grammar_backend = GrammarBackend(self.tokenizer, model_config.vocab_size)

    def _find_eos_ids(self) -> set[int]:
        ids: set[int] = set()
        tok = self.tokenizer
        if tok is not None:
            if getattr(tok, "eos_token_id", None) is not None:
                ids.add(tok.eos_token_id)
        cfg_path = self.args.model_path
        if cfg_path:
            gc = os.path.join(cfg_path, "generation_config.json")
            if os.path.exists(gc):
                with open(gc) as f:
                    eos = json.load(f).get("eos_token_id")
                if isinstance(eos, int):
                    ids.add(eos)
                elif isinstance(eos, list):
                    ids.update(eos)
        return ids

    # -------------------------------------------------------------- requests

    def register_topping(
        self,
        name: str,
        adapter_path: Optional[str] = None,
        state: Optional[dict] = None,
        scaling: float = 1.0,
        delta_state: Optional[dict] = None,
    ) -> int:
        """Register a LoRA adapter (a peft checkpoint directory, or its
        state dict and scaling) or, through ``delta_state``, a full-rank
        weight-delta adapter (HF-named [out, in] deltas, stored int8) for
        per-request serving; returns its pool slot."""
        runner = self.scheduler.runner
        if not getattr(runner.model, "supports_toppings", True):
            raise NotImplementedError(
                f"toppings are not ported for {type(runner.model).__name__}"
            )
        if self.toppings_manager is None:
            self.toppings_manager = ToppingsManager(
                self.model_config, dtype=runner.dtype, device=runner.device
            )
        if delta_state is not None:
            idx = self.toppings_manager.register_delta(name, delta_state, scaling)
        elif state is not None:
            idx = self.toppings_manager.register_state(name, state, scaling)
        else:
            idx = self.toppings_manager.register(name, adapter_path)
        runner.attach_toppings(self.toppings_manager)
        return idx

    def _make_req(
        self,
        prompt: Optional[str],
        input_ids: Optional[list[int]],
        sampling_params: Optional[SamplingParams],
        return_logprob: bool = False,
        rid: Optional[str] = None,
        topping: Optional[str] = None,
        image_data=None,
        video_data=None,
    ) -> Req:
        if image_data is not None or video_data is not None:
            raise NotImplementedError("images and videos are not ported yet")
        sp = sampling_params or SamplingParams()
        gk = sp.grammar_key()
        if gk is not None and self.grammar_backend is None:
            raise ValueError("constrained decoding needs a tokenizer (none is loaded)")
        if input_ids is None:
            assert prompt is not None and self.tokenizer is not None
            input_ids = self.tokenizer.encode(prompt)
        topping_idx = 0
        if topping:
            if self.toppings_manager is None:
                raise KeyError(f"unknown topping {topping!r}")
            topping_idx = self.toppings_manager.lookup(topping)
        req = Req(
            rid=rid or uuid.uuid4().hex,
            origin_input_ids=list(input_ids),
            sampling_params=sp,
            eos_token_ids=self.eos_token_ids,
            return_logprob=return_logprob,
            topping_idx=topping_idx,
        )
        if gk is not None:
            req.grammar = self.grammar_backend.get_grammar(*gk)
        return req

    # ------------------------------------------------------------ sync API

    def generate(
        self,
        prompt: Optional[Union[str, list[str]]] = None,
        input_ids: Optional[Union[list[int], list[list[int]]]] = None,
        sampling_params: Optional[
            Union[SamplingParams, list[SamplingParams]]
        ] = None,
        return_logprob: bool = False,
        topping: Optional[Union[str, list]] = None,
    ) -> Union[GenerationOutput, list[GenerationOutput]]:
        """Blocking generation for one prompt or a batch. ``topping``: the
        registered adapter of every prompt, or a list of one per prompt
        (None for the base model)."""
        batched = isinstance(prompt, list) or (
            input_ids is not None
            and len(input_ids) > 0
            and isinstance(input_ids[0], (list, tuple))
        )
        prompts = prompt if isinstance(prompt, list) else [prompt]
        if input_ids is not None and not batched:
            idss = [input_ids]
        else:
            idss = input_ids if input_ids is not None else [None] * len(prompts)
        if prompt is None:
            prompts = [None] * len(idss)
        sps = (
            sampling_params
            if isinstance(sampling_params, list)
            else [sampling_params] * len(prompts)
        )
        tops = topping if isinstance(topping, list) else [topping] * len(prompts)
        # parallel sampling (n > 1): pre-cache each prompt's prefix with a
        # zero-token warmup request, then expand into n stochastic clones
        if any(s is not None and s.n > 1 for s in sps):
            warmups = [
                self._make_req(
                    p, i, dataclasses.replace(s, max_new_tokens=0, n=1), topping=t
                )
                for p, i, s, t in zip(prompts, idss, sps, tops)
                if s is not None and s.n > 1
            ]
            for r in warmups:
                self.scheduler.add_request(r)
            while any(not r.finished() for r in warmups):
                if not self.scheduler.step() and not self.scheduler.has_work():
                    break
            new = ([], [], [], [])
            for p, i, s, t in zip(prompts, idss, sps, tops):
                reps = s.n if s is not None else 1
                for _ in range(reps):
                    new[0].append(p)
                    new[1].append(i)
                    new[2].append(
                        dataclasses.replace(s, n=1) if s is not None else None
                    )
                    new[3].append(t)
            prompts, idss, sps, tops = new
            batched = True
        reqs = [
            self._make_req(p, i, s, return_logprob, topping=t)
            for p, i, s, t in zip(prompts, idss, sps, tops)
        ]
        for r in reqs:
            self.scheduler.add_request(r)
        pending = {r.rid for r in reqs}
        while pending:
            events = self.scheduler.step()
            if not events and not self.scheduler.has_work():
                break
            for ev in events:
                self._postprocess_event(ev)
                if ev.req.finished() and ev.req.rid in pending:
                    pending.discard(ev.req.rid)
        for ev in self.scheduler.drain():
            self._postprocess_event(ev)
        outs = [self._to_output(r) for r in reqs]
        return outs if batched else outs[0]

    def generate_stream(
        self,
        prompt: Optional[str] = None,
        input_ids: Optional[list[int]] = None,
        sampling_params: Optional[SamplingParams] = None,
    ) -> Iterator[dict]:
        """Streaming generation for a single request; yields text deltas."""
        req = self._make_req(prompt, input_ids, sampling_params)
        req.stream = True
        self.scheduler.add_request(req)
        while not req.finished():
            events = self.scheduler.step()
            if not events and not self.scheduler.has_work():
                break
            for ev in events:
                self._postprocess_event(ev)
            safe = IncrementalDetokenizer.stream_safe_len(req)
            ntok = len(req.output_ids)
            if safe > req.stream_sent_len:
                delta = req.decoded_text[req.stream_sent_len : safe]
                req.stream_sent_len = safe
                req.stream_sent_tokens = ntok
                yield {"delta": delta, "finished": False}
            elif ntok > req.stream_sent_tokens and not req.finished():
                # token progress without streamable text
                req.stream_sent_tokens = ntok
                yield {"delta": "", "finished": False}
        for ev in self.scheduler.drain():
            self._postprocess_event(ev)
        if len(req.decoded_text) > req.stream_sent_len:
            yield {
                "delta": req.decoded_text[req.stream_sent_len :],
                "finished": False,
            }
            req.stream_sent_len = len(req.decoded_text)
        yield {
            "delta": "",
            "finished": True,
            "output": self._to_output(req),
        }

    # --------------------------------------------------------------- helpers

    def _postprocess_event(self, ev: StepEvent) -> None:
        req = ev.req
        if ev.new_tokens:
            self.latency.on_tokens(req, len(ev.new_tokens))
        if req.finished():
            self.latency.on_finish(req)
        if not ev.new_tokens:
            return
        self.detokenizer.step(req)
        if not req.finished():
            # a matched stop string finishes the request; the scheduler
            # releases it at the start of its next step
            self.detokenizer.check_stop_strings(req)

    def _to_output(self, req: Req) -> GenerationOutput:
        if req.finished() and req.read_offset < len(req.output_ids):
            self.detokenizer.step(req)
            self.detokenizer.check_stop_strings(req)
        reason = req.finished_reason or FinishReason.ABORT
        return GenerationOutput(
            rid=req.rid,
            text=req.decoded_text,
            output_ids=list(req.output_ids),
            finish_reason=reason.to_openai(),
            prompt_tokens=len(req.origin_input_ids),
            completion_tokens=len(req.output_ids),
            cached_tokens=req.cached_prefix_len,
            output_token_logprobs=(
                list(req.output_token_logprobs) if req.return_logprob else None
            ),
            output_top_logprobs=(
                list(req.output_top_logprobs) if req.output_top_logprobs else None
            ),
            ttft=(
                req.first_token_at - req.created_at if req.first_token_at else None
            ),
            e2e_latency=(
                req.finished_at - req.created_at if req.finished_at else None
            ),
        )

    def encode(
        self,
        prompt: Optional[Union[str, list[str]]] = None,
        input_ids: Optional[Union[list[int], list[list[int]]]] = None,
    ):
        """Embeddings: each prompt's L2-normalised last-token hidden state
        (after the final norm), f32 [H]; a list for a batch."""
        batched = isinstance(prompt, list) or (
            input_ids is not None
            and len(input_ids) > 0
            and isinstance(input_ids[0], (list, tuple))
        )
        prompts = prompt if isinstance(prompt, list) else [prompt]
        if input_ids is not None and not batched:
            idss = [input_ids]
        else:
            idss = input_ids if input_ids is not None else [None] * len(prompts)
        if prompt is None:
            prompts = [None] * len(idss)
        reqs = []
        for p, i in zip(prompts, idss):
            r = self._make_req(p, i, SamplingParams(max_new_tokens=0))
            r.is_embedding = True
            reqs.append(r)
            self.scheduler.add_request(r)
        while any(not r.finished() for r in reqs):
            if not self.scheduler.step() and not self.scheduler.has_work():
                break
        embs = [r.embedding for r in reqs]
        return embs if batched else embs[0]

    # --------------------------------------------------------------- sessions

    def _session_sweep(self) -> None:
        """Expire sessions idle longer than ``session_ttl``, then evict the
        least recently used above ``max_sessions``."""
        ttl = self.args.session_ttl
        if ttl > 0:
            now = time.monotonic()
            for sid in [s for s, (_, t) in self._sessions.items() if now - t > ttl]:
                del self._sessions[sid]
        cap = self.args.max_sessions
        while cap > 0 and len(self._sessions) > cap:
            self._sessions.popitem(last=False)

    def open_session(self) -> str:
        """A multi-turn session: each ``session_generate`` continues from the
        turns before it, and the radix cache makes the re-prefill cost only
        the new tokens."""
        sid = uuid.uuid4().hex
        self._sessions[sid] = ([], time.monotonic())
        self._session_sweep()
        return sid

    def close_session(self, sid: str) -> None:
        self._sessions.pop(sid, None)

    def session_generate(
        self,
        sid: str,
        prompt: Optional[str] = None,
        input_ids: Optional[list[int]] = None,
        sampling_params: Optional[SamplingParams] = None,
    ) -> GenerationOutput:
        if sid not in self._sessions:
            raise KeyError(f"unknown or expired session {sid!r}")
        history, _ = self._sessions[sid]
        if input_ids is None:
            input_ids = self.tokenizer.encode(prompt)
        full = history + list(input_ids)
        out = self.generate(input_ids=full, sampling_params=sampling_params)
        self._sessions[sid] = (full + out.output_ids, time.monotonic())
        self._sessions.move_to_end(sid)
        self._session_sweep()
        return out

    # ---------------------------------------------------------------- scoring

    def score(self, input_ids: list[int]) -> list[float]:
        """Teacher-forced next-token logprobs of a sequence: entry t is
        log p(input_ids[t + 1] | input_ids[..t]). Needs an idle engine; its
        pages are borrowed and returned."""
        req = self._make_req(None, input_ids, SamplingParams(max_new_tokens=0))
        req.is_score = True
        sched = self.scheduler
        sched.drain()
        if sched.has_work():
            raise RuntimeError("score() needs an idle engine")
        sched._run_score_req(req)
        if req.prompt_logprobs is None:
            raise RuntimeError(f"a {len(input_ids)}-token sequence does not fit the KV pool")
        return list(req.prompt_logprobs)

    def perplexity(self, input_ids: list[int]) -> float:
        lps = self.score(input_ids)
        return math.exp(-sum(lps) / max(len(lps), 1))

    def update_weights(self, model_path: Optional[str] = None, state: Optional[dict] = None):
        raise NotImplementedError(
            "update_weights is not ported to scratchpad_tpu_torch yet (ROADMAP Queue 1, item 9)"
        )

    def resize_kv_pool(self, new_num_tokens: int) -> int:
        raise NotImplementedError(
            "resize_kv_pool is not ported to scratchpad_tpu_torch yet (ROADMAP Queue 1, item 9)"
        )

    def shutdown(self) -> None:
        """Finish what is in flight and drop the sessions; the engine holds
        no other process or thread."""
        for ev in self.scheduler.drain():
            self._postprocess_event(ev)
        self._sessions.clear()

    def flush_cache(self) -> None:
        """Drop the radix cache and return every page; needs an idle engine."""
        self.scheduler.drain()
        assert not self.scheduler.has_work()
        self.scheduler.tree_cache.reset()
        self.scheduler.allocator.clear()
        self.scheduler.allocator.alloc(1)  # re-reserve dump page

"""Synchronous/offline engine facade.

Counterpart of ``scratchpad_tpu/server/engine.py`` for one device and one
host: the engine owns the Scheduler in-process and pumps its step loop.
The port has ``generate``, ``generate_stream``, per-request toppings
(``register_topping``, then ``generate(..., topping=name)``), embeddings
(``encode``), teacher-forced scoring (``score``, ``perplexity``),
multi-turn sessions, constrained decoding (``SamplingParams``'s
``regex``, ``json_schema``, ``ebnf`` and ``structural_tag``, through the
grammar backend of ``constrained/`` once a tokenizer is loaded) and, for
the vision models, ``image_data`` and ``video_data``: the tower encodes
them when the request is made, and each placeholder id expands into
negative ids hashed from the content (so the radix cache never aliases two
images) whose rows take the features. ``update_weights`` and
``resize_kv_pool`` are refused (not ported yet). The HTTP server
drives the same engine from its async runner's thread
(``server/async_runner.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import math
import os
import time
import uuid
from typing import Any, Iterator, Optional, Union

import numpy as np

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
        sp = sampling_params or SamplingParams()
        gk = sp.grammar_key()
        if gk is not None and self.grammar_backend is None:
            raise ValueError("constrained decoding needs a tokenizer (none is loaded)")
        if input_ids is None:
            assert prompt is not None and self.tokenizer is not None
            input_ids = self.tokenizer.encode(prompt)
        if any(t < 0 for t in input_ids):
            # negative ids are the vision rows' placeholders, which only
            # image_data and video_data make (the embedding cannot look
            # one up)
            raise ValueError("input_ids must be non-negative token ids")
        mm = {}
        if image_data is not None and video_data is not None:
            raise ValueError("one request carries images or one video, not both")
        if video_data is not None:
            input_ids, mm = self._prepare_video(list(input_ids), video_data)
        elif image_data is not None:
            input_ids, mm = self._prepare_multimodal(list(input_ids), image_data)
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
            **mm,
        )
        if gk is not None:
            req.grammar = self.grammar_backend.get_grammar(*gk)
        return req

    # ------------------------------------------------------------ multimodal

    def _vision_model(self, what: str):
        model = self.scheduler.runner.model
        if not getattr(model, "is_multimodal", False):
            raise ValueError(f"{self.model_config.architecture} does not accept {what}")
        return model

    def preprocess_image(self, img) -> np.ndarray:
        """A PIL image -> normalised f32 [3, S, S] pixels at the model's
        resolution (SigLIP's mean and std for Gemma 3, CLIP's otherwise)."""
        from scratchpad_tpu_torch.multimodal import preprocess_clip

        model = self._vision_model("images")
        if hasattr(model, "image_mean"):
            return preprocess_clip(
                img, model.vision.image_size,
                mean=np.asarray(model.image_mean, np.float32),
                std=np.asarray(model.image_std, np.float32),
            )
        return preprocess_clip(img, model.vision.image_size)

    @staticmethod
    def _content_hash(px: np.ndarray) -> int:
        return int.from_bytes(hashlib.blake2b(px.tobytes(), digest_size=8).digest(), "little")

    def _check_size(self, model, px: np.ndarray, what: str) -> None:
        S = model.vision.image_size
        if px.shape[2:] != (S, S):
            raise ValueError(
                f"{what} are {px.shape[2]}x{px.shape[3]} but {self.model_config.architecture} "
                f"expects {S}x{S} pixels (use Engine.preprocess_image)"
            )

    def _prepare_multimodal(self, input_ids: list[int], image_data):
        """Encode the images [N, C, S, S] (or one [C, S, S]) and splice them
        into the prompt (JAX ``engine.py:414-530``): each image token expands
        into the image's rows (or, in a prompt that arrives expanded, each
        token is one row), whose ids are ``-1 - pid``, pid hashed from the
        image's pixels (blake2b) plus the row; the features ride on the
        request. Qwen2-VL gets its 3-D rope table, Gemma 3 its spans."""
        model = self._vision_model("images")
        px = np.asarray(image_data, np.float32)
        if px.ndim == 3:
            px = px[None]
        if px.ndim != 4:
            raise ValueError("image_data must be [N, C, H, W] pixel values")
        self._check_size(model, px, "images")
        feats = self.scheduler.runner.encode_images(px)  # [N, P, H]
        N, Pn, H = feats.shape
        img_tok = model.image_token_index
        n_ph = sum(1 for t in input_ids if t == img_tok)
        if n_ph == N * Pn:
            expand = 1  # the prompt arrived expanded (HF-processor style)
        elif n_ph == N:
            expand = Pn
        else:
            raise ValueError(f"prompt has {n_ph} image tokens for {N} images ({Pn} rows each)")
        hashes = [self._content_hash(px[i]) for i in range(N)]
        out_ids: list[int] = []
        positions: list[int] = []
        spans: list[tuple[int, int]] = []  # (start row, rows) an image
        consumed = 0
        for t in input_ids:
            if t != img_tok:
                out_ids.append(t)
                continue
            if expand == 1:
                img_i, patch0 = divmod(consumed, Pn)
                if patch0 == 0:
                    spans.append((len(out_ids), Pn))
            else:
                img_i, patch0 = consumed, 0
                spans.append((len(out_ids), Pn))
            for j in range(expand):
                positions.append(len(out_ids))
                out_ids.append(-1 - (hashes[img_i] + patch0 + j) % (2**30))
            consumed += 1
        mm = dict(mm_positions=np.asarray(positions, np.int64), mm_features=feats.reshape(N * Pn, H))
        if getattr(model, "uses_mrope", False):
            mm["mrope_table"], mm["mrope_delta"] = model.compute_mrope(out_ids, spans)
        if getattr(model, "bidirectional_image_attention", False):
            mm["mm_spans"] = [(s0, s0 + n) for s0, n in spans]
        return out_ids, mm

    def _prepare_video(self, input_ids: list[int], video_data):
        """Encode a video's frames [T, C, S, S] and splice them into the
        prompt (JAX ``engine.py:336-412``): the one video token (or a run of
        grid_t x rows of them) expands into content-hashed ids, and the
        mrope time axis advances a temporal patch at a time."""
        model = self.scheduler.runner.model
        if not getattr(model, "supports_video", False):
            raise ValueError(f"{self.model_config.architecture} does not accept video_data")
        px = np.asarray(video_data, np.float32)
        if px.ndim != 4:
            raise ValueError("video_data must be [T, C, H, W] frame pixels")
        self._check_size(model, px, "video frames")
        feats = self.scheduler.runner.encode_videos(px)  # [grid_t, P, H]
        T, Pn, H = feats.shape
        vid_tok = model.video_token_index
        n_ph = sum(1 for t in input_ids if t == vid_tok)
        if n_ph == 1:
            expand = T * Pn
        elif n_ph == T * Pn:
            expand = 1
            first = input_ids.index(vid_tok)
            if any(t != vid_tok for t in input_ids[first : first + T * Pn]):
                raise ValueError("pre-expanded video tokens must form one contiguous run")
        else:
            raise ValueError(
                f"prompt has {n_ph} video tokens for a {T}-patch video ({Pn} rows a patch); "
                f"send 1 or {T * Pn}"
            )
        vhash = self._content_hash(px)
        out_ids: list[int] = []
        positions: list[int] = []
        spans: list[tuple] = []
        consumed = 0
        for t in input_ids:
            if t != vid_tok:
                out_ids.append(t)
                continue
            if consumed == 0:
                spans.append((len(out_ids), T * Pn, T))
            for j in range(expand):
                positions.append(len(out_ids))
                out_ids.append(-1 - (vhash + consumed * expand + j) % (2**30))
            consumed += 1
        table, delta = model.compute_mrope(out_ids, spans)
        return out_ids, dict(
            mm_positions=np.asarray(positions, np.int64),
            mm_features=feats.reshape(T * Pn, H),
            mrope_table=table,
            mrope_delta=delta,
        )

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
        image_data=None,
        video_data=None,
    ) -> Union[GenerationOutput, list[GenerationOutput]]:
        """Blocking generation for one prompt or a batch. ``topping``: the
        registered adapter of every prompt, or a list of one per prompt
        (None for the base model). ``image_data``: pixels [N, C, H, W] (see
        ``preprocess_image``), or a list of such, one a prompt;
        ``video_data``: frames [T, C, H, W], or a list of one a prompt."""
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
        imgs = image_data if isinstance(image_data, list) else [image_data] * len(prompts)
        vids = video_data if isinstance(video_data, list) else [video_data] * len(prompts)
        # parallel sampling (n > 1): pre-cache each prompt's prefix with a
        # zero-token warmup request, then expand into n stochastic clones
        if any(s is not None and s.n > 1 for s in sps):
            warmups = [
                self._make_req(
                    p, i, dataclasses.replace(s, max_new_tokens=0, n=1), topping=t,
                    image_data=im, video_data=vd,
                )
                for p, i, s, t, im, vd in zip(prompts, idss, sps, tops, imgs, vids)
                if s is not None and s.n > 1
            ]
            for r in warmups:
                self.scheduler.add_request(r)
            while any(not r.finished() for r in warmups):
                if not self.scheduler.step() and not self.scheduler.has_work():
                    break
            new = ([], [], [], [], [], [])
            for p, i, s, t, im, vd in zip(prompts, idss, sps, tops, imgs, vids):
                reps = s.n if s is not None else 1
                for _ in range(reps):
                    new[0].append(p)
                    new[1].append(i)
                    new[2].append(
                        dataclasses.replace(s, n=1) if s is not None else None
                    )
                    new[3].append(t)
                    new[4].append(im)
                    new[5].append(vd)
            prompts, idss, sps, tops, imgs, vids = new
            batched = True
        reqs = [
            self._make_req(p, i, s, return_logprob, topping=t, image_data=im, video_data=vd)
            for p, i, s, t, im, vd in zip(prompts, idss, sps, tops, imgs, vids)
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

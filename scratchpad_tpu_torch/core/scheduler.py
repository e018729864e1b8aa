"""Continuous-batching scheduler.

TPU-native rework of the reference Scheduler + ScheduleBatch
(reference: scratchpad/scheduler/scheduler.py:103-1884,
scratchpad/scheduler/schedule_batch.py:596-1480). Differences by design:

- single-controller: one Scheduler per host drives all local chips through
  the jitted ModelRunner step; there is no ZMQ process mesh and no
  broadcast_pyobj — multi-host replicas run this same loop in lockstep.
- page-granular KV: admission, retraction and radix insertion all move whole
  pages (the TPU DMA unit) instead of single token slots.
- batches are rebuilt host-side each step as numpy (cheap at B<=256) and
  padded to the compile-bucket ladder by the ModelRunner; there is no
  in-place device batch mutation like prepare_for_decode.

Event-loop results are returned to the caller (Engine) as StepEvents rather
than pushed over ZMQ to a detokenizer process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.core.policy import AddReqResult, PrefillAdder, SchedulePolicy
from scratchpad_tpu_torch.core.req import FinishReason, Req
from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
from scratchpad_tpu_torch.executor.model_runner import ModelRunner, WorkerBatch
from scratchpad_tpu_torch.memory.tree_group import TreeCacheGroup
from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo
from scratchpad_tpu_torch.toppings.manager import MAX_ACTIVE_TOPPINGS
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("scheduler")


def draft_model_config(args: ServerArgs, target_cfg: ModelConfig) -> ModelConfig:
    """The draft model's config: ``speculative_draft_preset`` (its weights
    from ``speculative_draft_model_path`` where one is given) or the
    checkpoint at that path, at the target's context length."""
    from scratchpad_tpu_torch.config.model_config import get_preset

    if args.speculative_draft_preset:
        dcfg = get_preset(args.speculative_draft_preset, dtype=args.dtype)
        if args.speculative_draft_model_path:
            dcfg.model_path = args.speculative_draft_model_path
    else:
        dcfg = ModelConfig.from_pretrained(args.speculative_draft_model_path, dtype=args.dtype)
    dcfg.max_position_embeddings = target_cfg.max_position_embeddings
    return dcfg


def spec_companion(args: ServerArgs, cfg: ModelConfig) -> tuple[int, int]:
    """(parameter bytes, KV bytes a token) of the draft model or EAGLE head
    that speculation puts beside the target, counted on the meta device
    before anything is allocated, so that the target's pool leaves them
    room (``ModelRunner(companion=)``); (0, 0) without one."""
    import torch

    from scratchpad_tpu_torch.executor.model_runner import _DTYPES
    from scratchpad_tpu_torch.memory import KVCacheConfig
    from scratchpad_tpu_torch.models.llama import LlamaDecoderLayer
    from scratchpad_tpu_torch.models.registry import get_model_class

    algo = args.speculative_algorithm
    if algo not in ("draft", "eagle"):
        return 0, 0
    dt, meta = _DTYPES[args.dtype], torch.device("meta")
    if algo == "draft":
        dcfg = draft_model_config(args, cfg)
        model = get_model_class(dcfg.architecture)(dcfg, meta, dt)
        layers = dcfg.num_hidden_layers
    else:  # fc [2H -> H] and one decoder layer
        dcfg = cfg
        model = LlamaDecoderLayer(cfg, meta, dt)
        layers = 1
    n = sum(t.numel() for t in model.parameters()) + (2 * cfg.hidden_size**2 if algo == "eagle" else 0)
    kv = KVCacheConfig(
        num_layers=layers, num_pages=0, page_size=args.page_size,
        num_kv_heads=dcfg.num_kv_heads, head_dim=dcfg.head_dim, dtype=dt,
    )
    return n * dt.itemsize, kv.bytes_per_token()


def build_draft_runner(target_runner: ModelRunner, args: ServerArgs) -> ModelRunner:
    """A second ``ModelRunner`` for draft-model speculation, unquantized,
    with a model-dtype pool that mirrors the target's page geometry, so
    page tables and radix pages serve both (JAX ``scheduler.py:39-71``)."""
    if getattr(target_runner.model, "is_multimodal", False):
        raise ValueError("draft-model speculation requires a text model")
    dcfg = draft_model_config(args, target_runner.model_config)
    dargs = dataclasses.replace(
        args,
        max_total_tokens=target_runner.max_total_num_tokens,
        quantization=None,
        kv_cache_dtype="auto",
        speculative_algorithm=None,
    )
    runner = ModelRunner(dcfg, dargs)
    assert (
        runner.page_allocator.num_pages == target_runner.page_allocator.num_pages
    ), "draft KV pool must mirror the target's page geometry"
    return runner


@dataclasses.dataclass
class StepEvent:
    """One request's progress this step (may cover a multi-token window)."""

    req: Req
    new_tokens: list[int]  # empty while still chunk-prefilling
    finished: bool


def cross_batch_fields(batch: list[Req], slot_rows: int) -> dict:
    """A batch's cross-attention fields for its ``WorkerBatch`` (JAX
    :1169-1192), none where no request holds a slot: each request's slot (0:
    none), live cross rows (``slot_rows``, the slot's, where it sets none)
    and image placeholder position."""
    if not any(r.cross_slot for r in batch):
        return {}
    return dict(
        cross_slots=np.array([r.cross_slot or 0 for r in batch], np.int32),
        cross_lens=np.array([slot_rows if r.cross_len is None else r.cross_len for r in batch], np.int32),
        cross_starts=np.array([r.cross_start for r in batch], np.int64),
    )


class Scheduler:
    def __init__(
        self,
        model_config: ModelConfig,
        server_args: ServerArgs,
        mesh=None,
        params=None,
        runner: Optional[ModelRunner] = None,
    ):
        self.args = server_args.resolve()
        self.model_config = model_config
        self.runner = runner or ModelRunner(
            model_config, self.args, mesh, params,
            companion=spec_companion(self.args, model_config),
        )
        self.page_size = self.runner.page_size
        self.allocator = self.runner.page_allocator
        self.req_slots = self.runner.req_slots
        # cross attention (Mllama): the free slots of KVCache.cross (slot 0
        # unused), one a running request with an image (JAX :131-141)
        self.cross_slot_free: list[int] = []
        if getattr(self.runner.model, "has_cross_attention", False):
            self.cross_slot_free = list(range(self.runner.kv_config.cross_slots - 1, 0, -1))
            if self.args.speculative_algorithm:
                raise ValueError(
                    "speculative decoding is not supported for cross-attention (Mllama) models yet"
                )

        # draft-model speculation: a second runner whose KV pool mirrors the
        # target's page geometry, so page tables / radix pages serve both
        self.draft_runner: Optional[ModelRunner] = None
        if self.args.speculative_algorithm == "draft":
            self.draft_runner = build_draft_runner(self.runner, self.args)
        # EAGLE: a feature-conditioned one-layer head sharing the target's
        # embedding and head
        self.eagle = None
        if self.args.speculative_algorithm == "eagle":
            from scratchpad_tpu_torch.executor.eagle import EagleRunner

            self.eagle = EagleRunner(self.runner, self.args)

        self.tree_cache = TreeCacheGroup(
            self.page_size, disable=self.args.disable_radix_cache
        )
        # host KV tier: evicted radix pages offload to CPU memory and promote
        # back on later prefix hits (reference: memory/het_pool.py two-tier)
        self.host_tier = None
        if self.args.host_kv_cache_tokens > 0:
            from scratchpad_tpu_torch.memory.host_kv_tier import HostKVTier

            self.host_tier = HostKVTier(self.runner, self.args.host_kv_cache_tokens)
            self.tree_cache.set_evict_hook(self.host_tier.on_evict)
        self.policy = SchedulePolicy(self.args.schedule_policy, self.tree_cache)

        self.waiting: list[Req] = []
        self.running: list[Req] = []
        self.chunked_req: Optional[Req] = None

        # retraction heuristic (reference: scheduler.py:92-101, 966-1001)
        self.init_new_token_ratio = min(0.7 * self.args.schedule_conservativeness, 1.0)
        self.min_new_token_ratio = min(0.1 * self.args.schedule_conservativeness, 1.0)
        self.new_token_ratio = self.init_new_token_ratio
        self.ratio_decay = (
            self.init_new_token_ratio - self.min_new_token_ratio
        ) / 600.0

        # decode-window pipeline (overlap scheduling analogue, reference:
        # managers/tp_worker_client.py): list of in-flight windows, oldest
        # first, each {"batch", "pending", "K"}. Depth >1 keeps the device
        # busy across the host's dispatch/fetch relay round trips.
        self._inflight: list = []

        # stats
        self.num_generated_tokens = 0
        self.num_prefill_tokens = 0
        self.num_retractions = 0
        # speculative decoding acceptance stats (reference keeps the same
        # counters for its spec plumbing, scheduler.py:1024-1035)
        self.num_spec_steps = 0
        self.num_spec_accepted = 0
        self.step_count = 0
        # periodic decode-stats log (reference: scheduler.py:726-773
        # print_decode_stats every decode_log_interval batches)
        self._decode_windows = 0
        self._log_gen0 = 0
        self._log_t0 = __import__("time").monotonic()

    # ------------------------------------------------------------ public API

    def add_request(self, req: Req) -> None:
        if req.sampling_params.max_new_tokens is None:
            req.sampling_params.max_new_tokens = 1 << 30
        # clamp to context length
        room = self.runner.max_context_len - len(req.origin_input_ids) - 1
        req.sampling_params.max_new_tokens = max(
            min(req.sampling_params.max_new_tokens, room), 0
        )
        self.waiting.append(req)

    def abort_request(self, rid: str) -> None:
        for r in self.waiting:
            if r.rid == rid:
                r.finished_reason = FinishReason.ABORT
                self.waiting.remove(r)
                return
        for r in self.running + ([self.chunked_req] if self.chunked_req else []):
            if r.rid == rid and not r.finished():
                r.finished_reason = FinishReason.ABORT
                return

    def drain(self) -> list[StepEvent]:
        """Complete any in-flight decode window and release finished reqs."""
        events: list[StepEvent] = []
        while self._inflight:
            events.extend(self._step_pipelined())
        self._sweep_external_finishes()
        return events

    def has_work(self) -> bool:
        return bool(
            self.waiting
            or self.running
            or self.chunked_req
            or bool(self._inflight)
        )

    def num_queued(self) -> int:
        return len(self.waiting)

    def num_running(self) -> int:
        return len(self.running) + (1 if self.chunked_req else 0)

    # ------------------------------------------------------------- main loop

    def step(self) -> list[StepEvent]:
        """One scheduling iteration: build a batch, run it, process results."""
        self.step_count += 1
        if self._inflight:
            return self._step_pipelined()
        self._sweep_external_finishes()

        # teacher-forcing scoring requests (echo+logprobs / lm-eval
        # loglikelihood primitive) run exclusively on an idle engine
        if not self.running and self.chunked_req is None:
            score = next((r for r in self.waiting if r.is_score), None)
            if score is not None:
                self.waiting.remove(score)
                return self._run_score_req(score)

        batch, mode, chunk_lens = self._get_next_batch()
        if batch is None:
            return []

        if mode == ForwardMode.EXTEND:
            wb = self._build_worker_batch(batch, mode, chunk_lens)
            if batch[0].is_embedding:
                emb = self.runner.run_embed(wb)
                return self._process_embed_result(batch, chunk_lens, emb)
            if self.eagle is not None and not wb.return_top_logprobs:
                token_ids, logprobs, h = self.runner.run_extend_with_hidden(wb)
                tops = None
                self._eagle_mirror_extend(batch, chunk_lens, h)
            else:
                token_ids, logprobs, tops = self.runner.run_extend(wb)
                if self.eagle is not None:
                    for r in batch:
                        r.last_feature = None  # features not captured
            if self.draft_runner is not None:
                # mirror the extend so the draft's KV tracks the target's
                # (the base model's K/V: the draft has no adapters, and a
                # request with one never speculates)
                self.draft_runner.run_kv_only(
                    dataclasses.replace(wb, active_adapters=None, adapter_slots=None)
                )
                for r, chunk in zip(batch, chunk_lens):
                    r.draft_len = r.computed_len + chunk
            return self._process_extend_result(
                batch, chunk_lens, token_ids, logprobs, tops
            )

        if self.args.speculative_algorithm is not None and self._spec_ok(batch):
            events = self._spec_decode_step(batch)
            if events is not None:
                return events

        wb = self._build_worker_batch(batch, mode, None)
        if self.eagle is not None:
            for r in batch:
                r.last_feature = None  # plain decode: features not captured
        K = self._decode_window
        if self.overlap_enabled() and self._pipeline_ok(batch, wb):
            pending = self.runner.dispatch_decode_window(wb, K)
            self._inflight = [{"batch": list(batch), "pending": pending, "K": K}]
            return []  # results surface next step, overlapped with host work
        token_ids, logprobs, tops = self.runner.run_decode_window(wb, K)
        events = self._process_decode_result(batch, token_ids, logprobs, tops)
        self._decode_windows += 1
        iv = self.args.decode_log_interval
        if iv and self._decode_windows % iv == 0:
            self._log_decode_stats(len(batch), K)
        return events

    def _log_decode_stats(self, bs: int, window: int) -> None:
        import time as _time

        now = _time.monotonic()
        dt = max(now - self._log_t0, 1e-9)
        tput = (self.num_generated_tokens - self._log_gen0) / dt
        total = self.allocator.num_pages
        usage = 1.0 - self.allocator.available_pages / max(total, 1)
        logger.info(
            "decode: #running %d, #queue %d, window %d, kv usage %.1f%%, "
            "gen throughput %.1f tok/s, #gen %d",
            bs,
            len(self.waiting),
            window,
            usage * 100.0,
            tput,
            self.num_generated_tokens,
        )
        self._log_gen0 = self.num_generated_tokens
        self._log_t0 = now

    # ------------------------------------------------------- window pipeline

    def overlap_enabled(self) -> bool:
        """``enable_overlap``, with None (auto) resolved as the JAX rule
        does (no mesh, not the CPU): on where the runner's device is CUDA."""
        if self.args.enable_overlap is not None:
            return self.args.enable_overlap
        return self.runner.mesh is None and self.runner.device.type == "cuda"

    def _pipeline_ok(self, batch, wb=None) -> bool:
        # a speculative engine tries its drafts before every window; chained
        # windows would never come back to them (the JAX copy chains on, so
        # its ngram engine stops speculating after a window without drafts)
        if self.args.speculative_algorithm is not None:
            return False
        if wb is not None and not self.runner._packed_supported(wb):
            return False
        return not any(
            r.grammar is not None
            or r.sampling_params.top_logprobs > 0
            or r.sampling_params.needs_penalties()
            or r.sampling_params.logit_bias
            or r.sampling_params.custom_logit_processor is not None
            for r in batch
        )

    # ------------------------------------------------- speculative decoding

    def _propose_draft(self, batch: list[Req], k: int):
        """Run the draft model for k fused greedy steps; returns per-request
        draft lists (all length k), or None to fall back to plain decode."""
        while k > 0 and not self._try_alloc_decode_pages(k + 1):
            k //= 2  # page pressure: shorter speculation beats retraction
        if k == 0:
            return None
        lag = [r for r in batch if r.draft_len < r.computed_len]
        if lag:
            self._draft_catch_up(lag)
        wb = self._build_worker_batch(batch, ForwardMode.DECODE, None)
        ids, _, _ = self.draft_runner.run_decode_window(wb, k)  # [k, B]
        for r in batch:
            r.draft_len = r.computed_len + k
        return [[int(t) for t in ids[:, i]] for i in range(len(batch))]

    def _draft_catch_up(self, lag: list[Req]) -> None:
        """Extend the draft model over tokens it has not seen (generated by
        plain decode windows while speculation was inapplicable)."""
        ps = self.page_size
        tokens_l, pos_l, loc_l, idx_l = [], [], [], []
        seq_lens = np.zeros(len(lag), np.int32)
        extend_lens = np.zeros(len(lag), np.int32)
        for i, r in enumerate(lag):
            start, end = r.draft_len, r.computed_len
            tokens_l.append(np.asarray(r.fill_ids[start:end], np.int32))
            pos_l.append(np.arange(start, end, dtype=np.int32))
            p = np.arange(start, end)
            loc_l.append((r.pages[p // ps] * ps + p % ps).astype(np.int32))
            idx_l.append(np.full(end - start, i, np.int32))
            seq_lens[i] = end
            extend_lens[i] = end - start
        maxp = max(len(r.pages) for r in lag)
        page_table = np.zeros((len(lag), maxp), np.int32)
        for i, r in enumerate(lag):
            page_table[i, : len(r.pages)] = r.pages
        wb = WorkerBatch(
            mode=ForwardMode.EXTEND,
            tokens=np.concatenate(tokens_l),
            positions=np.concatenate(pos_l),
            out_cache_loc=np.concatenate(loc_l),
            req_indices=np.concatenate(idx_l),
            page_table=page_table,
            seq_lens=seq_lens,
            extend_lens=extend_lens,
            sampling_info=SamplingBatchInfo.from_reqs(
                lag, len(lag), self.model_config.vocab_size
            ),
        )
        self.draft_runner.run_kv_only(wb)
        for r in lag:
            r.draft_len = r.computed_len

    def _eagle_mirror_extend(self, batch, chunk_lens, h) -> None:
        """After a target extend with captured features, write the draft's
        TRUE pairs (x_{p+1}, f_p) for the chunk (and the chunk boundary via
        the stored last_feature)."""
        ps = self.page_size
        toks, pos, loc, ridx, feats = [], [], [], [], []
        sub, seq, ext = [], [], []
        off = 0
        for r, chunk in zip(batch, chunk_lens):
            if r.is_embedding:
                off += chunk
                continue
            s0, e0 = r.computed_len, r.computed_len + chunk
            pairs = []
            if s0 > 0 and r.draft_len == s0 - 1 and r.last_feature is not None:
                # chunk boundary pair carried over from the previous chunk
                pairs.append((s0 - 1, int(r.fill_ids[s0]), r.last_feature))
            # else (radix-prefix hit): the prefix pairs live in the SHARED
            # pages (written when first computed); only position s0-1's pair
            # is unknowable — one stale draft-KV row costs acceptance
            # quality, never correctness (verification is exact)
            for p in range(s0, e0 - 1):
                pairs.append((p, int(r.fill_ids[p + 1]), h[off + (p - s0)]))
            r.last_feature = h[off + (e0 - 1 - s0)]
            if pairs:
                bi = len(sub)
                sub.append(r)
                seq.append(pairs[-1][0] + 1)
                ext.append(len(pairs))
                for p, t, f in pairs:
                    toks.append(t)
                    pos.append(p)
                    loc.append(int(r.pages[p // ps]) * ps + p % ps)
                    ridx.append(bi)
                    feats.append(f)
            r.draft_len = e0 - 1
            off += chunk
        if not sub:
            return
        maxp = max(len(r.pages) for r in sub)
        pt = np.zeros((len(sub), maxp), np.int32)
        for i, r in enumerate(sub):
            pt[i, : len(r.pages)] = r.pages
        self.eagle.write_pairs(
            dict(
                tokens=np.asarray(toks, np.int32),
                positions=np.asarray(pos, np.int32),
                out_cache_loc=np.asarray(loc, np.int32),
                req_indices=np.asarray(ridx, np.int32),
                feats=np.asarray(feats, np.float32),
                page_table=pt,
                seq_lens=np.asarray(seq, np.int32),
                extend_lens=np.asarray(ext, np.int32),
            )
        )

    def _propose_eagle(self, batch: list[Req], k: int):
        """k fused EAGLE draft steps; None -> fall back to plain decode."""
        if any(
            r.last_feature is None or r.draft_len != r.computed_len - 1
            for r in batch
        ):
            return None
        while k > 0 and not self._try_alloc_decode_pages(k + 1):
            k //= 2
        if k == 0:
            return None
        maxp = max(len(r.pages) for r in batch)
        pt = np.zeros((len(batch), maxp), np.int32)
        for i, r in enumerate(batch):
            pt[i, : len(r.pages)] = r.pages
        drafts = self.eagle.propose(
            np.asarray([r.output_ids[-1] for r in batch], np.int32),
            np.stack([r.last_feature for r in batch]),
            np.asarray([r.computed_len for r in batch], np.int32),
            pt,
            k,
        )  # [k, B]
        return [[int(t) for t in drafts[:, i]] for i in range(len(batch))]

    def _spec_ok(self, batch: list[Req]) -> bool:
        """Speculation preserves outputs for greedy rows trivially and for
        sampled rows via sampled verification (the proposals are
        deterministic, so sample-and-compare is distribution-exact — see
        ModelRunner._spec_verify_sampled_impl). Grammar/penalties/logit-bias
        rows need per-position sampler state and stay on the plain decode
        path."""
        ok = all(
            r.grammar is None
            and r.sampling_params.top_logprobs == 0
            and not r.sampling_params.needs_penalties()
            and not r.sampling_params.logit_bias
            # the sampler masks EOS until min_new_tokens; the verify
            # samplers don't
            and r.sampling_params.min_new_tokens <= len(r.output_ids)
            # the verify samplers run no custom processor, and the verify
            # batch carries no adapter table (the JAX copy verifies a
            # topping's row on the base model)
            and r.sampling_params.custom_logit_processor is None
            and r.topping_idx == 0
            for r in batch
        )
        return ok

    def _propose_ngram(self, req: Req, k: int) -> list[int]:
        """Prompt-lookup drafts: the longest recent suffix n-gram that
        occurred earlier in the sequence proposes its continuation (the
        draft-model-free speculator; the reference never implemented its
        EAGLE stub — spec_info.py:4-24)."""
        ctx = np.asarray(req.fill_ids, np.int64)
        m = len(ctx)
        for n in range(self.args.speculative_ngram_max, 0, -1):
            if m <= n:
                continue
            suffix = ctx[-n:]
            windows = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.nonzero(np.all(windows == suffix, axis=1))[0]
            if len(hits):
                start = int(hits[-1]) + n
                cont = ctx[start : start + k]
                if len(cont):
                    return [int(t) for t in cont]
        return []

    def _spec_decode_step(self, batch: list[Req]) -> Optional[list[StepEvent]]:
        """One ngram-speculative step: verify [last_token, drafts...] rows in
        a single extend forward; accept the longest prefix matching the
        greedy chain. Rejected rows' KV slots sit past computed_len and are
        overwritten by later steps. Returns None when no request drafted
        anything (caller falls back to the fused decode window)."""
        k = self.args.speculative_num_draft_tokens
        if self.args.speculative_algorithm == "draft":
            drafts = self._propose_draft(batch, k)
            if drafts is None:
                return None
        elif self.args.speculative_algorithm == "eagle":
            drafts = self._propose_eagle(batch, k)
            if drafts is None:
                return None
        else:
            drafts = [self._propose_ngram(r, k) for r in batch]
        if not any(drafts):
            return None
        ps = self.page_size
        # ensure page coverage for 1 + len(draft) tokens (trim on pressure)
        for i, (r, d) in enumerate(zip(batch, drafts)):
            while d:
                need = -(-(r.computed_len + 1 + len(d)) // ps) - len(r.pages)
                if need <= 0:
                    break
                pages = self._alloc_pages(need)
                if pages is not None:
                    r.pages = np.concatenate([r.pages, pages])
                    self.req_slots.write_pages(r.req_slot, 0, r.pages)
                    break
                d.pop()  # trim drafts rather than retract mid-batch
            drafts[i] = d

        tokens_l, pos_l, loc_l, idx_l = [], [], [], []
        B = len(batch)
        seq_lens = np.zeros(B, np.int32)
        extend_lens = np.zeros(B, np.int32)
        for i, (r, d) in enumerate(zip(batch, drafts)):
            row = [r.output_ids[-1]] + d
            start, end = r.computed_len, r.computed_len + len(row)
            tokens_l.append(np.asarray(row, np.int32))
            pos_l.append(np.arange(start, end, dtype=np.int32))
            p = np.arange(start, end)
            loc_l.append((r.pages[p // ps] * ps + p % ps).astype(np.int32))
            idx_l.append(np.full(len(row), i, np.int32))
            seq_lens[i] = end
            extend_lens[i] = len(row)
        from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
        from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo

        maxp = max(len(r.pages) for r in batch)
        page_table = np.zeros((B, maxp), np.int32)
        for i, r in enumerate(batch):
            page_table[i, : len(r.pages)] = r.pages
        rope_delta = None
        if any(r.mrope_delta for r in batch):
            rope_delta = np.array([r.mrope_delta for r in batch], np.int32)
        wb = WorkerBatch(
            mode=ForwardMode.EXTEND,
            tokens=np.concatenate(tokens_l),
            positions=np.concatenate(pos_l),
            out_cache_loc=np.concatenate(loc_l),
            req_indices=np.concatenate(idx_l),
            page_table=page_table,
            seq_lens=seq_lens,
            extend_lens=extend_lens,
            sampling_info=SamplingBatchInfo.from_reqs(
                batch, B, self.model_config.vocab_size
            ),
            rope_delta=rope_delta,
        )
        sampled = any(r.sampling_params.temperature > 0.0 for r in batch)
        if self.eagle is not None:
            if sampled:
                ids, lps, vh = self.runner.run_spec_verify_sampled(
                    wb, return_hidden=True
                )
            else:
                ids, lps, vh = self.runner.run_spec_verify_h(wb)
        elif sampled:
            ids, lps = self.runner.run_spec_verify_sampled(wb)
            vh = None
        else:
            ids, lps = self.runner.run_spec_verify(wb)
            vh = None
        e_toks, e_pos, e_loc, e_ridx, e_feats = [], [], [], [], []
        e_sub, e_seq, e_ext = [], [], []

        events: list[StepEvent] = []
        finished: list[Req] = []
        off = 0
        for r, d in zip(batch, drafts):
            L = 1 + len(d)
            row_ids = ids[off : off + L]
            row_lps = lps[off : off + L]
            off += L
            accepted: list[int] = []
            consumed = 1  # rows whose KV is now valid
            j = 0
            while True:
                tok = int(row_ids[j])
                accepted.append(tok)
                r.output_ids.append(tok)
                if r.return_logprob:
                    r.output_token_logprobs.append(float(row_lps[j]))
                r.check_finished()
                if r.finished() or j >= len(d) or d[j] != tok:
                    break
                j += 1
                consumed += 1
            r.computed_len += consumed
            if vh is not None:
                # stable draft KV: overwrite the accepted span with TRUE
                # feature pairs from the verify pass
                c_old = r.computed_len - consumed
                pairs = [
                    (p, int(r.fill_ids[p + 1]), vh[off - L + (p - c_old)])
                    for p in range(c_old, r.computed_len - 1)
                ]
                r.last_feature = vh[off - L + consumed - 1]
                ps_ = self.page_size
                if pairs:
                    bi = len(e_sub)
                    e_sub.append(r)
                    e_seq.append(pairs[-1][0] + 1)
                    e_ext.append(len(pairs))
                    for p, t, f in pairs:
                        e_toks.append(t)
                        e_pos.append(p)
                        e_loc.append(int(r.pages[p // ps_]) * ps_ + p % ps_)
                        e_ridx.append(bi)
                        e_feats.append(f)
                r.draft_len = r.computed_len - 1
            if self.draft_runner is not None:
                # draft KV covers the window it just ran ([p0, p0+k), set in
                # _propose_draft); on FULL acceptance the target advances one
                # position past that (the bonus token), so cap at coverage —
                # the gap is caught up before the next draft window
                r.draft_len = min(r.draft_len, r.computed_len)
            self.num_spec_accepted += len(accepted) - 1
            self.num_spec_steps += 1
            self.num_generated_tokens += len(accepted)
            if r.finished():
                finished.append(r)
            events.append(StepEvent(r, accepted, r.finished()))
        if self.eagle is not None and e_sub:
            maxp = max(len(r.pages) for r in e_sub)
            pt = np.zeros((len(e_sub), maxp), np.int32)
            for i, r in enumerate(e_sub):
                pt[i, : len(r.pages)] = r.pages
            self.eagle.write_pairs(
                dict(
                    tokens=np.asarray(e_toks, np.int32),
                    positions=np.asarray(e_pos, np.int32),
                    out_cache_loc=np.asarray(e_loc, np.int32),
                    req_indices=np.asarray(e_ridx, np.int32),
                    feats=np.asarray(e_feats, np.float32),
                    page_table=pt,
                    seq_lens=np.asarray(e_seq, np.int32),
                    extend_lens=np.asarray(e_ext, np.int32),
                )
            )
        for r in finished:
            self.running.remove(r)
            self._finish_req(r)
        return events

    def _try_alloc_decode_pages(self, horizon: int) -> bool:
        """Allocate pages covering ``horizon`` more tokens per running req
        WITHOUT retraction (chaining must not change batch membership)."""
        ps = self.page_size
        need = sum(
            -(-(r.computed_len + horizon) // ps) - len(r.pages)
            for r in self.running
        )
        if need > self.allocator.available_pages + self.tree_cache.evictable_pages:
            return False
        for r in self.running:
            n = -(-(r.computed_len + horizon) // ps) - len(r.pages)
            if n > 0:
                pages = self._alloc_pages(n)
                assert pages is not None
                r.pages = np.concatenate([r.pages, pages])
                self.req_slots.write_pages(r.req_slot, 0, r.pages)
        return True

    def _pipeline_depth(self) -> int:
        """Max in-flight decode windows. Depth 2 keeps a queued window on
        the device while the host fetches/processes the previous one, hiding
        the per-window dispatch+fetch relay latency (reference analogue: the
        one-batch-deep overlap loop, scheduler.py:409)."""
        d = self.args.decode_pipeline_depth
        return max(d if d is not None else 2, 1)

    def _step_pipelined(self) -> list[StepEvent]:
        """Top the pipeline up to depth (chained via the device-resident
        last samples) BEFORE fetching the oldest window, so the device never
        idles while the host detokenizes/streams or pays relay round trips."""
        infl = self._inflight
        batch = infl[0]["batch"]
        chain = (
            not self.waiting
            and self.chunked_req is None
            and len(self.running) == len(batch)
            and all(a is b for a, b in zip(self.running, batch))
            and all(not r.finished() for r in batch)
            and self._pipeline_ok(batch)
        )
        if chain:
            depth = self._pipeline_depth()
            total_K = sum(w["K"] for w in infl)
            while len(infl) < depth:
                K2 = self._pick_decode_window(ahead=total_K)
                if K2 <= 0 or not self._try_alloc_decode_pages(total_K + K2):
                    break
                wb2 = self._build_decode_wb_ahead(batch, total_K)
                pending = self.runner.dispatch_decode_window(
                    wb2, K2, prev_tokens=infl[-1]["pending"][1]
                )
                infl.append({"batch": batch, "pending": pending, "K": K2})
                total_K += K2
        head = infl.pop(0)
        token_ids, logprobs, _ = self.runner.fetch_decode_window(head["pending"])
        events = self._process_decode_result(
            head["batch"], token_ids, logprobs, defer_finish=bool(infl)
        )
        return events

    def _build_decode_wb_ahead(self, batch: list[Req], offset: int) -> WorkerBatch:
        """Decode WorkerBatch for a window starting ``offset`` steps ahead of
        the processed state; input tokens come from the device carry."""
        B = len(batch)
        positions = np.array(
            [r.computed_len + offset for r in batch], np.int32
        )
        maxp = max(len(r.pages) for r in batch)
        page_table = np.zeros((B, maxp), np.int32)
        for i, r in enumerate(batch):
            page_table[i, : len(r.pages)] = r.pages
        sinfo = SamplingBatchInfo.from_reqs(batch, B, self.model_config.vocab_size)
        rope_delta = None
        if any(r.mrope_delta for r in batch):
            rope_delta = np.array([r.mrope_delta for r in batch], np.int32)
        # the batch's adapters ride along (the JAX copy leaves them out, so
        # its chained windows decode without them)
        active, slots = self._build_topping_batch(batch)
        return WorkerBatch(
            mode=ForwardMode.DECODE,
            tokens=np.zeros(B, np.int32),  # overridden by prev_tokens
            positions=positions,
            out_cache_loc=np.zeros(B, np.int32),  # derived on device
            req_indices=np.arange(B, dtype=np.int32),
            page_table=page_table,
            seq_lens=positions + 1,
            extend_lens=np.ones(B, np.int32),
            sampling_info=sinfo,
            active_adapters=active,
            adapter_slots=slots,
            rope_delta=rope_delta,
        )

    # ------------------------------------------------------------ batch build

    def _get_next_batch(self):
        prefill = self._get_prefill_batch()
        if prefill is not None:
            self._admission_blocked = False
            reqs, chunk_lens = prefill
            return reqs, ForwardMode.EXTEND, chunk_lens
        # waiting requests that could NOT be admitted (req slots, pages,
        # adapter budget) should not also shrink the decode window — they
        # only become admittable when running requests finish
        self._admission_blocked = bool(self.waiting)
        # grammar jump-forward catch-up: requests that had forced tokens
        # appended host-side carry a multi-token KV deficit; compute it as
        # one extend chunk (prefill speed instead of per-token decode)
        catchup = [r for r in self.running if r.extend_input_len > 1]
        if catchup:
            batch, chunks = [], []
            for r in catchup:
                chunk = r.extend_input_len
                if self._alloc_for_extend(r, chunk):
                    batch.append(r)
                    chunks.append(chunk)
            if batch:
                return batch, ForwardMode.EXTEND, chunks

        if self.running:
            self._decode_window = self._pick_decode_window()
            self._prepare_decode(self._decode_window)
            if self.running:
                return self.running, ForwardMode.DECODE, None
        return None, None, None

    def _pick_decode_window(self, ahead: int = 0) -> int:
        """Decode steps fused per dispatch. Long windows amortise host-device
        round trips (the CUDA-graph/overlap analogue); short windows keep
        admission latency low when work is waiting. Returns 0 when ``ahead``
        in-flight tokens already exhaust every request's budget."""
        w = self.args.decode_window_size
        if getattr(self.runner, "param_offload", False):
            return 1  # host-resident layers stream once per dispatch
        if self.chunked_req is not None or (
            self.waiting and not getattr(self, "_admission_blocked", False)
        ):
            w = min(w, 4)
        elif self.waiting:
            # admission-blocked waiters free up only when running requests
            # finish: keep windows wide-ish but bound their wait
            w = min(w, 16)
        if any(r.grammar is not None for r in self.running):
            return 1  # grammar FSM advances on host per token (for now)
        if any(r.sampling_params.top_logprobs > 0 for r in self.running):
            return 1  # top-logprobs fetched per step
        # latency-sensitive streams see tokens once per window: cap the
        # burst so inter-chunk latency stays interactive while throughput
        # batches stay wide (reference stream_interval analogue,
        # scratchpad/server/args.py stream_interval)
        if any(r.stream for r in self.running):
            w = min(w, max(self.args.stream_interval, 8))
        # never decode past every request's remaining budget (``ahead``
        # tokens are already in flight when topping up a deep pipeline)
        rem = max(
            (
                r.sampling_params.max_new_tokens - len(r.output_ids)
                for r in self.running
            ),
            default=w,
        )
        rem -= ahead
        if ahead > 0 and rem <= 0:
            return 0
        w = min(w, max(rem, 1))
        # round down to a power of two for compile-cache reuse
        k = 1
        while k * 2 <= w:
            k *= 2
        return k

    def _get_prefill_batch(self):
        # in-flight chunked prefill continues before anything else
        # (reference: scheduler.py:800-807)
        if self.chunked_req is not None:
            req = self.chunked_req
            chunk = min(req.extend_input_len, self.args.chunked_prefill_size)
            chunk = min(req.clamp_chunk_for_spans(chunk), req.extend_input_len)
            if not self._alloc_for_extend(req, chunk):
                logger.warning("chunked req cannot allocate; retracting others")
                if not self._retract_for(req, chunk):
                    return None
                if not self._alloc_for_extend(req, chunk):
                    return None
            done = chunk == req.extend_input_len
            if done:
                self.chunked_req = None
            return [req], [chunk]

        if not self.waiting:
            return None
        if len(self.running) >= self.runner.max_running_requests:
            return None

        # embedding requests run in exclusive batches (their jitted step
        # returns hidden states, not sampled tokens)
        embed_waiting = [r for r in self.waiting if r.is_embedding]
        # scoring requests never join normal batches (exclusive step())
        candidates = embed_waiting or [
            r for r in self.waiting if not r.is_score
        ]
        if not candidates:
            return None
        self.policy.calc_priority(candidates)
        # sequence-parallel prefill budget: fresh prompts up to this length
        # run unchunked (the runner shards the token axis over "sp")
        sp_limit = 0
        if (
            getattr(self.runner, "sp_prefill_tokens", 0)
            and self.args.speculative_algorithm is None
        ):
            sp_limit = self.runner.sp_prefill_tokens
        adder = PrefillAdder(
            self.tree_cache,
            self.allocator,
            self.running,
            self.new_token_ratio,
            max(self.args.max_prefill_tokens, sp_limit),
            self.args.chunked_prefill_size,
            self.runner.max_running_requests - len(self.running),
            sp_unchunked_limit=sp_limit,
            # sp prefills run solo (the runner requires a single-request
            # extend), so only the batch's first admission may take the
            # unchunked path
            sp_eligible=lambda r: (
                not adder.can_run_list and self._sp_req_eligible(r)
            ),
        )
        admitted: list[Req] = []
        # cap distinct adapters across running + admitted
        # (reference: scheduler.py:875-890)
        active_toppings = {r.topping_idx for r in self.running if r.topping_idx}
        for req in list(candidates):
            if self.req_slots.available_slots <= len(admitted):
                break
            if (
                req.topping_idx
                and req.topping_idx not in active_toppings
                and len(active_toppings) >= MAX_ACTIVE_TOPPINGS - 1
            ):
                continue  # adapter budget full; retry next round
            if req.cross_states is not None and req.cross_slot is None and not self.cross_slot_free:
                continue  # every cross-KV slot taken; retry next round
            self._promote_host_prefix(req)
            res = adder.add_one_req(req)
            if adder.can_run_list and adder.can_run_list[-1] is req:
                admitted.append(req)
                self.waiting.remove(req)
                if req.topping_idx:
                    active_toppings.add(req.topping_idx)
                if req.cross_states is not None and req.cross_slot is None:
                    req.cross_slot = self.cross_slot_free.pop()
                    self.runner.write_cross(req.cross_slot, req.cross_states)
            if res != AddReqResult.CONTINUE:
                break
            if adder.new_chunked_req is not None:
                break
            # an sp-sized unchunked admission fills the batch by itself
            if (
                admitted
                and admitted[-1] is req
                and len(req.origin_input_ids) - req.cached_prefix_len
                > self.args.chunked_prefill_size
            ):
                break

        if not admitted:
            return None

        batch: list[Req] = []
        chunk_lens: list[int] = []
        for req in admitted:
            # (radix path already locked inside PrefillAdder.add_one_req)
            req.computed_len = req.cached_prefix_len
            chunk = req.extend_input_len
            if req is adder.new_chunked_req:
                # the admitted chunk, NOT chunked_prefill_size: the adder may
                # have cut it shorter when rem_input_tokens ran low
                chunk = min(chunk, adder.new_chunked_len)
                chunk = max((chunk // self.page_size) * self.page_size, 1)
                chunk = min(
                    req.clamp_chunk_for_spans(chunk), req.extend_input_len
                )
            if not self._alloc_for_extend(req, chunk):
                # roll back admission for this req
                if req.last_node is not None:
                    self.tree_cache.for_req(req).dec_lock_ref(req.last_node)
                self._free_cross_slot(req)
                req.reset_for_retract()
                self.waiting.insert(0, req)
                continue
            if req is adder.new_chunked_req and chunk < req.extend_input_len:
                self.chunked_req = req
            batch.append(req)
            chunk_lens.append(chunk)
            self.num_prefill_tokens += chunk
        if not batch:
            return None
        # mixed chunk: running decode requests join the prefill batch as
        # one-token extend rows (reference: schedule_batch.py:1073
        # mix_with_running); the flat-token extend layout handles them
        # natively — input token fill_ids[computed_len] is the last sample
        if (
            self.args.enable_mixed_chunk
            and self.running
            and not batch[0].is_embedding
            and not any(r.grammar is not None for r in self.running)
            # sp prefills stay solo (single-request ring-attention extend)
            and not any(c > self.args.chunked_prefill_size for c in chunk_lens)
        ):
            ps = self.page_size
            for r in self.running:
                need = -(-(r.computed_len + 1) // ps) - len(r.pages)
                if need > 0:
                    pages = self._alloc_pages(need)
                    if pages is None:
                        continue
                    r.pages = np.concatenate([r.pages, pages])
                    self.req_slots.write_pages(r.req_slot, 0, r.pages)
                batch.append(r)
                chunk_lens.append(1)
        return batch, chunk_lens

    def _sp_req_eligible(self, req: Req) -> bool:
        """May this request's fresh prompt run as ONE sequence-parallel
        extend? Excludes every feature the packed sp step can't carry
        (ModelRunner._packed_supported + ring-attention constraints)."""
        return (
            not req.is_embedding
            and req.topping_idx == 0
            and req.mm_positions is None
            and req.mrope_table is None
            and req.grammar is None
            and req.sampling_params.top_logprobs == 0
            and req.sampling_params.min_new_tokens == 0
        )

    def _alloc_for_extend(self, req: Req, chunk: int) -> bool:
        """Ensure req slot + pages to hold KV for the next ``chunk`` tokens."""
        if req.req_slot is None:
            slot = self.req_slots.alloc()
            if slot is None:
                return False
            req.req_slot = slot
        end = req.computed_len + chunk
        need = -(-end // self.page_size) - len(req.pages)
        if need > 0:
            pages = self._alloc_pages(need)
            if pages is None:
                return False
            req.pages = np.concatenate([req.pages, pages])
        self.req_slots.write_pages(req.req_slot, 0, req.pages)
        return True

    def _alloc_pages(self, n: int) -> Optional[np.ndarray]:
        if self.allocator.available_pages < n:
            self.tree_cache.evict(
                n - self.allocator.available_pages, self.allocator.free
            )
        return self.allocator.alloc(n)

    # --------------------------------------------------------------- decode

    def _prepare_decode(self, window: int) -> None:
        """Allocate pages covering ``window`` more tokens per request;
        shrink the window, then retract, under memory pressure
        (reference: scheduler.py:966-1001 update_running_batch)."""
        self.new_token_ratio = max(
            self.new_token_ratio - self.ratio_decay, self.min_new_token_ratio
        )
        ps = self.page_size

        def pages_needed(w: int) -> int:
            return sum(
                -(-(r.computed_len + w) // ps) - len(r.pages) for r in self.running
            )

        while True:
            avail = self.allocator.available_pages + self.tree_cache.evictable_pages
            if pages_needed(window) <= avail:
                break
            if window > 1:
                window //= 2
                continue
            if not self._retract_one():
                break
        self._decode_window = window
        for r in self.running:
            need = -(-(r.computed_len + window) // ps) - len(r.pages)
            if need > 0:
                pages = self._alloc_pages(need)
                assert pages is not None
                r.pages = np.concatenate([r.pages, pages])
                self.req_slots.write_pages(r.req_slot, 0, r.pages)

    def _retract_one(self) -> bool:
        """Retract the request with the most generated tokens back to waiting
        (reference: schedule_batch.py:1123-1170)."""
        if len(self.running) <= 1:
            return False
        victim = max(self.running, key=lambda r: len(r.output_ids))
        self.running.remove(victim)
        self._release_req(victim, keep_outputs=False)
        victim.reset_for_retract()
        self.waiting.insert(0, victim)
        self.num_retractions += 1
        self.new_token_ratio = self.init_new_token_ratio
        logger.info("retracted %s (out=%d)", victim.rid, len(victim.output_ids))
        return True

    def _retract_for(self, req: Req, chunk: int) -> bool:
        need = -(-(req.computed_len + chunk) // self.page_size) - len(req.pages)
        while (
            self.allocator.available_pages + self.tree_cache.evictable_pages < need
        ):
            if not self._retract_one():
                return False
        return True

    # ------------------------------------------------------------ worker batch

    def _build_worker_batch(
        self, batch: list[Req], mode: ForwardMode, chunk_lens: Optional[list[int]]
    ) -> WorkerBatch:
        ps = self.page_size
        if mode == ForwardMode.DECODE:
            B = len(batch)
            tokens = np.array([r.output_ids[-1] for r in batch], np.int32)
            positions = np.array([r.computed_len for r in batch], np.int32)
            out_loc = np.array(
                [
                    r.pages[r.computed_len // ps] * ps + r.computed_len % ps
                    for r in batch
                ],
                np.int32,
            )
            req_idx = np.arange(B, dtype=np.int32)
            seq_lens = positions + 1
            extend_lens = np.ones(B, np.int32)
            input_embeds = None
            mrope_positions = None
        else:
            tokens_l, pos_l, loc_l, idx_l = [], [], [], []
            seq_lens = np.zeros(len(batch), np.int32)
            extend_lens = np.asarray(chunk_lens, np.int32)
            for i, (r, chunk) in enumerate(zip(batch, chunk_lens)):
                start, end = r.computed_len, r.computed_len + chunk
                tokens_l.append(np.asarray(r.fill_ids[start:end], np.int32))
                pos_l.append(np.arange(start, end, dtype=np.int32))
                p = np.arange(start, end)
                loc_l.append((r.pages[p // ps] * ps + p % ps).astype(np.int32))
                idx_l.append(np.full(chunk, i, np.int32))
                seq_lens[i] = end
            tokens = np.concatenate(tokens_l)
            positions = np.concatenate(pos_l)
            out_loc = np.concatenate(loc_l)
            req_idx = np.concatenate(idx_l)
            # multimodal rows: gather precomputed vision embeddings for any
            # image-placeholder positions landing in this chunk
            input_embeds = None
            if np.any(tokens < 0):
                H = self.model_config.hidden_size
                input_embeds = np.zeros((len(tokens), H), np.float32)
                off = 0
                for r, chunk in zip(batch, chunk_lens):
                    if r.mm_positions is not None:
                        start = r.computed_len
                        sel = (r.mm_positions >= start) & (
                            r.mm_positions < start + chunk
                        )
                        rows = off + (r.mm_positions[sel] - start)
                        input_embeds[rows] = r.mm_features[sel]
                    off += chunk
            # multimodal rope: full 3-component positions whenever any row
            # of the batch belongs to an image prompt (text rows broadcast)
            mrope_positions = None
            if any(r.mrope_table is not None for r in batch):
                mrope_positions = np.concatenate(
                    [
                        self._mrope_rows(r, r.computed_len, r.computed_len + c)
                        for r, c in zip(batch, chunk_lens)
                    ],
                    axis=1,
                )

        # Gemma3-MM: absolute bidirectional spans [B, M, 2] (zeros = none)
        mm_spans = None
        if mode != ForwardMode.DECODE and any(r.mm_spans for r in batch):
            M = 8  # static span capacity; >8-image prompts degrade to causal
            mm_spans = np.zeros((len(batch), M, 2), np.int32)
            for i, r in enumerate(batch):
                for m, (s0, s1) in enumerate((r.mm_spans or [])[:M]):
                    mm_spans[i, m] = (s0, s1)

        rope_delta = None
        if mrope_positions is None and any(r.mrope_delta for r in batch):
            rope_delta = np.array([r.mrope_delta for r in batch], np.int32)

        maxp = max(len(r.pages) for r in batch)
        page_table = np.zeros((len(batch), maxp), np.int32)
        for i, r in enumerate(batch):
            page_table[i, : len(r.pages)] = r.pages

        cross = cross_batch_fields(batch, self.runner.kv_config.cross_len)
        sinfo = SamplingBatchInfo.from_reqs(
            batch, len(batch), self.model_config.vocab_size
        )
        bitmask = self._build_vocab_bitmask(batch, mode)
        active, slots = self._build_topping_batch(batch)
        want_tops = any(r.sampling_params.top_logprobs > 0 for r in batch)
        return WorkerBatch(
            mode=mode,
            tokens=tokens,
            positions=positions,
            out_cache_loc=out_loc,
            req_indices=req_idx,
            page_table=page_table,
            seq_lens=seq_lens,
            extend_lens=extend_lens,
            sampling_info=sinfo,
            vocab_bitmask=bitmask,
            active_adapters=active,
            adapter_slots=slots,
            return_top_logprobs=want_tops,
            input_embeds=input_embeds,
            mrope_positions=mrope_positions,
            rope_delta=rope_delta,
            mm_spans=mm_spans,
            **cross,
        )

    def _free_cross_slot(self, req: Req) -> None:
        if req.cross_slot is not None:
            self.cross_slot_free.append(req.cross_slot)
            req.cross_slot = None

    @staticmethod
    def _mrope_rows(r: Req, start: int, end: int) -> np.ndarray:
        """[3, end-start] rope positions for one request's token range:
        table lookup inside the prompt, scalar-shifted 1-D beyond it."""
        p = np.arange(start, end)
        out = np.empty((3, end - start), np.int32)
        tab = r.mrope_table
        if tab is None:
            out[:] = p[None, :] + r.mrope_delta
            return out
        w = tab.shape[1]
        within = p < w
        out[:, within] = tab[:, p[within]]
        out[:, ~within] = p[~within] + r.mrope_delta
        return out

    def _build_topping_batch(self, batch: list[Req]):
        """Distinct adapter slots in the batch + per-request positions
        (reference: toppings_manager.py:234 prepare_topping_batch)."""
        if not any(r.topping_idx for r in batch):
            return None, None
        active = [0]
        slots = np.zeros(len(batch), np.int32)
        for i, r in enumerate(batch):
            if r.topping_idx == 0:
                continue
            if r.topping_idx not in active:
                assert len(active) < MAX_ACTIVE_TOPPINGS, "too many toppings in batch"
                active.append(r.topping_idx)
            slots[i] = active.index(r.topping_idx)
        active += [0] * (MAX_ACTIVE_TOPPINGS - len(active))
        return np.asarray(active, np.int32), slots

    def _build_vocab_bitmask(self, batch: list[Req], mode) -> Optional[np.ndarray]:
        if not any(r.grammar is not None for r in batch):
            return None
        V = self.model_config.vocab_size
        words = -(-V // 32)
        mask = np.full((len(batch), words), 0xFFFFFFFF, np.uint32)
        for i, r in enumerate(batch):
            if r.grammar is not None:
                r.grammar.fill_vocab_bitmask(mask[i], V)
        return mask

    # --------------------------------------------------------------- results


    def _jump_forward(self, req: Req) -> list[int]:
        """Append grammar-forced tokens without model steps
        (reference: outlines_jump_forward.py:31; disable via grammar-free
        requests). The KV deficit is computed later as an extend chunk."""
        out: list[int] = []
        while (
            req.grammar is not None
            and not req.finished()
            and len(out) < 64
        ):
            forced = req.grammar.forced_next_token()
            if forced is None:
                break
            req.output_ids.append(forced)
            req.grammar.accept_token(forced)
            req.check_finished()
            out.append(forced)
            self.num_generated_tokens += 1
        return out

    def _nan_guard(self, batch, logprobs) -> None:
        """Divergence detection (reference: nn/layers/sampler.py:54-61 NaN
        check on logits): a non-finite chosen logprob means the forward
        produced NaN/inf logits — silent corruption. The affected request
        is ABORTED with a loud error instead of streaming garbage; the
        engine keeps serving the rest (cost: one np.isfinite over [K, B]
        host floats per window — the values are already fetched)."""
        if not self.args.enable_nan_detection or logprobs is None:
            return
        lp = np.asarray(logprobs)
        if lp.ndim == 1:
            lp = lp[None, :]
        bad = ~np.isfinite(lp).all(axis=0)  # [B]
        if not bad.any():
            return
        for i, req in enumerate(batch):
            if i < bad.shape[0] and bad[i] and not req.finished():
                logger.error(
                    "non-finite logits for %s (pos %d): aborting request "
                    "(model divergence / corrupted weights?)",
                    req.rid,
                    req.seq_len,
                )
                req.finished_reason = FinishReason.ABORT

    def _process_extend_result(
        self, batch, chunk_lens, token_ids, logprobs, tops=None
    ):
        self._nan_guard(batch, logprobs)
        events: list[StepEvent] = []
        for i, (req, chunk) in enumerate(zip(batch, chunk_lens)):
            req.computed_len += chunk
            if req.computed_len < len(req.origin_input_ids):
                # chunk-prefill continues; sampled token is meaningless
                self._cache_unfinished(req)
                events.append(StepEvent(req, [], False))
                continue
            if req.finished():  # aborted by the NaN guard: drop the sample
                if req in self.running:
                    self.running.remove(req)
                self._finish_req(req)
                events.append(StepEvent(req, [], True))
                continue
            tok = int(token_ids[i])
            new_tokens = [tok]
            if req.sampling_params.max_new_tokens > 0:
                req.output_ids.append(tok)
                if req.return_logprob:
                    req.output_token_logprobs.append(float(logprobs[i]))
                if tops is not None and req.sampling_params.top_logprobs > 0:
                    k = req.sampling_params.top_logprobs
                    req.output_top_logprobs.append(
                        (tops[0][i][:k].tolist(), tops[1][i][:k].tolist())
                    )
                if req.grammar is not None:
                    req.grammar.accept_token(tok)
                req.check_finished()
                if req.grammar is not None and not req.finished():
                    new_tokens.extend(self._jump_forward(req))
            else:
                req.finished_reason = FinishReason.LENGTH
            self.num_generated_tokens += 1
            if req.finished():
                if req in self.running:  # mixed-chunk decode row
                    self.running.remove(req)
                self._finish_req(req)
                events.append(StepEvent(req, new_tokens, True))
            else:
                if req not in self.running:
                    self._cache_unfinished(req)
                    self.running.append(req)
                events.append(StepEvent(req, new_tokens, False))
        return events

    def _run_score_req(self, req) -> list:
        """Exclusive teacher-forcing pass over one prompt: per-position
        next-token logprobs (reference quality-gate primitive: served
        prompt logprobs for lm-eval loops, cli/sp.py:59-68). Pages are
        borrowed and freed; nothing enters the radix cache."""
        from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
        from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo

        ids = req.origin_input_ids
        n = len(ids)
        ps = self.page_size
        pages = self._alloc_pages(-(-n // ps))
        if pages is None:
            req.finished_reason = FinishReason.ABORT
            return [StepEvent(req, [], True)]
        try:
            pos = np.arange(n)
            loc = (pages[pos // ps] * ps + pos % ps).astype(np.int32)
            sinfo = SamplingBatchInfo(
                temperature=np.zeros(1, np.float32),
                top_p=np.ones(1, np.float32),
                top_k=np.full(1, self.model_config.vocab_size, np.int32),
                min_p=np.zeros(1, np.float32),
            )
            wb = WorkerBatch(
                mode=ForwardMode.EXTEND,
                tokens=np.asarray(ids, np.int32),
                positions=pos.astype(np.int32),
                out_cache_loc=loc,
                req_indices=np.zeros(n, np.int32),
                page_table=pages[None, :].astype(np.int32),
                seq_lens=np.array([n], np.int32),
                extend_lens=np.array([n], np.int32),
                sampling_info=sinfo,
            )
            lps = self.runner.run_score(wb)
        finally:
            self.allocator.free(pages)
        # position t holds the logprob of token t+1; the last has no target
        req.prompt_logprobs = [float(x) for x in lps[: n - 1]]
        req.finished_reason = FinishReason.LENGTH
        return [StepEvent(req, [], True)]

    def _process_embed_result(self, batch, chunk_lens, emb):
        events: list[StepEvent] = []
        for i, (req, chunk) in enumerate(zip(batch, chunk_lens)):
            req.computed_len += chunk
            if req.computed_len < len(req.origin_input_ids):
                self._cache_unfinished(req)
                events.append(StepEvent(req, [], False))
                continue
            req.embedding = emb[i].copy()
            req.finished_reason = FinishReason.LENGTH
            self._finish_req(req)
            events.append(StepEvent(req, [], True))
        return events

    def _process_decode_result(
        self, batch, token_ids, logprobs, tops=None, defer_finish=False
    ):
        """Accept a [K, B] window of sampled tokens. A request that finishes
        at window step j still consumed valid inputs through step j+1, so its
        computed_len advances by min(j+2, K); later window slots are
        discarded (their KV lands in already-owned private pages).

        ``defer_finish``: another window over the same batch is already in
        flight — finished requests keep their resources (and stay in
        ``running``) until the pipeline drains, since the in-flight window
        still writes KV into their pages."""
        self._nan_guard(batch, logprobs)
        K = token_ids.shape[0]
        events: list[StepEvent] = []
        finished: list[Req] = []
        for i, req in enumerate(batch):
            if req.finished():
                # finished in an earlier window of the pipeline (or aborted
                # by the NaN guard — released by _sweep_external_finishes);
                # this window's speculative tokens for it are discarded
                events.append(StepEvent(req, [], True))
                continue
            accepted: list[int] = []
            finish_step = None
            for k in range(K):
                tok = int(token_ids[k, i])
                accepted.append(tok)
                req.output_ids.append(tok)
                if req.return_logprob:
                    req.output_token_logprobs.append(float(logprobs[k, i]))
                if tops is not None and req.sampling_params.top_logprobs > 0:
                    tk = req.sampling_params.top_logprobs
                    req.output_top_logprobs.append(
                        (tops[0][k][i][:tk].tolist(), tops[1][k][i][:tk].tolist())
                    )
                if req.grammar is not None:
                    req.grammar.accept_token(tok)
                req.check_finished()
                if req.finished():
                    finish_step = k
                    break
            if finish_step is None:
                req.computed_len += K
            else:
                req.computed_len += min(finish_step + 2, K)
                finished.append(req)
            if req.grammar is not None and not req.finished():
                forced = self._jump_forward(req)
                accepted.extend(forced)
                if req.finished():
                    finished.append(req)
            self.num_generated_tokens += len(accepted)
            events.append(StepEvent(req, accepted, req.finished()))
        if not defer_finish:
            for req in finished:
                self.running.remove(req)
                self._finish_req(req)
        return events

    # ----------------------------------------------------- cache bookkeeping

    def _cache_unfinished(self, req: Req) -> None:
        """Publish computed full pages into the radix tree and dedupe
        (reference: radix_cache.py:180-221 cache_unfinished_req)."""
        if self.tree_cache.disable:
            return
        tree = self.tree_cache.for_req(req)
        ps = self.page_size
        aligned = (req.computed_len // ps) * ps
        accepted = aligned // ps
        if accepted == 0:
            return
        toks = req.fill_ids[:aligned]
        dup = tree.insert(toks, req.pages[:accepted])
        if dup > req.num_tree_pages:
            self.allocator.free(req.pages[req.num_tree_pages : dup])
        m = tree.match_prefix(toks)
        assert m.num_pages >= accepted, "re-match lost inserted prefix"
        if req.last_node is not None:
            tree.dec_lock_ref(req.last_node)
        tree.inc_lock_ref(m.last_node)
        req.last_node = m.last_node
        req.pages = np.concatenate([m.page_ids[:accepted], req.pages[accepted:]])
        req.num_tree_pages = accepted
        self.req_slots.write_pages(req.req_slot, 0, req.pages)

    def _finish_req(self, req: Req) -> None:
        req.finished_at = __import__("time").monotonic()
        self._release_req(req, keep_outputs=True)

    def _release_req(self, req: Req, keep_outputs: bool) -> None:
        """Return KV pages + slot; insert finished KV into the radix tree
        (reference: radix_cache.py:145-178 cache_finished_req)."""
        self._free_cross_slot(req)
        ps = self.page_size
        if self.tree_cache.disable:
            if len(req.pages):
                self.allocator.free(req.pages)
        else:
            tree = self.tree_cache.for_req(req)
            kv_len = req.computed_len  # tokens with materialised KV
            aligned = (kv_len // ps) * ps
            accepted = aligned // ps
            if keep_outputs and accepted > 0:
                dup = tree.insert(
                    req.fill_ids[:aligned], req.pages[:accepted]
                )
                dup = max(dup, req.num_tree_pages)
                if dup > req.num_tree_pages:
                    self.allocator.free(req.pages[req.num_tree_pages : dup])
                if len(req.pages) > accepted:
                    self.allocator.free(req.pages[accepted:])
            else:
                # retraction/abort: free everything we privately own
                if len(req.pages) > req.num_tree_pages:
                    self.allocator.free(req.pages[req.num_tree_pages :])
            if req.last_node is not None:
                tree.dec_lock_ref(req.last_node)
                req.last_node = None
        if req.req_slot is not None:
            self.req_slots.free(req.req_slot)
            req.req_slot = None

    def _sweep_external_finishes(self) -> None:
        """Clean up requests finished outside the step loop (abort, stop str)."""
        for req in list(self.running):
            if req.finished():
                self.running.remove(req)
                self._finish_req(req)
        if self.chunked_req is not None and self.chunked_req.finished():
            self._release_req(self.chunked_req, keep_outputs=False)
            self.chunked_req = None

    # ---------------------------------------------------------------- debug

    def _promote_host_prefix(self, req: Req) -> None:
        """Before admission: pull any host-tier continuation of the request's
        device-cached prefix back into fresh device pages and re-insert it,
        so the admission match sees the full prefix (h2d copy instead of a
        prefill recompute)."""
        tier = self.host_tier
        if tier is None:
            return
        tree = self.tree_cache.for_req(req)
        m = tree.match_prefix(req.origin_input_ids)
        slots = tier.match(self.tree_cache.key_of(req), req.origin_input_ids, m.num_pages)
        if not slots:
            return
        loaded = tier.load(slots)  # copy out before any further eviction
        tree.inc_lock_ref(m.last_node)  # _alloc_pages may evict; protect match
        pages = self._alloc_pages(len(slots))
        tree.dec_lock_ref(m.last_node)
        if pages is None:
            return
        # eviction drops an image's tree that it empties (one that matched
        # nothing here); the request's tree is then a new one
        tree = self.tree_cache.for_req(req)
        self.runner.scatter_pages(pages, loaded)
        total = m.num_pages + len(slots)
        key = req.origin_input_ids[: total * self.page_size]
        all_pages = np.concatenate([m.page_ids, pages]).astype(np.int32)
        dup = tree.insert(key, all_pages)
        assert dup == m.num_pages, (dup, m.num_pages)
        logger.debug("promoted %d host-tier pages for %s", len(slots), req.rid)

    def resize_kv_pool(self, new_num_tokens: int) -> int:
        """Runtime KV-pool grow/shrink (reference: SystemController pool
        control, managers/controller.py:11 + scheduler handling). Requires an
        idle engine; flushes the radix cache because the layer->page fold
        renumbers with the page count."""
        if self.has_work():
            raise RuntimeError("cannot resize KV pool while requests are in flight")
        self.tree_cache.reset()
        tokens = self.runner.resize_kv_pool(new_num_tokens)
        self.allocator = self.runner.page_allocator
        if self.draft_runner is not None:
            self.draft_runner.resize_kv_pool(tokens)
            assert (
                self.draft_runner.page_allocator.num_pages
                == self.allocator.num_pages
            )
        if self.eagle is not None:  # the JAX copy leaves its pool at the old size
            self.eagle.resize_pool(self.allocator.num_pages)
        return tokens

    def check_memory_leak(self) -> None:
        """Idle-time invariant: all pages back in free list or tree
        (reference: scheduler.py:775-795 check_memory)."""
        assert not self.has_work()
        tree_pages = self.tree_cache.evictable_pages + self.tree_cache.protected_pages
        total = self.allocator.available_pages + tree_pages
        expect = self.allocator.num_pages - 1  # minus reserved dump page
        assert total == expect, f"KV page leak: {total} != {expect}"
        assert self.req_slots.available_slots == self.req_slots.max_reqs
        if getattr(self.runner.model, "has_cross_attention", False):
            n = self.runner.kv_config.cross_slots
            assert sorted(self.cross_slot_free) == list(range(1, n)), "cross-KV slot leak"

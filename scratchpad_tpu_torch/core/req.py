"""Request state machine.

Analogue of Req (reference: scratchpad/scheduler/schedule_batch.py:287-594)
reworked for the page-granular KV pool: a request tracks which of its pages
are radix-tree-owned (shared, lock-protected) vs privately allocated, and how
many tokens of KV are materialised in the cache.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Optional

import numpy as np

from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams


class FinishReason(enum.Enum):
    EOS = "stop"  # eos token or stop token id
    STOP_STR = "stop_str"
    LENGTH = "length"  # max_new_tokens reached
    ABORT = "abort"

    def to_openai(self) -> str:
        if self in (FinishReason.EOS, FinishReason.STOP_STR):
            return "stop"
        if self == FinishReason.LENGTH:
            return "length"
        return "abort"


@dataclasses.dataclass
class Req:
    rid: str
    origin_input_ids: list[int]
    sampling_params: SamplingParams

    # generated
    output_ids: list[int] = dataclasses.field(default_factory=list)

    # KV/cache state
    pages: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int32)
    )
    num_tree_pages: int = 0  # leading pages owned by the radix tree (shared)
    cached_prefix_len: int = 0  # tokens whose KV came from a radix hit
    computed_len: int = 0  # tokens whose KV is materialised in the cache
    last_node: Any = None  # radix tree node locked for this request
    req_slot: Optional[int] = None

    # grammar-constrained decoding
    grammar: Any = None

    # topping (LoRA adapter) pool slot; 0 = none
    topping_idx: int = 0

    # embedding request: finish at prefill with pooled hidden state
    is_embedding: bool = False
    embedding: Any = None

    # scoring request: teacher-forcing prompt logprobs (echo+logprobs /
    # lm-eval loglikelihood); finishes without generating
    is_score: bool = False
    prompt_logprobs: Any = None

    # multimodal: prompt positions holding image-placeholder pseudo ids
    # (negative, content-hashed) and their precomputed embeddings [n, H]
    mm_positions: Optional[np.ndarray] = None
    mm_features: Optional[np.ndarray] = None
    # multimodal rope (Qwen2-VL): [3, len(prompt)] position table for image
    # prompts and the scalar shift for every token past the prompt
    mrope_table: Optional[np.ndarray] = None
    mrope_delta: int = 0
    # Gemma3-MM: absolute (start, end) prompt ranges whose tokens attend
    # BIDIRECTIONALLY (HF token-type mask; reference: gemma3_mm.py:212-232)
    mm_spans: Optional[list] = None
    # cross attention (Mllama): the image's projected vision states [S_img,
    # H], its slot in KVCache.cross (None until admission, which writes
    # the slot), its live cross rows (n_tiles x patches; None: all) and the
    # position of its <|image|> placeholder
    cross_states: Optional[np.ndarray] = None
    cross_slot: Optional[int] = None
    cross_len: Optional[int] = None
    cross_start: int = 0
    # draft-model speculation: positions [0, draft_len) hold valid KV in the
    # DRAFT runner's pool (invariant: == computed_len right after any draft
    # forward; lags behind after plain decode windows, caught up on demand)
    draft_len: int = 0
    # EAGLE: the target's feature at the last processed position (None =
    # features lost, e.g. after a plain decode window -> no speculation)
    last_feature: Optional[np.ndarray] = None

    # stop/stream state
    finished_reason: Optional[FinishReason] = None
    eos_token_ids: frozenset[int] = frozenset()
    # incremental detokenization state (reference: managers/detokenizer.py:33)
    decoded_text: str = ""
    surr_offset: int = 0
    read_offset: int = 0
    stream_sent_len: int = 0  # chars already streamed out
    stream_sent_tokens: int = 0  # tokens acknowledged to the stream
    # latency-sensitive consumer: caps the fused decode window so token
    # bursts stay interactive (scheduler._pick_decode_window)
    stream: bool = False

    # logprobs
    return_logprob: bool = False
    output_token_logprobs: list[float] = dataclasses.field(default_factory=list)
    # [(top_values, top_ids), ...] per output token when requested
    output_top_logprobs: list = dataclasses.field(default_factory=list)

    # stats
    created_at: float = dataclasses.field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None  # host time of latest token event
    finished_at: Optional[float] = None
    retract_count: int = 0
    stats_done: bool = False  # terminal latency samples already recorded

    @property
    def image_key(self) -> Optional[int]:
        """What a cross-attention (Mllama) request's KV depends on from its
        first row besides its tokens: its image, as the placeholder's
        content-hashed id. Every row attends the image in the cross layers,
        the rows before the placeholder too (as in HF), so no prefix of it
        may serve a request with another image or none (the radix cache
        keeps a tree per image, ``TreeCacheGroup.key_of``)."""
        return None if self.cross_states is None else self.origin_input_ids[self.cross_start]

    @property
    def fill_ids(self) -> list[int]:
        """All token ids whose KV should eventually be in cache."""
        return self.origin_input_ids + self.output_ids

    @property
    def seq_len(self) -> int:
        return len(self.origin_input_ids) + len(self.output_ids)

    @property
    def extend_input_len(self) -> int:
        """Tokens still to be computed to finish prefill."""
        return len(self.fill_ids) - self.computed_len

    def clamp_chunk_for_spans(self, chunk: int) -> int:
        """Shrink (or grow) a prefill chunk so no bidirectional image span
        (Gemma3-MM) straddles the chunk boundary — a split span's earlier
        tokens would otherwise compute KV without intra-span attention."""
        if not self.mm_spans:
            return chunk
        end = self.computed_len + chunk
        for s0, s1 in self.mm_spans:
            if s0 < end < s1:
                if s0 > self.computed_len:
                    return s0 - self.computed_len  # stop before the span
                return s1 - self.computed_len  # cover the whole span
        return chunk

    @property
    def is_prefill_done(self) -> bool:
        # prefill is done when every fill token except none remain; during
        # decode, computed_len trails seq_len by the one just-sampled token
        return self.computed_len >= len(self.origin_input_ids)

    def finished(self) -> bool:
        return self.finished_reason is not None

    def check_finished(self) -> None:
        """Finish checks after appending a sampled token
        (reference: schedule_batch.py:525-570; stop strings are checked by
        the detokenizer path)."""
        if self.finished():
            return
        sp = self.sampling_params
        if len(self.output_ids) >= sp.max_new_tokens:
            self.finished_reason = FinishReason.LENGTH
            return
        if len(self.output_ids) < sp.min_new_tokens:
            return  # eos/stop suppressed until min_new_tokens
        last = self.output_ids[-1]
        if not sp.ignore_eos:
            if last in self.eos_token_ids:
                self.finished_reason = FinishReason.EOS
                return
        if sp.stop_token_ids and last in sp.stop_token_ids:
            self.finished_reason = FinishReason.EOS
            return

    def reset_for_retract(self) -> None:
        """Back to the waiting queue after retraction
        (reference: schedule_batch.py:1123-1170 retract_decode)."""
        self.pages = np.empty(0, np.int32)
        self.num_tree_pages = 0
        self.cached_prefix_len = 0
        self.computed_len = 0
        self.draft_len = 0
        self.last_node = None
        self.req_slot = None
        self.retract_count += 1

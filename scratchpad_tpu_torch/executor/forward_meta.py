"""Per-step device metadata for a model forward.

Counterpart of ``scratchpad_tpu/executor/forward_meta.py`` on torch tensors.
The layout convention is the same:

- new tokens are FLAT: ``tokens[T]`` spans all requests back to back, padded
  up to the T bucket. ``req_indices[t]`` says which request row each token
  belongs to. Decode is the special case T == B, req_indices == arange.
- ``page_table[B, MAXP]`` lists each request's KV pages in sequence order and
  ``seq_lens[B]`` counts its cached tokens *including* this step's new ones.
- each new token's KV is written to flat slot ``out_cache_loc[t]`` before
  attention runs, so causal masking by position is the only masking needed.

Padding rows have seq_lens == 0 / extend_lens == 0 and out_cache_loc pointing
at the reserved dump page 0.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class ForwardMode(enum.Enum):
    EXTEND = "extend"  # prefill or chunked-prefill continuation
    DECODE = "decode"  # one new token per running request
    IDLE = "idle"

    def is_extend(self) -> bool:
        return self == ForwardMode.EXTEND

    def is_decode(self) -> bool:
        return self == ForwardMode.DECODE


@dataclasses.dataclass
class ForwardMeta:
    mode: ForwardMode
    tokens: torch.Tensor  # i64[T] flat new token ids
    positions: torch.Tensor  # i64[T] absolute position of each new token
    out_cache_loc: torch.Tensor  # i64[T] flat KV slot for each new token
    req_indices: torch.Tensor  # i64[T] request row per token
    page_table: torch.Tensor  # i32[B, MAXP]
    seq_lens: torch.Tensor  # i32[B] tokens in cache incl. new ones
    extend_lens: torch.Tensor  # i32[B] new tokens this step per request
    last_token_idx: torch.Tensor  # i64[B] flat index of each row's last new token
    # i32[B + 1] prefix sums of extend_lens (extend only; the extend kernel's
    # ragged query offsets)
    cu_q_lens: torch.Tensor | None = None
    # toppings: the batch's distinct adapter pool slots (0 = none) and each
    # request's position in that list; None when no request names an adapter
    active_adapters: torch.Tensor | None = None  # i32[MAX_ACTIVE_TOPPINGS]
    adapter_slots: torch.Tensor | None = None  # i32[B]

    @property
    def num_tokens(self) -> int:
        return self.tokens.shape[0]

    @property
    def batch_size(self) -> int:
        return self.seq_lens.shape[0]

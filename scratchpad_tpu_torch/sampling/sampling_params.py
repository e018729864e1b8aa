"""Per-request sampling parameters.

Mirrors the reference SamplingParams surface
(reference: scratchpad/sampling/sampling_params.py:7) minus torch specifics.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union


@dataclasses.dataclass
class SamplingParams:
    max_new_tokens: int = 128
    min_new_tokens: int = 0
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1  # -1 = disabled
    min_p: float = 0.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    stop: Optional[Union[str, List[str]]] = None
    stop_token_ids: Optional[List[int]] = None
    ignore_eos: bool = False
    skip_special_tokens: bool = True
    spaces_between_special_tokens: bool = True
    n: int = 1
    top_logprobs: int = 0  # return top-k alternatives per output token (<=8)
    # constrained decoding (one of)
    json_schema: Optional[str] = None
    regex: Optional[str] = None
    ebnf: Optional[str] = None
    structural_tag: Optional[str] = None  # JSON-encoded {structures, triggers}
    # additive per-token-id logit bias (OpenAI logit_bias), applied on
    # device before penalties/softmax (reference: nn/layers/sampler.py:162)
    logit_bias: Optional[dict] = None  # {token_id: bias}
    # user-supplied logit transform: a jax-traceable callable
    # fn(logits[B, V], params) -> logits traced into the device sampling
    # step (sampling/custom_logit_processor.py; reference:
    # sampling/custom_logit_processor.py:1-38). Scalar knobs ride
    # custom_params as f32 per-row values.
    custom_logit_processor: Optional[object] = None
    custom_params: Optional[dict] = None  # {name: float}

    def __post_init__(self):
        if self.stop is None:
            self.stop = []
        elif isinstance(self.stop, str):
            self.stop = [self.stop]
        if self.stop_token_ids is None:
            self.stop_token_ids = []
        self.verify()

    def verify(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0 < self.top_p <= 1:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < -1 or self.top_k == 0:
            raise ValueError("top_k must be -1 (disable) or >= 1")
        if not 0 <= self.min_p <= 1:
            raise ValueError("min_p must be in [0, 1]")
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if self.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0

    def needs_penalties(self) -> bool:
        return (
            self.frequency_penalty != 0.0
            or self.presence_penalty != 0.0
            or self.repetition_penalty != 1.0
        )

    def grammar_key(self):
        """(kind, value) when constrained decoding is requested, else None
        (reference: scheduler/scheduler.py:629-649 key dispatch)."""
        if self.json_schema is not None:
            return ("json", self.json_schema)
        if self.regex is not None:
            return ("regex", self.regex)
        if self.ebnf is not None:
            return ("ebnf", self.ebnf)
        if self.structural_tag is not None:
            return ("structural_tag", self.structural_tag)
        return None

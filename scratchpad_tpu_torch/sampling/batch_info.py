"""Batched sampling state for one step.

Counterpart of ``scratchpad_tpu/sampling/batch_info.py``: host numpy arrays
built from the scheduler's requests (``from_reqs``), moved to the device by
``to(device)``. Padding rows are greedy. The port has no grammar bitmask and
no custom logit processors yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class SamplingBatchInfo:
    temperature: np.ndarray  # f32[B] (0 = greedy)
    top_p: np.ndarray  # f32[B]
    top_k: np.ndarray  # i32[B] (V for disabled)
    min_p: np.ndarray  # f32[B]
    # penalties (None when no request in the batch uses them)
    presence_penalty: Optional[np.ndarray] = None  # f32[B]
    frequency_penalty: Optional[np.ndarray] = None  # f32[B]
    repetition_penalty: Optional[np.ndarray] = None  # f32[B]
    output_token_counts: Optional[np.ndarray] = None  # i32[B, V]
    input_token_mask: Optional[np.ndarray] = None  # bool[B, V]
    # additive OpenAI logit_bias (None when no request in the batch has one)
    logit_bias: Optional[np.ndarray] = None  # f32[B, V]

    @property
    def needs_penalties(self) -> bool:
        return self.output_token_counts is not None

    def modes(self, vocab_size: int) -> tuple[bool, bool]:
        """(any row samples, any row filters by top-k/top-p/min-p)."""
        sampling = bool((self.temperature > 0).any())
        filtering = bool(
            ((self.top_k < vocab_size) | (self.top_p < 1.0) | (self.min_p > 0.0)).any()
        )
        return sampling, filtering

    def to(self, device) -> "SamplingBatchInfo":
        """Tensor copy of every present field on ``device``."""
        return SamplingBatchInfo(
            **{
                f.name: None
                if getattr(self, f.name) is None
                else torch.as_tensor(getattr(self, f.name)).to(device)
                for f in dataclasses.fields(self)
            }
        )

    @staticmethod
    def from_reqs(reqs, bucket_size: int, vocab_size: int) -> "SamplingBatchInfo":
        """Build padded host arrays from scheduler Req objects."""
        if any(r.sampling_params.custom_logit_processor is not None for r in reqs):
            raise NotImplementedError("custom logit processors are not ported yet")
        B = bucket_size
        temperature = np.zeros(B, np.float32)
        top_p = np.ones(B, np.float32)
        top_k = np.full(B, vocab_size, np.int32)
        min_p = np.zeros(B, np.float32)
        any_pen = any(r.sampling_params.needs_penalties() for r in reqs)
        pres = np.zeros(B, np.float32) if any_pen else None
        freq = np.zeros(B, np.float32) if any_pen else None
        rep = np.ones(B, np.float32) if any_pen else None
        for i, r in enumerate(reqs):
            sp = r.sampling_params
            temperature[i] = sp.temperature
            top_p[i] = sp.top_p
            top_k[i] = sp.top_k if sp.top_k > 0 else vocab_size
            min_p[i] = sp.min_p
            if any_pen:
                pres[i] = sp.presence_penalty
                freq[i] = sp.frequency_penalty
                rep[i] = sp.repetition_penalty
        bias = None
        if any(r.sampling_params.logit_bias for r in reqs):
            bias = np.zeros((B, vocab_size), np.float32)
            for i, r in enumerate(reqs):
                for tid, b in (r.sampling_params.logit_bias or {}).items():
                    if 0 <= int(tid) < vocab_size:
                        bias[i, int(tid)] = b
        out_counts = None
        in_mask = None
        if any_pen:
            out_counts = np.zeros((B, vocab_size), np.int32)
            in_mask = np.zeros((B, vocab_size), np.bool_)
            for i, r in enumerate(reqs):
                if r.output_ids:
                    ids, counts = np.unique(
                        np.asarray(r.output_ids, np.int64), return_counts=True
                    )
                    out_counts[i, ids] = counts
                in_mask[i, np.asarray(r.origin_input_ids, np.int64)] = True
        return SamplingBatchInfo(
            temperature=temperature,
            top_p=top_p,
            top_k=top_k,
            min_p=min_p,
            presence_penalty=pres,
            frequency_penalty=freq,
            repetition_penalty=rep,
            output_token_counts=out_counts,
            input_token_mask=in_mask,
            logit_bias=bias,
        )
